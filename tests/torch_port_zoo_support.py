"""What the port's model-zoo parity tests share
(``test_torch_port_zoo.py``, ``test_torch_port_inception.py``): the
reduced models of both packages, random flax variables from a seed, flax's
results compiled once a case into a module's cache, and the port's run on
the same numpy batch. Tolerances are the test modules' own.

Each flax program is compiled with XLA's costly CPU passes off; the port's
models are built on the meta device and take the converted tensors as
they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

from horovod_tpu.models import inception as JI
from horovod_tpu.models import mlp as JM
from horovod_tpu.models import vgg as JV
from horovod_tpu.models import vit as JT
from horovod_tpu_torch.models import inception as PI
from horovod_tpu_torch.models import mlp as PM
from horovod_tpu_torch.models import vgg as PV
from horovod_tpu_torch.models import vit as PT

BATCH, CLASSES = 2, 10
VIT_SMALL = dict(patch_size=4, d_model=32, n_layers=2, n_heads=4,
                 mlp_dim=64)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# XLA's CPU backend without its costly passes: each program runs once or
# twice, and compiling it dominates
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

# name -> (flax model by dtype, port model by dtype and device, image
# side, channels, whether the apply takes ``train``, params_from_jax)
MODELS = {
    "vgg16": (lambda d: JV.VGG16(num_classes=CLASSES, dtype=d,
                                 dropout_rate=0.0),
              lambda d, dev: PV.VGG16(num_classes=CLASSES, dtype=d, image=64,
                                      dropout_rate=0.0, device=dev),
              64, 3, True, PV.params_from_jax),
    "inception3": (lambda d: JI.InceptionV3(num_classes=CLASSES, dtype=d,
                                            dropout_rate=0.0),
                   lambda d, dev: PI.InceptionV3(
                       num_classes=CLASSES, dtype=d, dropout_rate=0.0,
                       device=dev),
                   75, 3, True, PI.params_from_jax),
    "vit": (lambda d: JT.ViT(num_classes=CLASSES, dtype=d, **VIT_SMALL),
            lambda d, dev: PT.ViT(num_classes=CLASSES, dtype=d, image=16,
                                  device=dev, **VIT_SMALL),
            16, 3, True, PT.params_from_jax),
    "mnist_conv": (lambda d: JM.MnistConvNet(dtype=d),
                   lambda d, dev: PM.MnistConvNet(dtype=d, device=dev),
                   28, 1, True, PM.params_from_jax),
    "mlp": (lambda d: JM.MLP(dtype=d),
            lambda d, dev: PM.MLP(dtype=d, device=dev), 28, 1, False,
            PM.mlp_params_from_jax),
}
HAS_STATS = ("inception3",)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_variables(shapes, seed: int = 0):
    """Random flax variables of the given shapes: kernels scaled by their
    fan-in, norm scales near 1, variances in [0.5, 1.5], other leaves
    (biases, means, the class token, the position embedding) small."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            # DenseGeneral's q/k/v kernels are [d, heads, head_dim]
            fan_in = (s.shape[0] if any(k in name for k in (
                "'query'", "'key'", "'value'")) else
                int(np.prod(s.shape[:-1])))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rs.randn(*s.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def batch_of(name: str):
    hw, ch = MODELS[name][2:4]
    rs = np.random.RandomState(hw)
    return (rs.randn(BATCH, hw, hw, ch).astype(np.float32),
            rs.randint(0, CLASSES, (BATCH,)))


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def convert(name, params, stats=None):
    convert = MODELS[name][5]
    return convert(params, stats) if name in HAS_STATS else convert(params)


def flax_variables(zoo, name):
    key = ("variables", name)
    if key not in zoo:
        jmodel, _, hw, ch, _, _ = MODELS[name]
        shapes = jax.eval_shape(
            lambda x: jmodel(jnp.float32).init(jax.random.PRNGKey(0), x),
            jax.ShapeDtypeStruct((BATCH, hw, hw, ch), jnp.float32))
        zoo[key] = random_variables(shapes)
    return zoo[key]


def compiled(zoo, name: str, dtype: str, train: bool, grads: bool):
    """flax's loss, logits and (train mode) updated batch statistics, and
    with ``grads`` the gradients, as one program compiled once."""
    key = ("compiled", name, dtype, train, grads)
    if key in zoo:
        return zoo[key]
    jmodel, _, _, _, takes_train, _ = MODELS[name]
    m = jmodel(JDT[dtype])
    has_stats = name in HAS_STATS

    def loss_fn(params, stats, x, y):
        v = {"params": params, **({"batch_stats": stats} if has_stats
                                  else {})}
        kw = {"train": train} if takes_train else {}
        if has_stats and train:
            logits, upd = m.apply(v, x, mutable=["batch_stats"], **kw)
            stats = upd["batch_stats"]
        else:
            logits = m.apply(v, x, **kw)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, stats)

    def ref(params, stats, x, y):
        if not grads:
            return loss_fn(params, stats, x, y), {}
        return jax.value_and_grad(loss_fn, has_aux=True)(params, stats, x, y)

    variables = flax_variables(zoo, name)
    x, y = batch_of(name)
    args = (variables["params"], variables.get("batch_stats", {}), x, y)
    zoo[key] = jax.jit(ref).lower(*args).compile(FAST_COMPILE)
    return zoo[key]


def reference(zoo, name: str, dtype: str, train: bool = True,
               grads: bool = True, params=None) -> dict:
    """flax's results for one case by group: ``logits``, ``loss``,
    ``grads`` and ``stats`` (the updated batch statistics), each a dict of
    state_dict names (or the group's own name) to numpy arrays, and
    ``grad_tree`` (flax's tree); on the random variables (cached) or on
    ``params``."""
    key = (name, dtype, train, grads)
    if params is None and key in zoo:
        return zoo[key]
    variables = flax_variables(zoo, name)
    x, y = batch_of(name)
    stats = variables.get("batch_stats", {})
    (loss, (logits, new_stats)), grad_tree = np_tree(compiled(
        zoo, name, dtype, train, grads)(
            variables["params"] if params is None else params, stats, x, y))
    groups = {"logits": {"logits": logits},
              "loss": {"loss": np.float32(loss)}, "grad_tree": grad_tree}
    if grads:
        groups["grads"] = {k: v.numpy() for k, v in convert(
            name, grad_tree, new_stats).items() if "running" not in k}
    if name in HAS_STATS:
        groups["stats"] = {k: v.numpy() for k, v in convert(
            name, variables["params"], new_stats).items()
            if "running" in k}
    if params is None:
        zoo[key] = groups
    return groups


def one_ulp(tree, seed: int = 7):
    """Every element of a tree moved one ulp up or down at random."""
    rs = np.random.RandomState(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        up = rs.rand(*a.shape) < 0.5
        return np.nextafter(a, np.where(up, np.inf, -np.inf).astype(
            np.float32)).astype(np.float32)

    return jax.tree_util.tree_map(move, tree)


def port_model(zoo, name: str, dtype: str):
    """The port's model on the CPU holding the random variables (built on
    the meta device: no weights drawn only to be replaced)."""
    variables = flax_variables(zoo, name)
    m = MODELS[name][1](TDT[dtype], "meta")
    m.load_state_dict(convert(name, variables["params"],
                               variables.get("batch_stats")), assign=True)
    return m


def port_run(zoo, name: str, dtype: str, train: bool = True) -> dict:
    m = port_model(zoo, name, dtype).train(train)
    x, y = batch_of(name)
    logits = m(nchw(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return {"logits": {"logits": logits.detach().numpy()},
            "loss": {"loss": np.float32(loss.item())},
            "grads": {k: p.grad.numpy() for k, p in m.named_parameters()},
            "stats": {k: t.numpy() for k, t in m.state_dict().items()
                      if "running" in k}}


def norm_err(got: dict, want: dict) -> float:
    """|got - want| / |want| over the group's tensors together."""
    g = np.concatenate([np.ravel(got[k]).astype(np.float64) for k in want])
    w = np.concatenate([np.ravel(want[k]).astype(np.float64) for k in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def assert_close(got: dict, want: dict, tol: float, what):
    """Every tensor within ``tol`` of its largest magnitude."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.abs(w).max(initial=0.0)) or 1.0
        err = float(np.abs(np.asarray(got[k], np.float64)
                           - w).max(initial=0.0))
        assert err <= tol * scale, (what, k, err, scale)
