"""The parallelism strategies across processes: one four-process gloo job
through the port's ``hvdrun``, started once for the file, against the JAX
package's strategies on the test process's virtual CPU devices.

The test process draws every input from one seed with numpy and writes
them to a file; each rank of the job reads them, runs its share of each
case and saves its results; the JAX references are computed while the
job runs. The cases (fp32 throughout):

- ``mlp``: ``parallel_mlp`` at tp = 4, forward against the JAX function
  under ``shard_map``, gradients against the dense MLP's (``jax.grad``):
  a column/row pair's gradients are the dense model's on every rank;
- ``lm``: the LM (vocab 64, d 32, 4 heads, 2 layers, d_ff 64, seq 16) at
  dp 2 x tp 2 through ``data_parallel_step`` and
  ``DistributedOptimizer(process_set=step.process_set)``: each rank's loss
  against its dp shard's, the averaged gradients (this rank's tp slice)
  against the JAX package's GSPMD gradient of the whole batch under
  ``param_specs``, and the parameters after one SGD step;
- ``moe``: ``moe_layer`` at ep = 4, k = 1 and 2, outputs, ``aux`` and
  each rank's gradients against the JAX layer under ``shard_map``
  (``jax.grad`` inside it: a replicated leaf's gradient is the rank's
  own, in both packages);
- ``pp``: ``pipeline_apply`` and ``pipeline_loss`` at pp = 4 (6
  microbatches), outputs and loss against the JAX functions under
  ``shard_map``, each stage's gradient against the sequential model's,
  and ``remat_stage`` bitwise the same gradients;
- ``fsdp``: ``fsdp_train_step`` on the LM, three steps of SGD with
  momentum 0.9 over dp = 4, losses and parameters after every step against
  the JAX package's ``fsdp_train_step`` with ``optax.sgd``;
- ``dp``: ``data_parallel_step`` over dp = 4, two steps of a linear model
  against the JAX package's;
- ``hier``: ``create_hierarchical_mesh`` at 2 hosts of 2, its coordinates
  and sets, a nested sum over its groups equal to the flat one.

Tolerances: fp32 summation order (``TOL``; the LM's gradients and
parameters after steps within ``LM_TOL`` of each tensor's largest).
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as T
from horovod_tpu.parallel import (create_mesh, data_parallel_step,
                                  fsdp_train_step, moe_layer, parallel_mlp,
                                  pipeline_apply, pipeline_loss)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16)
LM_BATCH, LR, FSDP_STEPS, MIN_SHARD = 8, 0.1, 3, 256
MOE = dict(t_local=8, d=16, experts=8, factor=2.0)
PP = dict(d=8, n_micro=6, mb=3)
TOL = dict(rtol=1e-5, atol=1e-6)
LM_TOL = 1e-5  # of each tensor's largest magnitude

JOB = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import (
        create_hierarchical_mesh, create_mesh, data_parallel_step,
        fsdp_train_step, moe_layer, parallel_mlp, pipeline_apply,
        pipeline_loss, _comm)
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
    inp = dict(np.load(IN))
    res = {}

    def t(name):
        return torch.from_numpy(inp[name])

    def save(prefix, **kw):
        for k, v in kw.items():
            res[prefix + k] = v.detach().numpy() if torch.is_tensor(v) else v

    def counted(prefix, before):
        res[prefix + "exchanges"] = np.array(
            [_comm.exchanges[k] - before[k] for k in sorted(before)])

    def lm_tree():
        blocks = []
        for i in range(CFG["n_layers"]):
            b = {k: inp[f"lm.blocks.{i}.{k}"] for k in
                 ("wq", "wk", "wv", "wo", "w1", "w2")}
            b.update({k: {"scale": inp[f"lm.blocks.{i}.{k}"]}
                      for k in ("ln1", "ln2")})
            blocks.append(b)
        return {"embed": inp["lm.embed"], "pos": inp["lm.pos"],
                "ln_f": {"scale": inp["lm.ln_f"]}, "blocks": blocks}

    cfg = T.TransformerConfig(**CFG, dtype=torch.float32)

    # mlp: tp = 4
    mesh = create_mesh({"tp": 4})
    g, i = mesh.group("tp"), mesh.coords["tp"]
    f = inp["mlp.w1"].shape[1] // 4
    x = t("mlp.x").requires_grad_()
    w1 = t("mlp.w1")[:, i * f:(i + 1) * f].clone().requires_grad_()
    w2 = t("mlp.w2")[i * f:(i + 1) * f].clone().requires_grad_()
    before = dict(_comm.exchanges)
    y = parallel_mlp(x, w1, w2, g)
    (y * t("mlp.co")).sum().backward()
    counted("mlp.", before)
    save("mlp.", y=y, dx=x.grad, dw1=w1.grad, dw2=w2.grad)

    # lm: dp 2 x tp 2, one step through the runtime
    mesh = create_mesh({"dp": 2, "tp": 2})
    dp, tp = mesh.coords["dp"], mesh.coords["tp"]
    model = T.TransformerLM(cfg, device="cpu", seed=7,
                            tp_group=mesh.group("tp"))
    dense = T.TransformerLM(cfg, device="cpu", seed=7).state_dict()
    specs = T.param_specs(cfg)
    res["lm.drawn_slices"] = np.array([torch.equal(
        v, T.tp_slice(dense[k], specs[k], tp, 2))
        for k, v in model.state_dict().items()])
    model.load_state_dict(T.params_from_jax(lm_tree(), tp, 2))

    def lm_step(model, opt, tokens):
        opt.zero_grad()
        loss = T.lm_loss(model, tokens)
        loss.backward()
        opt.synchronize()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        with opt.skip_synchronize():
            opt.step()
        return loss, grads

    step = data_parallel_step(lm_step, mesh=mesh, axis_name="dp")
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR),
        named_parameters=model.named_parameters(),
        process_set=step.process_set)
    half = LM_BATCH // 2
    loss, grads = step(model, opt, inp["lm.tokens"][dp * half:(dp + 1) * half])
    save("lm.", loss=loss)
    for k, v in grads.items():
        save("lm.grad.", **{k: v})
    for k, v in model.state_dict().items():
        save("lm.after.", **{k: v})
    res["lm.set"] = np.array(step.process_set.ranks)

    # moe: ep = 4, k = 1 and 2
    mesh = create_mesh({"ep": 4})
    g = mesh.group("ep")
    e_local = inp["moe.w"].shape[0] // 4
    for k in (1, 2):
        x = t("moe.x")[r * MOE["t_local"]:(r + 1) * MOE["t_local"]]
        x = x.clone().requires_grad_()
        gate_w = t("moe.gate_w").requires_grad_()
        w = t("moe.w")[r * e_local:(r + 1) * e_local].clone()
        w.requires_grad_()
        y, aux = moe_layer(x, gate_w, lambda p, xe: torch.tanh(xe @ p), w,
                           group=g, capacity_factor=MOE["factor"], k=k)
        co = t("moe.co")[r * MOE["t_local"]:(r + 1) * MOE["t_local"]]
        ((y * co).sum() + aux).backward()
        save(f"moe.{k}.", y=y, aux=aux, dx=x.grad, dgate=gate_w.grad,
             dw=w.grad)

    # pp: 4 stages
    mesh = create_mesh({"pp": 4})
    g = mesh.group("pp")
    ws = t("pp.ws")

    def stage(w, h):
        return torch.tanh(h @ w)

    def mse(o, tgt):
        return ((o - tgt) ** 2).mean()

    out = pipeline_apply(stage, ws[r], t("pp.xs"), group=g)
    save("pp.", out=out)
    before = dict(_comm.exchanges)
    for remat in (False, True):
        w = ws[r].clone().requires_grad_()
        loss = pipeline_loss(stage, mse, w, t("pp.xs"), t("pp.tgt"),
                             group=g, remat_stage=remat)
        loss.backward()
        save(f"pp.{remat}.", loss=loss, dw=w.grad)
    counted("pp.", before)

    # fsdp: dp = 4, SGD with momentum
    mesh = create_mesh({"dp": 4})
    model = T.TransformerLM(cfg, device="cpu")
    model.load_state_dict(T.params_from_jax(lm_tree()))
    make = fsdp_train_step(
        lambda m, tokens: T.lm_loss(m, tokens),
        lambda ps: torch.optim.SGD(ps, lr=LR, momentum=0.9), mesh,
        axis="dp", min_shard_elems=MIN_SHARD)
    state, fstep = make(model)
    quarter = LM_BATCH // 4
    for s in range(FSDP_STEPS):
        loss = fstep(torch.from_numpy(
            inp["lm.tokens"][r * quarter:(r + 1) * quarter]))
        save(f"fsdp.{s}.", loss=loss)
        for k, v in state.full_state_dict().items():
            save(f"fsdp.{s}.", **{k: v})
    for k, d in state.specs.items():
        res["fsdp.spec." + k] = np.array(-1 if d is None else d)
    res["fsdp.shard_bytes"] = np.array(
        sum(p.numel() * 4 for p in state.shards.values()))
    mom = [st["momentum_buffer"] for st in state.optimizer.state.values()]
    res["fsdp.momentum_shapes"] = np.array(
        sorted(int(m.numel()) for m in mom))

    # the two-level mesh: a sum over the ici lines, then the dcn lines,
    # is the sum over the world (integer-valued, so exact)
    hier = create_hierarchical_mesh({"dp_ici": 2}, {"dp_dcn": 2})
    x = torch.arange(6, dtype=torch.float32) * (r + 1)
    nested = x.clone()
    torch.distributed.all_reduce(nested, group=hier.group("dp_ici"))
    torch.distributed.all_reduce(nested, group=hier.group("dp_dcn"))
    flat = x.clone()
    torch.distributed.all_reduce(flat)
    res["hier.coords"] = np.array([hier.coords["dp_dcn"],
                                   hier.coords["dp_ici"]])
    res["hier.sets"] = np.array([hier.process_set("dp_ici").ranks,
                                 hier.process_set("dp_dcn").ranks])
    res["hier.equal"] = np.array(torch.equal(nested, flat))

    # dp: a linear model over dp = 4
    lin = torch.nn.Linear(8, 4, bias=False)
    with torch.no_grad():
        lin.weight.copy_(t("dp.w").T)

    def dp_step(model, opt, batch):
        xb, yb = batch
        opt.zero_grad()
        loss = ((model(xb) - yb) ** 2).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    step = data_parallel_step(dp_step, mesh=mesh, axis_name="dp")
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(lin.parameters(), lr=LR),
        named_parameters=lin.named_parameters(),
        process_set=step.process_set)
    for s in range(2):
        xb = inp["dp.x"][s, r * 2:(r + 1) * 2]
        yb = inp["dp.y"][s, r * 2:(r + 1) * 2]
        step(lin, opt, (xb, yb))
    save("dp.", w=lin.weight.T)

    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""


def _inputs() -> dict:
    rs = np.random.RandomState(0)
    c = CFG
    inp = {"mlp.x": rs.randn(4, 32), "mlp.w1": rs.randn(32, 64) * 0.3,
           "mlp.w2": rs.randn(64, 32) * 0.3, "mlp.co": rs.randn(4, 32)}
    d, h, hd, f = c["d_model"], c["n_heads"], c["d_model"] // c["n_heads"], \
        c["d_ff"]
    inp["lm.embed"] = 0.02 * rs.randn(c["vocab_size"], d)
    inp["lm.pos"] = 0.02 * rs.randn(c["max_seq"], d)
    inp["lm.ln_f"] = 1.0 + 0.1 * rs.randn(d)
    for i in range(c["n_layers"]):
        p = f"lm.blocks.{i}."
        for k, shape in (("wq", (d, h, hd)), ("wk", (d, h, hd)),
                         ("wv", (d, h, hd)), ("wo", (h, hd, d)),
                         ("w1", (d, f)), ("w2", (f, d))):
            inp[p + k] = 0.1 * rs.randn(*shape)
        for k in ("ln1", "ln2"):
            inp[p + k] = 1.0 + 0.1 * rs.randn(d)
    inp["lm.tokens"] = rs.randint(0, c["vocab_size"],
                                  (LM_BATCH, c["max_seq"] + 1))
    m = MOE
    inp["moe.x"] = rs.randn(N * m["t_local"], m["d"])
    inp["moe.gate_w"] = rs.randn(m["d"], m["experts"])
    inp["moe.w"] = 0.3 * rs.randn(m["experts"], m["d"], m["d"])
    inp["moe.co"] = rs.randn(N * m["t_local"], m["d"])
    inp["pp.ws"] = 0.5 * rs.randn(N, PP["d"], PP["d"])
    inp["pp.xs"] = rs.randn(PP["n_micro"], PP["mb"], PP["d"])
    inp["pp.tgt"] = rs.randn(PP["n_micro"], PP["mb"], PP["d"])
    inp["dp.w"] = rs.randn(8, 4)
    inp["dp.x"] = rs.randn(2, 8, 8)
    inp["dp.y"] = rs.randn(2, 8, 4)
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in inp.items()}


def _lm_tree(inp) -> dict:
    blocks = []
    for i in range(CFG["n_layers"]):
        p = f"lm.blocks.{i}."
        b = {k: jnp.asarray(inp[p + k]) for k in
             ("wq", "wk", "wv", "wo", "w1", "w2")}
        b.update({k: {"scale": jnp.asarray(inp[p + k])}
                  for k in ("ln1", "ln2")})
        blocks.append(b)
    return {"embed": jnp.asarray(inp["lm.embed"]),
            "pos": jnp.asarray(inp["lm.pos"]),
            "ln_f": {"scale": jnp.asarray(inp["lm.ln_f"])}, "blocks": blocks}


def _flat(tree) -> dict:
    """A JAX LM pytree as the port's ``state_dict`` keys."""
    out = {"embed": tree["embed"], "pos": tree["pos"],
           "ln_f.scale": tree["ln_f"]["scale"]}
    for i, b in enumerate(tree["blocks"]):
        for k in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[f"blocks.{i}.{k}"] = b[k]
        for k in ("ln1", "ln2"):
            out[f"blocks.{i}.{k}.scale"] = b[k]["scale"]
    return {k: np.asarray(v) for k, v in out.items()}


def _jcfg(**kw):
    return T.TransformerConfig(**CFG, dtype=jnp.float32, **kw)


def _mesh(names, shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))], dtype=object)
    return Mesh(devs.reshape(shape), names)


def _tp_dim(key):
    """The tp dim of a ``state_dict`` key under the JAX ``param_specs``."""
    spec = T.param_specs(_jcfg())
    if key.startswith("blocks."):
        _, i, name = key.split(".", 2)
        s = spec["blocks"][int(i)][name.split(".")[0]]
    else:
        s = P()
    return next((j for j, a in enumerate(s) if a == "tp"), None)


def _slice(x, dim, i, n):
    if dim is None:
        return x
    s = x.shape[dim] // n
    return np.take(x, np.arange(i * s, (i + 1) * s), axis=dim)


def _references(inp) -> dict:
    ref = {}
    # mlp
    x, w1, w2, co = (jnp.asarray(inp["mlp." + k])
                     for k in ("x", "w1", "w2", "co"))
    ref["mlp.y"] = np.asarray(jax.jit(jax.shard_map(
        lambda x, a, b: parallel_mlp(x, a, b, "tp"), mesh=_mesh(("tp",), (4,)),
        in_specs=(P(), P(None, "tp"), P("tp", None)), out_specs=P()))(
            x, w1, w2))
    ref["mlp.grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda x, a, b: jnp.sum(jax.nn.gelu(x @ a) @ b * co),
        argnums=(0, 1, 2)))(x, w1, w2)]

    # lm: each dp shard's loss, and the whole batch's gradient under GSPMD
    params, toks = _lm_tree(inp), jnp.asarray(inp["lm.tokens"])
    cfg = _jcfg(dp_axis="dp", tp_axis="tp", sp_axis=None)
    mesh = _mesh(("dp", "tp"), (2, 2))
    shard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                         T.param_specs(cfg),
                         is_leaf=lambda s: isinstance(s, P))
    vg = jax.jit(jax.value_and_grad(lambda p, t: T.lm_loss(p, t, cfg)),
                 in_shardings=(shard, NamedSharding(mesh, P("dp"))))
    with jax.set_mesh(mesh):
        _, grads = vg(params, toks)
    ref["lm.grads"] = _flat(grads)
    half = LM_BATCH // 2
    loss = jax.jit(lambda p, t: T.lm_loss(p, t, _jcfg(),
                                          use_constraints=False))
    ref["lm.losses"] = [float(loss(params, toks[j * half:(j + 1) * half]))
                        for j in range(2)]
    ref["lm.after"] = {k: v - LR * ref["lm.grads"][k]
                       for k, v in _flat(params).items()}

    # moe: per-rank values and gradients inside shard_map
    m = MOE
    mesh = _mesh(("ep",), (4,))
    for k in (1, 2):
        def per_rank(x, gate_w, w, co, k=k):
            def loss(x, gate_w, w):
                y, aux = moe_layer(x, gate_w, lambda p, xe: jnp.tanh(xe @ p),
                                   w, axis_name="ep",
                                   capacity_factor=m["factor"], k=k)
                return jnp.sum(y * co) + aux, (y, aux)

            (_, (y, aux)), gr = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(x, gate_w, w)
            return y, aux[None], gr[0], gr[1][None], gr[2]

        out = jax.jit(jax.shard_map(
            per_rank, mesh=mesh,
            in_specs=(P("ep"), P(), P("ep"), P("ep")),
            out_specs=(P("ep"), P("ep"), P("ep"), P("ep"), P("ep")),
            check_vma=False))(*(jnp.asarray(inp["moe." + n])
                               for n in ("x", "gate_w", "w", "co")))
        ref[f"moe.{k}"] = [np.asarray(o) for o in out]

    # pp: outputs and loss under shard_map, gradients of the sequential model
    ws, xs, tgt = (jnp.asarray(inp["pp." + n]) for n in ("ws", "xs", "tgt"))
    mesh = _mesh(("pp",), (4,))

    def stage(w, h):
        return jnp.tanh(h @ w)

    def mse(o, t):
        return jnp.mean((o - t) ** 2)

    ref["pp.out"] = np.asarray(jax.jit(jax.shard_map(
        lambda w, xs: jax.lax.psum(pipeline_apply(stage, w[0], xs,
                                                  axis_name="pp"), "pp"),
        mesh=mesh, in_specs=(P("pp"), P()), out_specs=P(),
        check_vma=False))(ws, xs))
    ref["pp.loss"] = float(jax.jit(jax.shard_map(
        lambda w, xs, t: pipeline_loss(stage, mse, w[0], xs, t,
                                       axis_name="pp"),
        mesh=mesh, in_specs=(P("pp"), P(), P()), out_specs=P(),
        check_vma=False))(ws, xs, tgt))

    def sequential(ws):
        h = xs
        for i in range(N):
            h = stage(ws[i], h)
        return mse(h, tgt)

    ref["pp.seq_loss"] = float(jax.jit(sequential)(ws))
    ref["pp.dws"] = np.asarray(jax.jit(jax.grad(sequential))(ws))

    # fsdp: the JAX package's ZeRO-3 step over dp = 4
    mesh = create_mesh({"dp": 4}, devices=jax.devices()[:4])
    opt = optax.sgd(LR, momentum=0.9)
    make = fsdp_train_step(lambda p, b: T.lm_loss(p, b, _jcfg(),
                                                  use_constraints=False),
                           opt, mesh, axis="dp", min_shard_elems=MIN_SHARD,
                           batch_spec=P("dp", None))
    fp, fs, fstep = make(params, opt.init(params))
    ref["fsdp.specs"] = {k: next((j for j, a in enumerate(
        fp_k.sharding.spec) if a == "dp"), None)
        for k, fp_k in _flat_leaves(fp).items()}
    ref["fsdp.steps"] = []
    for _ in range(FSDP_STEPS):
        fp, fs, loss = fstep(fp, fs, toks)
        ref["fsdp.steps"].append((float(loss), _flat(fp)))

    # dp: the JAX package's data-parallel step over dp = 4
    mesh = create_mesh({"dp": 4}, devices=jax.devices()[:4])

    def dp_step(w, _, batch):
        xb, yb = batch
        g = jax.grad(lambda w: jnp.mean((xb @ w - yb) ** 2))(w)
        return w - LR * jax.lax.pmean(g, "dp")

    f = data_parallel_step(dp_step, mesh=mesh, axis_name="dp",
                           donate_argnums=())
    w = jnp.asarray(inp["dp.w"])
    for s in range(2):
        w = f(w, 0, (jnp.asarray(inp["dp.x"][s]), jnp.asarray(inp["dp.y"][s])))
    ref["dp.w"] = np.asarray(w)
    return ref


def _flat_leaves(tree) -> dict:
    out = {"embed": tree["embed"], "pos": tree["pos"],
           "ln_f.scale": tree["ln_f"]["scale"]}
    for i, b in enumerate(tree["blocks"]):
        for k in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[f"blocks.{i}.{k}"] = b[k]
        for k in ("ln1", "ln2"):
            out[f"blocks.{i}.{k}.scale"] = b[k]["scale"]
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Each rank's results and the JAX references, computed while the job
    runs."""
    tmp = tmp_path_factory.mktemp("parallel_jobs")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    script = tmp / "parallel_cases.py"
    script.write_text(
        f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.{}.npz')!r}\n"
        f"CFG = {CFG!r}\nLM_BATCH, LR, FSDP_STEPS, MIN_SHARD = "
        f"{LM_BATCH}, {LR}, {FSDP_STEPS}, {MIN_SHARD}\nMOE = {MOE!r}\n"
        + textwrap.dedent(JOB))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-m", "horovod_tpu_torch.runner",
                          "-np", str(N), sys.executable, str(script)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        ref = _references(inp)
        out = p.communicate(timeout=240)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        raise AssertionError(f"the job timed out:\n{p.communicate()[0]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    assert p.returncode == 0, f"the job failed:\n{out}"
    res = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(N)]
    return inp, res, ref


def _close(got, want, tol=LM_TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_tp_mlp_forward_and_dense_gradients(job):
    _, res, ref = job
    dx, dw1, dw2 = ref["mlp.grads"]
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["mlp.y"], ref["mlp.y"], **TOL)
        _close(out["mlp.dx"], dx, 1e-6, f"rank {r} dx")
        _close(out["mlp.dw1"], _slice(dw1, 1, r, N), 1e-6, f"rank {r} dw1")
        _close(out["mlp.dw2"], _slice(dw2, 0, r, N), 1e-6, f"rank {r} dw2")
        # one sum forward (the row layer), one backward (the column input)
        assert out["mlp.exchanges"][1] == 2  # sorted keys: all_reduce second


def test_lm_dp2_tp2_against_the_dense_model(job):
    _, res, ref = job
    for r, out in enumerate(res):
        dp, tp = divmod(r, 2)
        np.testing.assert_allclose(float(out["lm.loss"]), ref["lm.losses"][dp],
                                   rtol=1e-5)
        assert list(out["lm.set"]) == [tp, tp + 2]
        for k, want in ref["lm.grads"].items():
            dim = _tp_dim(k)
            _close(out["lm.grad." + k], _slice(want, dim, tp, 2),
                   what=f"rank {r} {k}")
            _close(out["lm.after." + k],
                   _slice(ref["lm.after"][k], dim, tp, 2),
                   what=f"rank {r} {k} after the step")


def test_tp_model_draws_its_slice_of_the_dense_model(job):
    """A tp rank's random weights are its slices of the dense model drawn
    from the same seed."""
    for out in job[1]:
        assert out["lm.drawn_slices"].all()


def test_lm_replicated_leaves_bitwise_across_ranks(job):
    _, res, _ = job
    for k in ("embed", "pos", "ln_f.scale", "blocks.0.ln1.scale"):
        for out in res[1:]:
            np.testing.assert_array_equal(out["lm.after." + k],
                                          res[0]["lm.after." + k])


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ep4_against_jax(job, k):
    _, res, ref = job
    y, aux, dx, dgate, dw = ref[f"moe.{k}"]
    t, e = MOE["t_local"], MOE["experts"] // N
    for r, out in enumerate(res):
        p = f"moe.{k}."
        np.testing.assert_allclose(out[p + "y"], y[r * t:(r + 1) * t], **TOL)
        np.testing.assert_allclose(float(out[p + "aux"]), float(aux[r]),
                                   rtol=1e-6)
        _close(out[p + "dx"], dx[r * t:(r + 1) * t], 1e-5, f"rank {r} dx")
        _close(out[p + "dgate"], dgate[r], 1e-5, f"rank {r} dgate")
        _close(out[p + "dw"], dw[r * e:(r + 1) * e], 1e-5, f"rank {r} dw")


def test_pipeline_pp4_against_jax(job):
    _, res, ref = job
    for r, out in enumerate(res):
        want = ref["pp.out"] if r == N - 1 else np.zeros_like(ref["pp.out"])
        np.testing.assert_allclose(out["pp.out"], want, **TOL)
        for remat in (False, True):
            np.testing.assert_allclose(float(out[f"pp.{remat}.loss"]),
                                       ref["pp.loss"], rtol=1e-6)
            _close(out[f"pp.{remat}.dw"], ref["pp.dws"][r], 1e-5,
                   f"stage {r}")
        # remat changes memory, not a bit of the gradients
        np.testing.assert_array_equal(out["pp.True.dw"], out["pp.False.dw"])
    np.testing.assert_allclose(ref["pp.loss"], ref["pp.seq_loss"], rtol=1e-6)


def test_pipeline_exchanges_every_tick_both_ways(job):
    """(n_micro + n - 1) shifts forward and as many backward a run, two
    runs, one sum of the loss a run: on every rank alike."""
    _, res, _ = job
    ticks = PP["n_micro"] + N - 1
    for out in res:
        counts = dict(zip(("all_gather", "all_reduce", "all_to_all",
                           "ppermute", "reduce_scatter"),
                          out["pp.exchanges"]))
        assert counts == {"all_gather": 0, "all_reduce": 2, "all_to_all": 0,
                          "ppermute": 2 * 2 * ticks, "reduce_scatter": 0}


@pytest.mark.parametrize("step", range(FSDP_STEPS))
def test_fsdp_against_jax(job, step):
    _, res, ref = job
    loss, params = ref["fsdp.steps"][step]
    for r, out in enumerate(res):
        np.testing.assert_allclose(float(out[f"fsdp.{step}.loss"]), loss,
                                   rtol=1e-5)
        for k, want in params.items():
            _close(out[f"fsdp.{step}.{k}"], want, what=f"rank {r} {k}")


def test_fsdp_shards_as_jax_does(job):
    _, res, ref = job
    for out in res:
        got = {k[len("fsdp.spec."):]: (None if int(v) < 0 else int(v))
               for k, v in out.items() if k.startswith("fsdp.spec.")}
        assert got == ref["fsdp.specs"]
    # every rank holds a quarter of each sharded leaf, and its momentum
    sizes = {k: np.prod(v.shape) for k, v in _flat(_lm_tree(job[0])).items()}
    sharded = sum(sizes[k] for k, d in ref["fsdp.specs"].items()
                  if d is not None)
    assert int(res[0]["fsdp.shard_bytes"]) == sharded * 4 // N
    want = sorted([sizes[k] // N if d is not None else sizes[k]
                   for k, d in ref["fsdp.specs"].items()])
    assert list(res[0]["fsdp.momentum_shapes"]) == want


def test_hierarchical_mesh_nested_sum_equals_flat(job):
    """The dcn axes come first, as in the JAX package's
    ``create_hierarchical_mesh`` (its layout against the JAX mesh's is
    ``tests/test_torch_port_parallel.py``'s): rank r is host r // 2's GPU
    r % 2. A sum over the ici lines then the dcn lines equals the
    world's."""
    for r, out in enumerate(job[1]):
        dcn, ici = divmod(r, 2)
        assert list(out["hier.coords"]) == [dcn, ici]
        assert out["hier.sets"].tolist() == [[2 * dcn, 2 * dcn + 1],
                                             [ici, ici + 2]]
        assert out["hier.equal"]


def test_data_parallel_step_against_jax(job):
    _, res, ref = job
    for out in res:
        np.testing.assert_allclose(out["dp.w"], ref["dp.w"], **TOL)
