"""Parity of the port's parallelism strategies with the JAX package's, in
one process on the CPU (the exchanges across processes are
``tests/test_torch_port_parallel_jobs.py``'s):

- ``parse_mesh_spec``, and the mesh's rank layout and axis groups against
  ``jax.sharding.Mesh.devices`` for the same spec (row-major, the rightmost
  axis fastest); the mesh at a world of one;
- ``top1_gating`` and ``topk_gating`` against JAX on the same fp32 logits
  (ties included): dispatch bitwise, combine and aux within fp32 rounding;
  so is the chip's plain router (``parallel_probe.plain_gating``), and the
  chip's routing check fails on a dropped slot;
- ``fsdp_specs`` and ``opt_state_specs`` against the JAX ``PartitionSpec``
  dims for the LM's leaves and optax's / torch's optimizer state;
- ``params_from_jax``'s tp slices against the JAX ``param_specs``; the
  tp-aware LM at tp 1 bitwise the dense formula it replaced;
- each strategy at a group of one: ``moe_layer`` against the JAX layer
  and the plain loop over experts, ``pipeline_loss`` against the
  sequential model and the JAX function, ``fsdp_train_step`` bitwise plain
  training, ``data_parallel_step`` on the global set.

fp32 throughout; ``TOL`` covers summation order only.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as T
from horovod_tpu.parallel import fsdp as jfsdp
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import moe as jmoe
from horovod_tpu.parallel import pp as jpp
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.parallel import (create_hierarchical_mesh, create_mesh,
                                        data_parallel_step, fsdp_specs,
                                        fsdp_train_step, moe_layer,
                                        opt_state_specs, pipeline_apply,
                                        pipeline_loss, shard_batch)
from horovod_tpu_torch.parallel import mesh as pmesh
from horovod_tpu_torch.parallel import moe as pmoe
from horovod_tpu_torch.parallel import tp as ptp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import parallel_probe as probe  # noqa: E402

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16)
TOL = dict(rtol=1e-5, atol=1e-6)  # fp32, another summation order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _jmesh(spec):
    axes = jmesh.parse_mesh_spec(spec)
    n = int(np.prod(list(axes.values())))
    return jmesh.create_mesh(axes, devices=jax.devices()[:n])


def _ids(devices):
    return np.vectorize(lambda d: d.id)(devices)


# --- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("spec", ["dp=4,tp=2", " dp = 2 , pp=2,tp=2,", "ep=8",
                                  "fsdp=2,sp=4", ""])
def test_parse_mesh_spec_against_jax(spec):
    assert pmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["dp=8", "dp=2,tp=4", "dp=2,pp=2,tp=2",
                                  "pp=4,ep=2", "dp=1,tp=8"])
def test_rank_layout_against_jax_mesh(spec):
    """Rank at each coordinate, and the ranks along each axis, as the JAX
    mesh lays its devices out (device i is rank i)."""
    jm = _jmesh(spec)
    shape = tuple(jm.devices.shape)
    grid = pmesh.rank_grid(shape)
    np.testing.assert_array_equal(grid, _ids(jm.devices))
    for k in range(len(shape)):
        want = np.moveaxis(_ids(jm.devices), k, -1).reshape(-1, shape[k])
        assert pmesh.axis_groups(grid, k) == want.tolist()


def test_hierarchical_layout_against_jax():
    jm = jmesh.create_hierarchical_mesh({"dp_ici": 4}, {"dp_dcn": 2})
    assert jm.axis_names == ("dp_dcn", "dp_ici")
    np.testing.assert_array_equal(pmesh.rank_grid((2, 4)), _ids(jm.devices))


def test_mesh_at_a_world_of_one(port):
    mesh = create_mesh({"dp": 1, "tp": 1})
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.coords == {"dp": 0, "tp": 0}
    for axis in ("dp", "tp"):
        assert mesh.process_set(axis) is hvd.global_process_set()
        assert mesh.group(axis) is hvd.global_process_set().group
    assert create_mesh().shape == {"dp": 1}
    assert create_mesh("pp=1").axis_names == ("pp",)
    h = create_hierarchical_mesh({"dp_ici": 1}, {"dp_dcn": 1})
    assert h.axis_names == ("dp_dcn", "dp_ici")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        create_mesh({"dp": 2})


# --- MoE gating --------------------------------------------------------------

GATING = [(16, 4, 4), (32, 8, 3), (24, 4, 8), (12, 4, 1), (40, 8, 2)]


def _logits(t, e, seed, ties):
    x = np.random.RandomState(seed).randn(t, e).astype(np.float32)
    return np.round(x) if ties else x  # rounded: many exact ties


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,e,cap", GATING)
@pytest.mark.parametrize("k", [1, 2])
def test_gating_against_jax(k, t, e, cap, ties):
    logits = _logits(t, e, t + e + cap, ties)
    if k == 1:
        want = jmoe.top1_gating(jnp.asarray(logits), e, cap)
        got = pmoe.top1_gating(torch.from_numpy(logits), e, cap)
    else:
        want = jmoe.topk_gating(jnp.asarray(logits), e, cap, k=k)
        got = pmoe.topk_gating(torch.from_numpy(logits), e, cap, k=k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,e,cap", GATING)
@pytest.mark.parametrize("k", [1, 2])
def test_plain_router_against_jax(k, t, e, cap, ties):
    """The chip's reference router (``parallel_probe.plain_gating``, a
    token-by-token loop written apart from the layer) routes as JAX does:
    dispatch bitwise, combine and aux within fp32 rounding."""
    logits = _logits(t, e, t + e + cap, ties)
    if k == 1:
        want = jmoe.top1_gating(jnp.asarray(logits), e, cap)
    else:
        want = jmoe.topk_gating(jnp.asarray(logits), e, cap, k=k)
    slots, gates, aux = probe.plain_gating(torch.from_numpy(logits), e, cap,
                                           k)
    np.testing.assert_array_equal(
        probe.dispatch_of(slots, t, e, cap, "cpu").numpy(),
        np.asarray(want[0]))
    tok, exp, pos = (list(c) for c in zip(*slots))
    np.testing.assert_allclose(gates.numpy(),
                               np.asarray(want[1])[tok, exp, pos], **TOL)
    np.testing.assert_allclose(float(aux), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_check_routing_catches_a_dropped_slot(monkeypatch, k):
    """The chip's routing check fails when the layer's router keeps one
    slot fewer than the plain router."""
    m = dict(d=8, d_ff=16, experts=4, k=k, factor=1.25, tokens=16)
    gate, _, _ = probe.moe_weights(m, torch.device("cpu"), 0)
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    probe.check_routing(x, gate, m)
    name = "top1_gating" if k == 1 else "topk_gating"
    real = getattr(pmoe, name)

    def drop_one(*a, **kw):
        dispatch, combine, aux = real(*a, **kw)
        dispatch = dispatch.clone()
        dispatch.view(-1)[dispatch.view(-1).nonzero()[-1]] = 0.0
        return dispatch, combine, aux

    monkeypatch.setattr(pmoe, name, drop_one)
    with pytest.raises(AssertionError, match="dispatch differs"):
        probe.check_routing(x, gate, m)


def test_topk_without_normalize_against_jax():
    logits = _logits(20, 4, 5, False)
    want = jmoe.topk_gating(jnp.asarray(logits), 4, 6, k=3, normalize=False)
    got = pmoe.topk_gating(torch.from_numpy(logits), 4, 6, k=3,
                           normalize=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


def _moe_inputs(seed=0, t=16, d=8, e=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(t, d).astype(np.float32),
            rs.randn(d, e).astype(np.float32),
            (0.3 * rs.randn(e, d, d)).astype(np.float32),
            rs.randn(t, d).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_at_a_group_of_one_against_jax(port, k):
    """Output, aux and gradients against the JAX layer under a 1-device
    ``shard_map``."""
    x, gate_w, w, co = _moe_inputs()
    mesh = Mesh(np.array(jax.devices()[:1], dtype=object), ("ep",))

    def jloss(x, gate_w, w):
        y, aux = jmoe.moe_layer(x, gate_w, lambda p, xe: jnp.tanh(xe @ p), w,
                                axis_name="ep", capacity_factor=1.0, k=k)
        return jnp.sum(y * co) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.shard_map(
        jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
        check_vma=False))(x, gate_w, w)
    xs, gs, ws = (torch.from_numpy(a).requires_grad_() for a in (x, gate_w, w))
    y, aux = moe_layer(xs, gs, lambda p, xe: torch.tanh(xe @ p), ws,
                       group=hvd.global_process_set().group,
                       capacity_factor=1.0, k=k)
    ((y * torch.from_numpy(co)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    for got, want in zip((xs.grad, gs.grad, ws.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_moe_layer_against_the_plain_loop(port):
    """The chip's reference for the layer: the plain loop over experts."""
    m = dict(d=8, d_ff=16, experts=4, k=2, factor=1.25, tokens=16)
    gate, w1, w2 = probe.moe_weights(m, torch.device("cpu"), 0)
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    y, aux = moe_layer(x, gate, probe.expert_mlp, (w1, w2),
                       capacity_factor=m["factor"], k=m["k"])
    y_p, aux_p = probe.plain_moe(x, gate, w1, w2, m)
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), **TOL)
    assert float(aux) == float(aux_p)


@pytest.mark.parametrize("t,e,factor", [(16, 4, 1.25), (1, 8, 1.25),
                                         (2048, 8, 1.25), (8, 8, 2.0),
                                         (10, 3, 0.5)])
def test_capacity_as_the_jax_layer_computes_it(t, e, factor):
    assert pmoe.capacity_for(t, e, factor) == max(1, int(factor * t / e))


# --- FSDP specs --------------------------------------------------------------

def _jax_lm(cfg=None):
    cfg = cfg or T.TransformerConfig(**CFG, dtype=jnp.float32)
    return cfg, T.init(jax.random.PRNGKey(0), cfg)


def _flat(tree) -> dict:
    out = {"embed": tree["embed"], "pos": tree["pos"],
           "ln_f.scale": tree["ln_f"]["scale"]}
    for i, b in enumerate(tree["blocks"]):
        for k in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[f"blocks.{i}.{k}"] = b[k]
        for k in ("ln1", "ln2"):
            out[f"blocks.{i}.{k}.scale"] = b[k]["scale"]
    return out


def _dim(spec, axis):
    return next((j for j, a in enumerate(spec) if a == axis), None)


@pytest.mark.parametrize("axis_size,min_elems", [(4, 256), (8, 256),
                                                 (None, 64), (2, 2 ** 14)])
def test_fsdp_specs_against_jax(axis_size, min_elems):
    _, params = _jax_lm()
    want = _flat(jfsdp.fsdp_specs(params, "dp", min_elems, axis_size))
    model = PT.TransformerLM(PT.TransformerConfig(**CFG, dtype=torch.float32),
                             device="cpu")
    got = fsdp_specs(model.named_parameters(), min_elems, axis_size)
    assert got == {k: _dim(s, "dp") for k, s in want.items()}


def test_fsdp_specs_of_the_jax_example():
    shapes = {"w": (256, 128), "scale": (128,), "odd": (130, 3)}
    ts = {k: torch.zeros(s) for k, s in shapes.items()}
    js = {k: jnp.zeros(s) for k, s in shapes.items()}
    for kw in (dict(min_shard_elems=1024, axis_size=8),
               dict(min_shard_elems=64)):
        want = jfsdp.fsdp_specs(js, "dp", **kw)
        assert fsdp_specs(ts, **kw) == {k: _dim(s, "dp")
                                        for k, s in want.items()}


def test_opt_state_specs_against_jax():
    """Adam's moments follow their parameters' dims, its counters
    replicate: optax's state and torch's ``state_dict`` alike."""
    import optax

    _, params = _jax_lm()
    pspecs = jfsdp.fsdp_specs(params, "dp", 256, 4)
    opt_state = optax.adam(1e-3).init(params)
    want = jfsdp.opt_state_specs(opt_state, params, pspecs)
    mu = _flat(want[0].mu)

    model = PT.TransformerLM(PT.TransformerConfig(**CFG, dtype=torch.float32),
                             device="cpu")
    named = dict(model.named_parameters())
    opt = torch.optim.Adam(named.values(), lr=1e-3)
    sum(p.sum() for p in named.values()).backward()
    opt.step()
    got = opt_state_specs(opt.state_dict()["state"], named,
                          fsdp_specs(named, 256, 4))
    for i, name in enumerate(named):
        st = got[i]
        assert st["exp_avg"] == st["exp_avg_sq"] == _dim(mu[name], "dp")
        assert st["step"] is None and _dim(want[0].count, "dp") is None


# --- the LM under tensor parallelism -----------------------------------------

def test_param_specs_against_jax():
    cfg, _ = _jax_lm()
    want = _flat(T.param_specs(cfg))
    got = PT.param_specs(PT.TransformerConfig(**CFG))
    assert got == {k: _dim(s, cfg.tp_axis) for k, s in want.items()}


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_params_from_jax_tp_slices(tp):
    """Each rank's ``state_dict`` is its slice, on the ``param_specs``
    dim, of the JAX leaves; the slices laid end to end are the leaf."""
    cfg, params = _jax_lm()
    params = jax.tree_util.tree_map(np.asarray, params)
    dims = {k: _dim(s, "tp") for k, s in _flat(T.param_specs(cfg)).items()}
    whole = {k: np.asarray(v) for k, v in _flat(params).items()}
    shards = [PT.params_from_jax(params, r, tp) for r in range(tp)]
    for k, leaf in whole.items():
        if dims[k] is None:
            for sd in shards:
                np.testing.assert_array_equal(sd[k].numpy(), leaf)
        else:
            np.testing.assert_array_equal(np.concatenate(
                [sd[k].numpy() for sd in shards], axis=dims[k]), leaf)


def _former_block(blk, x, dtype, attn_fn):
    """The dense block's arithmetic before tensor parallelism, verbatim."""
    h = PT._rmsnorm(x, blk.ln1.scale)
    q = torch.einsum("bsd,dhk->bshk", h, blk.wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", h, blk.wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", h, blk.wv.to(dtype))
    o = attn_fn(q, k, v)
    x = x + torch.einsum("bshk,hkd->bsd", o, blk.wo.to(dtype))
    h = PT._rmsnorm(x, blk.ln2.scale)
    ff = F.gelu(torch.einsum("bsd,df->bsf", h, blk.w1.to(dtype)),
                approximate="tanh")
    return x + torch.einsum("bsf,fd->bsd", ff, blk.w2.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_at_tp_one_bitwise_the_dense_block(port, dtype):
    """At tp 1 (no group, or a world of one's) the tp-aware block is the
    dense one bit for bit, forward and backward, and the draw from the
    seed is unchanged."""
    cfg = PT.TransformerConfig(**CFG, dtype=dtype)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, 64, (2, 17)))
    results = []
    for group in (None, hvd.global_process_set().group, "former"):
        model = PT.TransformerLM(cfg, device="cpu", seed=5,
                                 tp_group=None if group == "former" else group)
        if group == "former":
            for blk in model.blocks:
                blk.forward = (lambda b: lambda x, dt, fn:
                               _former_block(b, x, dt, fn))(blk)
        loss = PT.lm_loss(model, tokens)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in
                                      model.named_parameters()},
                        {n: p.detach().clone() for n, p in
                         model.named_parameters()}))
    for loss, grads, params in results[1:]:
        assert loss == results[0][0]
        for n in grads:
            assert torch.equal(grads[n], results[0][1][n]), n
            assert torch.equal(params[n], results[0][2][n]), n


def test_tp_blocks_at_a_group_of_one(port):
    rs = np.random.RandomState(4)
    x, w1, w2 = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                 for s in ((3, 8), (8, 16), (16, 8)))
    want = F.gelu(x @ w1, approximate="tanh") @ w2
    for group in (None, hvd.global_process_set().group):
        np.testing.assert_allclose(ptp.parallel_mlp(x, w1, w2, group).numpy(),
                                   want.numpy(), **TOL)
        assert torch.equal(ptp.shard_leading(x, group), x)
    o = torch.randn(2, 3, 4, 5)
    wo = torch.randn(4, 5, 6)
    np.testing.assert_allclose(
        ptp.parallel_attention_output(o, wo).numpy(),
        torch.einsum("bshk,hkd->bsd", o, wo).numpy(), **TOL)
    b = torch.randn(16)
    np.testing.assert_allclose(
        ptp.column_parallel_dense(x, w1, b).numpy(), (x @ w1 + b).numpy(),
        **TOL)


@pytest.mark.parametrize("fn", ["mlp", "moe", "pipeline"])
def test_runtime_group_is_refused(port, fn):
    rg = hvd.global_process_set().runtime_group
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="runtime_group"):
        if fn == "mlp":
            ptp.parallel_mlp(x, torch.zeros(8, 8), torch.zeros(8, 8), rg)
        elif fn == "moe":
            moe_layer(x, torch.zeros(8, 4), lambda p, xe: xe,
                      torch.zeros(4, 1), group=rg)
        else:
            pipeline_apply(lambda w, h: h, None, x[None], group=rg)


# --- the pipeline ------------------------------------------------------------

def _pp_inputs(seed=1, d=8, n_micro=4, mb=3):
    rs = np.random.RandomState(seed)
    return ((0.5 * rs.randn(d, d)).astype(np.float32),
            rs.randn(n_micro, mb, d).astype(np.float32),
            rs.randn(n_micro, mb, d).astype(np.float32))


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_at_one_stage_is_the_sequential_model(port, remat):
    """One stage: the outputs and the loss equal the stage on each
    microbatch in turn, bit for bit, and JAX's ``pipeline_loss`` on one
    device; the gradients are the sequential model's."""
    w, xs, tgt = _pp_inputs()

    def stage(w, h):
        return torch.tanh(h @ w)

    def mse(o, t):
        return ((o - t) ** 2).mean()

    wt = torch.from_numpy(w).requires_grad_()
    out = pipeline_apply(stage, wt, torch.from_numpy(xs))
    seq = torch.stack([stage(wt, torch.from_numpy(x)) for x in xs])
    assert torch.equal(out, seq)
    loss = pipeline_loss(stage, mse, wt, torch.from_numpy(xs),
                         torch.from_numpy(tgt),
                         group=hvd.global_process_set().group,
                         remat_stage=remat)
    loss.backward()
    g = wt.grad.clone()
    wt.grad = None
    mse(seq, torch.from_numpy(tgt)).backward()
    assert loss.item() == mse(seq, torch.from_numpy(tgt)).item()
    np.testing.assert_allclose(g.numpy(), wt.grad.numpy(), **TOL)

    mesh = Mesh(np.array(jax.devices()[:1], dtype=object), ("pp",))
    jl = jax.jit(jax.shard_map(
        lambda w, xs, t: jpp.pipeline_loss(
            lambda w, h: jnp.tanh(h @ w),
            lambda o, t: jnp.mean((o - t) ** 2), w, xs, t,
            axis_name="pp", remat_stage=remat),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
        check_vma=False))(w, xs, tgt)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)


def test_pipeline_keeps_the_microbatch_shape(port):
    with pytest.raises(ValueError, match="preserve the microbatch shape"):
        pipeline_apply(lambda w, h: h[..., :2], None, torch.zeros(2, 3, 4))


# --- FSDP and the data-parallel step at a world of one ----------------------

def test_fsdp_at_a_world_of_one_is_plain_training(port):
    """A group of one: the shards are the leaves, the gathers and
    reduce-scatters copies, and three steps bitwise plain SGD with
    momentum."""
    cfg = PT.TransformerConfig(**CFG, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, 64, (2, 17)))
    mesh = create_mesh({"dp": 1})
    model = PT.TransformerLM(cfg, device="cpu", seed=1)
    make = fsdp_train_step(lambda m, t: PT.lm_loss(m, t),
                           lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                      momentum=0.9),
                           mesh, min_shard_elems=256)
    state, step = make(model)
    assert all(p.numel() == 0 for k, p in state.params.items()
               if k in state.shards)
    ref = PT.TransformerLM(cfg, device="cpu", seed=1)
    opt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)
    for _ in range(3):
        loss = step(tokens)
        opt.zero_grad()
        want = PT.lm_loss(ref, tokens)
        want.backward()
        opt.step()
        assert loss.item() == want.item()
    full = state.full_state_dict()
    for k, p in ref.named_parameters():
        assert torch.equal(full[k], p.detach()), k
    held = state.bytes_a_rank()
    total = sum(p.numel() * 4 for p in ref.parameters())
    assert held == {"params": total, "optimizer_state": total}


def test_data_parallel_step_at_a_world_of_one(port):
    seen = []

    def step_fn(a, b, batch):
        seen.append(batch)
        return a + b

    mesh = create_mesh({"dp": 1, "tp": 1})
    step = data_parallel_step(step_fn, mesh=mesh, axis_name="dp")
    assert step.process_set is hvd.global_process_set()
    assert step(1, 2, {"x": np.ones((2, 3), np.float32)}) == 3
    assert isinstance(seen[0]["x"], torch.Tensor)
    assert data_parallel_step(step_fn).process_set is \
        hvd.global_process_set()
    with pytest.raises(ValueError, match="not one of the mesh's"):
        data_parallel_step(step_fn, mesh=mesh, axis_name="ep")
    with pytest.raises(ValueError, match="pass mesh="):
        shard_batch(np.zeros(2), axis_name="dp")
    out = shard_batch((np.zeros(2), [torch.ones(1)]), mesh, "dp")
    assert isinstance(out, tuple) and torch.is_tensor(out[0])
