"""The port's async sharded checkpointer against the JAX package's, on the
CPU:

- ``read_manifest`` picks the same newest consistent set in both
  packages on one directory: complete, with a rank missing, with a stale
  generation beside a newer incomplete one; both refuse a checksum
  mismatch;
- N→M: a directory the JAX package wrote from its simulated ZeRO-1
  engines (optax ``sgd(momentum=0.9)`` and ``adam``, 4 and 2 ranks) loads
  into 3 of the port's engines, whose gathered state is bitwise the JAX
  package's ``assemble_full_state`` (the state carried across a resize);
- the port's own snapshots (fp32 and bf16 parameters): restored into a
  fresh world of the same size and of another, bitwise the saved engines'
  state, and the JAX package's ``assemble_full_state`` reads the port's
  directory to the same arrays as the port's;
- the queue: depth 1, newest wins, flush under a deadline, a transient
  ``ckpt.write`` fault retried by the flush, and no checkpointer (nor any
  ``hvd_ckpt_*`` series) unless ``HOROVOD_ASYNC_CKPT`` is set.
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.opt import sharded as jsharded
from horovod_tpu.utils import async_ckpt as jckpt
from horovod_tpu.utils import faults as jfaults
from horovod_tpu_torch.opt import sharded as psharded
from horovod_tpu_torch.utils import async_ckpt as pckpt
from horovod_tpu_torch.utils import faults as pfaults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HOROVOD_ELASTIC_GEN", "HOROVOD_FAULT_SPEC",
              "HOROVOD_SHARDED_MIN_ELEMS", "HOROVOD_ASYNC_CKPT"):
        monkeypatch.delenv(k, raising=False)
    pfaults.reset()
    jfaults.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    pfaults.reset()
    jfaults.reset()


def _tree(dtype=np.float32):
    """A JAX pytree with shardable and replicated leaves (the sharded
    tests' shape)."""
    r = np.random.RandomState(0)
    tree = {"w1": r.randn(256, 256), "b1": r.randn(256),
            "w2": r.randn(64, 64), "big": r.randn(16384),
            "scale": np.asarray(1.5)}
    return {k: np.asarray(v, np.float32).astype(dtype) for k, v in tree.items()}


def _torch_leaves(tree):
    out = []
    for x in jax.tree.leaves(tree):
        if x.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(x.view(np.uint16).copy())
                       .view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(x)))
    return out


def _grads(leaves, world, step):
    return [[torch.from_numpy(np.random.RandomState(97 * step + r)
                              .standard_normal(tuple(p.shape))
                              .astype(np.float32)).to(p.dtype)
             for p in leaves] for r in range(world)]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


def _flat(tree, path=()):
    """(path, leaf) pairs in a canonical order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str)
                for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.shape(x) == np.shape(y), p
            assert np.array_equal(_bits(np.asarray(x, np.asarray(y).dtype)),
                                  _bits(y)), p
        else:
            assert x == y, p


# --- the manifest choice -------------------------------------------------------

def _manifest(d, rank, world, step, gen, digest="d", checksum="0"):
    with open(os.path.join(d, f"manifest_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world, "step": step,
                   "generation": gen, "layout_digest": digest,
                   "checksum": checksum, "bytes": 1, "ts": 0.0}, f)


def _shard_files(d, world, step, gen):
    for r in range(world):
        path = os.path.join(d, f"shard_rank{r}.ckpt")
        from horovod_tpu_torch.utils import checkpoint

        checkpoint.save_pytree(path, {"rank": r, "world": world,
                                      "step": step, "generation": gen,
                                      "layout_digest": "d",
                                      "shard_state": {"m": np.arange(4) + r},
                                      "replicated": None})
        _manifest(d, r, world, step, gen, checksum=pckpt._sha1_file(path))


@pytest.mark.parametrize("case", ["complete", "rank_missing",
                                  "stale_generation", "newer_world_partial",
                                  "garbage_manifest", "none"])
def test_read_manifest_picks_the_same_set(tmp_path, case):
    d = str(tmp_path)
    if case != "none":
        _shard_files(d, 3, 5, 0)
    if case == "rank_missing":
        os.remove(os.path.join(d, "manifest_rank1.json"))
    elif case == "stale_generation":
        # a world of 2 under generation 1 wrote over ranks 0 and 1: rank
        # 2's manifest is the dead generation's
        _shard_files(d, 2, 6, 1)
    elif case == "newer_world_partial":
        _manifest(d, 3, 4, 9, 2)
    elif case == "garbage_manifest":
        with open(os.path.join(d, "manifest_rank2.json"), "w") as f:
            f.write("{half")
    got, want = pckpt.read_manifest(d), jckpt.read_manifest(d)
    assert got == want
    if case in ("complete", "newer_world_partial"):
        assert (got["step"], got["generation"], got["world"]) == (5, 0, 3)
    elif case == "stale_generation":
        assert (got["step"], got["generation"], got["world"]) == (6, 1, 2)
    else:
        assert got is None
    if got is not None:
        (pm, pp), (jm, jp) = pckpt.load_shards(d), jckpt.load_shards(d)
        assert pm == jm
        _assert_same_tree(pp, jp)


def test_both_refuse_a_checksum_mismatch(tmp_path):
    d = str(tmp_path)
    _shard_files(d, 2, 3, 0)
    path = os.path.join(d, "shard_rank1.ckpt")
    with open(path, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"\x00\x01\x02")
    for mod in (pckpt, jckpt):
        with pytest.raises(mod.CheckpointError, match="checksum"):
            mod.load_shards(d)
        assert mod.load_own_shard(d, 0) is None


# --- N -> M from a directory the JAX package wrote ---------------------------

OPTAX = {"sgd": lambda: optax.sgd(1e-2, momentum=0.9),
         "adam": lambda: optax.adam(1e-3)}
TORCH = {"sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9),
         "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3)}


def _jax_writes(d, opt_name, world):
    opt = OPTAX[opt_name]()
    params = _tree()
    engines = jsharded.make_simulated_engines(opt, world)
    states = [e.init(params) for e in engines]
    sp = params
    leaves = _torch_leaves(params)
    for step in range(2):
        gs = [[np.asarray(g) for g in rank]
              for rank in _grads(leaves, world, step)]
        tg = [jax.tree.unflatten(jax.tree.structure(params), g) for g in gs]
        sp, states = jsharded.simulated_step(engines, sp, tg, states)
    ckpts = [jckpt.AsyncCheckpointer(rank=r, world=world, directory=d)
             for r in range(world)]
    try:
        for r, c in enumerate(ckpts):
            assert c.snapshot(2, states[r],
                              replicated={"params": sp} if r == 0 else None,
                              layout=engines[r].layout)
            assert c.flush(deadline_s=30.0)
    finally:
        for c in ckpts:
            c.stop()
    return sp


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("w_from", [4, 2])
def test_n_to_m_restore_of_a_jax_directory(tmp_path, monkeypatch, opt_name,
                                           w_from):
    d = str(tmp_path)
    sp = _jax_writes(d, opt_name, w_from)
    manifest, payloads = jckpt.load_shards(d)
    jfull = jckpt.assemble_full_state(manifest, payloads, sp)
    leaves = _torch_leaves(sp)
    # the port assembles the same tree from the same files
    pm, pp = pckpt.load_shards(d)
    _assert_same_tree(pckpt.assemble_full_state(pm, pp, leaves), jfull)
    # a new generation, a world of 3
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "1")
    engines = psharded.make_simulated_engines(TORCH[opt_name], 3)
    rep_params = None
    for e in engines:
        m, opt, replicated = pckpt.restore_sharded(d, leaves, e)
        assert m["world"] == w_from and m["step"] == 2
        assert opt is e.optimizer
        if replicated is not None:
            rep_params = replicated["params"]
    for a, b in zip(jax.tree.leaves(rep_params), jax.tree.leaves(sp)):
        assert np.array_equal(_bits(a), _bits(b))
    full = psharded.simulated_full_state(engines)
    lay = engines[0].layout
    assert lay.world_size == 3 and lay.generation == 1
    nrep = len(lay.replicated)
    inner = jfull[0]
    names = ({"trace": "momentum_buffer"} if opt_name == "sgd"
             else {"mu": "exp_avg", "nu": "exp_avg_sq"})
    for field, tname in names.items():
        tree = getattr(inner, field)
        for n, i in enumerate(lay.replicated):
            want = tree["rep"][f"{i:05d}"]
            got = full["state"][n][tname].numpy()
            assert np.array_equal(_bits(got), _bits(want)), (field, i)
        for n, g in enumerate(lay.groups):
            want = tree["shard"][g.dtype]
            got = full["state"][nrep + n][tname].numpy()
            assert got.shape == (g.total,)
            assert np.array_equal(_bits(got), _bits(want)), (field, g.dtype)
    if opt_name == "adam":
        assert all(float(st["step"]) == float(inner.count)
                   for st in full["state"].values())


# --- the port's own snapshots ---------------------------------------------------

SGD = TORCH["sgd"]


def _port_world(dtype, world):
    leaves = _torch_leaves(_tree(dtype))
    engines = psharded.make_simulated_engines(SGD, world)
    for e in engines:
        e.init(leaves)
    for step in range(2):
        psharded.simulated_step(engines, leaves, _grads(leaves, world, step))
    return leaves, engines


def _port_writes(d, leaves, engines, step=2):
    world = len(engines)
    ckpts = [pckpt.AsyncCheckpointer(rank=r, world=world, directory=d)
             for r in range(world)]
    try:
        for r, (c, e) in enumerate(zip(ckpts, engines)):
            assert c.snapshot(step, e.optimizer.state_dict(),
                              replicated=leaves if r == 0 else None,
                              layout=e.layout)
            assert c.last_snapshot_bytes > 0
            assert c.flush(deadline_s=30.0)
    finally:
        for c in ckpts:
            c.stop()


def _state_bits(full):
    return {(i, k): (v.dtype, _bits(v.reshape(-1).view(torch.int16)
                                    .numpy() if v.dtype == torch.bfloat16
                                    else v.numpy()))
            for i, st in full["state"].items() for k, v in st.items()}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("w_to", [2, 3])
def test_port_snapshot_restores_bitwise(tmp_path, dtype, w_to):
    d = str(tmp_path)
    leaves, engines = _port_world(dtype, 2)
    saved = psharded.simulated_full_state(engines)
    _port_writes(d, leaves, engines)
    # what a file holds: numpy arrays, bf16 widened to float32, keyed
    payload = pckpt.load_own_shard(d, 1)
    st = payload["shard_state"]["state"]
    assert set(st) == {"rep", "shard"} and payload["replicated"] is None
    for arr in st["shard"][engines[0].layout.groups[0].dtype].values():
        assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
    fresh = psharded.make_simulated_engines(SGD, w_to)
    for e in fresh:
        pckpt.restore_sharded(d, leaves, e)
    got = psharded.simulated_full_state(fresh)
    assert got["param_groups"] == saved["param_groups"]
    gb, sb = _state_bits(got), _state_bits(saved)
    assert gb.keys() == sb.keys()
    for k in sb:
        assert gb[k][0] == sb[k][0], k
        assert np.array_equal(gb[k][1], sb[k][1]), k
    # the JAX package reads the port's directory to the same arrays
    manifest, payloads = jckpt.load_shards(d)
    jleaves = jax.tree.leaves(_tree(dtype))
    _assert_same_tree(jckpt.assemble_full_state(manifest, payloads, jleaves),
                      pckpt.assemble_full_state(*pckpt.load_shards(d),
                                                leaves))


def test_restore_refuses_a_changed_threshold(tmp_path):
    d = str(tmp_path)
    leaves, engines = _port_world(np.float32, 2)
    _port_writes(d, leaves, engines)
    e = psharded.ShardedUpdateEngine(SGD, world_size=2, rank=0,
                                     min_shard_elems=10)
    with pytest.raises(pckpt.CheckpointError, match="digest"):
        pckpt.restore_sharded(d, leaves, e)


# --- the queue ---------------------------------------------------------------

def _shard(scale):
    return {"m": torch.arange(64, dtype=torch.float32) * scale}


def test_depth_one_newest_wins_and_flush(tmp_path):
    c = pckpt.AsyncCheckpointer(rank=0, world=1, directory=str(tmp_path))
    try:
        c._stop.set()  # a disk that never catches up: only flush commits
        c._wakeup.set()
        c._thread.join(timeout=5)
        dropped = c._m_dropped.value
        assert c.snapshot(1, _shard(1.0)) is True
        assert c.snapshot(2, _shard(2.0)) is False
        assert c._m_dropped.value == dropped + 1
        assert c.flush(deadline_s=10.0)
        own = pckpt.load_own_shard(str(tmp_path), 0)
        assert own["step"] == 2
        assert np.array_equal(own["shard_state"]["m"], np.arange(64) * 2.0)
        assert c.report()["last_step"] == 2
        # a transient write fault is retried inside the flush's deadline
        os.environ["HOROVOD_FAULT_SPEC"] = "ckpt.write:error#1"
        assert c.snapshot(3, _shard(3.0))
        assert c.flush(deadline_s=10.0)
        assert pckpt.read_manifest(str(tmp_path))["step"] == 3
    finally:
        os.environ.pop("HOROVOD_FAULT_SPEC", None)
        c.stop()


def test_off_unless_the_knob_is_set(monkeypatch):
    from horovod_tpu_torch.utils import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "get_registry", lambda: reg)
    monkeypatch.setattr(pckpt, "_CHECKPOINTER", None)
    assert pckpt.init_checkpointer(0, 1) is None
    assert pckpt.report() == {"enabled": False} and not reg.names()
