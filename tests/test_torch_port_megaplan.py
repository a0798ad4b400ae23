"""The port's whole-step megaplan (``horovod_tpu_torch/ops/megaplan.py``
and its parts of ``ops/queue.py``) against the JAX package's, on the
schedules of ``tests/test_megaplan.py``: each test drives a private,
unstarted runtime of each package cycle by cycle (``run_cycle``) at a
world of one, on the same numpy inputs, and holds the two
``megaplan_report()`` dicts equal (the process-wide epoch counters left
out: each package's counts the invalidations of its whole process), the
outputs bitwise equal, and each invalidation under the same reason.

At a world of one neither runtime has a controller, so capture needs no
lease; the lease and the two-rank rules (a quantized group never
captures) are in ``test_torch_port_megaplan_jobs.py`` and
``test_torch_port_hier.py``.
"""

import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.common import context as jctx
from horovod_tpu.common.env import RuntimeConfig as JConfig
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops import megaplan as jmp
from horovod_tpu.ops import queue as jq
from horovod_tpu.utils import metrics as jmetrics

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import context as pctx
from horovod_tpu_torch.common.env import RuntimeConfig as PConfig
from horovod_tpu_torch.ops import collectives as PC
from horovod_tpu_torch.ops import compression as pcomp
from horovod_tpu_torch.ops import megaplan as pmp
from horovod_tpu_torch.ops import queue as pq
from horovod_tpu_torch.utils import metrics as pmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.fixture
def managers(port, monkeypatch):
    """Arm both packages' managers (``HOROVOD_MEGAPLAN`` on) and drop them
    afterwards; a runtime built after this resolves them."""

    def _arm(stable_rounds=3):
        monkeypatch.setenv("HOROVOD_MEGAPLAN", "1")
        monkeypatch.setenv("HOROVOD_MEGAPLAN_STABLE_ROUNDS",
                           str(stable_rounds))
        for mod in (jmp, pmp):
            mod.reset_manager()
            mod.init_manager(rank=0)

    yield _arm
    for mod in (jmp, pmp):
        mod.reset_manager()


def _outcome(wait):
    try:
        return np.asarray(wait())
    except Exception as e:  # the two packages' HorovodInternalError
        return (type(e).__name__, str(e).split(":")[0])


class _Jax:
    """A private JAX runtime on the session's global set."""

    def __init__(self, fusion_bytes=None):
        cfg = JConfig()
        cfg.stall_check_disable = True
        if fusion_bytes is not None:
            cfg.fusion_threshold_bytes = fusion_bytes
        self.rt = jq.BackgroundRuntime(jctx.global_process_set(), cfg)
        self.mgr = jmp.get_manager()

    def cycle(self, specs):
        hs = [self.rt.enqueue(jq.TensorEntry(
            name=n, op="allreduce", tensor=a, reduce_op=JC.ReduceOp(op)))
            for n, a, op in specs]
        self.rt.run_cycle()
        return [_outcome(lambda h=h: self.rt.handles.wait(h)) for h in hs]

    @staticmethod
    def inval(reason):
        return sum(c["value"] for c in
                   jmetrics.get_registry().snapshot()["counters"]
                   if c["name"] == "hvd_megaplan_invalidations_total"
                   and c["labels"].get("reason") == reason)


class _Port:
    """A private port runtime on the port's global set, on the CPU."""

    def __init__(self, fusion_bytes=None):
        ps = pctx.global_process_set()
        cfg = PConfig()
        if fusion_bytes is not None:
            cfg.fusion_threshold_bytes = fusion_bytes
        self.rt = pq.BackgroundRuntime(ps, cfg, torch.device("cpu"),
                                       ps.runtime_group)
        self.mgr = pmp.get_manager()

    def cycle(self, specs):
        entries = []
        for n, a, op in specs:
            t = torch.from_numpy(a.copy())
            entries.append(pq.TensorEntry(
                name=n, op="allreduce", tensor=t, output=torch.empty_like(t),
                reduce_op=PC.ReduceOp(op)))
        hs = self.rt.enqueue_group(entries)
        self.rt.run_cycle()
        return [_outcome(lambda h=h: self.rt.handles.wait(h)) for h in hs]

    @staticmethod
    def inval(reason):
        return pmetrics.get_registry().counter_value(
            "hvd_megaplan_invalidations_total", reason=reason)


def _report(mod) -> dict:
    rep = mod.report()
    rep.pop("epoch", None)
    if "plan" in rep:
        rep["plan"] = {k: v for k, v in rep["plan"].items() if k != "epoch"}
    return rep


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple) or isinstance(y, tuple):
            assert x == y
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _specs(n=4, elems=64, seed=7, prefix="mp", op=0):
    rng = np.random.default_rng(seed)
    return [(f"{prefix}.{i}", rng.standard_normal(elems).astype(np.float32),
             op) for i in range(n)]


def _both(j, p, specs):
    jo, po = j.cycle(specs), p.cycle(specs)
    _same(jo, po)
    return po


def _inval_delta(reason, run):
    before = (_Jax.inval(reason), _Port.inval(reason))
    run()
    return (_Jax.inval(reason) - before[0], _Port.inval(reason) - before[1])


# --- the schedules of tests/test_megaplan.py ------------------------------

def test_steady_state_captures_once_then_replays(managers):
    managers(stable_rounds=3)
    j, p = _Jax(), _Port()
    assert p.rt._mp is p.mgr is not None
    specs = _specs()
    for _ in range(10):
        for (_, a, _), o in zip(specs, _both(j, p, specs)):
            np.testing.assert_array_equal(o, a)
    rep = _report(pmp)
    assert rep == _report(jmp)
    assert hvd.megaplan_report() == pmp.report()
    assert rep["captures"] == 1 and rep["capture_rounds"] == 3
    assert rep["replays"] == 7 and rep["misses"] == 0
    assert rep["replay_hit_rate"] == 1.0
    assert rep["plan"] == {"tensors": 4, "chunks": 1, "bytes": 1024,
                           "plan_epoch": PC._plan_epoch()}


def test_replay_is_bitwise_a_run_that_never_replays(managers):
    managers(stable_rounds=3)
    j, p = _Jax(), _Port()
    specs = [(n, a, 1) for n, a, _ in _specs(elems=128, seed=11,
                                             prefix="mp.bw")]
    replayed = [_both(j, p, specs) for _ in range(8)]
    assert p.mgr.replays == j.mgr.replays == 5
    pmp.reset_manager()
    never = _Port()
    assert never.rt._mp is None
    for outs in replayed:
        _same(outs, never.cycle(specs))
    assert never.mgr is None and pmp.report() == {"enabled": False}


def test_changed_shape_invalidates_as_signature_and_recaptures(managers):
    managers(stable_rounds=3)
    j, p = _Jax(), _Port()
    specs = _specs()
    for _ in range(5):
        _both(j, p, specs)
    assert p.mgr.plan is not None and p.mgr.replays == 2
    changed = list(specs)
    changed[2] = (changed[2][0], np.ones(96, np.float32), 0)
    assert _inval_delta("signature",
                        lambda: _both(j, p, changed)) == (1, 1)
    assert p.mgr.plan is None
    for _ in range(4):
        _both(j, p, changed)
    assert _report(pmp) == _report(jmp)
    assert p.mgr.captures == 2 and p.mgr.plan is not None
    rows = pmp.batch_signature([pq.TensorEntry(
        name=n, op="allreduce", tensor=torch.from_numpy(a))
        for n, a, _ in changed])
    assert p.mgr.plan.sig == rows == jmp.batch_signature(
        [jq.TensorEntry(name=n, op="allreduce", tensor=a)
         for n, a, _ in changed])


def test_plan_cache_invalidation_drops_the_megaplan(managers):
    managers(stable_rounds=2)
    j, p = _Jax(), _Port()
    specs = _specs(n=2)
    for _ in range(3):
        _both(j, p, specs)
    assert p.mgr.plan is not None and j.mgr.plan is not None

    def drop():
        JC.invalidate_fused_plans()
        PC.invalidate_fused_plans()

    assert _inval_delta("plan_cache", drop) == (1, 1)
    assert p.mgr.plan is None
    _both(j, p, specs)
    assert _report(pmp) == _report(jmp)


def test_elastic_generation_bump_invalidates_as_epoch(managers, monkeypatch):
    managers(stable_rounds=3)
    j, p = _Jax(), _Port()
    specs = _specs(prefix="mp.el")
    for _ in range(5):
        _both(j, p, specs)
    assert p.mgr.plan is not None
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", str(PC._plan_epoch() + 1))
    assert JC._plan_epoch() == PC._plan_epoch()
    outs = []
    assert _inval_delta("epoch",
                        lambda: outs.append(_both(j, p, specs))) == (1, 1)
    assert _report(pmp) == _report(jmp)
    pmp.reset_manager()
    _same(outs[0], _Port().cycle(specs))


def test_a_join_invalidates_as_membership(managers):
    managers(stable_rounds=3)
    j, p = _Jax(), _Port()
    specs = _specs(prefix="mp.jn")
    for _ in range(4):
        _both(j, p, specs)
    assert p.mgr.plan is not None

    def joined_cycle():
        j.rt.joined = p.rt.joined = True
        outs = _both(j, p, specs)
        j.rt.joined = p.rt.joined = False
        for (_, a, _), o in zip(specs, outs):
            np.testing.assert_array_equal(o, a)

    assert _inval_delta("membership", joined_cycle) == (1, 1)
    for _ in range(3):
        _both(j, p, specs)
    assert _report(pmp) == _report(jmp)
    assert p.mgr.captures == 2 and p.mgr.misses == 1


def test_a_single_op_in_the_step_never_captures(managers):
    """A MIN allreduce runs alone, outside any chunk plan: a step that holds
    one is never captured, however often it repeats."""
    managers(stable_rounds=2)
    j, p = _Jax(), _Port()
    specs = _specs(n=3, prefix="mp.s") + [("mp.s.min", np.arange(
        5, dtype=np.float32), int(PC.ReduceOp.MIN))]
    for _ in range(6):
        _both(j, p, specs)
    rep = _report(pmp)
    assert rep == _report(jmp)
    assert rep["captures"] == 0 and rep["replays"] == 0 and not rep["active"]


def test_a_chunk_failing_mid_chain_fails_the_rest(managers, monkeypatch):
    """Four chunks (a fusion threshold of one tensor); the replay's second
    chunk raises: the first chunk's entries finish, the other three fail
    with HorovodInternalError, and the megaplan drops as ``dispatch``."""
    managers(stable_rounds=3)
    j, p = _Jax(fusion_bytes=256), _Port(fusion_bytes=256)
    specs = _specs(prefix="mp.fail")
    for _ in range(4):
        _both(j, p, specs)
    assert len(p.mgr.plan.chunks) == len(j.mgr.plan.chunks) == 4
    bad = {id(j.mgr.plan.chunks[1][1]), id(p.mgr.plan.chunks[1][1])}
    for cls in (JC.FusedChunkPlan, PC.FusedChunkPlan):
        def execute(self, *a, _orig=cls.execute, **kw):
            if id(self) in bad:
                raise RuntimeError("injected chunk failure")
            return _orig(self, *a, **kw)
        monkeypatch.setattr(cls, "execute", execute)
    outs = []
    assert _inval_delta("dispatch",
                        lambda: outs.append(_both(j, p, specs))) == (1, 1)
    np.testing.assert_array_equal(outs[0][0], specs[0][1])
    assert outs[0][1:] == [("HorovodInternalError",
                            "megaplan replay failed")] * 3
    rep = _report(pmp)
    assert rep == _report(jmp)
    assert rep["replays"] == 1 and rep["misses"] == 1 and not rep["active"]


@pytest.mark.parametrize("case", ["float32", "bfloat16", "int32", "scaled",
                                  "quant", "mixed"])
def test_batch_signature_rows_equal_the_jax_package(case):
    rng = np.random.default_rng(3)
    rows = {"float32": [("a", np.float32, (3, 4), 0, 1.0, 1.0, None)],
            "bfloat16": [("b", ml_dtypes.bfloat16, (8,), 1, 1.0, 1.0, None)],
            "int32": [("c", np.int32, (2, 2, 2), 1, 1.0, 1.0, None)],
            "scaled": [("d", np.float32, (5,), 0, 0.5, 1.0 / 3, None)],
            "quant": [("e", np.float32, (4096,), 0, 1.0, 1.0, 8)],
            "mixed": [("z", np.float64, (), 4, 1.0, 1.0, None),
                      ("y", np.float32, (7,), 1, 2.0, 1.0, 4),
                      ("x", ml_dtypes.bfloat16, (1, 3), 0, 1.0, 1.0, None)]
            }[case]
    jentries, pentries = [], []
    for name, dt, shape, op, pre, post, bits in rows:
        a = rng.standard_normal(shape).astype(dt)
        t = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
             if dt is ml_dtypes.bfloat16 else torch.from_numpy(a))
        jq_ = None if bits is None else jcomp.make_quant_spec(bits)
        pq_ = None if bits is None else pcomp.make_quant_spec(bits)
        jentries.append(jq.TensorEntry(
            name=name, op="allreduce", tensor=a, reduce_op=JC.ReduceOp(op),
            prescale_factor=pre, postscale_factor=post, quant=jq_))
        pentries.append(pq.TensorEntry(
            name=name, op="allreduce", tensor=t, reduce_op=PC.ReduceOp(op),
            prescale_factor=pre, postscale_factor=post, quant=pq_))
    assert pmp.batch_signature(pentries) == jmp.batch_signature(jentries)
    # order-insensitive: the drained order does not matter
    assert pmp.batch_signature(pentries[::-1]) \
        == pmp.batch_signature(pentries)


_FLAG_OFF = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    assert "HOROVOD_MEGAPLAN" not in os.environ
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import megaplan
    from horovod_tpu_torch.utils import metrics
    hvd.init(device="cpu")
    assert megaplan.get_manager() is None and context.runtime()._mp is None
    assert hvd.megaplan_report() == {"enabled": False}
    for _ in range(6):
        hvd.grouped_allreduce_([torch.ones(8), torch.ones(3)], name="g")
    hvd.shutdown()
    bad = [n for n in metrics.get_registry().names()
           if n.startswith("hvd_megaplan")]
    assert not bad, bad
    print("FLAG_OFF_OK")
""")


def test_flag_off_builds_no_manager_and_no_series():
    env = {k: v for k, v in os.environ.items() if k != "HOROVOD_MEGAPLAN"}
    out = subprocess.run([sys.executable, "-c", _FLAG_OFF], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(env, OMP_NUM_THREADS="1"))
    assert out.returncode == 0 and "FLAG_OFF_OK" in out.stdout, (
        out.stdout + out.stderr)


def test_init_builds_the_manager_and_shutdown_drops_it(monkeypatch):
    """``init`` builds the manager before the runtime, which resolves it;
    ``shutdown`` drops it."""
    was = hvd.is_initialized()
    if was:
        hvd.shutdown()
    monkeypatch.setenv("HOROVOD_MEGAPLAN", "1")
    try:
        hvd.init(device="cpu")
        assert pctx.runtime()._mp is pmp.get_manager() is not None
        assert hvd.megaplan_report()["enabled"] is True
        hvd.shutdown()
        assert pmp.get_manager() is None
        assert hvd.megaplan_report() == {"enabled": False}
        assert jhvd.megaplan_report() == {"enabled": False}
    finally:
        monkeypatch.delenv("HOROVOD_MEGAPLAN")
        if was and not hvd.is_initialized():
            hvd.init(device="cpu")
