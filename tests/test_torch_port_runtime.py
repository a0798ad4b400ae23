"""The port's negotiated, fused background runtime against the JAX
package's, on the CPU (gloo):

- ``entry_signature`` field by field (the device field names the device
  type, ``"cpu"`` here, where the JAX package names a memory kind);
- ``_chunk_group``'s chunk boundaries on the same byte sizes;
- the fused chain at a world of one against ``_build_fused_plan``'s
  output with pre- and postscale: bitwise for bf16 and wherever the
  factors are powers of two; fp32 with other factors within ``FP32_RTOL``
  (below);
- the fused chain at two ranks, op by op, against the JAX package's
  multi-rank rule (``_allreduce_body``) bit for bit, for fp32, bf16 and
  fp16, SUM and AVERAGE, with factors that are not powers of two; and bf16
  AVERAGE through both packages' ``hvdrun`` in 2-process jobs;
- ``slot_env`` against the JAX launcher's for the same slots;
- the runtime's own rules in one process: plan cache, the dtype rule for
  integer chunks with a factor, a chunk of one tensor reduced in place,
  the in-flight name guard, the fusion buffer, a group enqueued at once
  fused in one cycle, the cycle sleeping out its period;
- two processes through the port's ``hvdrun``: tensors enqueued in
  opposite orders and ``DistributedOptimizer`` hooks fired in opposite
  orders reduce correctly, a duplicate in-flight name raises, a shape
  mismatch fails on both ranks with the coordinator's message, steady
  state rides ``SAME_AS_LAST``, ``shutdown`` fails pending handles;
- the slice: a 2-layer LM (weights from the JAX model through
  ``params_from_jax``) trained 5 steps by ``DistributedOptimizer`` in a
  2-process job of the port's ``hvdrun`` and of the JAX package's
  (``horovod_tpu.torch``) gives the same fp32 losses.

Mirrors ``tests/test_async_runtime.py``, ``tests/test_controller.py``,
``tests/test_fusion_plan.py`` and ``tests/test_runner.py``.
"""

import io
import os
import signal
import subprocess
import sys
import textwrap
import time
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as T
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import controller as jctl
from horovod_tpu.ops import queue as jqueue
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu_torch._native import FusionBuffer
from horovod_tpu_torch.common import context
from horovod_tpu_torch.common.env import RuntimeConfig
from horovod_tpu_torch.common.exceptions import DuplicateNameError
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.ops import collectives as pcoll
from horovod_tpu_torch.ops import controller as pctl
from horovod_tpu_torch.ops import fused_pack
from horovod_tpu_torch.ops import queue as pqueue
from horovod_tpu_torch.runner import hosts as phosts
from horovod_tpu_torch.runner import launch as plaunch

# Factors that are not powers of two. The port rounds after the prescale
# (pack) and after the postscale (unpack), as the JAX package does on more
# than one rank, where the reduction lies between the two, and rounds a
# bf16 chunk's factors to bf16 first, as JAX's weak typing does. At a world
# of one the JAX plan is ``flat * pre * post`` under jit: for bf16 XLA
# keeps the two products, so the port matches it bit for bit; for fp32 it
# folds them into one product by ``pre * post`` and rounds once, so the
# two differ by the rounding of the folded factor and of the intermediate
# product: 1 + 1 + 1 half-ulps of 2^-23 < 2^-22.
FP32_RTOL = 2.0 ** -22


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


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _from_np(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# --- signatures ---------------------------------------------------------------

SIG_CASES = [("allreduce", np.float32, (3, 4), 1, 0, 1.0, 1.0),
             ("allreduce", np.float32, (5,), 0, 0, 0.5, 2.0),
             ("allreduce", ml_dtypes.bfloat16, (2, 2, 2), 0, 0, 1.0, 1.0 / 3),
             ("allreduce", np.int32, (7,), 1, 0, 3.0, 1.0),
             ("allreduce", np.float64, (), 4, 0, 1.0, 1.0),
             ("broadcast", np.float32, (6, 1), 0, 1, 1.0, 1.0),
             # ragged in the first dimension: marked "*"
             ("allgather", np.float32, (6, 3), 0, 0, 1.0, 1.0),
             ("allgather", np.uint8, (0,), 0, 0, 1.0, 1.0),
             ("alltoall", ml_dtypes.bfloat16, (4, 2, 2), 0, 0, 1.0, 1.0),
             ("reducescatter", np.float32, (4, 2), 0, 0, 1.0, 1.0),
             # a set other than the global one carries its members
             ("allreduce", np.float32, (3,), 1, 0, 1.0, 1.0, "sub"),
             ("allgather", np.int32, (2, 5), 0, 0, 1.0, 1.0, "sub")]


@pytest.mark.parametrize("case", SIG_CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}-{c[3]}"
                              f"{'-' + c[7] if len(c) > 7 else ''}"
                              for c in SIG_CASES])
def test_entry_signature_matches_jax(case):
    """Field for field but the device; a set other than the global one is
    the JAX package's set of chip 0, whose one process is rank 0 here."""
    op, dtype, shape, reduce_op, root, pre, post = case[:7]
    arr = np.zeros(shape, dtype=dtype)
    kw = dict(name="t", op=op, reduce_op=pcoll.ReduceOp(reduce_op),
              root_rank=root, prescale_factor=pre, postscale_factor=post)
    jps = pps = None
    if len(case) > 7:
        jps = types.SimpleNamespace(name=case[7], _proc_indices=[0])
        pps = types.SimpleNamespace(name=case[7], ranks=[0])
    j = jctl.entry_signature(jqueue.TensorEntry(tensor=arr, process_set=jps,
                                                **kw))
    p = pctl.entry_signature(pqueue.TensorEntry(tensor=_from_np(arr),
                                                process_set=pps, **kw))
    assert p[:8] == j[:8] and p[9:] == j[9:]
    assert p[8] == "cpu"
    assert len(p) == len(j) == (10 if jps else 9)


# --- chunking -----------------------------------------------------------------

CHUNK_CASES = [(0, [8, 8, 8]), (100, [40, 40, 40, 100, 4, 200, 0, 96]),
               (4096, [1024] * 9 + [5000, 1]), (1 << 20, [4096] * 300)]


@pytest.mark.parametrize("threshold,sizes", CHUNK_CASES,
                         ids=[str(c[0]) for c in CHUNK_CASES])
def test_chunk_boundaries_match_jax(threshold, sizes):
    jx = [jqueue.TensorEntry(name=f"t{i}", op="allreduce",
                             tensor=np.zeros(n // 4, np.float32))
          for i, n in enumerate(sizes)]
    pt = [pqueue.TensorEntry(name=f"t{i}", op="allreduce",
                             tensor=torch.zeros(n // 4))
          for i, n in enumerate(sizes)]
    jchunks = jqueue.BackgroundRuntime._chunk_group(
        types.SimpleNamespace(fusion_threshold=threshold,
                              plan_chunk_tensors=0), jx)
    pchunks = pqueue.BackgroundRuntime._chunk_group(
        types.SimpleNamespace(fusion_threshold=threshold,
                              plan_chunk_tensors=0), pt)
    assert ([[e.name for e in c] for c in pchunks]
            == [[e.name for e in c] for c in jchunks])


# --- the fused chain at a world of one ---------------------------------------

PACK_CASES = [(np.float32, 1.0, 1.0), (np.float32, 0.5, 4.0),
              (np.float32, 1.0 / 3, 3.0), (np.float32, 2.0, 1.0 / 3),
              (ml_dtypes.bfloat16, 1.0, 1.0), (ml_dtypes.bfloat16, 0.5, 2.0),
              (ml_dtypes.bfloat16, 1.0 / 3, 1.0),
              (ml_dtypes.bfloat16, 2.0, 1.0 / 3)]


def _dyadic(f: float) -> bool:
    return np.frexp(f)[0] == 0.5


@pytest.mark.parametrize("dtype,pre,post", PACK_CASES,
                         ids=[f"{np.dtype(c[0]).name}-{c[1]:.3g}-{c[2]:.3g}"
                              for c in PACK_CASES])
def test_fused_chain_matches_jax_plan_at_world_one(port, dtype, pre, post):
    shapes = [(3, 4), (1,), (0,), (7, 5), (129,)]
    rs = np.random.RandomState(0)
    arrs = [rs.uniform(-4, 4, s).astype(dtype) for s in shapes]
    sizes = tuple(int(a.size) for a in arrs)
    plan = jcoll._build_fused_plan(None, 1, jcoll.ReduceOp.SUM, pre, post,
                                   sizes, tuple(shapes), False, False)
    want = [np.asarray(o) for o in
            plan.execute(np.concatenate([a.reshape(-1) for a in arrs]))]
    ts = [_from_np(a) for a in arrs]
    # the plain pack and unpack, then the runtime's whole chain
    flat = torch.empty(sum(sizes), dtype=ts[0].dtype)
    fused_pack.pack(ts, flat, pre)
    outs = [torch.empty_like(t) for t in ts]
    fused_pack.unpack(flat, outs, post)
    chain = hvd.grouped_allreduce(ts, op=hvd.Sum, prescale_factor=pre,
                                  postscale_factor=post)
    for got in (outs, chain):
        for g, w in zip(got, want):
            assert g.dtype == ts[0].dtype and tuple(g.shape) == w.shape
            g = _to_np(g).astype(np.float64)
            w = w.astype(np.float64)
            if dtype != np.float32 or (_dyadic(pre) and _dyadic(post)):
                np.testing.assert_array_equal(g, w)
            else:
                assert (np.abs(g - w) <= FP32_RTOL * np.abs(w)).all(), (g, w)


RULE_CASES = [(dt, op, pre, post)
              for dt in (np.float32, ml_dtypes.bfloat16, np.float16)
              for op in ("SUM", "AVERAGE")
              for pre, post in ((1.0 / 3, 3.0), (0.1, 0.7),
                                (1.0 / 3, 1.0 / 7))]


@pytest.mark.parametrize(
    "dtype,op,pre,post", RULE_CASES,
    ids=[f"{np.dtype(c[0]).name}-{c[1]}-{c[2]:.3g}-{c[3]:.3g}"
         for c in RULE_CASES])
def test_fused_chain_equals_jax_multi_rank_rule_bitwise(port, dtype, op,
                                                        pre, post):
    """Two ranks, op by op: each rank packs its tensors with the plan's
    prescale, the collective adds the two flat buffers in the chunk's dtype
    (what gloo and NCCL compute for two ranks), and the unpack applies the
    plan's factor (the postscale, times 1/2 for AVERAGE on gloo, which has
    no AVG). The JAX package: ``_allreduce_body`` on the two ranks' flat
    buffers. Bit for bit."""
    shapes = [(3, 4), (1,), (0,), (7, 5), (129,)]
    rs = np.random.RandomState(1)
    ranks = [[rs.uniform(-4, 4, sh).astype(dtype) for sh in shapes]
             for _ in range(2)]
    flats = [np.concatenate([a.reshape(-1) for a in r]) for r in ranks]
    body = jcoll._allreduce_body(None, getattr(jcoll.ReduceOp, op), pre,
                                 post, False)
    want = np.asarray(body(jax.numpy.asarray(np.stack(flats))))
    sizes = tuple(int(np.prod(sh)) for sh in shapes)
    tdtype = _from_np(flats[0]).dtype
    plan = pcoll.FusedChunkPlan(None, 2, getattr(pcoll.ReduceOp, op), pre,
                                post, sizes, tuple(shapes), tdtype)
    packed = []
    for r in ranks:
        flat = torch.empty(sum(sizes), dtype=tdtype)
        fused_pack.pack([_from_np(a) for a in r], flat, plan.pre)
        packed.append(flat)
    outs = [torch.empty(sh, dtype=tdtype) for sh in shapes]
    fused_pack.unpack(packed[0] + packed[1], outs, plan.unpack_factor)
    got = np.concatenate([_to_np(o).reshape(-1) for o in outs])
    assert got.dtype == want.dtype
    bits = np.dtype(f"u{got.dtype.itemsize}")
    np.testing.assert_array_equal(got.view(bits), want.view(bits))


def test_unpack_flat_matches_jax():
    shapes = ((2, 3), (0,), (4,), (1, 1, 2))
    sizes = tuple(int(np.prod(s)) for s in shapes)
    flat = np.arange(sum(sizes), dtype=np.float32)
    want = jcoll.unpack_flat(jax.numpy.asarray(flat), sizes, shapes)
    got = pcoll.unpack_flat(torch.from_numpy(flat), sizes, shapes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_inplace_on_a_non_contiguous_tensor_writes_back(port):
    base = torch.arange(12.0).reshape(3, 4)
    view = base.t()  # not contiguous
    out = hvd.allreduce_(view, op=hvd.Sum, prescale_factor=2.0)
    assert out.data_ptr() == view.data_ptr() and torch.equal(out, view)
    assert torch.equal(base, torch.arange(12.0).reshape(3, 4) * 2)


def test_bf16_factor_rounding_differs_from_jax_by_one_ulp(port):
    """The once-pinned mismatch (ROADMAP.md queue 3), repaired: the port
    rounds a bf16 chunk's factor to bf16 before it multiplies, as JAX's
    weak typing does, so 5 * (1/3) in bf16 is 1.671875 in both (an fp32
    factor gave 1.6640625, one bf16 ulp off)."""
    x = np.array([5.0], ml_dtypes.bfloat16)
    plan = jcoll._build_fused_plan(None, 1, jcoll.ReduceOp.SUM, 1.0 / 3,
                                   1.0, (1,), ((1,),), False, False)
    j = float(np.asarray(plan.execute(x)[0])[0])
    p = float(hvd.allreduce(_from_np(x), op=hvd.Sum,
                            prescale_factor=1.0 / 3)[0])
    assert p == j == 1.671875


# --- the runtime's own rules, in one process ---------------------------------

def _private_runtime(**cfg):
    """A runtime on the world group that no thread drives: each test runs
    its cycles by hand."""
    ps = context.global_process_set()
    return pqueue.BackgroundRuntime(ps, RuntimeConfig(**cfg),
                                    torch.device("cpu"), ps.group)


def _entry(name, t, inplace=True, **kw):
    return pqueue.TensorEntry(name=name, op="allreduce", tensor=t,
                              output=t if inplace else torch.empty_like(t),
                              **kw)


def test_duplicate_in_flight_name_raises(port):
    rt = _private_runtime()
    h = rt.enqueue(_entry("dup", torch.ones(2), reduce_op=pcoll.Sum))
    with pytest.raises(DuplicateNameError):
        rt.enqueue(_entry("dup", torch.ones(2), reduce_op=pcoll.Sum))
    rt.run_cycle()
    assert rt.handles.poll(h)
    assert torch.equal(rt.handles.wait(h), torch.ones(2))
    # released once finished: the name may be used again
    h = rt.enqueue(_entry("dup", torch.ones(2), reduce_op=pcoll.Sum))
    rt.run_cycle()
    rt.handles.wait(h)


def test_fusion_plan_cache_and_chunks(port):
    rt = _private_runtime(fusion_threshold_bytes=64)
    pcoll.invalidate_fused_plans()
    for step in range(2):
        ts = [torch.full((4,), float(i)) for i in range(5)]  # 16 bytes each
        hs = [rt.enqueue(_entry(f"g{i}", t, reduce_op=pcoll.Sum))
              for i, t in enumerate(ts)]
        rt.run_cycle()
        for i, h in enumerate(hs):
            assert torch.equal(rt.handles.wait(h), torch.full((4,), float(i)))
    # 5 x 16 bytes at 64: chunks of 4 and 1, each step
    assert rt.chunks == 4 and rt.collective_calls == 4
    assert len(pcoll._PLANS) == 2


def test_threshold_zero_makes_every_tensor_its_own_chunk(port):
    rt = _private_runtime(fusion_threshold_bytes=0)
    hs = [rt.enqueue(_entry(f"z{i}", torch.ones(3), reduce_op=pcoll.Sum))
          for i in range(4)]
    rt.run_cycle()
    for h in hs:
        rt.handles.wait(h)
    assert rt.chunks == 4
    assert rt.fusion_buffer.allocated_bytes() == 0  # nothing packed


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
def test_integer_chunk_with_a_factor_promotes_per_tensor(port, dtype):
    """The dtype rule: an integer chunk whose factors are not both 1 goes
    tensor by tensor to the single path and comes back float32, as JAX's
    weak typing makes it; with factors of 1 it fuses as a byte copy and
    keeps its dtype."""
    rt = _private_runtime()
    a = torch.arange(4, dtype=dtype)
    h = rt.enqueue(_entry("i.a", a.clone(), inplace=False,
                          reduce_op=pcoll.Sum, prescale_factor=2.5))
    h2 = rt.enqueue(_entry("i.b", a.clone(), inplace=False,
                           reduce_op=pcoll.Sum, prescale_factor=2.5))
    rt.run_cycle()
    ref = np.asarray(jcoll._build_fused_plan(
        None, 1, jcoll.ReduceOp.SUM, 2.5, 1.0, (4,), ((4,),), False,
        False).execute(a.numpy())[0])
    for hh in (h, h2):
        out = rt.handles.wait(hh)
        assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
        np.testing.assert_array_equal(out.numpy(), ref)
    assert rt.chunks == 0  # no fused chunk
    hs = [rt.enqueue(_entry(f"i.c{i}", a.clone(), reduce_op=pcoll.Sum))
          for i in range(2)]
    rt.run_cycle()
    for hh in hs:
        out = rt.handles.wait(hh)
        assert out.dtype == dtype and torch.equal(out, a)
    assert rt.chunks == 1


def test_plans_do_not_outlive_their_runtime(port):
    """A plan holds its runtime's process group: after shutdown and init,
    the same chunk builds a plan on the new group."""
    ts = [torch.ones(2), torch.full((3,), 2.0)]
    hvd.grouped_allreduce(ts, name="reinit", op=hvd.Sum)
    assert pcoll._PLANS
    hvd.shutdown()
    assert not pcoll._PLANS
    hvd.init(device="cpu")
    outs = hvd.grouped_allreduce(ts, name="reinit", op=hvd.Sum)
    assert [o.tolist() for o in outs] == [[1.0, 1.0], [2.0, 2.0, 2.0]]


def test_chunk_of_one_tensor_is_reduced_in_place(port):
    rt = _private_runtime()
    t = torch.arange(6.0)
    h = rt.enqueue(_entry("one", t, reduce_op=pcoll.Sum,
                          prescale_factor=2.0, postscale_factor=0.5))
    rt.run_cycle()
    assert rt.handles.wait(h) is t
    assert torch.equal(t, torch.arange(6.0))
    assert rt.fusion_buffer.allocated_bytes() == 0


def test_fusion_buffer_is_one_buffer_reused_by_every_chunk():
    fb = FusionBuffer(64, torch.device("cpu"))
    assert fb.allocated_bytes() == 0  # allocated at first use
    a = fb.lease(torch.float32, 16)
    b = fb.lease(torch.bfloat16, 32)
    assert a.dtype == torch.float32 and a.numel() == 16
    assert b.dtype == torch.bfloat16 and b.numel() == 32
    assert a.data_ptr() == b.data_ptr() and fb.allocated_bytes() == 64
    with pytest.raises(ValueError, match="exceeds"):
        fb.lease(torch.float32, 17)


def test_group_enqueued_at_once_fuses_in_one_cycle(port):
    """``enqueue_group`` puts a whole group in the queue under one lock:
    one drain takes all of it, and a name already in flight refuses the
    whole group."""
    rt = _private_runtime()
    ts = [torch.full((n,), float(n)) for n in (3, 1, 5, 2)]
    hs = rt.enqueue_group([_entry(f"grp.{i}", t, reduce_op=pcoll.Sum)
                           for i, t in enumerate(ts)])
    with pytest.raises(DuplicateNameError):
        rt.enqueue_group([_entry("other", torch.ones(1)),
                          _entry("grp.2", torch.ones(1))])
    rt.run_cycle()
    assert rt.chunks == 1 and rt.collective_calls == 1
    for h, n in zip(hs, (3, 1, 5, 2)):
        assert torch.equal(rt.handles.wait(h), torch.full((n,), float(n)))
    # the refused group left nothing behind: its names are free
    h = rt.enqueue(_entry("other", torch.ones(1), reduce_op=pcoll.Sum))
    rt.run_cycle()
    rt.handles.wait(h)


def test_cycle_sleeps_out_its_period_so_close_enqueues_fuse(port):
    """An enqueue does not cut a cycle's sleep short (reference
    RunLoopOnce), and without a controller an idle runtime runs no cycle:
    the first enqueue starts one cycle of 200 ms, and the tensors enqueued
    one by one within it fuse (a host slower than 200 ms for six enqueues
    would split them in two chunks at most). Grouped ops through the front
    end fuse into one chunk."""
    rt = _private_runtime(cycle_time_ms=200.0)
    rt.start()
    try:
        time.sleep(0.25)
        assert rt.cycles == 0  # idle: no cycle ran
        hs = [rt.enqueue(_entry(f"near{i}", torch.ones(4),
                                reduce_op=pcoll.Sum)) for i in range(6)]
        for h in hs:
            assert torch.equal(rt.handles.wait(h), torch.ones(4))
        assert 1 <= rt.chunks <= 2 and rt.work_cycles == rt.chunks
        # an enqueue after the drain's wake may leave one empty cycle
        assert rt.cycles <= rt.chunks + 1
    finally:
        rt.stop()
    c0 = context.runtime().chunks
    outs = hvd.grouped_allreduce([torch.ones(3) * i for i in range(5)],
                                 name="grp", op=hvd.Sum)
    assert [o.tolist() for o in outs] == [[float(i)] * 3 for i in range(5)]
    assert context.runtime().chunks - c0 == 1


def test_pack_refuses_other_devices_and_unscalable_dtypes():
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        fused_pack.pack([torch.empty(4, device="meta")],
                        torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="only"):
        fused_pack.pack([torch.ones(2, dtype=torch.int32)],
                        torch.empty(2, dtype=torch.int32), 0.5)
    # a factor of 1 is a byte copy for any dtype
    flat = torch.empty(3, dtype=torch.int16)
    fused_pack.pack([torch.tensor([1, 2], dtype=torch.int16),
                     torch.tensor([3], dtype=torch.int16)], flat)
    assert flat.tolist() == [1, 2, 3]


@pytest.mark.parametrize("item", [1, 4])
def test_tables_split_chunks_and_run_offsets_on(item):
    """K1's and K2's launch tables (``csrc/tensor_table.cuh``): at most
    ``MAX_SEGS`` tensors a launch, each tensor's first element (or byte)
    in the chunk, the offsets running on from one launch to the next."""
    sizes = [3, 0, 5] * 100
    ts = [torch.empty(n) for n in sizes]
    got = list(fused_pack.tables(ts, item))
    assert [n for _, _, n in got] == [128, 128, 44]
    starts = np.concatenate([[0], np.cumsum(sizes)]) * item
    at = 0
    for ptrs, offs, n in got:
        assert list(offs) == list(starts[at:at + n + 1])
        assert list(ptrs) == [t.data_ptr() for t in ts[at:at + n]]
        at += n
    with pytest.raises(RuntimeError, match="error 7"):
        fused_pack.check_launch("pack", 7)
    fused_pack.check_launch("pack", 0)


# --- the launcher -------------------------------------------------------------

LAYOUTS = {"one-host": [("localhost", 2)],
           "two-hosts": [("hostA", 2), ("hostB", 2)]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slot_env_matches_jax_launcher(layout):
    jslots = jhosts.get_host_assignments(
        [jhosts.HostInfo(h, n) for h, n in LAYOUTS[layout]], 4 if
        layout == "two-hosts" else 2)
    pslots = phosts.get_host_assignments(
        [phosts.HostInfo(h, n) for h, n in LAYOUTS[layout]], len(jslots))
    for js, ps in zip(jslots, pslots):
        je = jlaunch.slot_env(js, "10.0.0.1", 4711, "10.0.0.1:5000",
                              {"HOROVOD_CYCLE_TIME": "2"})
        pe = plaunch.slot_env(ps, "10.0.0.1", 4711, "10.0.0.1:5000",
                              {"HOROVOD_CYCLE_TIME": "2"})
        want = {k: v for k, v in je.items() if k.startswith("HOROVOD_")
                and not k.startswith("HOROVOD_TPU_")}
        got = {k: v for k, v in pe.items() if k.startswith("HOROVOD_")}
        assert got == want
        assert (pe["MASTER_ADDR"], pe["MASTER_PORT"]) == ("10.0.0.1", "5000")
        assert not any(k.startswith("HOROVOD_TPU_") for k in pe)


@pytest.mark.parametrize("hosts,store_host", [
    ([("localhost", 1), ("hostB", 1)], "10.0.0.9"),
    ([("hostB", 1), ("localhost", 1)], "hostB")])
def test_workers_dial_rank_zero_host_for_the_tcp_store(monkeypatch, hosts,
                                                       store_host):
    """Rank 0 serves the ``TCPStore``: ``MASTER_ADDR`` names its host, the
    launcher's routable address where rank 0 runs beside the launcher. The
    KV store stays on the launcher. No worker starts and no name is
    resolved: ``Popen`` and the host probes are stand-ins."""
    from horovod_tpu_torch.runner import network

    envs = []

    class _Exited:
        def __init__(self, cmd, env, **kw):
            envs.append(env)
            self.stdout, self.stderr = io.BytesIO(), io.BytesIO()

        def poll(self):
            return 0

    monkeypatch.setattr(network, "is_local_host", lambda h: h == "localhost")
    monkeypatch.setattr(network, "pick_coordinator_address",
                        lambda remote, iface_override=None: ("10.0.0.9", ""))
    monkeypatch.setattr(plaunch.subprocess, "Popen", _Exited)
    slots = phosts.get_host_assignments(
        [phosts.HostInfo(h, n) for h, n in hosts], 2)
    assert plaunch.launch_slots(["true"], slots) == 0
    assert [e["MASTER_ADDR"] for e in envs] == [store_host] * 2
    assert [e["HOROVOD_GLOO_RENDEZVOUS_ADDR"] for e in envs] == \
        ["10.0.0.9"] * 2


def test_launcher_refuses_an_empty_command():
    assert plaunch.run_commandline(["-np", "2"]) == 2


def test_run_returns_results_in_rank_order():
    """``run(fn, np=)`` starts the workers and gathers what ``fn``
    returned, rank by rank; here ``fn`` reads the slot's environment."""
    out = plaunch.run(os.getenv, args=("HOROVOD_RANK",), np=2)
    assert out == ["0", "1"]


# --- two processes through the port's hvdrun ---------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hvdrun(package: str, script, timeout: float = 240.0):
    """``python -m <package>.runner -np 2 python <script>`` in a session of
    its own; at the timeout the whole session (launcher and workers) is
    killed. Returns (exit code, output)."""
    return _hvdrun_all([(package, script)], timeout)[0]


def _hvdrun_all(jobs, timeout: float = 240.0) -> list:
    """``_hvdrun`` of every ``(package, script)`` in ``jobs``, all started
    at once (each spends most of its time importing); their (exit code,
    output) in order."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [(package, subprocess.Popen(
        [sys.executable, "-m", f"{package}.runner", "-np", "2",
         sys.executable, str(script)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)) for package, script in jobs]
    out = []
    try:
        for package, p in procs:
            try:
                log = p.communicate(timeout=timeout)[0]
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                log = p.communicate()[0]
                raise AssertionError(
                    f"{package} hvdrun job timed out:\n{log}")
            out.append((p.returncode, log))
    finally:
        for _, p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return out


RUNTIME_WORKER = textwrap.dedent("""
    import sys, threading, time
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.common.exceptions import (DuplicateNameError,
                                                     HorovodInternalError)
    from horovod_tpu_torch.utils import metrics

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    rt = context.runtime()
    assert n == 2 and rt.controller is not None

    # 1) tensors enqueued in opposite orders
    names = [f"g{i}" for i in range(6)]
    order = names if r == 0 else names[::-1]
    hs = {nm: hvd.allreduce_async(
              torch.full((8,), float((r + 1) * (int(nm[1:]) + 1))),
              op=hvd.Sum, name=nm) for nm in order}
    for nm in names:
        out = hvd.synchronize(hs[nm])
        assert torch.equal(out, torch.full((8,), 3.0 * (int(nm[1:]) + 1)))

    # 2) DistributedOptimizer hooks fired in opposite orders
    params = [torch.nn.Parameter(torch.zeros(s))
              for s in ((3, 4), (5,), (2, 2, 2), (7,))]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1),
        named_parameters=[(f"p{i}", p) for i, p in enumerate(params)])
    for i, p in enumerate(params):
        p.grad = torch.full(p.shape, float((r + 1) * (i + 1)))
    for p in (params if r == 0 else params[::-1]):
        opt._hook(p)
    opt.synchronize()
    for i, p in enumerate(params):
        assert torch.equal(p.grad, torch.full(p.shape, 1.5 * (i + 1))), i

    # 3) a duplicate in-flight name (the other rank submits after the
    #    barrier, so the name is still in flight here)
    for owner, name in ((0, "dupA"), (1, "dupB")):
        if r == owner:
            h = hvd.allreduce_async(torch.ones(4), name=name, op=hvd.Sum)
            try:
                hvd.allreduce_async(torch.ones(4), name=name, op=hvd.Sum)
                raise SystemExit("expected DuplicateNameError")
            except DuplicateNameError:
                pass
            hvd.barrier()
        else:
            hvd.barrier()
            h = hvd.allreduce_async(torch.ones(4), name=name, op=hvd.Sum)
        assert torch.equal(hvd.synchronize(h), torch.full((4,), 2.0))

    # 4) a shape mismatch fails the name on both ranks
    shape = (4,) if r == 0 else (5,)
    h = hvd.allreduce_async(torch.ones(shape), op=hvd.Sum, name="bad")
    try:
        hvd.synchronize(h)
        raise SystemExit("expected the mismatch to fail")
    except HorovodInternalError as e:
        assert "Mismatched" in str(e), e

    # 5) steady state rides the SAME_AS_LAST marker: a cycle starts every
    #    cycle time whether or not anything was enqueued, so a loop of one
    #    synchronous name alternates its payload with empty rounds, and
    #    the idle rounds that follow it repeat the empty one
    reg = metrics.get_registry()
    hits0 = reg.counter_value("hvd_controller_cache_hits_total")
    for _ in range(30):
        out = hvd.synchronize(hvd.allreduce_async(
            torch.full((64,), float(r)), op=hvd.Sum, name="steady"))
        assert torch.equal(out, torch.ones(64))
    time.sleep(0.3)
    ctl = rt.controller
    assert reg.counter_value("hvd_controller_cache_hits_total") - hits0 > 10
    assert ctl.bytes_sent < ctl.round * 120, (ctl.bytes_sent, ctl.round)

    # 6) shutdown fails a pending handle (no other rank submits its name)
    h = hvd.allreduce_async(torch.ones(2), name=f"orphan.{r}", op=hvd.Sum)
    res = {}

    def wait():
        try:
            hvd.synchronize(h)
            res["out"] = "completed"
        except HorovodInternalError as e:
            res["out"] = str(e)

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.3)
    hvd.shutdown()
    t.join(10)
    assert not t.is_alive() and "shut down" in res["out"], res
    print("RUNTIME_OK", r)
""")


def test_two_process_runtime_through_hvdrun(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(RUNTIME_WORKER)
    rc, out = _hvdrun("horovod_tpu_torch", script)
    assert rc == 0, out
    assert "RUNTIME_OK 0" in out and "RUNTIME_OK 1" in out


# --- the slice: port hvdrun against horovod_tpu.torch under JAX hvdrun -------

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16)

SLICE_BODY = """
    cfg = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    model = PT.TransformerLM(cfg, device="cpu")
    sd = np.load({params!r})
    model.load_state_dict({{k: torch.from_numpy(sd[k]) for k in sd.files}})
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    tokens = torch.from_numpy(
        np.random.RandomState(100 + r).randint(0, 64, (2, 17)))
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = PT.lm_loss(model, tokens, attn_fn=ring_attention)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.save({out!r}.format(r), np.array(losses))
    hvd.shutdown()
"""

PORT_HEAD = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
"""

JAX_HEAD = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    import horovod_tpu.torch as hvd
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention
    torch.set_num_threads(1)
    hvd.init()
    r = hvd.cross_rank()
"""


def test_slice_losses_match_jax_package_two_processes(tmp_path):
    """fp32 losses of 5 steps on each rank; the averaged gradient of two
    ranks is exact in both packages (a sum of two and a halving), so the
    tolerance covers summation order only."""
    cfg = T.TransformerConfig(**CFG, dtype=jax.numpy.float32)
    params = PT.params_from_jax(jax.tree_util.tree_map(
        np.asarray, T.init(jax.random.PRNGKey(0), cfg)))
    pfile = str(tmp_path / "params.npz")
    np.savez(pfile, **{k: v.numpy() for k, v in params.items()})
    losses, jobs = {}, []
    for pkg, head, runner in (("port", PORT_HEAD, "horovod_tpu_torch"),
                              ("jax", JAX_HEAD, "horovod_tpu")):
        out = str(tmp_path / (pkg + ".{}.npy"))
        script = tmp_path / f"{pkg}_worker.py"
        script.write_text(textwrap.dedent(head) + textwrap.dedent(
            SLICE_BODY.format(params=pfile, out=out)))
        jobs.append((runner, script))
    for (rc, log), pkg in zip(_hvdrun_all(jobs), ("port", "jax")):
        assert rc == 0, log
        out = str(tmp_path / (pkg + ".{}.npy"))
        losses[pkg] = [np.load(out.format(r)) for r in range(2)]
    for r in range(2):
        np.testing.assert_allclose(losses["port"][r], losses["jax"][r],
                                   rtol=1e-6, atol=0)
        assert losses["port"][r][-1] < losses["port"][r][0]
    assert not np.array_equal(losses["port"][0], losses["port"][1])


AVG_SIZES = (12, 1, 35, 129)
AVG_PRE, AVG_POST = 1.0 / 3, 0.7

AVG_BODY = """
    rs = np.random.RandomState(7 + r)
    ts = [torch.from_numpy(rs.uniform(-4, 4, n).astype(np.float32))
          .to(torch.bfloat16) for n in {sizes!r}]
    outs = hvd.grouped_allreduce(ts, name="bf16avg", op=hvd.Average,
                                 prescale_factor={pre!r},
                                 postscale_factor={post!r})
    assert [o.dtype for o in outs] == [torch.bfloat16] * len(ts)
    np.save({out!r}.format(r), np.concatenate(
        [o.view(torch.int16).numpy() for o in outs]))
    hvd.shutdown()
"""


def test_bf16_average_matches_jax_package_two_processes(tmp_path):
    """bf16 AVERAGE with factors that bf16 does not hold exactly, as one
    fused chunk, in a 2-process job of the port's ``hvdrun`` and of the JAX
    package's (``horovod_tpu.torch``), over gloo. Both ranks of the port
    give, bit for bit, the JAX package's multi-rank rule run op by op
    (``_allreduce_body``: the prescaled values rounded to bf16, as they
    cross the wire, then mean and postscale). The JAX package's own job
    gives that rule under ``jax.jit``, where XLA keeps the prescaled values
    in fp32 through the mean and rounds once after it: a different
    result (ROADMAP.md queue 3), which this test pins."""
    inputs = []
    for r in range(2):
        rs = np.random.RandomState(7 + r)
        inputs.append(np.concatenate([
            _to_np(torch.from_numpy(rs.uniform(-4, 4, n).astype(np.float32))
                   .to(torch.bfloat16)) for n in AVG_SIZES]))
    body = jcoll._allreduce_body(None, jcoll.ReduceOp.AVERAGE, AVG_PRE,
                                 AVG_POST, False)
    g = jax.numpy.asarray(np.stack(inputs))
    rule = np.asarray(body(g)).view(np.int16)
    jitted = np.asarray(jax.jit(body)(g)).view(np.int16)
    got, jobs = {}, []
    for pkg, head, runner in (("port", PORT_HEAD, "horovod_tpu_torch"),
                              ("jax", JAX_HEAD, "horovod_tpu")):
        out = str(tmp_path / (pkg + ".{}.npy"))
        script = tmp_path / f"{pkg}_avg.py"
        script.write_text(textwrap.dedent(head) + textwrap.dedent(
            AVG_BODY.format(sizes=AVG_SIZES, pre=AVG_PRE, post=AVG_POST,
                            out=out)))
        jobs.append((runner, script))
    for (rc, log), pkg in zip(_hvdrun_all(jobs), ("port", "jax")):
        assert rc == 0, log
        out = str(tmp_path / (pkg + ".{}.npy"))
        got[pkg] = [np.load(out.format(r)) for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(got["port"][r], rule)
        np.testing.assert_array_equal(got["jax"][r], jitted)
    assert (rule != jitted).any()


def test_no_lock_order_inversions():
    """The port's lock auditor (armed for the session by the suite's
    ``HOROVOD_LOCKCHECK=1``) saw no inversion in this file's runtimes."""
    from horovod_tpu_torch.utils import lockcheck

    assert lockcheck.inversions() == []
