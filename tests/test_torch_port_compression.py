"""The port's compressed gradient wire against the JAX package's, on the CPU:

- the spec functions (``spec_for_mode``, ``resolve_quant_spec``,
  ``make_quant_spec``, the layout, the guardrails), for every mode and
  alias, with the error text, the normalization and the defaults filled
  from the environment;
- the plain ``quantize_blockwise``/``dequantize_blockwise`` bit for bit
  against the JAX functions as the package runs them, under ``jit``
  (where XLA turns ``absmax / qmax`` into ``absmax * fp32(1/qmax)``), for
  int8 and int4 at blocks 8, 9, 256 and 1000, lengths 1, block - 1,
  block + 1 and many blocks, with all-zero, saturating and tie blocks;
- ``quant_sim_chunk_plan(...).execute_simulated`` bit for bit against the
  JAX plan's at worlds 2, 3 and 4: SUM and AVERAGE, factors other than 1,
  fp32 and bf16 chunks, the bf16 cast plan, and int8/int4 with error
  feedback over three rounds, residuals included (N = 3 with a postscale
  pins the folded factor ``fp32(fp32(1/N) * fp32(post))``);
- ``ResidualStore`` resets, and the runtime committing a residual only
  after a dispatch that succeeded (a fault injected);
- the runtime's fallback matrix, each reason counted once per tensor, and
  the world-of-one fallback;
- the zero-cost contract: with the knob unset no ``hvd_quant_*`` series
  exists and the plan keys are the plain ones;
- the repairs of the knobs the port ignored: ``init`` warns for the JAX
  package's knobs that the port does not implement, raises on an unknown
  ``HOROVOD_COMPRESSION`` with the JAX message, ``sharded_update=None``
  reads ``HOROVOD_SHARDED_UPDATE``, and the sharded update and the wire
  exclude each other with the JAX message;
- the front end's ``Compression.int8``/``int4`` markers.

The 2-process jobs through both packages' ``hvdrun`` are in
``tests/test_torch_port_compression_jobs.py``.

Mirrors ``tests/test_quantized.py``.
"""

import itertools
import json
import os
import subprocess
import sys
import textwrap
import types
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.common import env as jenv
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.opt import sharded as jsharded
from horovod_tpu_torch.common import context
from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.common.env import RuntimeConfig
from horovod_tpu_torch.ops import collectives as pcoll
from horovod_tpu_torch.ops import compression as pcomp
from horovod_tpu_torch.ops import queue as pqueue
from horovod_tpu_torch.ops import quant_wire as qw
from horovod_tpu_torch.utils import metrics as pmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("HOROVOD_COMPRESSION", "HOROVOD_QUANT_BLOCK", "HOROVOD_QUANT_EF",
         "HOROVOD_QUANT_OPTOUT", "HOROVOD_QUANT_MIN_ELEMS",
         "HOROVOD_SHARDED_UPDATE") + penv.UNIMPLEMENTED_KNOBS


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh():
    """No port runtime before or after the test (``init`` is idempotent,
    so a test of what ``init`` does needs a fresh one)."""
    hvd.shutdown()
    yield
    hvd.shutdown()


@pytest.fixture
def port(fresh):
    hvd.init(device="cpu")
    yield


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _from_np(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


def _as_tuple(spec):
    return None if spec is None else tuple(spec)


# --- the spec functions -----------------------------------------------------

MODES = ["", "none", "0", "off", "OFF", "bf16", "int8", "int4", " Int8 ",
         "INT4", "fp16", "int3", "zstd"]


@pytest.mark.parametrize("mode", MODES)
def test_spec_for_mode_matches_jax(mode):
    p = _outcome(lambda m: _as_tuple(pcomp.spec_for_mode(m)), mode)
    j = _outcome(lambda m: _as_tuple(jcomp.spec_for_mode(m)), mode)
    assert p == j
    if p[0] == "ok" and p[1] is not None:
        spec = pcomp.spec_for_mode(mode)
        assert pcomp.mode_of_spec(spec) == jcomp.mode_of_spec(
            jcomp.spec_for_mode(mode))
        assert spec.signature() == jcomp.spec_for_mode(mode).signature()
        assert spec.qmax == jcomp.spec_for_mode(mode).qmax


RESOLVE_CASES = [("int8", None, None), ("int4", "9", None),
                 ("int4", "3", "0"), ("int8", "1000", "false"),
                 ("bf16", "64", "0"), ("none", "9", None), ("", None, None),
                 ("int2", None, None), (" BF16", None, "1")]


@pytest.mark.parametrize("mode,block,ef", RESOLVE_CASES)
def test_resolve_quant_spec_matches_jax(monkeypatch, mode, block, ef):
    """From the environment and from each package's parsed config: the
    same spec (blocks made even for int4 and at least 8, defaults from
    HOROVOD_QUANT_BLOCK/EF) or the same error text."""
    monkeypatch.setenv("HOROVOD_COMPRESSION", mode)
    for k, v in (("HOROVOD_QUANT_BLOCK", block), ("HOROVOD_QUANT_EF", ef)):
        if v is not None:
            monkeypatch.setenv(k, v)
    want = _outcome(lambda: _as_tuple(jcomp.resolve_quant_spec()))
    assert _outcome(lambda: _as_tuple(pcomp.resolve_quant_spec())) == want
    jcfg = jenv.RuntimeConfig.from_env()
    pcfg = RuntimeConfig.from_env()
    assert (pcfg.compression, pcfg.quant_block, pcfg.quant_error_feedback) \
        == (jcfg.compression, jcfg.quant_block, jcfg.quant_error_feedback)
    assert _outcome(lambda: _as_tuple(pcomp.resolve_quant_spec(pcfg))) == \
        _outcome(lambda: _as_tuple(jcomp.resolve_quant_spec(jcfg)))
    if want[0] == "error":
        assert want[1].startswith("HOROVOD_COMPRESSION: unknown compression "
                                  "mode")


def test_runtime_config_defaults_match_jax():
    p, j = RuntimeConfig(), jenv.RuntimeConfig()
    for f in ("compression", "quant_block", "quant_error_feedback",
              "quant_optout", "quant_min_elems"):
        assert getattr(p, f) == getattr(j, f), f


@pytest.mark.parametrize("bits", [8, 4])
def test_make_quant_spec_and_layout_match_jax(monkeypatch, bits):
    for block in (1, 7, 8, 9, 10, 255, 256, 1000):
        for ef in (True, False):
            p = pcomp.make_quant_spec(bits, block, ef)
            assert tuple(p) == tuple(jcomp.make_quant_spec(bits, block, ef))
            for n in (0, 1, p.block - 1, p.block, p.block + 1, 4099):
                assert pcomp.quant_wire_layout(n, p) == \
                    jcomp.quant_wire_layout(n, jcomp.QuantSpec(*p))
    monkeypatch.setenv("HOROVOD_QUANT_BLOCK", "33")
    monkeypatch.setenv("HOROVOD_QUANT_EF", "no")
    assert tuple(pcomp.make_quant_spec(bits)) == \
        tuple(jcomp.make_quant_spec(bits))
    assert tuple(pcomp.make_cast_spec()) == tuple(jcomp.make_cast_spec())
    assert pcomp.WIRE_MODES == jcomp.WIRE_MODES
    with pytest.raises(ValueError, match="8 or 4 bits"):
        pcomp.make_quant_spec(16)


FALLBACK_NAMES = ["allreduce.layer.weight", "blocks.0.ln1", "Encoder.BN.3",
                  "head.bias", "emb", "w.gamma", "x.beta", "my_embedding_scale",
                  "customthing", ""]


@pytest.mark.parametrize("optout", ["", "Custom, bias ,,EMB"])
def test_fallback_reasons_match_jax(monkeypatch, optout):
    """The same reason for every name, size and dtype, but bf16: numpy
    gives ml_dtypes' bfloat16 kind "V", so the JAX package keeps bf16
    tensors off the wire as ``non_float`` (and builds no compressed plan
    for a bf16 chunk); the port takes bf16 as the float it is (ROADMAP.md
    queue 3)."""
    monkeypatch.setenv("HOROVOD_QUANT_OPTOUT", optout)
    monkeypatch.setenv("HOROVOD_QUANT_MIN_ELEMS", "100")
    assert pcomp.quant_optout_patterns() == jcomp.quant_optout_patterns()
    assert pcomp.quant_min_elems() == jcomp.quant_min_elems() == 100
    pats = pcomp.quant_optout_patterns()
    for name in FALLBACK_NAMES:
        for size in (0, 99, 100, 5000):
            for pt, jt in ((torch.float32, "float32"),
                           (torch.float16, "float16"), (torch.int32, "int32"),
                           (torch.uint8, "uint8")):
                assert pcomp.quant_fallback_reason(name, size, pt, pats, 100) \
                    == jcomp.quant_fallback_reason(name, size, jt, pats, 100)
            assert jcomp.quant_fallback_reason(name, size, "bfloat16", pats,
                                               100) == "non_float"
            assert pcomp.quant_fallback_reason(
                name, size, torch.bfloat16, pats, 100) == \
                jcomp.quant_fallback_reason(name, size, "float32", pats, 100)


# --- the format, bit for bit ------------------------------------------------

def _special_flat(n: int, block: int, qmax: float, seed: int) -> np.ndarray:
    """Random values; where the length allows, an all-zero block, a block
    whose absmax recurs at both signs, a block of exact .5 ties of
    x / scale (absmax qmax * 0.5: the bf16 scale is 0.5) and a block whose
    absmax lands the scale where the reciprocal rule and a true division
    round differently in bf16 (int4)."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    if n >= 4 * block:
        x[:block] = 0
        sat = x[block:2 * block]
        sat[::3], sat[1::3] = 5.0, -5.0
        k = np.arange(block) % int(qmax)
        x[2 * block:3 * block] = (k + 0.5) * 0.5 * np.where(k % 2, -1, 1)
        x[2 * block] = qmax * 0.5
        pin = x[3 * block:4 * block]
        pin[:] = np.clip(pin, -2.5, 2.5)
        pin[5] = np.float32(2.9326172)
    return x


QUANT_CASES = [(bits, block, which) for bits in (8, 4)
               for block in (8, 9, 256, 1000)
               for which in ("one", "block-1", "block+1", "many")]


@pytest.mark.parametrize("bits,block,which", QUANT_CASES)
def test_quantize_blockwise_bitwise_matches_jax(bits, block, which):
    p = pcomp.make_quant_spec(bits, block, True)
    j = jcomp.QuantSpec(*p)
    n = {"one": 1, "block-1": p.block - 1, "block+1": p.block + 1,
         "many": 8 * p.block + 3}[which]
    x = _special_flat(n, p.block, p.qmax, bits * 1000 + block)
    jq, js = jax.jit(lambda a: jcomp.quantize_blockwise(a, j))(
        jnp.asarray(x))
    pq, ps = pcomp.quantize_blockwise(torch.from_numpy(x), p)
    np.testing.assert_array_equal(_bits(jq), _bits(pq.numpy()))
    np.testing.assert_array_equal(_bits(js), _bits(_to_np(ps)))
    jd = jax.jit(lambda q, s: jcomp.dequantize_blockwise(q, s, j, n))(jq, js)
    pd = pcomp.dequantize_blockwise(pq, ps, p, n)
    np.testing.assert_array_equal(_bits(jd), _bits(pd.numpy()))


def test_scale_is_absmax_times_the_reciprocal_of_qmax():
    """Under jit XLA turns ``absmax / 7`` into ``absmax * fp32(1/7)``: at
    absmax 2.9326172 the quotient is a bf16 tie (0.41796875) and the
    product rounds up (0.419921875). The port follows the product."""
    p = pcomp.make_quant_spec(4, 8, True)
    x = np.zeros(8, np.float32)
    x[3] = np.float32(2.9326172)
    _, js = jax.jit(lambda a: jcomp.quantize_blockwise(
        a, jcomp.QuantSpec(*p)))(jnp.asarray(x))
    _, ps = pcomp.quantize_blockwise(torch.from_numpy(x), p)
    assert float(np.asarray(js)[0]) == float(ps[0]) == 0.419921875
    assert float(np.float32(x[3] / np.float32(7.0)).astype(
        ml_dtypes.bfloat16)) == 0.41796875


def test_fma32_rounds_once():
    """``fma32`` against the exact value, rounded once (fractions)."""
    from fractions import Fraction

    rs = np.random.RandomState(3)
    a = rs.randn(4000).astype(np.float32)
    c = (rs.randn(4000) * 1e-3).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is a midpoint of the fp32 grid: a
    # tiny c decides the rounding, which an fp64 sum alone loses
    a[:8] = np.float32(1 + 2 ** -12)
    c[:8] = np.float32(2 ** -60) * np.array([1, -1] * 4, np.float32)
    b = 1 + 2 ** -12
    got = qw.fma32(torch.from_numpy(a), b, torch.from_numpy(c)).numpy()
    bf = Fraction(float(np.float32(b)))
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * bf + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the nearest fp32 to the exact value, ties to even
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        near = [v for v, d in zip(cands, dist) if d == best]
        want = near[0] if len(near) == 1 else min(
            near, key=lambda v: int(np.array(v).view(np.uint32)) & 1)
        assert got[i] == want, i


# --- the simulated plans against the JAX plans -------------------------------

PLAN_SIZES = (5000, 37, 3000, 1)
PLAN_SHAPES = ((50, 100), (37,), (3000,), (1,))
WIRES = {"int8": (8, 256, True), "int4": (4, 256, True),
         "int8-no-ef": (8, 256, False), "bf16": (16, 1, False)}
COMBOS = [(1, 1.0, 1.0, np.float32), (0, 0.7, 0.7, np.float32),
          (0, 1.0, 0.7, ml_dtypes.bfloat16), (1, 0.7, 0.5, ml_dtypes.bfloat16)]


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("combo", range(len(COMBOS)))
def test_sim_plan_bitwise_matches_jax(world, wire, combo):
    op, pre, post, dt = COMBOS[combo]
    spec = WIRES[wire]
    names = [f"s{world}.{wire}.{combo}.{i}" for i in range(len(PLAN_SIZES))]
    jdt = "float32" if dt is np.float32 else "bfloat16"
    pdt = torch.float32 if dt is np.float32 else torch.bfloat16
    jplan = jcoll.quant_sim_chunk_plan(
        world, jcoll.ReduceOp(op), pre, post, names, PLAN_SIZES, PLAN_SHAPES,
        jdt, jcomp.QuantSpec(*spec))
    pplan = pcoll.quant_sim_chunk_plan(
        world, op, pre, post, names, PLAN_SIZES, PLAN_SHAPES, pdt,
        pcomp.QuantSpec(*spec))
    assert pplan is pcoll.quant_sim_chunk_plan(
        world, op, pre, post, names, PLAN_SIZES, PLAN_SHAPES, pdt,
        pcomp.QuantSpec(*spec))
    assert (pplan.flat_size, pplan.wire_bytes, pplan.pre_bytes) == (
        jplan.flat_size, jplan.wire_bytes, jplan.pre_bytes)
    rs = np.random.RandomState(world * 100 + combo)
    jres = pres = None
    for _ in range(3 if spec[2] else 1):
        ins = [[(rs.randn(*s) * (r + 1)).astype(np.float32).astype(dt)
                for s in PLAN_SHAPES] for r in range(world)]
        jin = [[jnp.asarray(a) for a in r] for r in ins]
        pin = [[_from_np(a) for a in r] for r in ins]
        if spec[0] == 16:
            jout = jplan.execute_simulated(jin)
            pout = pplan.execute_simulated(pin)
        else:
            assert pplan.n_blocks == jplan.n_blocks
            jout, jres = jplan.execute_simulated(jin, jres)
            pout, pres = pplan.execute_simulated(pin, pres)
            for jr, pr in zip(jres, pres):
                if spec[2]:
                    np.testing.assert_array_equal(_bits(jr), _bits(pr.numpy()))
                else:
                    assert jr is None and pr is None
        for j, p in zip(jout, pout):
            assert tuple(p.shape) == tuple(j.shape) and p.dtype == pdt
            np.testing.assert_array_equal(_bits(j), _bits(_to_np(p)))


def test_reduce_factor_folds_the_mean_and_the_postscale():
    """At N = 3 the folded constant fp32(fp32(1/3) * fp32(0.7)) gives
    other bits than dividing by 3 or multiplying by fp32(1/3) and then by
    0.7, so the simulated plans at N = 3 pin it."""
    f = qw.reduce_factor(True, 3, 0.7)
    assert f == float(np.float32(np.float32(1 / 3) * np.float32(0.7)))
    xs = np.random.RandomState(0).randn(1000).astype(np.float32)
    folded = xs * np.float32(f)
    assert (folded != (xs / np.float32(3)) * np.float32(0.7)).any()
    assert (folded != (xs * np.float32(1 / 3)) * np.float32(0.7)).any()
    assert qw.reduce_factor(True, 4, 1.0) == 0.25
    assert qw.reduce_factor(False, 3, 1.0) is None
    assert qw.reduce_factor(False, 3, 0.5) == 0.5


def test_launch_ranges_cut_at_blocks_and_tables():
    sizes = [3] * 300
    ranges = qw._launch_ranges(sizes, 8, 904)
    assert ranges[0][0] == 0 and ranges[-1][1] == 904
    for (a, b, idx), (c, _, _) in zip(ranges, ranges[1:]):
        assert b == c and b % 8 == 0 and len(idx) <= qw.MAX_SEGS
    covered = sorted({i for _, _, idx in ranges for i in idx})
    assert covered == list(range(300))
    # empty tensors are left out of every table
    assert qw._launch_ranges([0, 5, 0, 4], 1, 9) == [(0, 9, [1, 3])]
    with pytest.raises(ValueError, match="spans more than"):
        qw._launch_ranges([1] * 200, 256, 256)


def test_wire_entries_refuse_other_devices():
    t = torch.empty(8, device="meta")
    row = torch.empty(16, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        qw.cast_pack([t], row)
    with pytest.raises(ValueError, match="one float dtype"):
        qw.cast_pack([torch.ones(4, dtype=torch.int32)],
                     torch.empty(8, dtype=torch.uint8))
    spec = pcomp.make_quant_spec(8, 8, True)
    r = torch.zeros(8)
    with pytest.raises(ValueError, match="must not share memory"):
        qw.quantize_pack([torch.ones(8)], torch.empty(10, dtype=torch.uint8),
                         spec, 1.0, r, r)


# --- the redesigned kernels' host-side rules, and their arithmetic ----------
#
# The kernels run only on the card; these hold the rules the wrappers and
# chip_smoke.py apply around them, and the kernels' arithmetic emulated in
# numpy step by step, against the plain versions.

MAGIC = np.float32(12582912.0)  # 1.5 * 2^23, csrc/quant_wire.cu kMagic


def test_reduce_launches_cut_at_runs():
    """The reduce-unpack's launches cut the chunk at multiples of ``RUN``
    (a run is one thread's), each table within ``MAX_SEGS`` tensors."""
    rs = np.random.RandomState(5)
    sizes = [int(n) for n in rs.randint(0, 70, 300)]
    total = sum(sizes)
    ranges = qw._launch_ranges(sizes, qw.RUN, total)
    assert len(ranges) > 1 and ranges[0][0] == 0 and ranges[-1][1] == total
    starts = np.cumsum([0] + sizes)
    for (a, b, idx), (c, _, _) in zip(ranges, ranges[1:]):
        assert b == c and b % qw.RUN == 0 and len(idx) <= qw.MAX_SEGS
    for a, b, idx in ranges:
        # every element of the range lies in a tensor of its table
        assert starts[idx[0]] <= a and starts[idx[-1] + 1] >= b


@pytest.mark.parametrize("addr,nbytes,width", [
    (0, 32, 16), (16, 16, 16), (8, 16, 8), (8, 8, 8), (0, 8, 8),
    (4, 16, 4), (12, 8, 4), (6, 16, 2), (2, 8, 2), (1, 16, 1), (7, 8, 1),
    (0, 4, 4), (2, 4, 2), (3, 64, 1), (32, 64, 16), (40, 64, 8)])
def test_access_width_follows_alignment(addr, nbytes, width):
    assert qw.access_width(addr, nbytes) == width


@pytest.mark.parametrize("bits,nblocks,widths", [
    (8, 3, [16, 2, 4, 2]),     # rows of 774 bytes: 774 % 16 = 6
    (8, 4, [16, 8, 16, 8]),    # 1032 bytes
    (4, 3, [8, 2, 4, 2]),      # 390 bytes; a run is 8 bytes
    (16, 0, [16, 2, 4, 2])])   # bf16 rows of 2 * 513 elements
def test_row_load_widths_of_rows_that_start_misaligned(bits, nblocks,
                                                       widths):
    if bits == 16:
        nb = qw.row_bytes(513, pcomp.make_cast_spec())
    else:
        spec = pcomp.make_quant_spec(bits, 256, True)
        nb = qw.row_bytes(nblocks * 256, spec)
    assert qw.row_load_widths(1 << 20, nb, 4, bits) == widths


def _block_paths_walk(sizes, idx, ptrs, res_ptrs, item, block, total, b0,
                      b1, ef, res_out):
    """The kernel's rule block by block (``register_path`` after
    ``find_seg`` over the launch's table, the tensors ``idx``)."""
    starts = np.cumsum([0] + list(sizes))
    reg = 0
    for b in range(b0, b1):
        base = b * block
        k = max([k for k, i in enumerate(idx) if starts[i] <= base],
                default=0)
        seg = idx[k]
        if block != qw.REG_BLOCK or base + block > min(total,
                                                       starts[seg + 1]):
            continue
        j = base - starts[seg]
        if (ptrs[k] + j * item) % 16:
            continue
        if ef:
            r = res_ptrs[k] if res_ptrs else 0
            if res_out % 16 or (r and (r + j * 4) % 16):
                continue
        reg += 1
    return reg, (b1 - b0) - reg


@pytest.mark.parametrize("sizes,mis,item,ef,res_mis,out_mis,want", [
    ([769], 0, 4, False, 0, 0, (3, 1)),      # the padding block: general
    ([300, 500], 0, 4, False, 0, 0, (2, 2)),  # block 1 straddles
    ([1000, 3000], 1, 4, False, 0, 0, (0, 16)),  # a start 1 element in
    ([1000, 3000], 4, 4, False, 0, 0, (14, 2)),  # 4 elements: 16 bytes
    ([1000, 3000], 2, 2, False, 0, 0, (0, 16)),  # bf16, 4 bytes in
    ([1000, 3000], 8, 2, False, 0, 0, (14, 2)),  # bf16, 16 bytes in
    ([512, 256], 0, 4, True, 0, 0, (3, 0)),
    ([512, 256], 0, 4, True, 1, 0, (1, 2)),   # tensor 0's residual
    ([512, 256], 0, 4, True, 0, 1, (0, 3)),   # the new residual
    ([512, 256], 0, 8, True, 0, 0, (3, 0))])  # fp64
def test_quantize_block_paths_count_by_the_kernel_rule(
        sizes, mis, item, ef, res_mis, out_mis, want):
    """Tensors allocated 256-byte aligned and started ``mis`` elements in;
    residuals of tensor 0 ``res_mis`` elements in, the new residual
    ``out_mis``."""
    total = sum(sizes)
    nblocks = -(-total // 256)
    ptrs = [(i + 1) * (1 << 20) + mis * item for i in range(len(sizes))]
    res = [(i + 9) * (1 << 20) + (res_mis * 4 if i == 0 else 0)
           for i in range(len(sizes))]
    out = (1 << 30) + out_mis * 4
    idx = list(range(len(sizes)))
    starts = [0, *itertools.accumulate(sizes)]
    got = qw.quantize_block_paths(starts, idx, ptrs, res, item, 256, total,
                                  0, nblocks, ef, out)
    assert got == want
    assert got == _block_paths_walk(sizes, idx, ptrs, res, item, 256, total,
                                    0, nblocks, ef, out)


@pytest.mark.parametrize("seed", range(6))
def test_quantize_block_paths_match_a_walk_of_every_block(seed):
    """Random chunks (empty tensors, residuals missing, misaligned
    starts) cut into the wrapper's launches: the arithmetic count equals
    the kernel's rule applied block by block, launch by launch."""
    rs = np.random.RandomState(seed)
    sizes = [int(rs.choice([0, 3, 256, 300, 512, 1000, 4096]))
             for _ in range(rs.randint(1, 200))]
    total = sum(sizes)
    if total == 0:
        sizes, total = [256], 256
    item = int(rs.choice([2, 4, 8]))
    ef = bool(seed % 2)
    ptrs = [(i + 1) * (1 << 16) + int(rs.choice([0, 0, 0, 1, 2])) * item
            for i in range(len(sizes))]
    res = [0 if rs.rand() < 0.3 else (i + 1) * (1 << 24)
           + 4 * int(rs.choice([0, 0, 1])) for i in range(len(sizes))]
    out = 1 << 40
    padded = -(-total // 256) * 256
    starts = [0, *itertools.accumulate(sizes)]
    reg = gen = 0
    for e0, e1, idx in qw._launch_ranges(sizes, 256, padded):
        b0, b1 = e0 // 256, -(-e1 // 256)
        got = qw.quantize_block_paths(
            starts, idx, [ptrs[i] for i in idx], [res[i] for i in idx], item,
            256, total, b0, b1, ef, out)
        want = _block_paths_walk(
            sizes, idx, [ptrs[i] for i in idx], [res[i] for i in idx], item,
            256, total, b0, b1, ef, out)
        assert got == want
        reg, gen = reg + got[0], gen + got[1]
    assert reg + gen == padded // 256


def _emulate_reduce_unpack(gathered, sizes, spec, nrows, factor):
    """csrc/quant_wire.cu reduce_unpack_kernel over one launch of the
    whole chunk, in numpy: runs of ``RUN`` elements from element 0; a run
    in range (and blocks of at least a run) takes reduce_run's arithmetic
    (the run's block by a shift or a division, the scale split where the
    block size is not a multiple of ``RUN``, an int8/int4 value's offset
    byte placed in 1.5 * 2^23's mantissa by ``__byte_perm``, the int4
    nibbles split into even and odd bytes first, acc + q * scale as one
    fused multiply-add, which q * scale's exactness makes one fp32 add),
    the others ``deq`` element by element. Returns (the fp32 results, runs
    taken whole)."""
    total = sum(sizes)
    bits, block = spec.bits, spec.block
    rows = gathered.reshape(nrows, -1)
    payload = 0 if bits == 16 else pcomp.quant_wire_layout(total, spec)[2]

    def scale(r, b):
        lo, hi = rows[r, payload + 2 * b], rows[r, payload + 2 * b + 1]
        return np.uint32((int(hi) << 8 | int(lo)) << 16).view(np.float32)

    def deq(r, e):  # the general path's element
        if bits == 16:
            v = int(rows[r, 2 * e]) | int(rows[r, 2 * e + 1]) << 8
            return np.uint32(v << 16).view(np.float32)
        if bits == 8:
            q = int(np.uint8(rows[r, e]).view(np.int8))
        else:
            byte = int(rows[r, e >> 1])
            q = ((((byte >> 4) if e & 1 else byte) & 0xF) ^ 8) - 8
        return np.float32(q) * scale(r, e // block)

    def byte_perm(x, y, sel):  # __byte_perm without the sign modes
        src = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
              [(y >> (8 * k)) & 0xFF for k in range(4)]
        return sum(src[(sel >> (4 * k)) & 7] << (8 * k) for k in range(4))

    def run_q(r, a):  # run_bytes, run_offset_value, less the offset
        nb = qw.RUN * bits // 8
        raw = rows[r, a * bits // 8:a * bits // 8 + nb]
        w = [int(raw[4 * k]) | int(raw[4 * k + 1]) << 8
             | int(raw[4 * k + 2]) << 16 | int(raw[4 * k + 3]) << 24
             for k in range(nb // 4)]
        if bits == 8:
            u = [x ^ 0x80808080 for x in w]
            word = [u[i // 4] for i in range(qw.RUN)]
            byte = [i % 4 for i in range(qw.RUN)]
            off = MAGIC + np.float32(128)
        else:
            u = []
            for x in w:
                x ^= 0x88888888
                u += [x & 0x0F0F0F0F, (x >> 4) & 0x0F0F0F0F]
            word = [u[2 * (i // 8) + (i & 1)] for i in range(qw.RUN)]
            byte = [(i % 8) // 2 for i in range(qw.RUN)]
            off = MAGIC + np.float32(8)
        return [np.uint32(byte_perm(word[i], 0x4B400000, 0x7640 | byte[i]))
                .view(np.float32) - off for i in range(qw.RUN)]

    out = np.zeros(total, np.float32)
    whole = 0
    for a in range(0, total, qw.RUN):
        b = min(total, a + qw.RUN)
        if b - a == qw.RUN and (bits == 16 or block >= qw.RUN):
            whole += 1
            if bits != 16:
                b0 = (a >> (block.bit_length() - 1) if not block & (block - 1)
                      else a // block)
                split = (qw.RUN if block % qw.RUN == 0
                         else min((b0 + 1) * block - a, qw.RUN))
            acc = np.zeros(qw.RUN, np.float32)
            for r in range(nrows):
                qs = None if bits == 16 else run_q(r, a)
                for i in range(qw.RUN):
                    if bits == 16:
                        x = deq(r, a + i)
                        acc[i] = x if r == 0 else acc[i] + x
                        continue
                    sc = scale(r, b0 if i < split else b0 + 1)
                    assert sc <= 2.0 ** 120  # else the kernel takes deq
                    p = qs[i] * sc  # exact
                    acc[i] = p if r == 0 else acc[i] + p
            out[a:b] = acc
        else:
            for e in range(a, b):
                acc = deq(0, e)
                for r in range(1, nrows):
                    acc = acc + deq(r, e)
                out[e] = acc
    if factor is not None:
        out = out * np.float32(factor)
    return out, whole


@pytest.mark.parametrize("wire,block", [(16, 256), (8, 256), (4, 256),
                                        (8, 1000), (8, 9), (4, 10),
                                        (8, 16), (4, 16)])
def test_reduce_run_arithmetic_matches_the_plain_version(wire, block):
    """The reduce-unpack's run arithmetic, emulated, against
    ``plain_reduce_unpack`` bit for bit, at 3 ranks, AVERAGE with a
    postscale, over tensors whose boundaries cut runs and blocks."""
    spec = (pcomp.make_cast_spec() if wire == 16
            else pcomp.make_quant_spec(wire, block, False))
    sizes = [3 * 256 + 5, 7, 2 * 256 + 1, 40]
    total, nrows = sum(sizes), 3
    rs = np.random.RandomState(wire + block)
    nb = qw.row_bytes(total, spec)
    gathered = torch.empty(nrows * nb, dtype=torch.uint8)
    for r in range(nrows):
        ts = [torch.from_numpy(rs.randn(n).astype(np.float32))
              for n in sizes]
        if wire == 16:
            qw.plain_cast_pack(ts, gathered[r * nb:(r + 1) * nb])
        else:
            qw.plain_quantize_pack(ts, gathered[r * nb:(r + 1) * nb], spec)
    f = qw.reduce_factor(True, nrows, 0.5)
    outs = [torch.empty(n) for n in sizes]
    qw.plain_reduce_unpack(gathered, outs, spec, nrows, True, 0.5)
    got, whole = _emulate_reduce_unpack(gathered.numpy(), sizes, spec,
                                        nrows, f)
    assert _bits(got).tolist() == _bits(torch.cat(outs).numpy()).tolist()
    assert whole == (0 if block < qw.RUN else total // qw.RUN)


def _stage_slot(k_vecs, lane, k):
    """csrc/quant_wire.cu stage_slot."""
    return lane * k_vecs + (k ^ ((lane // (8 // k_vecs)) & (k_vecs - 1)))


@pytest.mark.parametrize("k_vecs", [2, 4, 8])
def test_staged_stores_permute_pieces_without_bank_conflicts(k_vecs):
    """The reduce-unpack's staging area for a warp's stores (16-byte pieces
    a run: 2 for bf16/fp16 outputs, 4 for fp32, 8 for fp64): a
    permutation of its slots; each quarter-warp's 8 writes of piece k, and
    its 8 reads of consecutive pieces, meet 8 different bank groups (a
    16-byte slot's group is its index mod 8); and read slot
    ``k * 32 + lane`` returns the piece lane ``c // k_vecs`` wrote as its
    ``c % k_vecs``."""
    n = 32 * k_vecs
    written = {_stage_slot(k_vecs, lane, k): (lane, k)
               for lane in range(32) for k in range(k_vecs)}
    assert sorted(written) == list(range(n))
    for k in range(k_vecs):
        for q in range(4):
            lanes = range(8 * q, 8 * q + 8)
            assert len({_stage_slot(k_vecs, ln, k) % 8 for ln in lanes}) == 8
            reads = [_stage_slot(k_vecs, c // k_vecs, c % k_vecs)
                     for c in (k * 32 + ln for ln in lanes)]
            assert len({r % 8 for r in reads}) == 8
            for ln, r in zip(lanes, reads):
                c = k * 32 + ln
                assert written[r] == (c // k_vecs, c % k_vecs)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_register_quantize_arithmetic_matches_the_plain_version(bits, ef):
    """K3's register path emulated on blocks of 256 (lane l holds elements
    8l .. 8l + 7; q's bits from q + 1.5 * 2^23; int4 nibbles packed within
    the lane, low first; the residual from the integer's value) against
    ``plain_quantize_pack``: payload, scales and residual bit for bit,
    with the special blocks (zeros, saturation, exact ties, -0)."""
    spec = pcomp.make_quant_spec(bits, 256, ef)
    qmax = np.float32(spec.qmax)
    rs = np.random.RandomState(bits)
    x = rs.randn(4 * 256).astype(np.float32)
    x[:256] = 0
    x[256:512:3], x[257:512:3] = 5.0, -5.0
    k = np.arange(256) % int(qmax)
    x[512:768] = (k + 0.5) * 0.5 * np.where(k % 2 == 0, 1.0, -1.0)
    x[512] = qmax * 0.5
    x[768:784] = -0.0
    res = (rs.randn(x.size).astype(np.float32) * 0.01) if ef else None
    row = torch.empty(qw.row_bytes(x.size, spec), dtype=torch.uint8)
    new = torch.empty(x.size) if ef else None
    qw.plain_quantize_pack([torch.from_numpy(x.copy())], row, spec, 1.0,
                           None if res is None else [torch.from_numpy(res)],
                           new)
    xs = x + res if ef else x
    pay = np.zeros(x.size * bits // 8, np.uint8)
    scales = np.zeros(2 * (x.size // 256), np.uint8)
    nres = np.zeros(x.size, np.float32)
    inv = np.float32(1.0) / qmax
    for b in range(x.size // 256):
        blk = xs[256 * b:256 * (b + 1)]
        amax = np.float32(np.abs(blk).max())
        sc = amax * inv if amax > 0 else np.float32(1.0)
        sbits = int(_bits(np.array([sc], ml_dtypes.bfloat16))[0])
        eff = np.uint32(sbits << 16).view(np.float32)
        scales[2 * b], scales[2 * b + 1] = sbits & 0xFF, sbits >> 8
        for lane in range(32):
            w = 0
            for i in range(8):
                xi = blk[8 * lane + i]
                q = np.clip(np.rint(xi / eff), -qmax, qmax).astype(np.float32)
                m = q + MAGIC
                qb = int(_bits(np.array([m], np.float32))[0])
                nres[256 * b + 8 * lane + i] = xi - (m - MAGIC) * eff
                w |= (qb & (0xFF if bits == 8 else 0xF)) << (bits * i)
            nbytes = bits  # 8 values of `bits` bits
            for k2 in range(nbytes):
                pay[256 * b * bits // 8 + nbytes * lane + k2] = \
                    (w >> (8 * k2)) & 0xFF
    got = np.concatenate([pay, scales])
    assert got.tolist() == row.numpy().tolist()
    if ef:
        assert _bits(nres).tolist() == _bits(new.numpy()).tolist()


# --- residuals ----------------------------------------------------------------

SIG8, SIG4 = ("quant", 8, 256, True), ("quant", 4, 256, True)


def test_residual_store_resets_on_generation_and_shape(monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "2")
    st = pcomp.ResidualStore()
    assert st.get(["a", "b"], [4, 2], SIG8) is None
    st.commit(["a", "b"], [4, 2], SIG8, torch.arange(6.0))
    got = st.get(["a", "b"], [4, 2], SIG8)
    assert torch.equal(got[0], torch.arange(4.0))
    assert torch.equal(got[1], torch.tensor([4.0, 5.0]))
    assert len(st) == 2 and st.nbytes() == 24
    assert st.get(["a"], [5], SIG8) is None and len(st) == 1  # a stale shape
    assert st.residual("b", SIG8) is not None
    st.commit(["a"], [4], SIG8, torch.ones(4))
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "3")
    assert st.get(["a"], [4], SIG8) is None and len(st) == 0  # a resize
    st.commit(["a"], [4], SIG8, torch.ones(4))
    st.reset()
    assert len(st) == 0
    assert (st.hits, st.misses) == (2, 4)


def test_residual_store_keeps_one_residual_per_tensor():
    """A residual follows its tensor: after chunks {a, b} and {c}, the
    chunk {b, c} finds both, and committing it leaves a's in place; the
    other wire's residuals are its own."""
    st = pcomp.ResidualStore()
    st.commit(["a", "b"], [4, 2], SIG8, torch.arange(6.0))
    st.commit(["c"], [2], SIG8, torch.full((2,), 7.0))
    st.commit(["a", "b"], [4, 2], SIG4, torch.zeros(6))
    got = st.get(["b", "c"], [2, 2], SIG8)
    assert torch.equal(torch.cat(got), torch.tensor([4.0, 5.0, 7.0, 7.0]))
    st.commit(["b", "c"], [2, 2], SIG8, torch.full((4,), 9.0))
    assert torch.equal(st.residual("a", SIG8), torch.arange(4.0))
    assert torch.equal(st.residual("b", SIG8), torch.full((2,), 9.0))
    assert torch.equal(st.residual("b", SIG4), torch.zeros(2))
    assert len(st) == 5 and st.nbytes() == 4 * (4 + 2 + 2 + 4 + 2)
    assert st.get(["d", "a"], [3, 4], SIG8)[0] is None


@pytest.mark.parametrize("pre", [1.0, 0.7])
@pytest.mark.parametrize("bits", [8, 4])
def test_per_tensor_residuals_fold_as_a_flat_one(bits, pre):
    """K3's plain version takes the residual one a tensor (None: zeros),
    and packs what the flat residual of the chunk packs, bit for bit."""
    spec = pcomp.make_quant_spec(bits, 256, True)
    rs = np.random.RandomState(bits)
    ts = [torch.from_numpy(rs.randn(n).astype(np.float32))
          for n in (300, 5, 700)]
    parts = [torch.from_numpy(rs.randn(300).astype(np.float32) * 0.01),
             None, torch.from_numpy(rs.randn(700).astype(np.float32) * 0.01)]
    flat = torch.cat([torch.zeros(5) if p is None else p for p in parts])
    nb = qw.row_bytes(1005, spec)
    outs = []
    for res in (parts, flat):
        row, new = torch.empty(nb, dtype=torch.uint8), torch.empty(1005)
        qw.quantize_pack(ts, row, spec, pre, res, new)
        outs.append((row, new))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].view(torch.int32),
                       outs[1][1].view(torch.int32))
    with pytest.raises(ValueError, match="2 residuals for 3 tensors"):
        qw.quantize_pack(ts, torch.empty(nb, dtype=torch.uint8), spec, pre,
                         parts[:2], torch.empty(1005))
    with pytest.raises(ValueError, match="must not share memory"):
        qw.quantize_pack(ts, torch.empty(nb, dtype=torch.uint8), spec, pre,
                         [None, None, flat[305:]], flat)


def _private_runtime(**cfg):
    ps = context.global_process_set()
    return pqueue.BackgroundRuntime(ps, RuntimeConfig(**cfg),
                                    torch.device("cpu"), ps.group)


class _FakeSet:
    """A process set of two ranks, for the split's rules in one process."""

    name = "global"
    size = 2


def _entry(name, t, **kw):
    return pqueue.TensorEntry(name=name, op="allreduce", tensor=t, output=t,
                              reduce_op=pcoll.Sum, **kw)


def test_residual_committed_only_after_a_dispatch_succeeded(port):
    """The runtime's quantized dispatch through a simulated plan of two
    ranks: the first dispatch commits its residual; a dispatch that fails
    after the residual was read leaves it in place, and its entries fail;
    the next one folds the residual committed before the failure."""
    rt = _private_runtime(compression="int8")
    spec = pcomp.make_quant_spec(8, 256, True)
    rt._quant_split([_entry("x.a", torch.ones(4096))], spec)  # set up
    plan = pcoll.quant_sim_chunk_plan(2, pcoll.Sum, 1.0, 1.0, ["x.a"],
                                      [5000], [(5000,)], torch.float32, spec)
    state = {"fail": False, "seen": []}

    class Flaky(pcoll.QuantFusedChunkPlan):
        def execute(self, inputs, outputs, residual=None):
            state["seen"].append(residual)
            if state["fail"]:
                raise RuntimeError("injected")
            outs, new = plan.execute_simulated([inputs, inputs],
                                               [residual, residual])
            for o, p in zip(outputs, outs):
                o.copy_(p)
            return new[0]

    flaky = Flaky.__new__(Flaky)
    for f in pcoll._WireChunkPlan.__slots__:
        setattr(flaky, f, getattr(plan, f))
    rt._chunk_plan = lambda chunk, quant=None: flaky
    store = rt._quant_residuals
    x = torch.from_numpy(np.random.RandomState(5).randn(5000)
                         .astype(np.float32))
    sig = spec.signature()

    def dispatch():
        t = x.clone()
        e = _entry("x.a", t)
        e.handle = rt.handles.allocate()
        rt._run_quant_allreduce([e], spec)
        return e

    dispatch()
    first = store.residual("x.a", sig)
    assert first is not None and state["seen"][-1] is None
    state["fail"] = True
    e = dispatch()
    assert state["seen"][-1][0] is first
    assert store.residual("x.a", sig) is first  # not replaced
    with pytest.raises(Exception, match="injected"):
        rt.handles.wait(e.handle)
    state["fail"] = False
    dispatch()
    assert state["seen"][-1][0] is first
    assert store.residual("x.a", sig) is not first


def _fallbacks(reason):
    return pmetrics.get_registry().counter_value("hvd_quant_fallback_total",
                                                 reason=reason)


def test_quant_split_matrix_counts_each_tensor_once(port):
    rt = _private_runtime(compression="int8", quant_optout="skipme")
    spec = rt._quant
    group = [_entry("m.w", torch.ones(5000)),
             _entry("m.bias", torch.ones(5000)),
             _entry("m.small", torch.ones(100)),
             _entry("m.skipme.w", torch.ones(5000)),
             _entry("m.int", torch.ones(5000, dtype=torch.int32)),
             _entry("m.w2", torch.ones(9000, dtype=torch.bfloat16))]
    for e in group:
        e.process_set = _FakeSet()
    before = {r: _fallbacks(r) for r in ("optout_match", "small_leaf",
                                         "non_float")}
    for _ in range(3):
        quant, plain = rt._quant_split(group, spec)
        assert [e.name for e in quant] == ["m.w", "m.w2"]
        assert [e.name for e in plain] == ["m.bias", "m.small", "m.skipme.w",
                                           "m.int"]
    after = {r: _fallbacks(r) for r in before}
    assert {r: after[r] - before[r] for r in before} == {
        "optout_match": 2, "small_leaf": 1, "non_float": 1}


def test_world_of_one_sends_no_wire(port):
    """At one rank the whole group stays uncompressed (reason
    ``world_size``, counted once per tensor over two cycles), and the
    result is the uncompressed one."""
    rt = _private_runtime(compression="int4")
    before = _fallbacks("world_size")
    xs = [torch.from_numpy(np.random.RandomState(i).randn(5000)
                           .astype(np.float32)) for i in range(3)]
    for _ in range(2):
        hs = [rt.enqueue(_entry(f"w1.{i}", x.clone()))
              for i, x in enumerate(xs)]
        rt.run_cycle()
        for h, x in zip(hs, xs):
            assert torch.equal(rt.handles.wait(h), x)
    assert _fallbacks("world_size") - before == 3
    assert rt._quant_residuals is not None and len(rt._quant_residuals) == 0


def test_allreduce_with_a_marker_falls_back_at_one_rank(port):
    """The front end's int8 marker at a world of one: the uncompressed
    result, one ``world_size`` fallback."""
    before = _fallbacks("world_size")
    x = torch.arange(5000, dtype=torch.float32)
    out = hvd.allreduce(x, name="marker.q", op=hvd.Sum,
                        compression=hvd.Compression.int8)
    assert torch.equal(out, x) and _fallbacks("world_size") - before == 1


def test_runtime_reads_the_guardrails_from_its_config(port, monkeypatch):
    """The opt-outs and the small-leaf threshold come from the
    ``RuntimeConfig`` that ``init`` parsed from the environment."""
    monkeypatch.setenv("HOROVOD_QUANT_OPTOUT", "Foo, bar")
    monkeypatch.setenv("HOROVOD_QUANT_MIN_ELEMS", "77")
    rt = pqueue.BackgroundRuntime(
        context.global_process_set(), RuntimeConfig.from_env(),
        torch.device("cpu"), context.global_process_set().group)
    assert rt._quant_optout == pcomp.DEFAULT_OPTOUT_PATTERNS + ("foo", "bar")
    assert rt._quant_min_elems == 77
    assert _private_runtime()._quant_optout == pcomp.DEFAULT_OPTOUT_PATTERNS


# --- the zero-cost contract ----------------------------------------------------

ZERO_COST = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.utils import metrics

    def run():
        hvd.init(device="cpu")
        p = torch.nn.Parameter(torch.zeros(5000))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                       named_parameters=[("p", p)])
        p.grad = torch.ones(5000)
        opt.step()
        hvd.grouped_allreduce([torch.ones(5000), torch.ones(3)], name="g")
        keys = sorted(map(repr, C._PLANS))
        hvd.shutdown()
        return keys

    off = run()
    names = metrics.get_registry().names()
    assert not [n for n in names if n.startswith(("hvd_quant_",
                                                  "hvd_compression_"))], names
    # the plain key, ending in the device type and the hierarchical
    # verdict (no wire signature after them)
    assert off and all(len(eval(k)) == 13 and eval(k)[-2:] == ("cpu", False)
                       for k in off), off
    os.environ["HOROVOD_COMPRESSION"] = "int8"
    on = run()
    assert on == off, (on, off)  # a world of one: the plain plans
    names = metrics.get_registry().names()
    assert "hvd_quant_fallback_total" in names, names
    print("ZERO_COST_OK")
""")


def test_zero_cost_when_the_knob_is_unset():
    out = subprocess.run([sys.executable, "-c", ZERO_COST], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0 and "ZERO_COST_OK" in out.stdout, (
        out.stdout + out.stderr)


# --- the repairs: knobs the port ignored -----------------------------------------

@pytest.mark.parametrize("knob", penv.UNIMPLEMENTED_KNOBS)
def test_init_warns_for_a_knob_the_port_does_not_implement(fresh, monkeypatch,
                                                           knob):
    assert hasattr(jenv, knob)  # the JAX package's name
    monkeypatch.setenv(knob, "1")
    with pytest.warns(RuntimeWarning, match=knob):
        hvd.init(device="cpu")


class _RoundRecorder:
    """A KV client that records the controller's PUTs and answers every
    response poll with an empty round."""

    def __init__(self):
        self.puts = []

    def put(self, scope, key, value):
        self.puts.append(value)

    def get(self, scope, key, timeout=30.0):
        return b'{"ready": [], "errors": {}, "sigs": {}, "join_done": null}'


class _SecondOfTwo:
    """Rank 1 of a set of two, so a runtime builds a controller (and, not
    being rank 0, no coordinator)."""

    name = "global"
    size = 2
    rank = 1


@pytest.mark.parametrize("knob", ["HOROVOD_HIER_NEGOTIATION",
                                  "HOROVOD_MEGAPLAN",
                                  "HOROVOD_HIERARCHICAL_ALLREDUCE",
                                  "HOROVOD_HIERARCHICAL_ALLGATHER"])
def test_init_runs_a_knob_the_port_now_implements(fresh, monkeypatch, knob):
    """The control-plane and two-level knobs are no longer warned about:
    set, each changes what the runtime runs. ``HOROVOD_MEGAPLAN`` makes the
    megaplan's manager, which the runtime resolves;
    ``HOROVOD_HIER_NEGOTIATION`` makes a controller advertise wire v2 in
    its first round; the two hierarchical knobs are read into the config,
    and at a world of one (no second level) the collectives stay flat."""
    assert hasattr(jenv, knob) and knob not in penv.UNIMPLEMENTED_KNOBS
    monkeypatch.setenv(knob, "1")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        hvd.init(device="cpu")
    assert not [w for w in seen if knob in str(w.message)]
    rt = context.runtime()
    if knob == "HOROVOD_MEGAPLAN":
        assert rt._mp is not None and hvd.megaplan_report()["enabled"]
        return
    if knob.startswith("HOROVOD_HIERARCHICAL_"):
        attr = knob[len("HOROVOD_"):].lower()
        assert getattr(context._ctx.config, attr)
        assert getattr(jenv.RuntimeConfig.from_env(), attr)
        ps = hvd.global_process_set()
        assert ps.hierarchy is None and ps.runtime_hierarchy is None
        assert pcoll.allreduce_hierarchy(ps, hvd.Sum) is None
        assert pcoll.allgather_hierarchy(ps) is None
        return
    assert context._ctx.config.hier_negotiation
    for on in (True, False):
        monkeypatch.setenv(knob, "1" if on else "0")
        config = RuntimeConfig.from_env()
        assert config.hier_negotiation is on
        kv = _RoundRecorder()
        ctl = rt._maybe_controller.__func__(
            types.SimpleNamespace(process_set=_SecondOfTwo()), config, kv)
        ctl.negotiate({})
        assert ("wv" in json.loads(kv.puts[0])) is on


def test_init_warns_not_for_knobs_turned_off(fresh, monkeypatch):
    for k in penv.UNIMPLEMENTED_KNOBS:
        monkeypatch.setenv(k, "0")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        hvd.init(device="cpu")
    assert not [w for w in seen if "HOROVOD_" in str(w.message)]


def test_unknown_compression_raises_at_init(fresh, monkeypatch):
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int3")
    with pytest.raises(ValueError) as jax_err:
        jcomp.resolve_quant_spec()
    with pytest.raises(ValueError) as err:
        hvd.init(device="cpu")
    assert str(err.value) == str(jax_err.value)
    assert str(err.value).startswith(
        "HOROVOD_COMPRESSION: unknown compression mode 'int3'")
    assert not hvd.is_initialized()


def _opt():
    return torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1)


def test_sharded_update_none_reads_its_knob(port, monkeypatch):
    monkeypatch.setenv("HOROVOD_SHARDED_UPDATE", "1")
    assert type(hvd.DistributedOptimizer(_opt())).__name__ \
        == "ShardedDistributedSGD"
    assert type(hvd.DistributedOptimizer(
        _opt(), sharded_update=None)).__name__ == "ShardedDistributedSGD"
    monkeypatch.delenv("HOROVOD_SHARDED_UPDATE")
    assert type(hvd.DistributedOptimizer(_opt())).__name__ \
        == "DistributedSGD"


def test_sharded_update_and_the_wire_exclude_each_other(monkeypatch):
    monkeypatch.setenv("HOROVOD_SHARDED_UPDATE", "1")
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int8")
    with pytest.raises(ValueError) as jax_err:
        jsharded.sharded_update_enabled()
    with pytest.raises(ValueError) as err:
        hvd.DistributedOptimizer(_opt())
    assert str(err.value) == str(jax_err.value)
    assert "mutually exclusive" in str(err.value)


# --- the front end's markers ---------------------------------------------------------

def test_markers_match_jax(monkeypatch):
    for m in ("int8", "int4"):
        p, j = getattr(hvd.Compression, m), getattr(jcomp.Compression, m)
        assert tuple(p.quant_spec) == tuple(j.quant_spec)
        t = torch.ones(3)
        out, ctx = p.compress(t)
        assert out is t and ctx is None and p.decompress(t, None) is t
        assert tuple(p.with_options(block=9, error_feedback=False)
                     .quant_spec) == tuple(j.with_options(
                         block=9, error_feedback=False).quant_spec)
    monkeypatch.setenv("HOROVOD_QUANT_BLOCK", "64")
    assert hvd.Compression.int4.quant_spec.block == 64  # read at use
    assert pcomp.Compression.bf16.compress(torch.ones(2))[0].dtype == \
        torch.bfloat16


def _captured(monkeypatch):
    rt = context.runtime()
    seen = []
    real = rt.enqueue_group

    def capture(entries):
        seen.extend(entries)
        return real(entries)

    monkeypatch.setattr(rt, "enqueue_group", capture)
    return seen


def test_allreduces_carry_the_marker_to_the_runtime(port, monkeypatch):
    seen = _captured(monkeypatch)
    int8 = hvd.Compression.int8
    x = torch.ones(5000)
    hvd.allreduce(x, name="m.a", compression=int8)
    hvd.synchronize(hvd.allreduce_async(x, name="m.b",
                                        compression=hvd.Compression.int4))
    hvd.allreduce_(x.clone(), name="m.c", compression=int8)
    hvd.grouped_allreduce([x, x], name="m.d", compression=int8)
    hvd.grouped_allreduce_([x.clone()], name="m.e", compression=int8)
    hvd.allreduce(x, name="m.f")
    hvd.allreduce(x.clone().requires_grad_(), name="m.g", compression=int8)
    p = torch.nn.Parameter(torch.zeros(5000))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                   named_parameters=[("m.h", p)],
                                   compression=int8)
    p.grad = torch.ones(5000)
    opt.step()
    got = {e.name: e.quant for e in seen}
    assert got["m.a"] == got["m.c"] == got["m.d.0"] == got["m.e.0"] == \
        got["m.h"] == int8.quant_spec
    assert got["m.b"].bits == 4
    # no marker, and an autograd-tracked tensor: the plain wire
    assert got["m.f"] is None and got["m.g"] is None
    with pytest.raises(ValueError, match="cast compression"):
        hvd.allreduce_async(x, compression=hvd.Compression.fp16)
