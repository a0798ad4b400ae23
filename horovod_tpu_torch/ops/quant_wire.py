"""K2 and K3: the compressed wire of a fused chunk — the hand-written Hopper
kernels (``csrc/quant_wire.cu``) and their plain PyTorch versions.

A compressed chunk (``ops/collectives.py`` ``CastFusedChunkPlan`` and
``QuantFusedChunkPlan``) runs as one pack into a byte row, one allgather
of every rank's row, and one reduce-unpack, the chain XLA compiles into the
programs of ``horovod_tpu/ops/collectives.py`` ``_build_cast_fused_plan``
(:1060-1090) and ``_build_quant_fused_plan`` (:971-1016):

- ``cast_pack(tensors, row, pre)`` (K2): the tensors back to back in fp32,
  times the prescale (skipped at 1, rounded to fp32), rounded to bf16: the
  row holds ``2 * total`` bytes;
- ``quantize_pack(tensors, row, spec, pre, residual, new_residual)`` (K3):
  x is the tensors in fp32 folded with the prescale and the residual (one
  fused multiply-add with both, as XLA contracts ``cat * pre + res``), then
  ``compression.quantize_blockwise``: the row holds the payload and then
  the bf16 scales (``quant_wire_layout``); with error feedback
  ``new_residual`` receives ``x - dequantized``, flat in chunk order. The
  residual is one per tensor (a list, None for zeros, which the kernel
  reads through a second pointer table), a flat tensor of the chunk, or
  None for zeros;
- ``reduce_unpack(gathered, outputs, spec, nrows, average, post)``: every
  row dequantized (or widened) and summed in rank order in fp32; AVERAGE
  multiplies by the one constant ``fp32(fp32(1/N) * fp32(post))``, into
  which XLA folds the mean and the postscale, SUM by ``post`` when it is
  not 1; then cast to the outputs' dtype and written into them.

The prescale is not rounded to the chunk's dtype first (K1's rule):
both JAX plans widen the chunk to fp32 and multiply by the fp32 factor.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel on PyTorch's current stream, or raise. ``kernel_launches`` counts
the launches by kernel and wire (K3 without error feedback under its own
``_no_ef`` names); ``quantize_paths`` counts K3's blocks by the path the
kernel takes them on (``quantize_block_paths``): ``register`` (a block of
256 in one tensor, 16-byte aligned, quantized from registers) or
``general`` (the two-pass walk). The reduce-unpack gives each thread a run
of ``RUN`` elements; ``row_load_widths`` says how wide each row's loads
are.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Optional

import numpy as np
import torch

from . import compression as comp
from .fused_pack import (MAX_SEGS, check_launch, ctypes_table,
                         current_stream, tables)

SOURCE = "quant_wire"
# kernel dtype codes of csrc/quant_wire.cu
_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
          torch.float64: 4}
DTYPES = tuple(_CODES)

# launches, by kernel and wire (read and reset by chip_smoke.py)
kernel_launches = {"wire_cast_pack": 0, "wire_quantize_int8": 0,
                   "wire_quantize_int4": 0, "wire_quantize_int8_no_ef": 0,
                   "wire_quantize_int4_no_ef": 0, "wire_reduce_bf16": 0,
                   "wire_reduce_int8": 0, "wire_reduce_int4": 0}
# K3's blocks by path, over every launch (read and reset by chip_smoke.py)
quantize_paths = {"register": 0, "general": 0}
_WIRE_NAME = {16: "bf16", 8: "int8", 4: "int4"}
REG_BLOCK = 256  # kRegBlock: the block size K3 quantizes from registers
RUN = 16         # kRun: the elements a thread of the reduce-unpack takes

_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        fn = getattr(_build.load(SOURCE), name)
        fn.argtypes = {
            "hvd_cast_pack": [I, P, P, I, P, F, I, I, P],
            "hvd_quantize_pack": [I, I, I, P, P, I, P, L, L, L, P, I, F, P,
                                  P, P, I, P],
            "hvd_reduce_unpack": [I, I, I, P, L, L, I, P, P, I, L, L, F, I,
                                  I, P],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def row_bytes(n_elems: int, spec: comp.QuantSpec) -> int:
    """Bytes of one rank's wire row for a chunk of ``n_elems``."""
    if spec.bits == 16:
        return 2 * int(n_elems)
    _, _, payload, scales = comp.quant_wire_layout(n_elems, spec)
    return payload + scales


def _f32(x: float) -> float:
    return float(np.float32(x))


def reduce_factor(average: bool, nrows: int, post: float) -> Optional[float]:
    """The one fp32 factor of the reduction's result, or None: AVERAGE
    ``fp32(fp32(1/N) * fp32(post))``, SUM ``fp32(post)`` when not 1."""
    if average:
        return float(np.float32(np.float32(1.0 / nrows) * np.float32(post)))
    return _f32(post) if post != 1.0 else None


def fma32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in fp32 with one rounding (the fused multiply-add), on
    any device: the product is exact in fp64, ``TwoSum`` gives the sum's
    exact error, and only an fp64 sum that lands on a midpoint of the fp32
    grid rounds otherwise than the exact value, which the error's sign
    then decides."""
    p = a.double() * _f32(b)
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    f = s.float()
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    down = torch.nextafter(f, torch.full_like(f, float("-inf")))
    fd = f.double()
    f = torch.where((s == (fd + up.double()) * 0.5) & (err > 0), up, f)
    return torch.where((s == (fd + down.double()) * 0.5) & (err < 0), down,
                       f)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _check_inputs(tensors, device, name: str) -> int:
    total = 0
    dtype = tensors[0].dtype if tensors else None
    for t in tensors:
        if t.dtype not in _CODES or t.dtype != dtype:
            raise ValueError(f"{name}: a chunk of one float dtype of "
                             f"{DTYPES}, not {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: a tensor on {t.device} for a row on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        total += t.numel()
    return total


def _check_row(row: torch.Tensor, nbytes: int, name: str):
    if row.dtype != torch.uint8 or row.dim() != 1 or not row.is_contiguous():
        raise ValueError(f"{name}: the wire row is a 1-D contiguous uint8 "
                         "tensor")
    if row.numel() != nbytes:
        raise ValueError(f"{name}: a row of {row.numel()} bytes for "
                         f"{nbytes}")


def _check_f32(t: Optional[torch.Tensor], n: int, device, what: str):
    if t is None:
        return
    if (t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"the {what} is a contiguous fp32 tensor of {n} "
                         f"elements on {device}")


def _launch_ranges(sizes, align: int, end: int) -> list:
    """The launches of one chunk: (first element, end element, indices of
    the tensors they read or write), each range a multiple of ``align``
    long except the last and overlapping at most ``MAX_SEGS`` non-empty
    tensors; empty tensors are left out."""
    starts, off = [], 0
    for n in sizes:
        starts.append(off)
        off += n
    segs = [i for i, n in enumerate(sizes) if n]
    out, e0, k = [], 0, 0
    while e0 < end:
        last = min(k + MAX_SEGS, len(segs))
        if last == len(segs):
            e1 = end
        else:
            e1 = starts[segs[last]] // align * align
            if e1 <= e0:
                raise ValueError(f"a block of {align} elements spans more "
                                 f"than {MAX_SEGS} tensors")
        j = k
        while j < len(segs) and starts[segs[j]] < e1:
            j += 1
        out.append((e0, e1, segs[k:j]))
        e0 = e1
        while k < len(segs) and starts[segs[k]] + sizes[segs[k]] <= e0:
            k += 1
    return out


def _table(tensors, idx: list, ptrs=None):
    """ctypes (pointers, offsets) of ``tensors[idx]`` (or of ``ptrs``, one
    for each): each tensor's first element in the chunk, and the end of
    the last."""
    starts, off = [], 0
    for t in tensors:
        starts.append(off)
        off += t.numel()
    if ptrs is None:
        ptrs = [tensors[i].data_ptr() for i in idx]
    return ctypes_table(ptrs, [starts[i] for i in idx]
                        + [starts[idx[-1]] + tensors[idx[-1]].numel()])


def access_width(addr: int, nbytes: int) -> int:
    """The bytes of each load or store the kernels make to move ``nbytes``
    (a multiple of 4) at ``addr``: as wide as the address's alignment
    allows, at most 16 (``load_bytes`` / ``store_bytes``)."""
    if nbytes % 16 == 0 and addr % 16 == 0:
        return 16
    if nbytes % 8 == 0 and addr % 8 == 0:
        return 8
    for w in (4, 2):
        if addr % w == 0:
            return w
    return 1


def row_load_widths(addr: int, row_bytes_: int, nrows: int,
                    bits: int) -> list:
    """The reduce-unpack's load width in each row of ``gathered`` at
    ``addr``: a run's ``RUN * bits / 8`` bytes start at a multiple of that
    count in its row, so the row's start decides."""
    return [access_width(addr + r * row_bytes_, RUN * bits // 8)
            for r in range(nrows)]


def quantize_block_paths(starts: list, idx: list, ptrs: list, res_ptrs,
                         item: int, block: int, total: int, b0: int, b1: int,
                         ef: bool, res_out: int) -> tuple:
    """(register, general): how many of the blocks [b0, b1) of one K3
    launch over the tensors ``idx`` of a chunk (tensor i spans elements
    ``starts[i]`` to ``starts[i + 1]``) take each path, by the kernel's
    rule (``register_path``): a block of ``REG_BLOCK`` elements that lies
    in one tensor and before the padding at ``total``, whose source
    (``ptrs``, elements of ``item`` bytes) and, with error feedback,
    residual (``res_ptrs``, 0 or None for zeros) and new residual
    (``res_out``) are 16-byte aligned at the block's first element."""
    reg = 0
    if block == REG_BLOCK:
        for k, i in enumerate(idx):
            s, e = starts[i], min(starts[i + 1], total)
            lo = max(-(-s // block), b0)
            hi = min(e // block, b1)
            if hi <= lo:
                continue
            j = lo * block - s  # the first full block's offset in the tensor
            ok = (ptrs[k] + j * item) % 16 == 0
            if ef:
                r = res_ptrs[k] if res_ptrs is not None else 0
                ok = ok and res_out % 16 == 0 and (
                    not r or (r + j * 4) % 16 == 0)
            reg += (hi - lo) if ok else 0
    return reg, (b1 - b0) - reg


# --- K2: the cast pack -----------------------------------------------------

def plain_cast_pack(tensors, row: torch.Tensor, pre: float = 1.0):
    x = _flat(tensors)
    if pre != 1.0:
        x = x * torch.tensor(_f32(pre), dtype=torch.float32, device=x.device)
    row.view(torch.bfloat16).copy_(x.to(torch.bfloat16))


def cast_pack(tensors, row: torch.Tensor, pre: float = 1.0):
    """The chunk's tensors into a bf16 wire row (``2 * total`` bytes)."""
    tensors = list(tensors)
    total = _check_inputs(tensors, row.device, "cast_pack")
    _check_row(row, 2 * total, "cast_pack")
    if row.device.type == "cpu":
        return plain_cast_pack(tensors, row, pre)
    if row.device.type != "cuda":
        raise ValueError(f"cast_pack runs on CUDA or the CPU, not "
                         f"{row.device}")
    fn, dev = _kernel("hvd_cast_pack"), row.device
    for ptrs, offs, n in tables(tensors):
        check_launch("cast_pack", fn(
            _CODES[tensors[0].dtype], ptrs, offs, n, row.data_ptr(),
            _f32(pre), int(pre != 1.0), dev.index, current_stream(dev)))
        kernel_launches["wire_cast_pack"] += 1


# --- K3: the quantize pack ---------------------------------------------------

def _residuals(tensors, residual) -> Optional[list]:
    """The residual as one entry a tensor (None: zeros), or None for all
    zeros; a flat residual of the chunk is cut into views."""
    if residual is None:
        return None
    if isinstance(residual, torch.Tensor):
        if residual.dim() != 1:
            raise ValueError("a flat residual is 1-D")
        n = sum(t.numel() for t in tensors)
        if residual.numel() != n:
            raise ValueError(f"a flat residual of {residual.numel()} "
                             f"elements for a chunk of {n}")
        residual = list(torch.split(residual,
                                    [t.numel() for t in tensors]))
    residual = list(residual)
    if len(residual) != len(tensors):
        raise ValueError(f"{len(residual)} residuals for {len(tensors)} "
                         "tensors")
    return residual


def _quant_x(tensors, pre: float, residual, ef: bool) -> torch.Tensor:
    v = _flat(tensors)
    if ef:
        r = (torch.cat([torch.zeros(t.numel(), device=v.device)
                        if x is None else x.reshape(-1)
                        for t, x in zip(tensors, residual)])
             if residual is not None else torch.zeros_like(v))
        return fma32(v, pre, r) if pre != 1.0 else v + r
    if pre != 1.0:
        return v * torch.tensor(_f32(pre), dtype=torch.float32,
                                device=v.device)
    return v


def plain_quantize_pack(tensors, row: torch.Tensor, spec: comp.QuantSpec,
                        pre: float = 1.0, residual=None, new_residual=None):
    tensors = list(tensors)
    x = _quant_x(tensors, pre, _residuals(tensors, residual),
                 spec.error_feedback)
    q, s = comp.quantize_blockwise(x, spec)
    _, _, payload, _ = comp.quant_wire_layout(x.numel(), spec)
    row[:payload].copy_(q.view(torch.uint8))
    row[payload:].copy_(s.view(torch.uint8))
    if spec.error_feedback:
        new_residual.copy_(x - comp.dequantize_blockwise(q, s, spec,
                                                         x.numel()))


def quantize_pack(tensors, row: torch.Tensor, spec: comp.QuantSpec,
                  pre: float = 1.0, residual=None,
                  new_residual: Optional[torch.Tensor] = None,
                  reg_blocks: Optional[torch.Tensor] = None):
    """The chunk's tensors, prescaled and folded with ``residual`` (one
    fp32 tensor or None a tensor, a flat fp32 tensor of the chunk, or
    None), into a quantized wire row; with error feedback the error lands
    in ``new_residual`` (a flat buffer of its own). ``reg_blocks``, a
    one-element int64 tensor on the row's device, receives the kernel's
    own count of its register-path blocks (a check of
    ``quantize_block_paths``; the plain version leaves it alone)."""
    tensors = list(tensors)
    total = _check_inputs(tensors, row.device, "quantize_pack")
    padded, nblocks, payload, scales = comp.quant_wire_layout(total, spec)
    _check_row(row, payload + scales, "quantize_pack")
    ef = spec.error_feedback
    res = _residuals(tensors, residual) if ef else None
    if ef:
        if new_residual is None:
            raise ValueError("error feedback needs a new_residual buffer")
        _check_f32(new_residual, total, row.device, "new residual")
        lo = new_residual.data_ptr()
        hi = lo + 4 * total
        for t, r in zip(tensors, res or ()):
            if r is None:
                continue
            _check_f32(r, t.numel(), row.device, "residual")
            if r.numel() and lo < r.data_ptr() + 4 * r.numel() and \
                    r.data_ptr() < hi:
                raise ValueError("the residual and the new residual must "
                                 "not share memory")
    if row.device.type == "cpu":
        return plain_quantize_pack(tensors, row, spec, pre, res,
                                   new_residual)
    if row.device.type != "cuda":
        raise ValueError(f"quantize_pack runs on CUDA or the CPU, not "
                         f"{row.device}")
    if reg_blocks is not None and (reg_blocks.dtype != torch.int64
                                   or reg_blocks.numel() != 1
                                   or reg_blocks.device != row.device):
        raise ValueError("reg_blocks is one int64 element on the row's "
                         "device")
    mode = int(pre != 1.0) | (2 if ef else 0)
    fn, dev, block = _kernel("hvd_quantize_pack"), row.device, spec.block
    name = "wire_quantize_" + _WIRE_NAME[spec.bits] + ("" if ef else "_no_ef")
    base = row.data_ptr()
    sizes = [t.numel() for t in tensors]
    starts = [0, *itertools.accumulate(sizes)]
    res_out = new_residual.data_ptr() if ef else 0
    item = tensors[0].element_size()
    for e0, e1, idx in _launch_ranges(sizes, block, padded):
        ptrs, offs = _table(tensors, idx)
        rlist = (None if res is None else
                 [0 if res[i] is None else res[i].data_ptr() for i in idx])
        rptrs = (None if rlist is None
                 else (ctypes.c_ulonglong * len(idx))(*rlist))
        b0, b1 = e0 // block, -(-e1 // block)
        check_launch("quantize_pack", fn(
            _CODES[tensors[0].dtype], spec.bits, block, ptrs, offs,
            len(idx), rptrs, b0, b1, total, res_out or None, mode,
            _f32(pre), base, base + payload,
            None if reg_blocks is None else reg_blocks.data_ptr(),
            dev.index, current_stream(dev)))
        kernel_launches[name] += 1
        reg, gen = quantize_block_paths(
            starts, idx, list(ptrs), rlist, item, block, total, b0, b1, ef,
            res_out)
        quantize_paths["register"] += reg
        quantize_paths["general"] += gen


# --- K2/K3: the reduce-unpack -----------------------------------------------

def plain_reduce_unpack(gathered: torch.Tensor, outputs,
                        spec: comp.QuantSpec, nrows: int,
                        average: bool, post: float = 1.0):
    total = sum(o.numel() for o in outputs)
    rows = gathered.view(nrows, -1)
    if spec.bits == 16:
        deq = [rows[r].view(torch.bfloat16).float() for r in range(nrows)]
    else:
        _, _, payload, _ = comp.quant_wire_layout(total, spec)
        deq = [comp.dequantize_blockwise(
            rows[r, :payload], rows[r, payload:].clone()
            .view(torch.bfloat16), spec, total) for r in range(nrows)]
    acc = deq[0].clone()
    for d in deq[1:]:
        acc += d
    f = reduce_factor(average, nrows, post)
    if f is not None:
        acc = acc * torch.tensor(f, dtype=torch.float32, device=acc.device)
    parts = torch.split(acc, [o.numel() for o in outputs])
    for o, p in zip(outputs, parts):
        o.copy_(p.view(o.shape).to(o.dtype))


def reduce_unpack(gathered: torch.Tensor, outputs, spec: comp.QuantSpec,
                  nrows: int, average: bool, post: float = 1.0):
    """Every rank's row of ``gathered`` (``nrows`` rows back to back, in
    rank order) dequantized, reduced and written into ``outputs``."""
    outputs = list(outputs)
    total = _check_inputs(outputs, gathered.device, "reduce_unpack")
    nb = row_bytes(total, spec)
    _check_row(gathered, nrows * nb, "reduce_unpack")
    if gathered.device.type == "cpu":
        return plain_reduce_unpack(gathered, outputs, spec, nrows, average,
                                   post)
    if gathered.device.type != "cuda":
        raise ValueError(f"reduce_unpack runs on CUDA or the CPU, not "
                         f"{gathered.device}")
    f = reduce_factor(average, nrows, post)
    payload = (comp.quant_wire_layout(total, spec)[2]
               if spec.bits != 16 else 0)
    fn, dev = _kernel("hvd_reduce_unpack"), gathered.device
    name = "wire_reduce_" + _WIRE_NAME[spec.bits]
    for e0, e1, idx in _launch_ranges([o.numel() for o in outputs], RUN,
                                      total):
        ptrs, offs = _table(outputs, idx)
        check_launch("reduce_unpack", fn(
            _CODES[outputs[0].dtype], spec.bits, spec.block,
            gathered.data_ptr(), nb, payload, nrows, ptrs, offs, len(idx),
            e0, e1, f if f is not None else 1.0, int(f is not None),
            dev.index, current_stream(dev)))
        kernel_launches[name] += 1
