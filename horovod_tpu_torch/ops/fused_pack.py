"""K1: the fused-chunk pack and unpack — the hand-written Hopper kernel
(``csrc/fused_pack.cu``) and its plain PyTorch version.

The background runtime (``ops/queue.py``) reduces a chunk of gradients as
pack → one collective → unpack, the chain that XLA compiles into one
program in ``horovod_tpu/ops/collectives.py`` ``_build_fused_plan``
(:738-783):

- ``pack(tensors, flat, factor)`` writes the tensors' elements back to back
  into ``flat``, each multiplied by ``factor`` (the prescale);
- ``unpack(flat, outputs, factor)`` writes each tensor's slice of ``flat``
  into its output, multiplied by ``factor`` (the postscale, times 1/n for
  AVERAGE where the backend has no average).

The rule for the factor, which kernel and plain version share, is the JAX
package's multi-rank rule (``_allreduce_body``, :576-597: ``g * pre``, the
reduction, ``* post``, each a product with a weakly typed Python float):
for bf16 and fp16 elements the factor is first rounded to the element's
dtype (round to nearest even), then the element is multiplied by it in
fp32 and the product rounded once to the dtype; fp32 elements are
multiplied by the factor rounded to fp32, and fp64 elements in fp64. So
the fused chain equals that rule, run op by op, bit for bit wherever the
collective's own sum rounds as JAX's does: always at two ranks (ROADMAP.md
queue 3 has the rest). A factor of 1 is a byte copy,
valid for any dtype; any other dtype with another factor raises (the
runtime sends such tensors to the per-tensor path instead).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel, on PyTorch's current stream, or raise. ``kernel_launches`` counts
the launches by direction.
"""

from __future__ import annotations

import ctypes

import torch

# kernel dtype codes of csrc/fused_pack.cu (0 = byte copy)
_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
          torch.float64: 4}
SCALED_DTYPES = tuple(_CODES)
MAX_SEGS = 128  # HVD_TABLE_MAX_SEGS: tensors per launch
SOURCE = "fused_pack"

# launches made by _launch, by direction (read and reset by chip_smoke.py)
kernel_launches = {"fused_pack": 0, "fused_unpack": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load(SOURCE).hvd_fused_pack
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_double, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def can_scale(dtype: torch.dtype) -> bool:
    """Whether a chunk of ``dtype`` may carry a factor other than 1."""
    return dtype in _CODES


def _check(tensors, flat, factor: float):
    if flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError("the flat buffer must be 1-D and contiguous")
    total = 0
    for t in tensors:
        if t.dtype != flat.dtype:
            raise ValueError(f"a {t.dtype} tensor in a {flat.dtype} chunk")
        if t.device != flat.device:
            raise ValueError(f"a tensor on {t.device} in a chunk on "
                             f"{flat.device}")
        if not t.is_contiguous():
            raise ValueError("pack and unpack take contiguous tensors")
        total += t.numel()
    if total > flat.numel():
        raise ValueError(f"{total} elements do not fit a flat buffer of "
                         f"{flat.numel()}")
    if factor != 1.0 and not can_scale(flat.dtype):
        raise ValueError(f"a factor of {factor} on a {flat.dtype} chunk: "
                         f"only {SCALED_DTYPES} scale")
    return total


def scaled(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x`` times ``factor`` under the module's rule (the plain
    arithmetic of one element)."""
    if factor == 1.0:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        # the factor in the element's dtype, as JAX's weak typing makes it
        f = float(torch.tensor(factor, dtype=x.dtype))
        return (x.float() * f).to(x.dtype)
    return x * factor


def plain_pack(tensors, flat: torch.Tensor, factor: float = 1.0):
    """The plain version of ``pack``: ``torch.cat`` of the flattened
    tensors, times the factor."""
    total = _check(tensors, flat, factor)
    if tensors:
        flat[:total].copy_(scaled(torch.cat([t.reshape(-1)
                                             for t in tensors]), factor))


def plain_unpack(flat: torch.Tensor, outputs, factor: float = 1.0):
    """The plain version of ``unpack``: ``split`` of the flat buffer and
    ``copy_`` into each output, times the factor."""
    total = _check(outputs, flat, factor)
    parts = torch.split(flat[:total], [o.numel() for o in outputs])
    for o, p in zip(outputs, parts):
        o.copy_(scaled(p, factor).view(o.shape))


def ctypes_table(ptrs: list, offs: list):
    """The ctypes arrays of one launch's table (``csrc/tensor_table.cuh``):
    ``ptrs[n]`` and ``offs[n + 1]``."""
    n = len(ptrs)
    return ((ctypes.c_ulonglong * n)(*ptrs),
            (ctypes.c_longlong * (n + 1))(*offs))


def tables(tensors, item: int = 1):
    """The launches of one chunk, as K1 and K2 make them: (ptrs, offs,
    count) of at most ``MAX_SEGS`` tensors each, the offsets running on
    from one launch to the next (elements, times ``item`` for the byte
    copy)."""
    off = 0
    for i in range(0, len(tensors), MAX_SEGS):
        seg = tensors[i:i + MAX_SEGS]
        offs = [off]
        for t in seg:
            off += t.numel() * item
            offs.append(off)
        yield ctypes_table([t.data_ptr() for t in seg], offs) + (len(seg),)


def current_stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def check_launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err} (a "
                           "cudaError_t, or -1 for arguments the kernel "
                           "refuses)")


def _launch(pack_dir: int, tensors, flat: torch.Tensor, factor: float):
    fn = _kernel()
    # offsets in bytes for the byte copy, in elements when scaling
    if factor == 1.0:
        code, item = 0, flat.element_size()
    else:
        code, item = _CODES[flat.dtype], 1
    dev = flat.device
    stream = current_stream(dev)
    name = "fused_pack" if pack_dir else "fused_unpack"
    for ptrs, offs, n in tables(tensors, item):
        check_launch(name, fn(pack_dir, code, ptrs, offs, n, flat.data_ptr(),
                              float(factor), float(factor), dev.index,
                              stream))
        kernel_launches[name] += 1


def pack(tensors, flat: torch.Tensor, factor: float = 1.0):
    """Write ``tensors`` back to back into ``flat``, times ``factor``."""
    _check(tensors, flat, factor)
    if flat.device.type == "cpu":
        return plain_pack(tensors, flat, factor)
    if flat.device.type != "cuda":
        raise ValueError(f"pack runs on CUDA or the CPU, not {flat.device}")
    _launch(1, list(tensors), flat, factor)


def unpack(flat: torch.Tensor, outputs, factor: float = 1.0):
    """Write each output's slice of ``flat`` into it, times ``factor``."""
    _check(outputs, flat, factor)
    if flat.device.type == "cpu":
        return plain_unpack(flat, outputs, factor)
    if flat.device.type != "cuda":
        raise ValueError(f"unpack runs on CUDA or the CPU, not "
                         f"{flat.device}")
    _launch(0, list(outputs), flat, factor)
