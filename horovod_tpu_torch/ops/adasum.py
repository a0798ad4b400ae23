"""Adasum: scale-invariant adaptive summation — counterpart of
``horovod_tpu/ops/adasum.py``.

The combine rule for two gradients a and b (``adasum_combine``, JAX
:26-50) is

    (1 - a.b / (2 |a|^2)) * a  +  (1 - a.b / (2 |b|^2)) * b

computed in fp32 and rounded once to the inputs' dtype, a side of zero
norm taking coefficient 0: orthogonal gradients add, identical ones
average. Here it is K4 (``csrc/adasum.cu``), two hand-written kernels:

- ``dot_norms(a, b)`` (K4a): the fp32 ``[a.b, |a|^2, |b|^2]`` in one pass,
  on the device, with no floating-point atomic (bitwise the same from run
  to run, which the ranks' bitwise agreement rests on);
- ``scaled_add(a, b, sums)`` (K4b): the coefficients from those three sums
  (read from device memory) and the scaled sum, in one pass.

Beside each is its plain PyTorch version (``dot_norms_plain``,
``scaled_add_plain``), the JAX arithmetic op for op. Dispatch: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. ``kernel_launches`` counts the launches by kernel.

Built on them:

- ``adasum_combine(a, b)``: the two kernels in turn;
- ``adasum_tree_reduce(rows)`` (JAX :107-120): pairs (0, 1), (2, 3), ...
  each round, an odd last row carried to the next, over the rows of every
  rank (the flat eager path gathers them first);
- ``hierarchical_allreduce(flat, hier)``, the two-level Adasum of
  ``adasum_allreduce_hierarchical`` (JAX :81-104): a reduce-scatter of
  the flat over the host's ranks, divided by their number (each host's
  mean, in chunks), the cross-host hypercube on the chunks (partner
  ``cross_rank ^ k``, one ``batch_isend_irecv`` pair a round, the three
  scalars summed over the host with one allreduce of an fp32[3]), then an
  allgather over the host. The result is Adasum of the hosts' means, the
  reference's GPU semantics, not flat Adasum of the ranks;
- ``simulated_hierarchical(xs, local_size)``: the same arithmetic for
  every rank of a simulated world in one process (tests, the card's
  check).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

SOURCE = "adasum"
# kernel dtype codes of csrc/adasum.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DTYPES = tuple(_CODES)

# launches made by the wrappers, by kernel (read and reset by chip_smoke.py)
kernel_launches = {"adasum_dot_norms": 0, "adasum_scaled_add": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "hvd_adasum_dot_norms": [_I, _P, _P, _L, _P, _P, _I, _P],
    "hvd_adasum_scaled_add": [_I, _P, _P, _P, _P, _L, _I, _P],
}
_fns: dict = {}
_scratch_bytes = None


def _lib():
    from . import _build

    return _build.load(SOURCE)


def _kernel(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_lib(), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _scratch(device) -> torch.Tensor:
    """K4a's scratch: its blocks' partial sums and the last-block counter."""
    global _scratch_bytes
    if _scratch_bytes is None:
        fn = _lib().hvd_adasum_scratch_bytes
        fn.restype = ctypes.c_longlong
        _scratch_bytes = int(fn())
    return torch.empty(-(-_scratch_bytes // 4), dtype=torch.float32,
                       device=device)


def _check(a: torch.Tensor, b: torch.Tensor, out=None):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"Adasum combines rows of one shape and dtype, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} "
                         f"{tuple(b.shape)}")
    if a.dtype not in _CODES:
        raise ValueError(f"K4 takes {DTYPES}, not {a.dtype}")
    for t in (a, b) + (() if out is None else (out,)):
        if t.device != a.device:
            raise ValueError("K4's tensors must lie on one device")
        if not t.is_contiguous():
            raise ValueError("K4's tensors must be contiguous")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"K4 runs on CUDA or the CPU, not {a.device}")


def _launch(symbol: str, dev: torch.device, *args):
    err = _kernel(symbol)(*args, dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 {symbol} launch failed: error {err} (a "
                           "cudaError_t, or -1 for arguments the kernel "
                           "refuses)")
    kernel_launches[symbol[4:]] += 1


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def dot_norms_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of ``dot_norms``: three fp32 dot products."""
    af = a.reshape(-1).float()
    bf = b.reshape(-1).float()
    return torch.stack([torch.dot(af, bf), torch.dot(af, af),
                        torch.dot(bf, bf)])


def coefficients(sums: torch.Tensor) -> tuple:
    """(acoef, bcoef) of the three sums, fp32, as JAX computes them: a side
    of zero norm takes 0."""
    dot, na2, nb2 = sums[0], sums[1], sums[2]
    one, two, zero = (_f32(v).to(sums.device) for v in (1.0, 2.0, 0.0))
    acoef = torch.where(na2 > 0, one - dot / (two * torch.where(
        na2 > 0, na2, one)), zero)
    bcoef = torch.where(nb2 > 0, one - dot / (two * torch.where(
        nb2 > 0, nb2, one)), zero)
    return acoef, bcoef


def scaled_add_plain(a: torch.Tensor, b: torch.Tensor, sums: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``scaled_add``: each side times its
    coefficient in fp32, their sum rounded once to the rows' dtype."""
    acoef, bcoef = coefficients(sums)
    r = (acoef * a.float() + bcoef * b.float()).to(a.dtype)
    if out is None:
        return r
    return out.copy_(r)


def dot_norms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4a: ``[a.b, |a|^2, |b|^2]`` as an fp32[3] on the rows' device."""
    _check(a, b)
    if a.device.type == "cpu":
        return dot_norms_plain(a, b)
    out = torch.empty(3, dtype=torch.float32, device=a.device)
    _launch("hvd_adasum_dot_norms", a.device, _CODES[a.dtype], a.data_ptr(),
            b.data_ptr(), a.numel(), _scratch(a.device).data_ptr(),
            out.data_ptr())
    return out


def scaled_add(a: torch.Tensor, b: torch.Tensor, sums: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4b: ``acoef * a + bcoef * b`` from ``sums`` (an fp32[3] on the
    rows' device), into ``out`` (a new tensor when None; it may be ``a``
    or ``b``)."""
    _check(a, b, out)
    if sums.shape != (3,) or sums.dtype != torch.float32 or (
            sums.device != a.device):
        raise ValueError("sums must be an fp32[3] on the rows' device")
    if a.device.type == "cpu":
        return scaled_add_plain(a, b, sums, out)
    if out is None:
        out = torch.empty_like(a)
    _launch("hvd_adasum_scaled_add", a.device, _CODES[a.dtype], a.data_ptr(),
            b.data_ptr(), sums.data_ptr(), out.data_ptr(), a.numel())
    return out


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The pair combine (JAX ``adasum_combine``); the two-level path sums
    the three scalars over the host between the kernels (JAX's
    ``norm_axis``, ``hierarchical_allreduce``)."""
    return scaled_add(a, b, dot_norms(a, b))


def adasum_combine_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return scaled_add_plain(a, b, dot_norms_plain(a, b))


def adasum_tree_reduce(rows, combine=adasum_combine) -> torch.Tensor:
    """Adasum over ``rows`` (a list of same-shaped tensors, or a tensor
    whose first dimension is the rank), pairing (0, 1), (2, 3), ... each
    round and carrying an odd last row to the next (JAX
    ``adasum_tree_reduce``)."""
    rows = list(rows)
    if not rows:
        raise ValueError("Adasum of no rows")
    while len(rows) > 1:
        nxt = [combine(rows[i], rows[i + 1])
               for i in range(0, len(rows) - 1, 2)]
        if len(rows) % 2:
            nxt.append(rows[-1])
        rows = nxt
    return rows[0]


def adasum_tree_reduce_plain(rows) -> torch.Tensor:
    return adasum_tree_reduce(rows, adasum_combine_plain)


def _padded(flat: torch.Tensor, nl: int) -> torch.Tensor:
    pad = (-flat.numel()) % nl
    if not pad:
        return flat.contiguous()
    out = torch.zeros(flat.numel() + pad, dtype=flat.dtype,
                      device=flat.device)
    out[:flat.numel()] = flat
    return out


def hierarchical_allreduce(flat: torch.Tensor, hier,
                           count=lambda: None) -> torch.Tensor:
    """The two-level Adasum of this rank's 1-D ``flat`` over the global
    set's ``hier`` (``common.context.Hierarchy``; a power-of-two
    ``cross_size``). Returns a new 1-D tensor of ``flat``'s length, bitwise
    the same on every rank. ``count`` is called once a call into the
    communicator."""
    from .collectives import _all_gather, _reduce_scatter

    nl, n = hier.local_size, flat.numel()
    padded = _padded(flat, nl)
    cs = padded.numel() // nl
    chunk = torch.empty(cs, dtype=flat.dtype, device=flat.device)
    count()
    _reduce_scatter(chunk, padded, dist.ReduceOp.SUM,
                    group=hier.local_group)
    chunk.div_(nl)  # the host's mean (JAX: psum_scatter / nl)
    k = 1
    while k < hier.cross_size:
        peer = dist.get_global_rank(hier.cross_group, hier.cross_rank ^ k)
        other = torch.empty_like(chunk)
        count()
        # both directions in one batch on each side: two blocking calls
        # in opposite orders on the partners would deadlock
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, chunk, peer, hier.cross_group),
                dist.P2POp(dist.irecv, other, peer, hier.cross_group)]):
            w.wait()
        sums = dot_norms(chunk, other)
        count()
        dist.all_reduce(sums, dist.ReduceOp.SUM, group=hier.local_group)
        chunk = scaled_add(chunk, other, sums)
        k *= 2
    out = torch.empty(cs * nl, dtype=flat.dtype, device=flat.device)
    count()
    _all_gather(out, chunk, group=hier.local_group)
    return out[:n]


def simulated_hierarchical(xs, local_size: int) -> list:
    """Every rank's result of ``hierarchical_allreduce`` over ``xs`` (one
    1-D tensor a rank, in global rank order ``cross_rank * local_size +
    local_rank``), in one process: the reduce-scatter as a rank-order sum
    of each host's chunks, the hypercube on every host's chunks, the
    host's allreduce of the scalars as a sum in local-rank order. Through
    ``dot_norms`` and ``scaled_add``, so CUDA tensors run K4."""
    nl = local_size
    nx = len(xs) // nl
    if nl * nx != len(xs) or nx & (nx - 1):
        raise ValueError(f"{len(xs)} ranks are not hosts of {local_size} "
                         "in a power-of-two number")
    n = xs[0].numel()
    padded = [_padded(x.reshape(-1), nl) for x in xs]
    cs = padded[0].numel() // nl

    def host_mean(c, i):
        parts = [padded[c * nl + m][i * cs:(i + 1) * cs] for m in range(nl)]
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.div_(nl)

    chunks = [[host_mean(c, i) for i in range(nl)] for c in range(nx)]
    k = 1
    while k < nx:
        nxt = []
        for c in range(nx):
            p = c ^ k
            parts = [dot_norms(chunks[c][i], chunks[p][i])
                     for i in range(nl)]
            sums = parts[0].clone()
            for s in parts[1:]:
                sums += s
            nxt.append([scaled_add(chunks[c][i], chunks[p][i], sums)
                        for i in range(nl)])
        chunks = nxt
        k *= 2
    per_host = [torch.cat(chunks[c])[:n] for c in range(nx)]
    return [per_host[r // nl] for r in range(len(xs))]
