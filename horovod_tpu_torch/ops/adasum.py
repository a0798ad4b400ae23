"""Adasum: scale-invariant adaptive summation — counterpart of
``horovod_tpu/ops/adasum.py``.

The combine rule for two gradients a and b (``adasum_combine``, JAX
:26-50) is

    (1 - a.b / (2 |a|^2)) * a  +  (1 - a.b / (2 |b|^2)) * b

computed in fp32 and rounded once to the inputs' dtype, a side of zero
norm taking coefficient 0: orthogonal gradients add, identical ones
average. Here it is K4 (``csrc/adasum.cu``), two hand-written kernels over
a table of items (``Items``: each item a pair of equal-length slices of
two 1-D buffers and the row of its sums):

- ``dot_norms_table(items, A, B, sums)`` (K4a): the fp32
  ``[a.b, |a|^2, |b|^2]`` of every item into its row of ``sums``, in one
  launch, with no floating-point atomic (each item's sums are bitwise the
  same from run to run and bitwise those of a table of that item alone,
  which the ranks' bitwise agreement rests on);
- ``scaled_add_table(items, A, B, sums, OUT)`` (K4b): every item's
  coefficients from its three sums (read from device memory) and its
  scaled sum, in one launch.

A launch takes at most ``MAX_ITEMS`` items; a longer table is split into
launches. ``dot_norms(a, b)`` and ``scaled_add(a, b, sums)`` are tables of
one item. Beside each is its plain PyTorch version
(``dot_norms_table_plain``: three ``torch.dot`` an item;
``scaled_add_table_plain``), the JAX arithmetic op for op. Dispatch: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
``kernel_launches`` counts the launches by kernel.

Built on them:

- ``adasum_combine(a, b)``: the two kernels in turn;
- ``adasum_tree_reduce(rows, sizes)`` (JAX :107-120): pairs (0, 1),
  (2, 3), ... each round, an odd last row carried to the next, over the
  rows of every rank; with ``sizes`` the rows are packed chunks of
  tensors of those sizes, and each tensor is reduced with its own
  coefficients: a round is one K4a and one K4b launch over every
  (pair, tensor) item (``tree_items``), the result in the left row;
- ``hierarchical_allreduce(flat, hier, sizes=...)``, the two-level Adasum
  of ``adasum_allreduce_hierarchical`` (JAX :81-104) over a packed chunk:
  a reduce-scatter of the flat over the host's ranks, divided by their
  number (each host's mean, in slices), the cross-host hypercube on the
  slices (partner ``cross_rank ^ k``, one ``batch_isend_irecv`` pair a
  round; K4a over the items where this rank's slice meets each tensor
  (``slice_items``), the fp32[tensors, 3] summed over the host with one
  allreduce, K4b), then an allgather over the host. The result is
  Adasum of the hosts' means, per tensor, the reference's GPU semantics,
  not flat Adasum of the ranks;
- ``simulated_hierarchical(xs, local_size, sizes)``: the same arithmetic
  for every rank of a simulated world in one process (tests, the card's
  check).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

SOURCE = "adasum"
# kernel dtype codes of csrc/adasum.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DTYPES = tuple(_CODES)
MAX_ITEMS = 512  # kMaxItems of csrc/adasum.cu: items a launch

# launches made by the wrappers, by kernel (read and reset by chip_smoke.py)
kernel_launches = {"adasum_dot_norms": 0, "adasum_scaled_add": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "hvd_adasum_dot_norms": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "hvd_adasum_scaled_add": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
}
_fns: dict = {}
_scratch_bytes = None
# K4a's scratch by (device index, stream): zeroed once when made, its
# counters left 0 by every launch; one a stream, so launches on two
# streams never share it
_scratches: dict = {}


def _lib():
    from . import _build

    return _build.load(SOURCE)


def _kernel(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        lib = _lib()
        if lib.hvd_adasum_max_items() != MAX_ITEMS:
            raise RuntimeError("csrc/adasum.cu's items a launch differ from "
                               f"MAX_ITEMS ({MAX_ITEMS})")
        fn = getattr(lib, symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _scratch(dev: torch.device, stream: int) -> torch.Tensor:
    """K4a's scratch on ``stream``: every block's partial sums and one
    last-block counter an item, made (and zeroed) at its first use."""
    global _scratch_bytes
    key = (dev.index, stream)
    buf = _scratches.get(key)
    if buf is None:
        if _scratch_bytes is None:
            fn = _lib().hvd_adasum_scratch_bytes
            fn.restype = ctypes.c_longlong
            _scratch_bytes = int(fn())
        buf = _scratches[key] = torch.zeros(-(-_scratch_bytes // 4),
                                            dtype=torch.float32, device=dev)
    return buf


class Items:
    """A table of K4 items over 1-D buffers: item k pairs
    ``A[a_off[k] : a_off[k] + n[k]]`` with ``B[b_off[k] : b_off[k] +
    n[k]]``, keeps its three sums in row ``slot[k]`` of an fp32[rows, 3]
    (distinct rows; the item's index by default) and, in K4b, writes
    ``OUT[a_off[k] : a_off[k] + n[k]]`` (A's place; OUT may be A). Offsets
    are in elements."""

    __slots__ = ("a_off", "b_off", "n", "slot", "rows")

    def __init__(self, a_off, b_off, n, slot=None,
                 rows: Optional[int] = None):
        self.a_off = np.asarray(a_off, dtype=np.int64).reshape(-1)
        self.b_off = np.asarray(b_off, dtype=np.int64).reshape(-1)
        self.n = np.asarray(n, dtype=np.int64).reshape(-1)
        self.slot = (np.arange(len(self.n), dtype=np.int32) if slot is None
                     else np.asarray(slot, dtype=np.int32).reshape(-1))
        k = len(self.n)
        if not (len(self.a_off) == len(self.b_off) == len(self.slot)
                == k):
            raise ValueError("an item table's columns differ in length")
        if k and (min(self.a_off.min(), self.b_off.min(), self.n.min(),
                      self.slot.min()) < 0):
            raise ValueError("an item table holds a negative offset, "
                             "length or slot")
        if len(np.unique(self.slot)) != k:
            raise ValueError("two items of one table share a row of sums")
        need = int(self.slot.max()) + 1 if k else 0
        self.rows = need if rows is None else int(rows)
        if self.rows < need:
            raise ValueError(f"{self.rows} rows of sums for slot {need - 1}")

    def __len__(self) -> int:
        return len(self.n)

    @property
    def elements(self) -> int:
        return int(self.n.sum())


def _check_buf(t: torch.Tensor, dtype, device, name: str, end: int):
    if t.dtype != dtype:
        raise ValueError(f"K4's {name} is {t.dtype}, its rows {dtype}")
    if t.device != device:
        raise ValueError("K4's tensors must lie on one device")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"K4's {name} must be 1-D and contiguous")
    if end > t.numel():
        raise ValueError(f"an item reaches element {end} of K4's {name} of "
                         f"{t.numel()}")


def _check_table(items: Items, A, B, out=None, sums=None):
    if A.dtype not in _CODES:
        raise ValueError(f"K4 takes {DTYPES}, not {A.dtype}")
    if A.device.type not in ("cuda", "cpu"):
        raise ValueError(f"K4 runs on CUDA or the CPU, not {A.device}")
    k = len(items)
    ends = [0, 0] if not k else [int((items.a_off + items.n).max()),
                                 int((items.b_off + items.n).max())]
    _check_buf(A, A.dtype, A.device, "A", ends[0])
    _check_buf(B, A.dtype, A.device, "B", ends[1])
    if out is not None:
        _check_buf(out, A.dtype, A.device, "OUT", ends[0])
    if sums is not None and (sums.dtype != torch.float32 or sums.dim() != 2
                             or sums.shape[1] != 3
                             or sums.shape[0] < items.rows
                             or sums.device != A.device
                             or not sums.is_contiguous()):
        raise ValueError(f"sums must be a contiguous fp32[rows >= "
                         f"{items.rows}, 3] on the rows' device")


def _launch(symbol: str, dev: torch.device, stream: int, dtype,
            items: Items, ptrs, *extra):
    """One launch of ``symbol`` a ``MAX_ITEMS`` items on ``stream``:
    ``ptrs`` the items' columns of pointers (uint64 arrays), then their
    lengths and slots, then ``extra``."""
    fn = _kernel(symbol)
    code = _CODES[dtype]
    for i in range(0, len(items), MAX_ITEMS):
        j = min(i + MAX_ITEMS, len(items))
        cols = [p[i:j] for p in ptrs] + [items.n[i:j], items.slot[i:j]]
        err = fn(code, j - i, *(c.ctypes.data for c in cols), *extra,
                 dev.index, stream)
        if err != 0:
            raise RuntimeError(f"K4 {symbol} launch failed: error {err} (a "
                               "cudaError_t, or -1 for arguments the kernel "
                               "refuses)")
        kernel_launches[symbol[4:]] += 1


def _ptrs(t: torch.Tensor, off: np.ndarray) -> np.ndarray:
    return (off * t.element_size() + t.data_ptr()).astype(np.uint64)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def dot_norms_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of one item's sums: three fp32 dot products."""
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
    """The plain version of one item's scaled add: each side times its
    coefficient in fp32, their sum rounded once to the rows' dtype."""
    acoef, bcoef = coefficients(sums)
    r = (acoef * a.float() + bcoef * b.float()).to(a.dtype)
    if out is None:
        return r
    return out.copy_(r)


def _new_sums(items: Items, device) -> torch.Tensor:
    return torch.zeros((items.rows, 3), dtype=torch.float32, device=device)


def dot_norms_table_plain(items: Items, A: torch.Tensor, B: torch.Tensor,
                          sums: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain version of ``dot_norms_table``: three ``torch.dot`` an
    item, into its row of ``sums``."""
    _check_table(items, A, B, sums=sums)
    if sums is None:
        sums = _new_sums(items, A.device)
    for a0, b0, n, s in zip(items.a_off.tolist(), items.b_off.tolist(),
                            items.n.tolist(), items.slot.tolist()):
        sums[s] = dot_norms_plain(A[a0:a0 + n], B[b0:b0 + n])
    return sums


def scaled_add_table_plain(items: Items, A: torch.Tensor, B: torch.Tensor,
                           sums: torch.Tensor, OUT: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version of ``scaled_add_table``: ``scaled_add_plain`` an
    item, with its row of ``sums``."""
    _check_table(items, A, B, OUT, sums)
    for a0, b0, n, s in zip(items.a_off.tolist(), items.b_off.tolist(),
                            items.n.tolist(), items.slot.tolist()):
        scaled_add_plain(A[a0:a0 + n], B[b0:b0 + n], sums[s],
                         OUT[a0:a0 + n])
    return OUT


def dot_norms_table(items: Items, A: torch.Tensor, B: torch.Tensor,
                    sums: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4a: every item's ``[a.b, |a|^2, |b|^2]`` into its row of ``sums``
    (an fp32[rows, 3] on the buffers' device, new when None; rows no item
    names keep their values). One launch a ``MAX_ITEMS`` items."""
    _check_table(items, A, B, sums=sums)
    if A.device.type == "cpu":
        return dot_norms_table_plain(items, A, B, sums)
    if sums is None:
        sums = torch.empty((items.rows, 3), dtype=torch.float32,
                           device=A.device)
    if len(items):
        dev = A.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("hvd_adasum_dot_norms", dev, stream, A.dtype, items,
                (_ptrs(A, items.a_off), _ptrs(B, items.b_off)),
                _scratch(dev, stream).data_ptr(), sums.data_ptr())
    return sums


def scaled_add_table(items: Items, A: torch.Tensor, B: torch.Tensor,
                     sums: torch.Tensor, OUT: torch.Tensor) -> torch.Tensor:
    """K4b: every item's ``acoef * a + bcoef * b`` into ``OUT`` at its
    ``a`` offsets (``OUT`` may be ``A``), the coefficients from its row of
    ``sums``. One launch a ``MAX_ITEMS`` items."""
    _check_table(items, A, B, OUT, sums)
    if A.device.type == "cpu":
        return scaled_add_table_plain(items, A, B, sums, OUT)
    if items.elements:
        dev = A.device
        _launch("hvd_adasum_scaled_add", dev,
                torch.cuda.current_stream(dev).cuda_stream, A.dtype, items,
                (_ptrs(A, items.a_off), _ptrs(B, items.b_off),
                 _ptrs(OUT, items.a_off)), sums.data_ptr())
    return OUT


@functools.lru_cache(maxsize=64)
def _one(n: int) -> Items:
    """The table of one item of ``n`` elements at offset 0."""
    return Items([0], [0], [n])


def _check_pair(a: torch.Tensor, b: torch.Tensor, out=None):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"Adasum combines rows of one shape and dtype, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} "
                         f"{tuple(b.shape)}")
    for t in (a, b) + (() if out is None else (out,)):
        if not t.is_contiguous():
            raise ValueError("K4's tensors must be contiguous")


def dot_norms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4a on one pair: ``[a.b, |a|^2, |b|^2]`` as an fp32[3] on the rows'
    device (a table of one item)."""
    _check_pair(a, b)
    return dot_norms_table(_one(a.numel()), a.view(-1), b.view(-1))[0]


def scaled_add(a: torch.Tensor, b: torch.Tensor, sums: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4b on one pair: ``acoef * a + bcoef * b`` from ``sums`` (an
    fp32[3] on the rows' device), into ``out`` (a new tensor when None; it
    may be ``a`` or ``b``)."""
    _check_pair(a, b, out)
    if sums.shape != (3,) or sums.dtype != torch.float32:
        raise ValueError("sums must be an fp32[3] on the rows' device")
    if out is None:
        out = torch.empty_like(a)
    scaled_add_table(_one(a.numel()), a.view(-1), b.view(-1),
                     sums.view(1, 3), out.view(-1))
    return out


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The pair combine (JAX ``adasum_combine``); the two-level path sums
    the three scalars over the host between the kernels (JAX's
    ``norm_axis``, ``hierarchical_allreduce``)."""
    return scaled_add(a, b, dot_norms(a, b))


# --- the tree over packed rows ---------------------------------------------

def _offsets(sizes) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))])


def tree_items(nrows: int, sizes) -> list:
    """The rounds of ``adasum_tree_reduce`` over ``nrows`` rows of a packed
    chunk of tensors of ``sizes`` (back to back, a row ``sum(sizes)``
    long): one ``Items`` a round over the flat rows, an item a (pair,
    tensor) of that round (tensors of no elements left out), written into
    the pair's left row. The rows' order follows the JAX tree: pairs
    (0, 1), (2, 3), ... of the live rows, an odd last one carried."""
    sizes = [int(s) for s in sizes]
    total = sum(sizes)
    offs = _offsets(sizes)[:-1]
    keep = np.asarray(sizes, np.int64) > 0
    offs, lens = offs[keep], np.asarray(sizes, np.int64)[keep]
    live = list(range(nrows))
    rounds = []
    while len(live) > 1:
        left = np.asarray(live[0:len(live) - 1:2], np.int64)
        right = np.asarray(live[1:len(live):2], np.int64)
        a = (left[:, None] * total + offs[None, :]).reshape(-1)
        b = (right[:, None] * total + offs[None, :]).reshape(-1)
        rounds.append(Items(a, b, np.tile(lens, len(left))))
        live = live[0:len(live):2]
    return rounds


def adasum_tree_reduce_(rows: torch.Tensor, sizes=None, rounds=None,
                        plain: bool = False) -> torch.Tensor:
    """``adasum_tree_reduce`` in place over ``rows`` (a contiguous
    [nrows, total] tensor, which it overwrites): each round one K4a and one
    K4b launch (the plain versions with ``plain``), ``rounds`` from
    ``tree_items`` (computed when None). Returns row 0, the result."""
    if rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("the tree runs on contiguous [rows, total] rows")
    if rows.shape[0] < 1:
        raise ValueError("Adasum of no rows")
    if rounds is None:
        rounds = tree_items(rows.shape[0],
                            (rows.shape[1],) if sizes is None else sizes)
    flat = rows.view(-1)
    dots, adds = ((dot_norms_table_plain, scaled_add_table_plain) if plain
                  else (dot_norms_table, scaled_add_table))
    for items in rounds:
        sums = dots(items, flat, flat)
        adds(items, flat, flat, sums, flat)
    return rows[0]


def _stacked(rows) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        if rows.dim() < 1 or rows.shape[0] < 1:
            raise ValueError("Adasum of no rows")
        return rows.reshape(rows.shape[0], -1).clone(
            memory_format=torch.contiguous_format)
    if not rows:
        raise ValueError("Adasum of no rows")
    return torch.stack([r.reshape(-1) for r in rows])


def adasum_tree_reduce(rows, sizes=None, plain: bool = False
                       ) -> torch.Tensor:
    """Adasum over ``rows`` (a list of same-shaped tensors, or a tensor
    whose first dimension is the rank), pairing (0, 1), (2, 3), ... each
    round and carrying an odd last row to the next (JAX
    ``adasum_tree_reduce``), on a copy. With ``sizes`` each row is a packed
    chunk of tensors of those sizes, each reduced with its own
    coefficients (per-tensor Adasum); without, a row is one tensor.
    Returns a new tensor of one row's shape."""
    if not isinstance(rows, torch.Tensor):
        rows = list(rows)
    stacked = _stacked(rows)
    shape = rows.shape[1:] if isinstance(rows, torch.Tensor) else \
        rows[0].shape
    return adasum_tree_reduce_(stacked, sizes, plain=plain).view(shape)


def adasum_tree_reduce_plain(rows, sizes=None) -> torch.Tensor:
    return adasum_tree_reduce(rows, sizes, plain=True)


# --- two levels -------------------------------------------------------------

def slice_items(sizes, lo: int, hi: int) -> Items:
    """The items where the slice ``[lo, hi)`` of a packed chunk of tensors
    of ``sizes`` meets each tensor (empty meets dropped): offsets into the
    slice, each item's sums in the tensor's row of an fp32[tensors, 3]."""
    offs = _offsets(sizes)
    start = np.maximum(offs[:-1], lo)
    end = np.minimum(offs[1:], hi)
    hit = np.nonzero(end > start)[0]
    rel = start[hit] - lo
    return Items(rel, rel, end[hit] - start[hit], slot=hit,
                 rows=len(offs) - 1)


def _padded(flat: torch.Tensor, nl: int) -> torch.Tensor:
    pad = (-flat.numel()) % nl
    if not pad:
        return flat.contiguous()
    out = torch.zeros(flat.numel() + pad, dtype=flat.dtype,
                      device=flat.device)
    out[:flat.numel()] = flat
    return out


def hierarchical_allreduce(flat: torch.Tensor, hier, count=lambda: None,
                           sizes=None, items: Optional[Items] = None
                           ) -> torch.Tensor:
    """The two-level Adasum of this rank's 1-D ``flat`` over the global
    set's ``hier`` (``common.context.Hierarchy``; a power-of-two
    ``cross_size``): per tensor of ``sizes`` (a packed chunk; one tensor of
    ``flat``'s length when None). ``items`` (``slice_items`` of this
    rank's slice) is computed when None. Returns a new 1-D tensor of
    ``flat``'s length, bitwise the same on every rank. ``count`` is called
    once a call into the communicator."""
    from .collectives import _all_gather, _reduce_scatter

    nl, n = hier.local_size, flat.numel()
    padded = _padded(flat, nl)
    cs = padded.numel() // nl
    sizes = (n,) if sizes is None else tuple(sizes)
    if items is None:
        lo = hier.local_rank * cs
        items = slice_items(sizes, lo, lo + cs)
    chunk = torch.empty(cs, dtype=flat.dtype, device=flat.device)
    count()
    _reduce_scatter(chunk, padded, dist.ReduceOp.SUM,
                    group=hier.local_group)
    chunk.div_(nl)  # the host's mean (JAX: psum_scatter / nl)
    sums = torch.empty((len(sizes), 3), dtype=torch.float32,
                       device=flat.device)
    other = torch.empty_like(chunk)
    k = 1
    while k < hier.cross_size:
        peer = dist.get_global_rank(hier.cross_group, hier.cross_rank ^ k)
        count()
        # both directions in one batch on each side: two blocking calls
        # in opposite orders on the partners would deadlock
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, chunk, peer, hier.cross_group),
                dist.P2POp(dist.irecv, other, peer, hier.cross_group)]):
            w.wait()
        sums.zero_()  # a tensor off this rank's slice adds nothing
        dot_norms_table(items, chunk, other, sums)
        count()
        dist.all_reduce(sums, dist.ReduceOp.SUM, group=hier.local_group)
        scaled_add_table(items, chunk, other, sums, chunk)
        k *= 2
    out = torch.empty(cs * nl, dtype=flat.dtype, device=flat.device)
    count()
    _all_gather(out, chunk, group=hier.local_group)
    return out[:n]


def simulated_hierarchical(xs, local_size: int, sizes=None) -> list:
    """Every rank's result of ``hierarchical_allreduce`` over ``xs`` (one
    1-D tensor a rank, in global rank order ``cross_rank * local_size +
    local_rank``, a packed chunk of tensors of ``sizes``), in one process:
    the reduce-scatter as a rank-order sum of each host's slices, the
    hypercube on every host's slices, the host's allreduce of the sums as a
    sum in local-rank order. Through ``dot_norms_table`` and
    ``scaled_add_table``, so CUDA tensors run K4."""
    nl = local_size
    nx = len(xs) // nl
    if nl * nx != len(xs) or nx & (nx - 1):
        raise ValueError(f"{len(xs)} ranks are not hosts of {local_size} "
                         "in a power-of-two number")
    n = xs[0].numel()
    sizes = (n,) if sizes is None else tuple(sizes)
    padded = [_padded(x.reshape(-1), nl) for x in xs]
    cs = padded[0].numel() // nl
    items = [slice_items(sizes, i * cs, (i + 1) * cs) for i in range(nl)]

    def host_mean(c, i):
        parts = [padded[c * nl + m][i * cs:(i + 1) * cs] for m in range(nl)]
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.div_(nl)

    slices = [[host_mean(c, i) for i in range(nl)] for c in range(nx)]
    k = 1
    while k < nx:
        nxt = []
        for c in range(nx):
            p = c ^ k
            parts = [dot_norms_table(items[i], slices[c][i], slices[p][i],
                                     _new_sums(items[i], xs[0].device))
                     for i in range(nl)]
            sums = parts[0].clone()
            for s in parts[1:]:
                sums += s
            nxt.append([scaled_add_table(items[i], slices[c][i],
                                         slices[p][i], sums,
                                         slices[c][i].clone())
                        for i in range(nl)])
        slices = nxt
        k *= 2
    per_host = [torch.cat(slices[c])[:n] for c in range(nx)]
    return [per_host[r // nl] for r in range(len(xs))]
