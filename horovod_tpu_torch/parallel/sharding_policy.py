"""Leaf-sharding policy — the port's own copy of
``horovod_tpu/parallel/sharding_policy.py``.

One place for the "should this leaf be sharded, and how" decision that the
ZeRO-1 planner (``opt/sharded.py``) and the whole-leaf owners of the torch
front end (``torch/__init__.py``) share:

- :func:`shard_dim`: the dimension to shard a leaf over in place (the
  JAX package's FSDP annotations use it; the port keeps it beside the
  threshold it shares);
- :func:`should_shard`: whether a leaf is big enough to leave the
  replicated path (the ZeRO-1 planner flattens leaves, so only the
  element count matters);
- :func:`assign_owners`: whole-leaf owner assignment, for a front end that
  cannot slice a tensor across an optimizer step: each rank gets a
  disjoint subset of whole leaves, balanced greedily by size.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

#: Replicate threshold: leaves below this many elements are not worth
#: sharding; gathering a norm scale costs more in collective latency than
#: it saves in memory. 16k elements, 64 KiB in fp32.
DEFAULT_MIN_SHARD_ELEMS = 2 ** 14


def _num_elems(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def shard_dim(shape: Sequence[int], *,
              min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS,
              axis_size: Optional[int] = None) -> Optional[int]:
    """The dimension index to shard ``shape`` over, or None to replicate.

    Scalars and leaves smaller than ``min_shard_elems`` replicate;
    otherwise the largest dimension that ``axis_size`` divides (the first
    of equals), so shards are even. ``axis_size=None`` accepts any
    dimension. No divisible dimension: replicate.
    """
    shape = tuple(int(d) for d in shape)
    if not shape or _num_elems(shape) < min_shard_elems:
        return None
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if axis_size is None or shape[i] % axis_size == 0:
            return i
    return None


def should_shard(shape: Sequence[int], *,
                 min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> bool:
    """True when a leaf of ``shape`` is big enough to move off the
    replicated path: not a scalar, and at least ``min_shard_elems``
    elements."""
    shape = tuple(int(d) for d in shape)
    return bool(shape) and _num_elems(shape) >= min_shard_elems


def assign_owners(sizes: Sequence[int], world_size: int, *,
                  min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS
                  ) -> List[Optional[int]]:
    """Greedy whole-leaf owner per entry of ``sizes`` (element counts).

    One entry per leaf: the owning rank, or None for a leaf under the
    replicate threshold (every rank updates it). Leaves go largest first
    to the least-loaded rank, ties to the lowest rank and, among equal
    sizes, to the earlier leaf first: every rank computes the same table
    from (sizes, world_size, min_shard_elems) without communicating,
    which an elastic resize relies on.
    """
    world_size = max(int(world_size), 1)
    owners: List[Optional[int]] = [None] * len(sizes)
    load = [0] * world_size
    order = sorted(range(len(sizes)), key=lambda i: (-int(sizes[i]), i))
    for i in order:
        if int(sizes[i]) < min_shard_elems:
            continue
        rank = min(range(world_size), key=lambda r: (load[r], r))
        owners[i] = rank
        load[rank] += int(sizes[i])
    return owners
