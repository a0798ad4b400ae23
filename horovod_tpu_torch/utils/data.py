"""Sharded, device-prefetching input pipeline — counterpart of
``horovod_tpu/utils/data.py``.

The per-rank dataset sharding every Horovod example does by hand
(``dataset.shard(hvd.size(), hvd.rank())``) and a loader that issues the
next batches' host-to-device copies ahead of the steps that use them.
Batches are host numpy, drawn exactly as the JAX package draws them
(``np.random.RandomState(seed + epoch)`` shuffles the order), so the same
seed gives the same batches bit for bit.

One departure: ``shard_arrays`` shards by ``size()``/``rank()``, where the
JAX package reads ``cross_size()``/``cross_rank()``. A JAX process drives
every chip of its host and feeds them one batch; a port process drives one
GPU and reads its own shard (``ElasticSampler`` does the same).

On the card, ``prefetch_to_device`` copies each host batch into pinned
memory and from there with ``non_blocking=True`` on a side CUDA stream;
the consumer's stream waits on the copy's event before the batch is
handed out, and ``record_stream`` tells the caching allocator that the
consumer's stream uses the memory. A batch is gathered and pinned on the
host, and its copy issued, when the loop asks for the batch before it.
In a loop whose steps wait on the card (a hook step's ``opt.step()``
waits on the gradients) that host work runs while the card is idle, and
the copy runs before the next kernel is launched: traced on an H100 with
VGG-16 at 64 images of 224², 17-23 ms of idle card before each 0.8 ms
copy, none of it under a kernel (``chip_smoke.py``'s loader phase). On
the CPU (tests: ``device="cpu"``) a batch is a plain copy.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..common import context as ctx_mod


def shard_arrays(arrays: Sequence[np.ndarray], shard_id: Optional[int] = None,
                 num_shards: Optional[int] = None) -> list[np.ndarray]:
    """This rank's strided shard of host arrays (Horovod's
    ``dataset.shard(size, rank)``; a rank is a GPU)."""
    if num_shards is None:
        num_shards = max(ctx_mod.size(), 1)
    if shard_id is None:
        shard_id = ctx_mod.rank() if num_shards > 1 else 0
    return [np.ascontiguousarray(a[shard_id::num_shards]) for a in arrays]


def batch_iterator(arrays: Sequence[np.ndarray], batch_size: int,
                   shuffle: bool = True, seed: int = 0,
                   drop_remainder: bool = True) -> Iterator[tuple]:
    """Epoch iterator over aligned arrays."""
    n = len(arrays[0])
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    end = (n - n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        yield tuple(a[idx] for a in arrays)


def _tree_map(fn, batch):
    """``fn`` over the leaves of a batch: a tuple, list or dict of arrays,
    or one array."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, x) for x in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _leaves(batch) -> list:
    out = []
    _tree_map(out.append, batch)
    return out


def prefetch_to_device(it: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Wrap a host-batch iterator so its copies are issued ahead of use:
    up to ``size`` batches in flight, yielded in order as tensors on
    ``device`` (default: the rank's GPU, ``hvd.device()`` after
    ``init``)."""
    device = (torch.device(device) if device is not None
              else ctx_mod.default_device())
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)

        def put(batch):
            with torch.cuda.stream(stream):
                out = _tree_map(lambda x: torch.as_tensor(x).pin_memory().to(
                    device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(stream)
            return out, done

        def take(entry):
            out, done = entry
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in _leaves(out):
                t.record_stream(consumer)
            return out
    elif device.type == "cpu":
        def put(batch):
            return _tree_map(lambda x: torch.tensor(np.asarray(x)), batch)

        def take(entry):
            return entry
    else:
        raise ValueError(f"prefetch_to_device: device {device} is neither "
                         "CUDA nor the CPU")

    queue: collections.deque = collections.deque()
    it = iter(it)
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = take(queue.popleft())
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out


class ShardedLoader:
    """Shard, shuffle per epoch, batch, prefetch.

    .. code-block:: python

        loader = ShardedLoader((x, y), batch_size=128)
        for epoch in range(epochs):
            for bx, by in loader.epoch(epoch):
                loss = step(bx, by)

    With ``prefetch`` 0 the batches stay host numpy; else they are tensors
    on ``device`` (default: the rank's GPU).
    """

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, drop_remainder: bool = True,
                 device=None):
        self.arrays = shard_arrays(arrays)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self.device = device

    def __len__(self) -> int:
        n = len(self.arrays[0])
        return n // self.batch_size if self.drop_remainder else \
            -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[tuple]:
        it = batch_iterator(self.arrays, self.batch_size, self.shuffle,
                            self.seed + epoch, self.drop_remainder)
        if self.prefetch > 0:
            return prefetch_to_device(it, self.prefetch, self.device)
        return it
