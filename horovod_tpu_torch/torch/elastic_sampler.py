"""Elastic-aware distributed sampler for torch DataLoaders — counterpart
of ``horovod_tpu/torch/elastic_sampler.py`` (the reference Horovod's
``torch/elastic/sampler.py``).

``ElasticSampler`` shards the dataset over the workers and records the
indices processed, so that after an elastic reset mid-epoch (a resize or a
recovery) the unprocessed remainder is shuffled (``random.Random(seed +
epoch)``), padded and strided over the new world, and nothing processed is
seen again. It shards by ``size()``/``rank()``: a port rank is one process
driving one GPU. The JAX package's sampler reads ``cross_size()``/
``cross_rank()``, which count hosts in the port (ROADMAP.md queue 3); at
``cross_size() == W`` the two give the same indices.
"""

from __future__ import annotations

import math
import random
from typing import Iterator

import torch.utils.data



class ElasticSampler(torch.utils.data.Sampler):
    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set[int] = set()
        self.num_replicas = 1
        self.rank = 0
        self.remaining_indices: list[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.indices: list[int] = []
        self.reset()

    # -- epoch / progress tracking ------------------------------------------
    def set_epoch(self, epoch: int):
        """New epoch: clear progress and re-shard (reference set_epoch)."""
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int):
        """Mark one local batch as processed."""
        self.record_indices(self.get_indices(batch_idx, batch_size))

    def record_indices(self, indices):
        self.processed_indices.update(indices)

    def get_indices(self, batch_idx: int, batch_size: int) -> list[int]:
        start = batch_idx * batch_size
        return self.indices[start:start + batch_size]

    # -- elastic reset -------------------------------------------------------
    def reset(self):
        """Re-shard the *unprocessed* remainder over the current world
        (called by set_epoch, and by TorchState on elastic reset)."""
        from ..common import context

        if context.is_initialized():
            self.num_replicas = max(context.size(), 1)
            self.rank = context.rank() if self.num_replicas > 1 else 0
        else:
            self.num_replicas, self.rank = 1, 0

        remaining = [i for i in range(len(self.dataset))
                     if i not in self.processed_indices]
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(remaining)
        self.remaining_indices = remaining

        self.num_samples = int(
            math.ceil(len(remaining) / float(self.num_replicas)))
        self.total_size = self.num_samples * self.num_replicas
        # pad to equal per-worker length (torch DistributedSampler
        # convention; keeps collective step counts aligned)
        padded = list(remaining)
        if padded:
            while len(padded) < self.total_size:
                padded += padded[:self.total_size - len(padded)]
        self.indices = padded[self.rank:self.total_size:self.num_replicas]

    # -- Sampler protocol ----------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        self.reset()
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples

    # -- elastic state (consumed by TorchState's sampler handling) ----------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def load_state_dict(self, state: dict):
        self.epoch = int(state.get("epoch", 0))
        self.processed_indices = set(state.get("processed_indices", ()))
        self.reset()
