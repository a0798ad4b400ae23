"""The fusion buffer of the background runtime — counterpart of
``FusionBuffer`` and ``StagingRing`` in ``horovod_tpu/_native/__init__.py``
(:179-433), rebuilt for the card.

Gradients already live on the device, so the JAX package's host pack
(``core.cc``) has no counterpart, and neither has its ring of slots: the
JAX ring lets a host pack into one slot while the device still reads
another, and retires a slot on the program's completion token. Here every
fused chunk's pack, collective and unpack are issued on the runtime's one
comm stream, in order (``dist.all_reduce`` without ``async_op`` makes the
current stream wait on the communicator's), so the next chunk's pack
cannot start before the last unpack has read the buffer. One buffer of
``nbytes`` on the runtime's device, allocated at first use (an idle
runtime pins nothing), is therefore all a chunk needs: no event, no lock
and no host wait. On the CPU the chain runs to its end on the cycle thread.
A second slot would pay off only beside a second stream or device to
overlap with.
"""

from __future__ import annotations

import torch


class FusionBuffer:
    """The runtime's pack target: one device buffer sized to the fusion
    threshold, reused by every fused chunk."""

    def __init__(self, nbytes: int, device: torch.device):
        self.capacity = max(0, int(nbytes))
        self.device = torch.device(device)
        self._buf = None

    def lease(self, dtype: torch.dtype, numel: int) -> torch.Tensor:
        """A 1-D ``dtype`` view of the buffer's first ``numel`` elements."""
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        if nbytes > self.capacity:
            raise ValueError(f"a chunk of {nbytes} bytes exceeds the "
                             f"fusion buffer's {self.capacity}")
        if self._buf is None:
            self._buf = torch.empty(self.capacity, dtype=torch.uint8,
                                    device=self.device)
        # offset 0 of an allocation, whose alignment suits every dtype
        return self._buf[:nbytes].view(dtype)

    def allocated_bytes(self) -> int:
        return 0 if self._buf is None else int(self._buf.numel())
