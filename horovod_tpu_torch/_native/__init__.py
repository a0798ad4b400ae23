"""The fusion buffer of the background runtime and the megaplan's chained
dispatch — counterpart of ``FusionBuffer``, ``StagingRing`` and
``chain_dispatch`` in ``horovod_tpu/_native/__init__.py`` (:179-433,
:309-344), rebuilt for the card.

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

``chain_dispatch`` replays a captured step (``ops/megaplan.py``) chunk by
chunk under the stream contract of ``ops/queue.py``: the comm stream waits
on each chunk's ready events before its pack reads the gradients, and
records a done event after its unpack, with the chunk's tensors marked as
used there (``wait_ready`` and ``record_done``, which the negotiated path
calls too).
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


def wait_ready(stream, events) -> None:
    """Make ``stream`` wait on each distinct event of ``events`` (recorded
    on the callers' streams at enqueue); nothing on the CPU (``stream``
    None)."""
    if stream is None:
        return
    for ev in {id(e): e for e in events if e is not None}.values():
        stream.wait_event(ev)


def record_done(stream, tensors):
    """Mark ``tensors`` as used on ``stream`` and return an event recorded
    after its last kernel; None on the CPU."""
    if stream is None:
        return None
    for t in tensors:
        t.record_stream(stream)
    done = torch.cuda.Event()
    done.record(stream)
    return done


def chain_dispatch(buffer: FusionBuffer, steps, stream=None):
    """Run a captured step's chunks in their captured order, with no
    negotiation, grouping or plan lookup. ``steps`` holds ``(plan, inputs,
    outputs, ready events)`` a chunk, ``plan`` an
    ``ops.collectives.FusedChunkPlan``; ``stream`` is the comm stream the
    chain is issued on (None on the CPU).

    Returns ``(outs, exc)``: the done event (None on the CPU) of every
    chunk that was fully issued, and the failure that stopped the chain
    (None when none did). The caller fails the entries of the chunks after
    ``outs``."""
    outs = []
    for plan, inputs, outputs, ready in steps:
        try:
            wait_ready(stream, ready)
            plan.execute(inputs, outputs, buffer)
            outs.append(record_done(stream, inputs + [
                o for o, i in zip(outputs, inputs) if o is not i]))
        except Exception as exc:
            return outs, exc
    return outs, None
