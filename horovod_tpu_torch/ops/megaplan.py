"""Whole-step megaplan capture and replay — counterpart of
``horovod_tpu/ops/megaplan.py``, with its names and semantics.

The cycle loop pays host time every working cycle for negotiation,
grouping and a plan lookup a chunk. When the runtime sees the same named
tensor set for ``HOROVOD_MEGAPLAN_STABLE_ROUNDS`` consecutive working
cycles, it captures the step's chunk schedule (the negotiated order, the
chunk grouping and each chunk's ``FusedChunkPlan``) as one
:class:`Megaplan`, and later cycles replay it through
``_native.chain_dispatch`` after one validity check.

Validity is stamped on two axes, so a result never depends on replay:

- the megaplan epoch (:func:`epoch`), bumped by
  :func:`invalidate_megaplan` from the plan cache's invalidation and a
  change of the hierarchical group size;
- the plan epoch (``collectives._plan_epoch``, the elastic generation),
  stamped at capture.

A mismatch of either epoch, of the batch signature (names, shapes,
dtypes, ops, factors, set, wire, residency), of membership (a join, a
pending backlog) or a dropped coordinator lease sends the cycle back to
the negotiated path and re-arms capture. At more than one rank the
coordinator grants a lease (``"mp"`` on its response) after that many
rounds in which every rank sent the 1-byte SAME_AS_LAST marker, so every
rank enters and leaves replay at the same round (``ops/controller.py``).

With ``HOROVOD_MEGAPLAN`` unset no manager exists, the cycle pays one
``is None`` check, and no ``hvd_megaplan_*`` series is registered: the
series are made in ``MegaplanManager.__init__``. The JAX module's
flight-recorder notes wait for the port's recorder (ROADMAP.md queue 1
item 16).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from ..common import env as env_schema
from ..utils import metrics as metrics_mod

DEFAULT_STABLE_ROUNDS = 5

# bumped by every invalidate_megaplan(); a captured plan stamps the value
# it was built under, so a replaying cycle compares one int
_EPOCH = 0

_MANAGER: Optional["MegaplanManager"] = None


def epoch() -> int:
    return _EPOCH


def invalidate_megaplan(reason: str = "invalidation") -> None:
    """The one invalidation funnel: bumps the epoch, so a replaying cycle
    fails its next check, and drops the captured plan."""
    global _EPOCH
    _EPOCH += 1
    mgr = _MANAGER
    if mgr is not None:
        mgr.invalidate(reason)


def batch_signature(batch: Sequence[Any]) -> Tuple:
    """A drained batch's identity, whatever its order: one row an entry,
    (name, op, shape, dtype as numpy spells it, reduce op, pre, post, set,
    wire signature, on the card), sorted by name. A shape, dtype, set or
    residency change under a reused name misses instead of replaying a
    stale chunk."""
    from .controller import dtype_name  # the controller imports this module

    rows = []
    for e in batch:
        t = e.tensor
        q = e.quant
        rows.append((e.name, e.op, tuple(int(n) for n in t.shape),
                     dtype_name(t.dtype), int(e.reduce_op),
                     float(e.prescale_factor), float(e.postscale_factor),
                     getattr(e.process_set, "name", None) or "global",
                     None if q is None else q.signature(),
                     t.device.type == "cuda"))
    rows.sort()
    return tuple(rows)


class Megaplan:
    """One captured step: the ordered chunk chain and the stamps it was
    captured under."""

    __slots__ = ("sig", "chunks", "epoch", "plan_epoch", "tensors",
                 "nbytes")

    def __init__(self, sig: Tuple, chunks: Tuple, epoch: int,
                 plan_epoch: int):
        self.sig = sig
        # (names, FusedChunkPlan, chunk bytes, dtype name) a chunk, in
        # dispatch order; the plan is held here, so an eviction from the
        # plan cache cannot tear a live megaplan
        self.chunks = chunks
        self.epoch = epoch
        self.plan_epoch = plan_epoch
        self.tensors = sum(len(c[0]) for c in chunks)
        self.nbytes = sum(int(c[2]) for c in chunks)


class MegaplanManager:
    """Capture and replay state of one process, driven by the cycle
    thread: armed, then captured. ``observe`` counts identical batch
    signatures on negotiated working cycles, ``commit`` installs a
    captured schedule, and a validity miss or ``invalidate_megaplan``
    drops it and re-arms. ``invalidate`` may run on another thread: it
    only clears references, so the cycle thread sees the old plan (a
    stale epoch, a miss) or None."""

    def __init__(self, rank: int = 0, stable_rounds: Optional[int] = None):
        self.rank = rank
        if stable_rounds is None:
            stable_rounds = env_schema.get_int(
                env_schema.HOROVOD_MEGAPLAN_STABLE_ROUNDS,
                DEFAULT_STABLE_ROUNDS)
        self.stable_rounds = max(1, int(stable_rounds))
        self.plan: Optional[Megaplan] = None
        self._last_sig: Optional[Tuple] = None
        self._stable = 0
        self.capture_rounds = 0  # stable cycles before the last capture
        self.captures = 0
        self.replays = 0
        # cycles after a capture that missed validity: with ``replays``
        # the hit rate's denominator
        self.misses = 0
        self.invalidations = 0
        reg = metrics_mod.get_registry()
        self._reg = reg
        self._m_captures = reg.counter(
            "hvd_megaplan_captures_total",
            "whole-step megaplans captured")
        self._m_replays = reg.counter(
            "hvd_megaplan_replays_total",
            "steady-state cycles replayed from a captured megaplan")
        self._m_active = reg.gauge(
            "hvd_megaplan_active",
            "1 while a captured megaplan is live, 0 while armed")
        self._m_capture_rounds = reg.gauge(
            "hvd_megaplan_capture_rounds",
            "stable cycles observed before the most recent capture")
        self._m_inval: dict = {}  # reason -> counter, made at first use

    def observe(self, sig: Tuple) -> bool:
        """Count stability on a negotiated working cycle; True when this
        cycle should capture: the batch has been the same for
        ``stable_rounds`` cycles and no plan is live."""
        if sig == self._last_sig:
            self._stable += 1
        else:
            self._last_sig = sig
            self._stable = 1
        return self.plan is None and self._stable >= self.stable_rounds

    def commit(self, plan: Megaplan) -> None:
        self.plan = plan
        self.captures += 1
        self.capture_rounds = self._stable
        self._m_captures.inc()
        self._m_active.set(1)
        self._m_capture_rounds.set(self.capture_rounds)

    def abort_capture(self) -> None:
        """A capture failed: a new capture needs a new stable window."""
        self._stable = 0
        self._last_sig = None

    def note_replay(self) -> None:
        self.replays += 1
        self._m_replays.inc()

    def invalidate(self, reason: str = "invalidation") -> None:
        """Drop the captured schedule, if any, and re-arm capture; counted
        only when a plan was live."""
        had = self.plan is not None
        self.plan = None
        self._stable = 0
        self._last_sig = None
        if not had:
            return
        self.invalidations += 1
        self.misses += 1
        m = self._m_inval.get(reason)
        if m is None:
            m = self._m_inval[reason] = self._reg.counter(
                "hvd_megaplan_invalidations_total",
                "captured megaplans dropped back to negotiated mode",
                reason=reason)
        m.inc()
        self._m_active.set(0)

    def replay_hit_rate(self) -> Optional[float]:
        """The replayed share of the cycles after a capture; None before
        any."""
        total = self.replays + self.misses
        if total == 0:
            return None
        return self.replays / total

    def report(self) -> dict:
        plan = self.plan
        out = {"enabled": True, "active": plan is not None,
               "stable_rounds": self.stable_rounds,
               "captures": self.captures, "replays": self.replays,
               "misses": self.misses,
               "invalidations": self.invalidations,
               "capture_rounds": self.capture_rounds,
               "replay_hit_rate": self.replay_hit_rate(),
               "epoch": _EPOCH}
        if plan is not None:
            out["plan"] = {"tensors": plan.tensors,
                           "chunks": len(plan.chunks),
                           "bytes": plan.nbytes,
                           "epoch": plan.epoch,
                           "plan_epoch": plan.plan_epoch}
        return out


# The process's manager: None while HOROVOD_MEGAPLAN is off, so the cycle
# pays one is-None check.

def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_MEGAPLAN)


def get_manager() -> Optional[MegaplanManager]:
    return _MANAGER


def init_manager(rank: int = 0) -> Optional[MegaplanManager]:
    """Make the process's manager when ``HOROVOD_MEGAPLAN`` is set (once);
    None when it is off."""
    global _MANAGER
    if not enabled():
        return _MANAGER
    if _MANAGER is None:
        _MANAGER = MegaplanManager(rank=rank)
    return _MANAGER


def reset_manager() -> None:
    global _MANAGER
    _MANAGER = None


def report() -> dict:
    """``hvd.megaplan_report()``: ``{"enabled": False}`` when off, else
    the counters, the hit rate and the live plan's shape."""
    mgr = _MANAGER
    if mgr is None:
        return {"enabled": False}
    return mgr.report()
