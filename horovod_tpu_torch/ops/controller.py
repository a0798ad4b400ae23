"""Cross-process negotiation of globally ready named tensors — counterpart
of ``horovod_tpu/ops/controller.py`` (``entry_signature`` :124,
``KVController`` :171, ``_Coordinator`` :781), in the reference's
controller role: each cycle every worker posts the names it has ready, the
coordinator (rank 0) counts them, checks that every rank sent the same
signature (a mismatch fails that name on every rank) and publishes the
ready names in one order, which every rank then executes.

Transport is the launcher's KV store (``runner/http_server.py``). The round
protocol is the JAX package's flat v1 wire, byte for byte, whose payloads
``ops/wire.py`` encodes and decodes (round r, prefix P = ctl/e{epoch}g{gen}):

    worker k:  PUT P/r{r}/ready/{k} = JSON {"e": [[name, sig], ...],
                                           "j": joined?, "sd": shutting down?}
               (or the 1-byte SAME_AS_LAST marker when identical to r-1)
    rank 0:    GET P/r{r}/ready/*  -> count, validate, order
               PUT P/r{r}/resp     = JSON {"ready", "sigs", "errors",
                                           "join_done"[, "shutdown_done"]}
    worker k:  GET P/r{r}/resp (blocking)

Rounds advance in lockstep, and rank 0 deletes round r-2. Left out, as
ROADMAP.md queue 1 lists them: the hierarchical v2 rounds (the v2 frames
of ``ops/wire.py`` are ported, the v2 mode is not), the megaplan lease, tuned
parameters, and the tracing, flight-recorder and fault hooks.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from ..common import env as env_schema
from ..utils import metrics as metrics_mod
from ..utils import retry as retry_mod
from . import wire

LOG = logging.getLogger("horovod_tpu_torch")


def _ctl_prefix() -> str:
    """Namespace of this controller generation's rounds: a new lockstep
    must never read a dead generation's rounds left in the store."""
    return (f"ctl/e{os.environ.get(env_schema.HOROVOD_ELASTIC_EPOCH, '0')}"
            f"g{os.environ.get(env_schema.HOROVOD_ELASTIC_GEN, '0')}")


def _ctl_scope(r: int) -> str:
    return f"{_ctl_prefix()}/r{r}"


def dtype_name(dtype) -> str:
    """A dtype as the JAX package's wire names it (``float32``,
    ``bfloat16``, ...), from a ``torch.dtype`` or a numpy dtype."""
    return str(dtype).replace("torch.", "")


def entry_signature(entry) -> list:
    """The fields every rank must agree on for one name: [op, dtype, shape,
    reduce op, root rank, prescale, postscale, process set, device]. The
    device field is the device type the collective runs on, ``"cuda"`` or
    ``"cpu"`` (the JAX package names its memory kind there). Metadata only,
    cached on the entry."""
    cached = getattr(entry, "_sig", None)
    if cached is not None:
        return cached
    t = entry.tensor
    ps = getattr(entry, "process_set", None)
    sig = [entry.op, dtype_name(t.dtype), [int(n) for n in t.shape],
           int(entry.reduce_op), entry.root_rank,
           float(entry.prescale_factor), float(entry.postscale_factor),
           getattr(ps, "name", None) or "global", t.device.type]
    entry._sig = sig
    return sig


class KVController:
    """One per process; rank 0 also runs the coordinator thread."""

    # a worker waits for a response longer than the coordinator waits for a
    # straggler, so a slow rank stalls a round and never desyncs it
    RESPONSE_TIMEOUT_S = 300.0
    # per-attempt server-side block while polling for the response
    POLL_ATTEMPT_S = 10.0
    SAME_AS_LAST = wire.SAME_AS_LAST

    def __init__(self, client, rank: int, size: int,
                 poll_timeout: float = RESPONSE_TIMEOUT_S,
                 stall_warning_s: float = 60.0,
                 stall_shutdown_s: float = 0.0):
        self.client = client
        self.rank = rank
        self.size = size
        self.round = 0
        self.poll_timeout = poll_timeout
        self.broken = False
        self._last_payload: Optional[bytes] = None
        self.bytes_sent = 0
        self.fast_rounds = 0
        reg = metrics_mod.get_registry()
        self._m_cache_hit = reg.counter(
            "hvd_controller_cache_hits_total",
            "negotiation rounds sent as the 1-byte SAME_AS_LAST marker")
        self._m_cache_miss = reg.counter(
            "hvd_controller_cache_misses_total",
            "negotiation rounds sent as a full payload")
        self._m_wire_bytes = reg.counter(
            "hvd_controller_wire_bytes_total",
            "negotiation submission bytes put to the KV store")
        self._coord: Optional[_Coordinator] = None
        if rank == 0:
            self._coord = _Coordinator(client, size,
                                       stall_warning_s=stall_warning_s,
                                       stall_shutdown_s=stall_shutdown_s)
            self._coord.start()

    def negotiate(self, pending: dict[str, list], joined: bool = False,
                  shutting_down: bool = False) -> dict:
        """Submit this process's ready set and block for the round's
        response (``ready`` names in order, ``errors`` by name, ``sigs`` of
        the ready names, ``join_done``). Any failure breaks the controller:
        a worker that missed a round can never rejoin the lockstep."""
        if self.broken:
            raise RuntimeError(
                "controller is broken; re-initialize horovod_tpu_torch")
        r = self.round
        try:
            resp = wire.decode_response_v1(
                self._round_v1(r, pending, joined, shutting_down))
        except Exception:
            self.broken = True
            raise
        if resp.get("abort"):
            self.broken = True
            raise RuntimeError(resp["abort"])
        self.round += 1
        if resp.get("invalidate"):
            # the coordinator dropped its submission cache (error-closed
            # round): the next round carries a full payload
            self._last_payload = None
        resp.setdefault("errors", {})
        resp.setdefault("sigs", {})
        resp.setdefault("join_done", None)
        if resp.get("shutdown_done"):
            self.broken = True  # every rank asked to shut down
        return resp

    def _round_v1(self, r: int, pending: dict, joined: bool,
                  shutting_down: bool) -> bytes:
        payload = wire.encode_submission_v1(pending.items(), joined,
                                            shutting_down)
        if payload == self._last_payload:
            w = wire.SAME_AS_LAST
            self.fast_rounds += 1
            self._m_cache_hit.inc()
        else:
            w = payload
            self._m_cache_miss.inc()
        self.client.put(_ctl_scope(r), f"ready/{self.rank}", w)
        self.bytes_sent += len(w)
        self._m_wire_bytes.inc(len(w))
        self._last_payload = payload
        return self._poll_response(r)

    def _poll_response(self, r: int) -> bytes:
        """Block for round ``r``'s response: short server-side blocking
        GETs re-polled with backoff until ``poll_timeout``."""
        deadline = self.poll_timeout
        start = time.monotonic()
        policy = retry_mod.RetryPolicy(
            max_attempts=None, deadline_s=deadline,
            base_delay_s=0.05, max_delay_s=1.0)

        def attempt():
            remaining = deadline - (time.monotonic() - start)
            per = max(0.1, min(self.POLL_ATTEMPT_S, deadline / 4.0,
                               remaining))
            return self.client.get(_ctl_scope(r), "resp", timeout=per)

        return retry_mod.Retrier("controller.poll", policy).call(attempt)

    def drain_shutdown(self):
        """Shutdown barrier: keep the lockstep alive with empty submissions
        and the ``sd`` flag until the coordinator announces that every rank
        asked to shut down, so a finished rank (rank 0's coordinator
        included) keeps serving peers that still have work."""
        if self.broken:
            return
        try:
            while True:
                resp = self.negotiate({}, shutting_down=True)
                if resp.get("shutdown_done"):
                    return
        except Exception:
            return  # peer gone or round timed out: nothing left to serve

    def stop(self):
        if self._coord:
            self._coord.stop()


class _Coordinator(threading.Thread):
    """Rank 0's aggregation loop (the reference's message table owner). It
    knows which ranks submitted each pending name, so a stalled round or
    tensor is reported with the ranks it waits on, and past
    ``stall_shutdown_s`` it is failed instead of hanging."""

    # per-attempt poll while gathering a round
    POLL_TIMEOUT_S = 1.0

    def __init__(self, client, size: int, stall_warning_s: float = 60.0,
                 stall_shutdown_s: float = 0.0):
        super().__init__(daemon=True, name="hvd-coordinator")
        self.client = client
        self.size = size
        self.stall_warning_s = stall_warning_s
        self.stall_shutdown_s = stall_shutdown_s
        self._stop_evt = threading.Event()
        # name -> (sig, ranks that submitted), kept across rounds
        self.table: dict[str, tuple[list, set[int]]] = {}
        self.order: list[str] = []  # first-submission order
        self.errors: dict[str, str] = {}
        self._down: set[int] = set()
        # source -> last decoded submission, for SAME_AS_LAST markers
        self._last_submission: dict[str, dict] = {}
        self._joined: set[int] = set()
        self._last_joined_rank = -1
        self._first_seen: dict[str, float] = {}
        self._stall_warned: set[str] = set()
        reg = metrics_mod.get_registry()
        self._m_responses = reg.counter(
            "hvd_coordinator_responses_total",
            "negotiation responses published by the rank-0 coordinator")
        self._m_errors = reg.counter(
            "hvd_coordinator_error_tensors_total",
            "tensors failed with per-tensor errors (mismatch/stall)")
        self._m_stall_warn = reg.counter(
            "hvd_coordinator_stall_warnings_total",
            "coordinator stall warnings (round or per-tensor)")

    def _warn_stall(self, round_no: int, missing: set[int], elapsed: float):
        waiting = {n: sorted(set(range(self.size)) - ranks)
                   for n, (_, ranks) in self.table.items()
                   if len(ranks) < self.size}
        detail = "; ".join(
            f"tensor {n!r} waiting on ranks {w}" for n, w in waiting.items()
        ) or "no named tensors pending"
        LOG.warning("Negotiation round %d stalled for %.0f s: ranks %s have "
                    "not reported. %s", round_no, elapsed, sorted(missing),
                    detail)
        self._m_stall_warn.inc()

    def _error_close_round(self, r: int, missing: set[int], elapsed: float):
        """Past stall_shutdown_s: fail every pending tensor, naming the
        absent ranks, and tell workers to resend full payloads."""
        msg = (f"collective negotiation stalled for {elapsed:.0f} s waiting "
               f"on ranks {sorted(missing)}; shutting the round down "
               "(HOROVOD_STALL_SHUTDOWN_TIME_SECONDS exceeded)")
        errors = {n: msg for n in self.order}
        self.table.clear()
        self.order.clear()
        self.errors.clear()
        self._last_submission.clear()
        self.client.put(_ctl_scope(r), "resp", wire.encode_response_v1(
            {"ready": [], "errors": errors, "invalidate": True}))

    def _decode(self, k: int, raw: bytes) -> dict:
        """One rank's submission: {"e": [[name, sig]], "j", "sd"}; a
        SAME_AS_LAST marker repeats the rank's last one."""
        msg = wire.decode_submission_v1(raw,
                                        self._last_submission.get(str(k)))
        self._last_submission[str(k)] = msg
        return msg

    def _gather_round(self, r: int) -> Optional[dict[int, dict]]:
        """Every rank's submission for round ``r`` (one bulk read per poll),
        or None when stopping or after an error-close."""
        got: dict[int, dict] = {}
        world = set(range(self.size))
        start = time.monotonic()
        warned_at = 0.0
        min_count = self.size
        poll_s = 0.05
        while len(got) < self.size and not self._stop_evt.is_set():
            raw_map = self.client.get_prefix(_ctl_scope(r), "ready/",
                                             min_count=min_count,
                                             timeout=poll_s)
            for suffix, raw in raw_map.items():
                if suffix.isdigit() and int(suffix) not in got:
                    got[int(suffix)] = self._decode(int(suffix), raw)
            missing = world - got.keys()
            elapsed = time.monotonic() - start
            if missing and elapsed - warned_at > self.stall_warning_s:
                self._warn_stall(r, missing, elapsed)
                warned_at = elapsed
            if (missing and self.stall_shutdown_s > 0
                    and elapsed > self.stall_shutdown_s):
                self._error_close_round(r, missing, elapsed)
                return None
            poll_s = min(self.POLL_TIMEOUT_S, poll_s * 4)
        return got if len(got) == self.size else None

    def run(self):
        try:
            # drop every dead generation's rounds, never this one's
            self.client.delete_prefix("ctl/", exclude=_ctl_prefix() + "/")
        except Exception:
            pass  # a store without prefix deletes
        r = 0
        resp_published = False
        while not self._stop_evt.is_set():
            try:
                resp_published = False
                subs = self._gather_round(r)
                if subs is None:
                    if self._stop_evt.is_set():
                        return
                    r += 1  # error-closed round: the lockstep advances
                    continue
                resp = self._respond(subs)
                self.client.put(_ctl_scope(r), "resp",
                                wire.encode_response_v1(resp))
                resp_published = True
                self._m_responses.inc()
                self._m_errors.inc(len(resp["errors"]))
                if r >= 2:
                    self.client.delete_scope(_ctl_scope(r - 2))
                if resp.get("shutdown_done"):
                    return  # every rank drained: the lockstep is over
                r += 1
            except Exception as e:
                if self._stop_evt.is_set():
                    return
                LOG.warning("coordinator round %d error: %s", r, e)
                self._abort_close(r + 1 if resp_published else r, e)
                return

    def _respond(self, subs: dict[int, dict]) -> dict:
        """Fold one round's submissions into the table and build the
        response: a name is ready when every rank submitted it or has
        joined (joined ranks contribute zeros); one real submission is
        needed, so a join alone fires nothing."""
        for k in sorted(subs):
            msg = subs[k]
            if msg.get("j") and k not in self._joined:
                self._joined.add(k)
                self._last_joined_rank = k
            if msg.get("sd"):
                self._down.add(k)
            for name, sig in msg.get("e", []):
                self._increment(name, sig, k)
        self._check_stalled_tensors()
        world = set(range(self.size))
        ready = [n for n in self.order
                 if n not in self.errors
                 and not (world - self.table[n][1] - self._joined)]
        join_done = None
        if len(self._joined) == self.size:
            join_done = self._last_joined_rank
            self._joined.clear()
            self._last_joined_rank = -1
        errors = dict(self.errors)
        sigs = {n: self.table[n][0] for n in ready}
        for n in ready + list(errors):
            self.table.pop(n, None)
            if n in self.order:
                self.order.remove(n)
            self.errors.pop(n, None)
            self._first_seen.pop(n, None)
            self._stall_warned.discard(n)
        resp = {"ready": ready, "sigs": sigs, "errors": errors,
                "join_done": join_done}
        if len(self._down) == self.size:
            resp["shutdown_done"] = True
        return resp

    def _abort_close(self, r: int, exc: Exception):
        """Fail fast when the coordinator dies: publish an abort for the
        round workers are (or will next be) blocked on."""
        msg = (f"coordinator aborted in negotiation round: {exc!r}; "
               "pending collectives failed (re-initialize "
               "horovod_tpu_torch)")
        payload = wire.encode_response_v1(
            {"ready": [], "errors": {n: msg for n in self.order},
             "abort": msg, "invalidate": True})
        try:
            self.client.put(_ctl_scope(r), "resp", payload)
        except Exception:
            pass  # store unreachable: workers fall back to their timeout

    def _check_stalled_tensors(self):
        """A tensor submitted by some ranks but not others for longer than
        ``stall_warning_s`` is reported with the absent ranks; past
        ``stall_shutdown_s`` it fails on the ranks that submitted it."""
        now = time.monotonic()
        world = set(range(self.size))
        for n, (_, ranks) in list(self.table.items()):
            missing = sorted(world - ranks - self._joined)
            if not missing or n in self.errors:
                continue
            age = now - self._first_seen.get(n, now)
            if self.stall_shutdown_s > 0 and age > self.stall_shutdown_s:
                self.errors[n] = (
                    f"tensor {n!r} stalled for {age:.0f} s waiting on ranks "
                    f"{missing}; exceeded "
                    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")
            elif age > self.stall_warning_s and n not in self._stall_warned:
                LOG.warning(
                    "Tensor %r has been ready on ranks %s for %.0f s but is "
                    "still waiting on ranks %s. One or more processes may "
                    "have stopped submitting this collective.",
                    n, sorted(ranks), age, missing)
                self._stall_warned.add(n)
                self._m_stall_warn.inc()

    def _increment(self, name: str, sig: list, rank: int):
        """Count one rank's submission of ``name``; a signature that
        differs from the first rank's fails the name on every rank."""
        if name not in self.table:
            self.table[name] = (sig, {rank})
            self.order.append(name)
            self._first_seen[name] = time.monotonic()
            return
        ref_sig, ranks = self.table[name]
        if sig != ref_sig:
            self.errors[name] = (
                f"Mismatched submissions for tensor {name!r}: rank {rank} "
                f"sent {sig}, previously {ref_sig}")
            return
        ranks.add(rank)

    def stop(self):
        self._stop_evt.set()
