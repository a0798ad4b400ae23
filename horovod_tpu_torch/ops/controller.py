"""Cross-process negotiation of globally ready named tensors — counterpart
of ``horovod_tpu/ops/controller.py`` (``entry_signature`` :124,
``KVController`` :171, ``_Coordinator`` :781), in the reference's
controller role: each cycle every worker posts the names it has ready, the
coordinator (rank 0) counts them, checks that every rank sent the same
signature (a mismatch fails that name on every rank) and publishes the
ready names in one order, which every rank then executes.

Transport is the launcher's KV store (``runner/http_server.py``). The round
protocol is the JAX package's, byte for byte, whose payloads
``ops/wire.py`` encodes and decodes (round r, prefix P = ctl/e{epoch}g{gen}):

    worker k:  PUT P/r{r}/ready/{k} = JSON {"e": [[name, sig], ...],
                                           "j": joined?, "sd": shutting down?}
               (or the 1-byte SAME_AS_LAST marker when identical to r-1)
    rank 0:    GET P/r{r}/ready/*  -> count, validate, order
               PUT P/r{r}/resp     = JSON {"ready", "sigs", "errors",
                                           "join_done"[, "shutdown_done"]}
    worker k:  GET P/r{r}/resp (blocking)

Rounds advance in lockstep, and rank 0 deletes round r-2.

The hierarchical rounds (``HOROVOD_HIER_NEGOTIATION``, JAX :41-52): every
rank advertises wire v2 in its round-0 submission (``"wv": 2``); when every
rank did, the coordinator confirms it in the round-0 response, and from
round 1 on the payloads are the binary frames of ``ops/wire.py`` and a rank
submits through its group's leader, rank ``rank // k * k``
(``HOROVOD_HIER_GROUP_SIZE``), which merges its group into one aggregate
(``P/r{r}/ready/g{gid}``) and fans the response down
(``P/r{r}/g{gid}/resp``). A member whose leader does not answer within
``HOROVOD_HIER_FALLBACK_S`` submits flat and stays flat for
``FLAT_BACKOFF_ROUNDS``, so no round is lost. A world with any rank
without the advert stays on v1, and with the flag off the wire is v1 byte
for byte.

The megaplan lease (``ops/megaplan.py``): with ``HOROVOD_MEGAPLAN`` set the
coordinator counts consecutive rounds in which every source sent the
marker and nothing perturbed the round, and after
``HOROVOD_MEGAPLAN_STABLE_ROUNDS`` of them grants ``"mp": true`` on its
response; a replaying rank submits through ``lease_round``. The lease is
never granted under wire v2, whose leaders merge their groups every round.

Left out, as ROADMAP.md queue 1 lists them: tuned parameters (item 11),
and the tracing, straggler, flight-recorder and fault hooks (items 14
and 16).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from ..common import env as env_schema
from ..utils import metrics as metrics_mod
from ..utils import retry as retry_mod
from . import megaplan as megaplan_mod
from . import wire

LOG = logging.getLogger("horovod_tpu_torch")

# the first byte of every v2 frame (v1 JSON starts with "{" or "[", the
# marker is "=")
_MAGIC_BYTE = bytes((wire.MAGIC_V2,))


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
    reduce op, root rank, prescale, postscale, process set, device], plus,
    for a set other than the global one, its members' global ranks
    (``sig[9]``), which scope the name's readiness to them. allgather and
    alltoall are ragged in the first dimension, marked ``"*"`` and not
    checked. The device field is the device type the collective runs on,
    ``"cuda"`` or ``"cpu"`` (the JAX package names its memory kind there).
    Metadata only, cached on the entry."""
    cached = getattr(entry, "_sig", None)
    if cached is not None:
        return cached
    t = entry.tensor
    shape = [int(n) for n in t.shape]
    if entry.op in ("allgather", "alltoall") and shape:
        shape[0] = "*"
    ps = getattr(entry, "process_set", None)
    ps_name = getattr(ps, "name", None) or "global"
    sig = [entry.op, dtype_name(t.dtype), shape,
           int(entry.reduce_op), entry.root_rank,
           float(entry.prescale_factor), float(entry.postscale_factor),
           ps_name, t.device.type]
    if ps_name != "global":
        # the coordinator keeps no registry of sets: the signature tells
        # it whom to wait for, as in the JAX package
        sig.append(sorted(ps.ranks))
    entry._sig = sig
    return sig


def _source_order(suffix: str):
    """The order in which a round's sources are folded: flat ranks first,
    then leader aggregates ("g<id>"); None for a foreign key under the
    ready/ prefix."""
    if suffix.isdigit():
        return (0, int(suffix))
    if suffix[:1] == "g" and suffix[1:].isdigit():
        return (1, int(suffix[1:]))
    return None


class KVController:
    """One per process; rank 0 also runs the coordinator thread."""

    # a worker waits for a response longer than the coordinator waits for a
    # straggler, so a slow rank stalls a round and never desyncs it
    RESPONSE_TIMEOUT_S = 300.0
    # per-attempt server-side block while polling for the response
    POLL_ATTEMPT_S = 10.0
    SAME_AS_LAST = wire.SAME_AS_LAST
    # after a leader let its group down, its ranks submit flat for this
    # many rounds before they try the hierarchy again
    FLAT_BACKOFF_ROUNDS = 16

    # True while the coordinator's latest response granted the megaplan
    # lease; set every round by _finish_round, read by the cycle's capture
    # gate and the replay's check
    megaplan_lease = False

    def __init__(self, client, rank: int, size: int,
                 poll_timeout: float = RESPONSE_TIMEOUT_S,
                 stall_warning_s: float = 60.0,
                 stall_shutdown_s: float = 0.0,
                 hier: Optional[bool] = None,
                 hier_group_size: Optional[int] = None,
                 hier_fallback_s: Optional[float] = None):
        self.client = client
        self.rank = rank
        self.size = size
        self.round = 0
        self.poll_timeout = poll_timeout
        self.broken = False
        self._last_payload: Optional[bytes] = None
        self.bytes_sent = 0
        self.bytes_received = 0
        self.fast_rounds = 0
        if hier is None:
            hier = env_schema.get_bool(env_schema.HOROVOD_HIER_NEGOTIATION)
        self._hier = bool(hier)
        if hier_group_size is None:
            hier_group_size = env_schema.get_int(
                env_schema.HOROVOD_HIER_GROUP_SIZE, 8)
        self._fallback_s = float(
            hier_fallback_s if hier_fallback_s is not None
            else env_schema.get_float(env_schema.HOROVOD_HIER_FALLBACK_S,
                                      5.0))
        self._set_groups(max(1, int(hier_group_size)))
        # dormant until the round-0 handshake confirms v2
        self._wire_version = wire.WIRE_V1
        self._resp_dec: Optional[wire.ResponseDecoder] = None
        self._last_channel = "flat"  # the channel _last_payload went on
        self._last_agg: Optional[bytes] = None
        self._member_cache: dict[int, dict] = {}  # leader: members' last
        self._flat_until = 0
        self._m_wire_v2: dict = {}  # direction -> counter, made at first use
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

    def _set_groups(self, k: int):
        self._group_size = k
        self._group = self.rank // k
        self._group_ranks = list(range(self._group * k,
                                       min((self._group + 1) * k, self.size)))
        self._member_set = set(self._group_ranks)

    def set_group_size(self, k: int):
        """Adopt a new group size. Every rank must apply it at the same
        round boundary (the JAX package's tuned-parameter push, ROADMAP.md
        queue 1 item 11). Every channel's cache is dropped, so no marker,
        member cache or aggregate of the old grouping is replayed against
        the new one, and a captured megaplan is invalidated."""
        k = max(1, int(k))
        if k == self._group_size:
            return
        self._set_groups(k)
        self._member_cache.clear()
        self._last_payload = None
        self._last_agg = None
        self._last_channel = "flat"
        self._flat_until = 0
        megaplan_mod.invalidate_megaplan("hier_group")

    @property
    def wire_format(self) -> str:
        """"v1" or "v2": what this controller speaks now."""
        return "v2" if self._wire_version >= wire.WIRE_V2 else "v1"

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
            if self._wire_version >= wire.WIRE_V2:
                raw = self._round_v2(r, pending, joined, shutting_down)
                self._wire_count("rx", len(raw))
            else:
                raw = self._round_v1(r, pending, joined, shutting_down)
            self.bytes_received += len(raw)
            resp = self._decode_response(raw)
        except Exception:
            self.broken = True
            raise
        return self._finish_round(resp)

    def lease_round(self) -> dict:
        """A round of a replaying cycle: under the lease this process's
        submission is the last one again, so it puts the verbatim 1-byte
        marker without encoding anything. The response goes through
        ``_finish_round`` like a negotiated one, so aborts, invalidations
        and shutdown are never lost; the caller checks ``megaplan_lease``
        afterwards. Wire v1 only: the lease is never granted under v2."""
        if self.broken:
            raise RuntimeError(
                "controller is broken; re-initialize horovod_tpu_torch")
        r = self.round
        try:
            w = self.SAME_AS_LAST
            self.fast_rounds += 1
            self._m_cache_hit.inc()
            self.client.put(_ctl_scope(r), f"ready/{self.rank}", w)
            self.bytes_sent += len(w)
            self._m_wire_bytes.inc(len(w))
            raw = self._poll_response(r)
            self.bytes_received += len(raw)
            resp = self._decode_response(raw)
        except Exception:
            self.broken = True
            raise
        return self._finish_round(resp)

    def _finish_round(self, resp: dict) -> dict:
        """The control tail that a negotiated and a lease round share:
        abort, the lockstep's advance, cache invalidation, the lease,
        shutdown and the wire handshake."""
        if resp.get("abort"):
            self.broken = True
            raise RuntimeError(resp["abort"])
        self.round += 1
        if resp.get("invalidate"):
            # the coordinator dropped its submission cache (error-closed
            # round): the next round carries a full payload
            self._last_payload = None
            self._last_agg = None
        resp.setdefault("errors", {})
        resp.setdefault("sigs", {})
        resp.setdefault("join_done", None)
        # granted or not every round, so every rank leaves replay at the
        # same boundary
        self.megaplan_lease = bool(resp.get("mp"))
        if resp.get("shutdown_done"):
            self.broken = True  # every rank asked to shut down
        if (self._wire_version < wire.WIRE_V2
                and int(resp.get("wv") or 1) >= wire.WIRE_V2):
            # every rank advertised v2 and the coordinator confirmed:
            # binary frames and the hierarchy from the next round, with
            # fresh caches (a marker never crosses wire formats)
            self._wire_version = wire.WIRE_V2
            self._resp_dec = wire.ResponseDecoder()
            self._last_payload = None
            self._last_agg = None
        return resp

    def _round_v1(self, r: int, pending: dict, joined: bool,
                  shutting_down: bool) -> bytes:
        payload = wire.encode_submission_v1(
            pending.items(), joined, shutting_down,
            wv=wire.WIRE_V2 if self._hier and r == 0 else None)
        w = self._marker_or(payload, "flat")  # v1 has the flat channel only
        self.client.put(_ctl_scope(r), f"ready/{self.rank}", w)
        self.bytes_sent += len(w)
        self._m_wire_bytes.inc(len(w))
        self._last_payload = payload
        return self._poll_response(r)

    # -- wire v2: the hierarchical rounds ----------------------------------

    def _decode_response(self, raw: bytes) -> dict:
        """A v2 frame once the handshake is done, else v1 JSON (the
        coordinator keeps error-close and abort responses in JSON in every
        mode)."""
        if raw[:1] == _MAGIC_BYTE and self._resp_dec is not None:
            return self._resp_dec.decode(raw)
        return wire.decode_response_v1(raw)

    def _wire_count(self, direction: str, n: int) -> None:
        c = self._m_wire_v2.get(direction)
        if c is None:
            c = self._m_wire_v2[direction] = \
                metrics_mod.get_registry().counter(
                    "hvd_controller_wire_bytes_total",
                    "negotiation submission bytes put to the KV store",
                    direction=direction, format="v2")
        c.inc(n)

    def _sent(self, w: bytes) -> None:
        self.bytes_sent += len(w)
        self._wire_count("tx", len(w))

    def _marker_or(self, payload: bytes, channel: str) -> bytes:
        """The marker when ``payload`` repeats the last one sent on
        ``channel``, else the payload."""
        if payload == self._last_payload and self._last_channel == channel:
            self.fast_rounds += 1
            self._m_cache_hit.inc()
            return wire.SAME_AS_LAST
        self._m_cache_miss.inc()
        return payload

    def _round_v2(self, r: int, pending: dict, joined: bool,
                  shutting_down: bool) -> bytes:
        entries = list(pending.items())
        if self.rank == self._group_ranks[0]:
            return self._leader_round(r, entries, joined, shutting_down)
        if r < self._flat_until:
            return self._flat_round(r, entries, joined, shutting_down)
        return self._member_round(r, entries, joined, shutting_down)

    def _flat_round(self, r: int, entries, joined, shutting_down) -> bytes:
        """A v2 submission straight to the coordinator: the fallback, and
        a leader's own path while it backs off."""
        payload = wire.encode_submission(entries, joined, shutting_down)
        w = self._marker_or(payload, "flat")
        self.client.put(_ctl_scope(r), f"ready/{self.rank}", w)
        self._sent(w)
        self._last_payload = payload
        self._last_channel = "flat"
        return self._poll_response(r)

    def _member_round(self, r: int, entries, joined, shutting_down) -> bytes:
        """Submit through the group's leader; submit flat if its fan-down
        does not come within the fallback time."""
        gscope = f"{_ctl_scope(r)}/g{self._group}"
        payload = wire.encode_submission(entries, joined, shutting_down)
        w = self._marker_or(payload, "group")
        try:
            # submit and wait on the fan-down key in one call
            raw = self.client.put_get(gscope, f"ready/{self.rank}", w, "resp",
                                      timeout=min(self._fallback_s,
                                                  self.poll_timeout))
            self._sent(w)
            self._last_payload = payload
            self._last_channel = "group"
            return raw
        except Exception:
            # the leader is suspect: submit flat so the round keeps this
            # rank's tensors, and stay flat for a while
            self._flat_until = r + self.FLAT_BACKOFF_ROUNDS
            self._last_payload = None
            raw = self._flat_round(r, entries, joined, shutting_down)
            # the coordinator may have closed the round on the leader's
            # aggregate without reading the flat submission, so its flat
            # cache for this rank is not to be trusted: markers resume
            # after a clean flat round
            self._last_payload = None
            return raw

    def _leader_round(self, r: int, entries, joined, shutting_down) -> bytes:
        """Gather the group, put one aggregate to the coordinator and fan
        the response down. A failed merge or submit falls back to a flat
        round (the members submit flat on their own timeout), so a dead
        leader stalls a round and never desyncs it."""
        if r < self._flat_until:
            return self._flat_round(r, entries, joined, shutting_down)
        gscope = f"{_ctl_scope(r)}/g{self._group}"
        members = self._group_ranks[1:]
        raw = None
        try:
            w, covered = self._merge_group(r, gscope, members, entries,
                                           joined, shutting_down)
            # submit and wait on the response in one call; a 404 at the
            # deadline means the put landed and the round is still open
            try:
                raw = self.client.put_get(
                    _ctl_scope(r), f"ready/g{self._group}", w, "resp",
                    timeout=max(0.1, min(self.POLL_ATTEMPT_S,
                                         self.poll_timeout / 4.0)))
            except Exception as e:
                if getattr(e, "code", None) != 404:
                    raise
            self._sent(w)
        except Exception:
            self._last_agg = None
            self._last_payload = None
            self._flat_until = r + self.FLAT_BACKOFF_ROUNDS
            raw = self._flat_round(r, entries, joined, shutting_down)
            self._last_payload = None
            return raw
        if members and len(covered) == 1:
            # no member made it into the aggregate: they are flat (or
            # gone); back off with them instead of waiting every round
            self._flat_until = r + self.FLAT_BACKOFF_ROUNDS
        if raw is None:
            raw = self._poll_response(r)
        if members:
            # the members wait on the group's key: unblock them first
            self.client.put(gscope, "resp", raw)
            self._sent(raw)
        return raw

    def _merge_group(self, r: int, gscope: str, members, entries, joined,
                     shutting_down):
        """Collect the members' submissions (those in by the fallback time;
        a member left out submits flat itself), merge them with this
        leader's, and return ``(bytes to put, covered ranks)``. The
        aggregate gets the marker when it repeats the last one."""
        got: dict[int, bytes] = {}
        if members:
            try:
                raw_map = self.client.get_prefix(
                    gscope, "ready/", min_count=len(members),
                    timeout=min(self._fallback_s, self.poll_timeout))
            except Exception:
                raw_map = {}
            for suffix, raw in raw_map.items():
                if suffix.isdigit() and int(suffix) != self.rank \
                        and int(suffix) in self._member_set:
                    got[int(suffix)] = raw
        merged: dict = {}  # (name, canonical sig) -> [name, sig, ranks]
        order: list = []
        covered = {self.rank}
        j_set = {self.rank} if joined else set()
        sd_set = {self.rank} if shutting_down else set()

        def add(name, sig, k):
            key = (name, json.dumps(sig))
            ent = merged.get(key)
            if ent is None:
                merged[key] = [name, sig, {k}]
                order.append(key)
            else:
                ent[2].add(k)

        for name, sig in entries:
            add(name, sig, self.rank)
        for k in sorted(got):
            raw = got[k]
            if raw[:1] == wire.SAME_AS_LAST:
                msg = self._member_cache.get(k)
                if msg is None:
                    # nothing to expand the marker with: the member stays
                    # uncovered and submits flat when no fan-down frees it
                    continue
            else:
                try:
                    msg = wire.decode_submission(raw)
                except wire.WireDecodeError:
                    continue  # a torn frame: the member submits flat
                msg.pop("t", None)  # a traced peer's submit time
                self._member_cache[k] = msg
            covered.add(k)
            if msg.get("j"):
                j_set.add(k)
            if msg.get("sd"):
                sd_set.add(k)
            for name, sig in msg.get("e", []):
                add(name, sig, k)
        items = [tuple(merged[key]) for key in order]
        base = wire.encode_aggregate(self._group, self.size, items, covered,
                                     j_set, sd_set)
        if base == self._last_agg:
            w = wire.SAME_AS_LAST
            self.fast_rounds += 1
            self._m_cache_hit.inc()
        else:
            w = base
            self._m_cache_miss.inc()
        self._last_agg = base
        return w, covered

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


def _flat_contribution(k: int, msg: dict, wv: int) -> dict:
    """One rank's submission ``{"e", "j", "sd"}`` in the coordinator's
    contribution shape: ``{"entries": [(name, sig, ranks)], "covered",
    "j", "sd", "wv"}``, the last three rank sets and a wire version."""
    return {"entries": [(n, sig, {k}) for n, sig in msg.get("e", [])],
            "covered": {k},
            "j": {k} if msg.get("j") else set(),
            "sd": {k} if msg.get("sd") else set(),
            "wv": wv}


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
        # source ("3" a flat rank, "g1" a leader's aggregate) -> its last
        # decoded contribution, for SAME_AS_LAST markers
        self._last_submission: dict[str, dict] = {}
        # wire v2, switched on after the round-0 handshake; its encoder
        # interns across rounds
        self._wire_v2 = False
        self._resp_enc: Optional[wire.ResponseEncoder] = None
        self._m_fanin = None  # hvd_negotiation_fanin, made under v2
        # the sources that closed the last round: size when flat, about
        # size / k under the hierarchy (the bulk read's target)
        self._expected_sources = size
        # the megaplan lease: consecutive all-marker, unperturbed rounds;
        # 0 rounds (HOROVOD_MEGAPLAN unset) never grants it
        self._mp_rounds = 0
        if env_schema.get_bool(env_schema.HOROVOD_MEGAPLAN):
            self._mp_rounds = max(1, env_schema.get_int(
                env_schema.HOROVOD_MEGAPLAN_STABLE_ROUNDS,
                megaplan_mod.DEFAULT_STABLE_ROUNDS))
        self._mp_stable = 0
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
        waiting = {n: sorted(self._required(n) - ranks)
                   for n, (_, ranks) in self.table.items()
                   if self._required(n) - ranks}
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
        self._mp_stable = 0
        self.client.put(_ctl_scope(r), "resp", wire.encode_response_v1(
            {"ready": [], "errors": errors, "invalidate": True}))

    def _decode_contribution(self, source: str, raw: bytes) -> dict:
        """One source's submission in the contribution shape, the format
        sniffed a frame (marker, v2 binary, v1 JSON), so a flat rank and a
        leader's aggregate can share a round; ``mk`` says the source sent
        the marker. The decoded contribution is kept for markers."""
        if raw[:1] == wire.SAME_AS_LAST:
            base = self._last_submission.get(source)
            if base is None:
                # nothing cached: an empty submission, which covers a flat
                # rank (a group's marker can claim nothing)
                base = {"entries": [], "j": set(), "sd": set(),
                        "wv": wire.WIRE_V1,
                        "covered": (set() if source[:1] == "g"
                                    else {int(source)})}
            return dict(base, mk=True)
        if raw[:1] == _MAGIC_BYTE:
            if wire.is_aggregate(raw):
                m = wire.decode_aggregate(raw)
                contrib = {"entries": [(n, sig, set(ranks))
                                       for n, sig, ranks in m["e"]],
                           "covered": set(m["covered"]),
                           "j": set(m["j"]), "sd": set(m["sd"]),
                           "wv": wire.WIRE_V2}
            else:
                contrib = _flat_contribution(
                    int(source), wire.decode_submission(raw), wire.WIRE_V2)
        else:
            msg = wire.decode_response_v1(raw)
            if isinstance(msg, list):  # a bare entry list
                msg = {"e": msg}
            contrib = _flat_contribution(int(source), msg,
                                         int(msg.get("wv") or 1))
        self._last_submission[source] = contrib
        return dict(contrib, mk=False)

    def _gather_round(self, r: int) -> Optional[list]:
        """Read submissions until every rank is covered (a flat source
        covers its rank, an aggregate its bitmap), one bulk read a poll,
        naming the missing ranks when the round stalls. Returns
        ``[(source, contribution)]`` in folding order, or None when
        stopping or after an error-close."""
        got: dict[str, dict] = {}
        covered: set[int] = set()
        world = set(range(self.size))
        start = time.monotonic()
        warned_at = 0.0
        # the fan-in of the last round: size flat sources, about size / k
        # aggregates under the hierarchy; the short first poll bounds the
        # stall of the round where the count shrinks
        min_count = max(1, min(self._expected_sources, self.size))
        poll_s = 0.05
        while covered != world and not self._stop_evt.is_set():
            raw_map = self.client.get_prefix(_ctl_scope(r), "ready/",
                                             min_count=min_count,
                                             timeout=poll_s)
            for suffix, raw in raw_map.items():
                if suffix in got or _source_order(suffix) is None:
                    continue
                contrib = self._decode_contribution(suffix, raw)
                got[suffix] = contrib
                covered |= contrib["covered"]
            missing = world - covered
            elapsed = time.monotonic() - start
            if missing and elapsed - warned_at > self.stall_warning_s:
                self._warn_stall(r, missing, elapsed)
                warned_at = elapsed
            if (missing and self.stall_shutdown_s > 0
                    and elapsed > self.stall_shutdown_s):
                self._error_close_round(r, missing, elapsed)
                return None
            min_count = min(self.size, len(got) + 1)
            poll_s = min(self.POLL_TIMEOUT_S, poll_s * 4)
        if covered != world:
            return None
        self._expected_sources = max(1, len(got))
        return sorted(got.items(), key=lambda kv: _source_order(kv[0]))

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
                contribs = self._gather_round(r)
                if contribs is None:
                    if self._stop_evt.is_set():
                        return
                    r += 1  # error-closed round: the lockstep advances
                    continue
                resp = self._respond_round([c for _, c in contribs])
                if (r == 0 and not self._wire_v2
                        and all(c["wv"] >= wire.WIRE_V2
                                for _, c in contribs)):
                    # every rank advertised v2 in round 0: confirm it in
                    # this (JSON) response; a rank without the advert
                    # keeps the world on v1
                    resp["wv"] = wire.WIRE_V2
                if self._mp_rounds:
                    # the lease: an all-marker round that nothing perturbed
                    # extends the streak, anything else resets it; never
                    # under v2, where no per-rank marker is seen
                    stable = (not resp["errors"]
                              and resp["join_done"] is None
                              and not self._joined and not self._down
                              and not self._wire_v2 and "wv" not in resp
                              and all(c["mk"] for _, c in contribs))
                    self._mp_stable = self._mp_stable + 1 if stable else 0
                    if self._mp_stable >= self._mp_rounds:
                        resp["mp"] = True
                raw_resp = (self._resp_enc.encode(resp)
                            if self._resp_enc is not None
                            else wire.encode_response_v1(resp))
                self.client.put(_ctl_scope(r), "resp", raw_resp)
                resp_published = True
                if resp.get("wv"):
                    self._wire_v2 = True
                    self._resp_enc = wire.ResponseEncoder()
                self._m_responses.inc()
                self._m_errors.inc(len(resp["errors"]))
                if self._wire_v2:
                    if self._m_fanin is None:
                        self._m_fanin = metrics_mod.get_registry().gauge(
                            "hvd_negotiation_fanin",
                            "submission sources the coordinator merged in "
                            "the last negotiation round")
                    self._m_fanin.set(len(contribs))
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
        """``_respond_round`` over flat v1 submissions, ``{rank: {"e",
        "j", "sd"}}``."""
        return self._respond_round([_flat_contribution(k, subs[k],
                                                       wire.WIRE_V1)
                                    for k in sorted(subs)])

    def _respond_round(self, contribs: list) -> dict:
        """Fold one round's contributions into the table and build the
        response: a name is ready when every rank it requires (its set's
        members) submitted it or has joined (joined ranks contribute
        zeros); one real submission is needed, so a join alone fires
        nothing."""
        for c in contribs:
            for k in sorted(c["j"]):
                if k not in self._joined:
                    self._joined.add(k)
                    self._last_joined_rank = k
            self._down |= c["sd"]
            for name, sig, ranks in c["entries"]:
                for k in sorted(ranks):
                    self._increment(name, sig, k)
        self._check_stalled_tensors()
        ready = [n for n in self.order
                 if n not in self.errors
                 and not (self._required(n) - self.table[n][1]
                          - self._joined)]
        join_done = None
        if len(self._joined) == self.size:
            join_done = self._last_joined_rank
            self._joined.clear()
            self._last_joined_rank = -1
            # a repeated submission must not join again
            for c in self._last_submission.values():
                c["j"] = set()
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
        for n, (_, ranks) in list(self.table.items()):
            missing = sorted(self._required(n) - ranks - self._joined)
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

    def _required(self, name: str) -> set:
        """The ranks that must submit ``name``: its set's members when the
        signature carries them, else the world."""
        sig = self.table[name][0]
        if len(sig) > 9 and sig[9]:
            return set(sig[9])
        return set(range(self.size))

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
