"""The port's hierarchical negotiation and the coordinator's megaplan lease
(``horovod_tpu_torch/ops/controller.py``) on the schedules of
``tests/test_hier_negotiation.py`` and ``tests/test_megaplan.py``'s lease
test, without KV shards (the port's store has none): N controllers on N
threads against one real ``RendezvousServer``, which runs the whole round
protocol with thread-level concurrency.

- the round-0 handshake into wire v2, the coordinator's fan-in N/k, the
  markers on the group channel;
- a world with one rank that does not advertise v2 stays on v1;
- a leader whose merge fails: it and its members submit flat for the
  round, and no rank loses a tensor or desyncs;
- the flag off: the v1 submissions are the JAX controller's byte for byte
  and no v2 series exists (a fresh process);
- the lease granted after the stable rounds, renewed by lease rounds and
  dropped for every rank in the round one rank breaks stability, the same
  sequence from both packages; never granted under v2;
- JAX-package and port controllers in one world on one server, either as
  rank 0: every rank agrees on every round and speaks v2.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from horovod_tpu.ops import controller as jctl
from horovod_tpu.runner.http_server import KVStoreClient as JClient
from horovod_tpu.runner.http_server import RendezvousServer as JServer
from horovod_tpu_torch.ops import controller as pctl
from horovod_tpu_torch.runner.http_server import KVStoreClient as PClient
from horovod_tpu_torch.runner.http_server import RendezvousServer as PServer
from horovod_tpu_torch.utils import metrics as pmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIG = ["allreduce", "float32", [1024], 0, -1, 1.0, 1.0, "global", "cpu"]
SIG2 = ["allgather", "int32", [8], 2, None, 1.0, 1.0, "global", "cpu"]
PORT = (pctl.KVController, PClient)
JAX = (jctl.KVController, JClient)


def _world(nranks, schedule, *, group_size=4, fallback_s=5.0, hier=True,
           legacy_ranks=(), kinds=None, server=PServer, timeout_s=60.0):
    """Run ``nranks`` controllers through ``schedule`` (a pending dict a
    round, every rank the same); ``kinds[rank]`` is (controller class,
    client class), the port's by default. Returns (controllers, per-rank
    results: (sorted ready, errors) a round)."""
    srv = server()
    port = srv.start()
    ctls = [None] * nranks
    results = [[] for _ in range(nranks)]
    errs = []

    def run(rank):
        ctl_cls, cli_cls = (kinds or {}).get(rank, PORT)
        try:
            ctl = ctls[rank] = ctl_cls(
                cli_cls("127.0.0.1", port), rank, nranks,
                poll_timeout=timeout_s,
                hier=hier and rank not in legacy_ranks,
                hier_group_size=group_size, hier_fallback_s=fallback_s)
            for pending in schedule:
                resp = ctl.negotiate(dict(pending))
                results[rank].append((sorted(resp["ready"]),
                                      dict(resp["errors"])))
        except Exception as e:
            errs.append((rank, repr(e)))
        finally:
            if ctls[rank] is not None:
                ctls[rank].stop()

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"world-rank{r}")
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
    hung = [t.name for t in threads if t.is_alive()]
    srv.stop()
    assert not hung, f"ranks wedged: {hung}"
    assert not errs, f"ranks failed: {errs}"
    return ctls, results


def _assert_agreed(results, schedule):
    for rank_res in results:
        assert rank_res == [(sorted(p), {}) for p in schedule]


SCHEDULE = [{"warm": SIG},                                 # v1 handshake
            {f"t0_{j}": SIG for j in range(4)},            # binary from here
            {f"t1_{j}": (SIG if j % 2 else SIG2) for j in range(4)},
            {},                                            # an idle round
            {"steady": SIG}, {"steady": SIG}]              # markers


@pytest.mark.parametrize("nranks,k", [(8, 4), (4, 2)])
def test_hier_world_switches_to_v2_with_fan_in_n_over_k(nranks, k):
    ctls, results = _world(nranks, SCHEDULE, group_size=k)
    _assert_agreed(results, SCHEDULE)
    assert all(c.wire_format == "v2" for c in ctls)
    assert sum(c.fast_rounds for c in ctls) > 0
    assert pmetrics.get_registry().gauge(
        "hvd_negotiation_fanin").value == nranks // k


def test_mixed_world_stays_v1():
    schedule = SCHEDULE[:3]
    ctls, results = _world(6, schedule, group_size=4, legacy_ranks=(3,))
    _assert_agreed(results, schedule)
    assert all(c.wire_format == "v1" for c in ctls)


class _DeadLeader(pctl.KVController):
    """A leader whose merge fails in round 1 (the JAX tests inject this at
    their ``leader.merge`` fault point, which the port does not have)."""

    def _merge_group(self, r, *a, **kw):
        if r == 1:
            raise RuntimeError("leader died in its merge")
        return super()._merge_group(r, *a, **kw)


@pytest.mark.parametrize("leader", [0, 4])
def test_dead_leader_falls_back_flat_without_desync(leader):
    schedule = [{"warm": SIG}, {f"t{j}": SIG for j in range(3)},
                {"after0": SIG}, {"after1": SIG}]
    kinds = {leader: (_DeadLeader, PClient)}
    ctls, results = _world(8, schedule, group_size=4, fallback_s=0.3,
                           kinds=kinds)
    _assert_agreed(results, schedule)
    assert all(not c.broken and c.wire_format == "v2" for c in ctls)
    # the leader and its members back off from the failed round (the other
    # group's members may too: the round waited on the flat submissions
    # past their own fallback time)
    assert all(ctls[r]._flat_until == 1 + pctl.KVController
               .FLAT_BACKOFF_ROUNDS for r in range(leader, leader + 4))


class _Recording:
    """Mixin for a KV client: records every submission it puts."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.submissions = []

    def put(self, scope, key, value):
        if key.startswith("ready/"):
            self.submissions.append(bytes(value))
        super().put(scope, key, value)


_FLAG_OFF = textwrap.dedent("""
    import json, sys, threading
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    from horovod_tpu_torch.ops import controller as pctl
    from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                      RendezvousServer)
    from horovod_tpu_torch.utils import metrics
    SCHEDULE = json.loads(sys.argv[1])

    class Rec(KVStoreClient):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.submissions = []

        def put(self, scope, key, value):
            if key.startswith("ready/"):
                self.submissions.append(bytes(value).hex())
            super().put(scope, key, value)

    srv = RendezvousServer()
    port = srv.start()
    clis = [Rec("127.0.0.1", port) for _ in range(2)]
    ctls = [None, None]
    def run(r):
        ctls[r] = pctl.KVController(clis[r], r, 2, poll_timeout=30.0)
        for pending in SCHEDULE:
            ctls[r].negotiate(dict(pending))
        ctls[r].stop()
    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    srv.stop()
    reg = metrics.get_registry()
    print(json.dumps({
        "subs": [c.submissions for c in clis],
        "formats": [c.wire_format for c in ctls],
        "names": sorted(reg.names()),
        "v2_series": [k[0] for k in reg._metrics
                      if dict(k[1]).get("format") == "v2"]}))
""")


def test_flag_off_v1_wire_is_the_jax_packages_and_no_new_series():
    schedule = [{"warm": SIG}, {"a": SIG, "b": SIG2},
                {"a": SIG, "b": SIG2}]  # the same set again: the marker
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_HIER_NEGOTIATION", "HOROVOD_MEGAPLAN")}
    out = subprocess.run([sys.executable, "-c", _FLAG_OFF,
                          json.dumps(schedule)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    port = json.loads(out.stdout.strip().splitlines()[-1])
    assert port["formats"] == ["v1", "v1"]
    assert "hvd_negotiation_fanin" not in port["names"]
    assert port["v2_series"] == []
    ctls, _ = _world(2, schedule, hier=False, server=JServer,
                     kinds={r: (jctl.KVController,
                                type("Rec", (_Recording, JClient), {}))
                            for r in (0, 1)})
    jax_subs = [[w.hex() for w in c.client.submissions] for c in ctls]
    assert port["subs"] == jax_subs
    for subs in port["subs"]:
        raw = [bytes.fromhex(w) for w in subs]
        assert raw[2] == b"="
        assert all(set(json.loads(w)) == {"e", "j", "sd"} for w in raw[:2])


def _both(ctl0, ctl1, fn0, fn1):
    out = {}

    def side():
        out["r1"] = fn1(ctl1)

    t = threading.Thread(target=side)
    t.start()
    out["r0"] = fn0(ctl0)
    t.join(timeout=60)
    assert not t.is_alive()
    return out["r0"], out["r1"]


def _lease_sequence(kind, server) -> list:
    """``test_coordinator_grants_and_drops_lease``'s rounds on two ranks of
    ``kind``; returns (ready on 0, ready on 1, lease on 0, lease on 1) a
    round."""
    ctl_cls, cli_cls = kind
    srv = server()
    port = srv.start()
    sig = {"c0": list(SIG)}
    sig2 = {"c0": list(SIG), "c1": list(SIG)}
    ctl0 = ctl_cls(cli_cls("127.0.0.1", port), rank=0, size=2,
                   poll_timeout=60.0)
    ctl1 = ctl_cls(cli_cls("127.0.0.1", port), rank=1, size=2,
                   poll_timeout=60.0)
    neg = lambda s: (lambda c: c.negotiate(dict(s)))  # noqa: E731
    lease = lambda c: c.lease_round()  # noqa: E731
    rounds = ([(neg(sig), neg(sig))] * 3 + [(lease, lease)]
              + [(lease, neg(sig2))] + [(neg(sig2), neg(sig2))] * 3)
    seq = []
    try:
        for f0, f1 in rounds:
            r0, r1 = _both(ctl0, ctl1, f0, f1)
            seq.append((r0["ready"], r1["ready"], ctl0.megaplan_lease,
                        ctl1.megaplan_lease))
    finally:
        ctl0.stop()
        ctl1.stop()
        srv.stop()
    return seq


def test_coordinator_grants_and_drops_lease(monkeypatch):
    monkeypatch.setenv("HOROVOD_MEGAPLAN", "1")
    monkeypatch.setenv("HOROVOD_MEGAPLAN_STABLE_ROUNDS", "2")
    seq = _lease_sequence(PORT, PServer)
    leases = [s[2] for s in seq]
    assert all(s[2] == s[3] for s in seq)  # every rank in the same round
    # full payloads, two marker rounds, granted; a lease round renews it;
    # rank 1 breaks stability mid-replay: dropped for both, the common
    # subset still released; three stable rounds bring it back
    assert leases == [False, False, True, True, False, False, False, True]
    assert seq[4][:2] == (["c0"], ["c0"])
    assert seq == _lease_sequence(JAX, JServer)


def test_no_lease_under_v2(monkeypatch):
    monkeypatch.setenv("HOROVOD_MEGAPLAN", "1")
    monkeypatch.setenv("HOROVOD_MEGAPLAN_STABLE_ROUNDS", "2")
    schedule = [{"steady": SIG}] * 8
    ctls, results = _world(4, schedule, group_size=2)
    _assert_agreed(results, schedule)
    assert all(c.wire_format == "v2" and not c.megaplan_lease
               for c in ctls)
    assert ctls[0]._coord._mp_rounds == 2
    assert ctls[0]._coord._mp_stable == 0


@pytest.mark.parametrize("rank0", ["jax", "port"])
def test_jax_and_port_controllers_share_one_hier_world(rank0):
    """Ranks alternate between the packages, so each group of two has a
    leader of one package and a member of the other."""
    first, second = (JAX, PORT) if rank0 == "jax" else (PORT, JAX)
    kinds = {r: (first if r % 2 == 0 else second) for r in range(4)}
    ctls, results = _world(4, SCHEDULE, group_size=2, kinds=kinds,
                           server=JServer if rank0 == "jax" else PServer)
    _assert_agreed(results, SCHEDULE)
    assert [c.wire_format for c in ctls] == ["v2"] * 4
    assert [type(c).__module__.split(".")[0] for c in ctls] == [
        ("horovod_tpu" if kinds[r] is JAX else "horovod_tpu_torch")
        for r in range(4)]


def test_set_group_size_regroups_and_invalidates_the_megaplan(monkeypatch):
    """A new group size (the JAX package's tuned-parameter push) regroups
    every rank as the JAX controller does, drops every channel's cache and
    invalidates a live megaplan under reason ``hier_group``."""
    from horovod_tpu_torch.ops import megaplan as pmp

    monkeypatch.setenv("HOROVOD_MEGAPLAN", "1")
    pmp.reset_manager()
    mgr = pmp.init_manager(rank=0)
    try:
        mgr.commit(pmp.Megaplan(sig=(), chunks=(), epoch=pmp.epoch(),
                                plan_epoch=0))
        ctls = {mod: mod.KVController(None, rank=5, size=8,
                                      hier=True, hier_group_size=4)
                for mod in (pctl, jctl)}
        for ctl in ctls.values():
            ctl._last_payload, ctl._last_agg = b"x", b"y"
            ctl._member_cache[4] = {"e": []}
            ctl._flat_until = 9
        before = pmetrics.get_registry().counter_value(
            "hvd_megaplan_invalidations_total", reason="hier_group")
        epoch = pmp.epoch()
        for ctl in ctls.values():
            ctl.set_group_size(2)
        p, j = ctls[pctl], ctls[jctl]
        for attr in ("_group_size", "_group", "_group_ranks", "_member_set",
                     "_member_cache", "_last_payload", "_last_agg",
                     "_last_channel", "_flat_until"):
            assert getattr(p, attr) == getattr(j, attr), attr
        assert p._group_ranks == [4, 5] and p._last_payload is None
        assert mgr.plan is None and pmp.epoch() == epoch + 1
        assert pmetrics.get_registry().counter_value(
            "hvd_megaplan_invalidations_total",
            reason="hier_group") == before + 1
        p.set_group_size(2)  # the same size: nothing happens
        assert pmp.epoch() == epoch + 1
    finally:
        pmp.reset_manager()
