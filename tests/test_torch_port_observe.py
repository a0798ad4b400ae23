"""The port's runtime instruments held against the JAX package's on the
same inputs: the metrics registry and its exposition, the flight
recorder, the timeline writer, the stall inspector, tracing (clock
offset, merged timeline, straggler verdicts, the traced wire), the perf
ledger with its SLO budgets, and the step anatomy. Inputs come from numpy
seeds; every comparison is exact unless it names a tolerance."""

import json
import logging
import os
import time
import types

import numpy as np
import pytest
import torch

from horovod_tpu import _native as jnative
from horovod_tpu.ops import controller as jctl
from horovod_tpu.utils import anatomy as janat
from horovod_tpu.utils import flightrec as jfr
from horovod_tpu.utils import metrics as jmet
from horovod_tpu.utils import perfledger as jperf
from horovod_tpu.utils import stall as jstall
from horovod_tpu.utils import timeline as jtl
from horovod_tpu.utils import tracing as jtr
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import context as pctx
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 StalledTensorError)
from horovod_tpu_torch.ops import controller as pctl
from horovod_tpu_torch.ops import wire as pwire
from horovod_tpu_torch.utils import anatomy as panat
from horovod_tpu_torch.utils import flightrec as pfr
from horovod_tpu_torch.utils import metrics as pmet
from horovod_tpu_torch.utils import perfledger as pperf
from horovod_tpu_torch.utils import stall as pstall
from horovod_tpu_torch.utils import timeline as ptl
from horovod_tpu_torch.utils import tracing as ptr

SEEDS = range(4)


# --- metrics ----------------------------------------------------------------

def _registry_ops(seed: int) -> list:
    """A seeded sequence of registry operations: (kind, name, labels,
    value)."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(60):
        kind = ("counter", "gauge", "histogram")[rng.randint(3)]
        name = f"hvd_{kind}_{rng.randint(3)}"
        labels = {"dtype": ("float32", "bfloat16")[rng.randint(2)]} \
            if rng.rand() < 0.5 else {}
        value = (int(rng.randint(1, 1 << 20)) if rng.rand() < 0.5
                 else float(rng.exponential(0.01)))
        ops.append((kind, name, labels, value))
    return ops


def _apply_ops(mod, ops):
    reg = mod.MetricsRegistry()
    for kind, name, labels, value in ops:
        if kind == "counter":
            reg.counter(name, "c", **labels).inc(value)
        elif kind == "gauge":
            reg.gauge(name, "g", **labels).set(value)
        else:
            reg.histogram(name, "h", buckets=mod.LATENCY_BUCKETS_S,
                          **labels).observe(value)
    return reg


def _no_ts(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k != "ts"}


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_exposition_and_snapshot_match_jax(seed):
    ops = _registry_ops(seed)
    j, p = _apply_ops(jmet, ops), _apply_ops(pmet, ops)
    assert p.render_prometheus() == j.render_prometheus()
    assert _no_ts(p.snapshot()) == _no_ts(j.snapshot())
    for name in {o[1] for o in ops if o[0] == "histogram"}:
        for q in (0.5, 0.95, 0.99):
            assert p.histogram_quantile(name, q) == \
                j.histogram_quantile(name, q)
    names = sorted({o[1] for o in ops if o[0] == "counter"})
    assert p.counter_values(names) == j.counter_values(names)


@pytest.mark.parametrize("seed", SEEDS)
def test_merged_exposition_of_ranks_matches_jax(seed):
    """The launcher's ``/metrics`` render: several ranks' snapshots under
    one family header, each labelled."""
    snaps = [_apply_ops(jmet, _registry_ops(seed + k)).snapshot()
             for k in range(3)]
    extra = [{"rank": str(k)} for k in range(3)]
    extra[2]["stale"] = "1"
    assert (pmet.render_snapshots(list(zip(extra, snaps)))
            == jmet.render_snapshots(list(zip(extra, snaps))))


def test_metrics_dumper_writes_the_snapshot(tmp_path):
    reg = pmet.MetricsRegistry()
    reg.counter("hvd_allreduce_bytes_total", "b", dtype="float32").inc(7)
    path = str(tmp_path / "m.json")
    d = pmet.MetricsDumper(reg, file_path=path, interval_s=60)
    d.start()
    d.stop()  # the final flush writes the file
    with open(path) as f:
        snap = json.load(f)
    assert snap["counters"] == [{"name": "hvd_allreduce_bytes_total",
                                 "labels": {"dtype": "float32"},
                                 "value": 7}]


# --- flight recorder ---------------------------------------------------------

def test_flightrec_categories_match_jax():
    assert pfr.CATEGORIES == jfr.CATEGORIES
    assert pfr.CATEGORY_NAMES == jfr.CATEGORY_NAMES


@pytest.mark.parametrize("seed", SEEDS)
def test_flightrec_records_match_jax(seed):
    rng = np.random.RandomState(seed)
    cats = [c for c, _ in jfr.CATEGORIES]
    notes = [(cats[rng.randint(len(cats))],
              {"round": int(rng.randint(100)), "ok": bool(rng.rand() < .5)})
             for _ in range(40)]
    recs = [mod.FlightRecorder(rank=3, capacity=16) for mod in (jfr, pfr)]
    for cat, kv in notes:
        for r in recs:
            r.note(cat, **kv)

    def strip(evs):
        return [{k: v for k, v in e.items() if k not in ("ts", "ts_mono")}
                for e in evs]

    assert strip(recs[1].events()) == strip(recs[0].events())
    assert len(recs[1]) == 16
    assert strip(recs[1].snapshot(last=5)["events"]) == \
        strip(recs[0].snapshot(last=5)["events"])


def test_flightrec_off_registers_nothing(monkeypatch):
    monkeypatch.delenv("HOROVOD_FLIGHTREC", raising=False)
    pfr.reset_recorder()
    before = pmet.get_registry().names()
    assert pfr.init_recorder() is None and pfr.get_recorder() is None
    pfr.note("init_phase", phase="x")
    assert pmet.get_registry().names() == before


# --- timeline ----------------------------------------------------------------

class _Clock:
    """A fixed clock: every read advances it by 1 ms."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _timeline_calls(tl):
    tl.negotiate_start("grad.a", "ALLREDUCE")
    tl.negotiate_start("grad.b", "ALLREDUCE")
    tl.mark_cycle_start()
    for n in ("grad.a", "grad.b"):
        tl.start_activity(n, "FUSED_ALLREDUCE")
    for n in ("grad.a", "grad.b"):
        tl.end_activity(n)
        tl.negotiate_end(n)
    tl.negotiate_start("x", "BROADCAST")
    tl.start_activity("x", "BROADCAST")
    tl.end_activity("x")
    tl.negotiate_end("x")


@pytest.mark.parametrize("mark_cycles", [False, True])
def test_timeline_events_match_jax(tmp_path, monkeypatch, mark_cycles):
    # the JAX writer's own queue (its native ring writes the same lines)
    monkeypatch.setattr(jnative, "lib", lambda: None)
    events = []
    for name, mod in (("jax", jtl), ("port", ptl)):
        # the module's own clock: other threads keep the real one
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=_Clock(), sleep=time.sleep))
        path = str(tmp_path / f"{name}.json")
        tl = mod.Timeline(path, mark_cycles=mark_cycles)
        _timeline_calls(tl)
        tl.close()
        with open(path) as f:
            events.append(json.load(f))
    assert events[1] == events[0]
    names = [e.get("name") for e in events[1]]
    assert names.count("NEGOTIATE_ALLREDUCE") == 2
    assert names.count("CYCLE_START") == (1 if mark_cycles else 0)


def test_timeline_closed_is_false_and_reopens(tmp_path):
    tl = ptl.Timeline()
    assert not tl
    tl.negotiate_start("a", "ALLREDUCE")  # dropped: no file
    tl.reopen(str(tmp_path / "t.json"))
    assert tl
    tl.negotiate_start("a", "ALLREDUCE")
    tl.negotiate_end("a")
    tl.close()
    assert not tl
    with open(tmp_path / "t.json") as f:
        evs = json.load(f)
    assert [e.get("ph") for e in evs] == ["M", "B", "E", None]


# --- stall inspector ---------------------------------------------------------

class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.msgs = []

    def emit(self, record):
        self.msgs.append(record.getMessage())


@pytest.mark.parametrize("seed", SEEDS)
def test_stall_warnings_and_error_match_jax(monkeypatch, seed):
    rng = np.random.RandomState(seed)
    ages = rng.uniform(0, 20, size=6)
    clock = {"t": 100.0}
    outs = []
    for mod, logger in ((jstall, "horovod_tpu"),
                        (pstall, "horovod_tpu_torch")):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: clock["t"]))
        cap = _Capture()
        logging.getLogger(logger).addHandler(cap)
        try:
            insp = mod.StallInspector(warning_time_s=5.0,
                                      shutdown_time_s=15.0)
            for i, age in enumerate(ages):
                clock["t"] = 100.0 - age
                insp.record_pending(f"t{i}")
            clock["t"] = 90.0
            insp.note_straggler("t0", 2, 0.25)
            clock["t"] = 100.0
            err = None
            try:
                insp.check()
            except RuntimeError as e:
                err = (str(e), e.names)
            insp.record_done("t0")
            try:
                insp.check()
            except RuntimeError:
                pass
            outs.append((cap.msgs, err, insp._m_oldest.value,
                         insp._m_pending.value))
        finally:
            logging.getLogger(logger).removeHandler(cap)
    assert outs[1] == outs[0]
    if outs[1][1] is not None:
        assert issubclass(pstall.StalledTensorError, HorovodInternalError)


def test_stall_error_is_an_internal_error():
    """A stalled tensor fails as ``StalledTensorError``, which an elastic
    run recovers from as from any failed collective."""
    insp = pstall.StallInspector(warning_time_s=0.0, shutdown_time_s=1e-9)
    insp.record_pending("late")
    time.sleep(1e-3)
    with pytest.raises(StalledTensorError) as ei:
        insp.check()
    assert ei.value.names == ["late"]
    assert isinstance(ei.value, HorovodInternalError)


def test_the_coordinators_stall_errors_are_stalls():
    """Both of the coordinator's stall shutdowns, a stalled tensor and a
    stalled round, carry the marker the runtime fails them by as
    ``StalledTensorError``; a mismatched signature does not."""

    class Client:
        def __init__(self):
            self.puts = []

        def put(self, scope, key, value):
            self.puts.append(value)

    coord = pctl._Coordinator(Client(), 3, stall_warning_s=0.0,
                              stall_shutdown_s=1e-9)
    coord._increment("late", ["sig"], 0)
    coord._increment("odd", ["a"], 0)
    coord._increment("odd", ["b"], 1)
    time.sleep(1e-3)
    coord._check_stalled_tensors()
    assert pctl.is_stall_error(coord.errors["late"])
    assert not pctl.is_stall_error(coord.errors["odd"])
    coord._error_close_round(4, {2}, 12.0)
    errors = pwire.decode_response_v1(coord.client.puts[-1])["errors"]
    assert set(errors) == {"late", "odd"}
    assert all(pctl.is_stall_error(m) for m in errors.values())


def test_a_failed_stall_check_fails_the_drained_batch(monkeypatch):
    """A stall check that fails with anything but ``StalledTensorError``
    fails the batch its cycle drained, whose handles would otherwise never
    finish, and later cycles go on."""
    for k in list(os.environ):
        if k.startswith("HOROVOD_"):
            monkeypatch.delenv(k)
    hvd.init(device="cpu")
    try:
        rt = pctx.runtime()
        check = rt.stall.check

        def failing():
            raise RuntimeError("dictionary changed size during iteration")

        rt.stall.check = failing
        h = hvd.allreduce_async_(torch.ones(4), name="drained")
        deadline = time.monotonic() + 30
        while not hvd.poll(h):
            assert time.monotonic() < deadline, "the handle never finished"
            time.sleep(0.01)
        with pytest.raises(HorovodInternalError, match="stall check failed"):
            hvd.synchronize(h)
        rt.stall.check = check
        out = hvd.allreduce(torch.full((4,), 3.0), name="after")
        assert torch.equal(out, torch.full((4,), 3.0))
    finally:
        hvd.shutdown()


# --- tracing -----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_clock_offset_matches_jax(monkeypatch, seed):
    """The same probes (client send/receive times, server reads) give the
    same offset and uncertainty."""
    import urllib.request

    rng = np.random.RandomState(seed)
    probes = [(t0, t0 + rtt, t0 + rtt * f + off)
              for t0, rtt, f, off in zip(
                  np.cumsum(rng.uniform(0.01, 0.1, 5)) + 1e9,
                  rng.uniform(1e-4, 5e-3, 5), rng.uniform(0, 1, 5),
                  rng.uniform(-0.5, 0.5, 5))]
    outs = []
    for mod in (jtr, ptr):
        it = iter(probes)
        state = {}

        def fake_time():
            if "p" not in state:
                state["p"] = next(it)
                return state["p"][0]
            return state.pop("p")[1]

        class Resp:
            def __init__(self):
                self.body = json.dumps({"t": state["p"][2]}).encode()

            def read(self):
                return self.body

            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=fake_time))
        monkeypatch.setattr(urllib.request, "urlopen",
                            lambda url, timeout=None: Resp())
        outs.append(mod.estimate_clock_offset("127.0.0.1", 1, probes=5))
    assert outs[1] == outs[0]


def _span_buffers(seed: int) -> list:
    rng = np.random.RandomState(seed)
    bufs = []
    for rank in range(3):
        spans = []
        for i in range(8):
            t = list(np.cumsum(rng.uniform(1e-4, 1e-2, 7)) + 1e9)
            if rng.rand() < 0.3:
                t[2] = t[3] = None  # a span that never negotiated
            spans.append({"n": f"grad.{i}", "o": "allreduce",
                          "r": int(i), "t": t, "cb": int(rng.randint(1e6)),
                          "ct": int(rng.randint(1, 9)),
                          "sr": int(rng.randint(-1, 3)),
                          "sw": float(rng.uniform(0, 0.01)),
                          "e": int(rng.rand() < 0.1)})
        bufs.append({"rank": rank, "clock_offset_s": float(rng.normal(0, .01)),
                     "clock_uncertainty_s": 1e-4, "spans": spans})
    return bufs


def _anatomy_snapshots(mod, seed: int) -> list:
    out = []
    for rank in range(3):
        prof = mod.AnatomyProfiler(rank=rank)
        _anatomy_steps(prof, seed + rank)
        out.append(_stable(prof.snapshot()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_merged_timeline_matches_jax(seed):
    bufs = _span_buffers(seed)
    assert ptr.merge_chrome_trace(bufs) == jtr.merge_chrome_trace(bufs)
    anat = _anatomy_snapshots(janat, seed)
    merged = ptr.merge_chrome_trace(bufs, anatomy=anat)
    assert merged == jtr.merge_chrome_trace(bufs, anatomy=anat)
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1, 2}


def _coordinator(mod, size: int):
    """A coordinator's straggler bookkeeping without its thread."""
    c = mod._Coordinator.__new__(mod._Coordinator)
    c.size, c.table, c.order, c.errors = size, {}, [], {}
    c._joined, c._arrivals, c._first_seen = set(), {}, {}
    c._m_strag_wait, c._m_strag_last = None, {}
    return c


@pytest.mark.parametrize("seed", SEEDS)
def test_straggler_verdict_matches_jax(seed):
    rng = np.random.RandomState(seed)
    size = 4
    subs = [(f"t{i}", k, float(1e9 + rng.uniform(0, 0.05)))
            for i in range(6) for k in rng.permutation(size)
            if rng.rand() < 0.9]
    sig = ["allreduce", "float32", [4], 1, 0, 1.0, 1.0, "global", "cpu"]
    verdicts = []
    for mod in (jctl, pctl):
        c = _coordinator(mod, size)
        for name, k, t in subs:
            c._increment(name, sig, k, t)
        verdicts.append(c._attribute_stragglers([f"t{i}" for i in range(6)]))
    assert verdicts[1] == verdicts[0]


class _Recorder:
    """A KV client recording the controller's PUTs and answering every
    poll with an empty round."""

    def __init__(self):
        self.puts = []

    def put(self, scope, key, value):
        self.puts.append(value)

    def get(self, scope, key, timeout=30.0):
        return b'{"ready": [], "errors": {}, "sigs": {}, "join_done": null}'


def test_traced_v1_submissions_match_jax(monkeypatch):
    """With tracing on, the v1 payload carries the submit time outside the
    marker comparison, byte for byte the JAX package's; off, nothing."""
    tracer = types.SimpleNamespace(aligned_now=lambda: 1234567.25)
    sig = ["allreduce", "float32", [4], 1, 0, 1.0, 1.0, "global", "cpu"]
    puts = []
    for mod in (jctl, pctl):
        kv = _Recorder()
        ctl = mod.KVController(kv, rank=1, size=2)
        ctl._tracer = tracer
        for pending in ({"a": sig}, {"a": sig}, {}, {}):
            ctl.negotiate(pending)
        ctl._tracer = None
        ctl.negotiate({"a": sig})
        puts.append(kv.puts)
    assert puts[1] == puts[0]
    assert puts[1][1].startswith(b"=") and b'"t"' in puts[1][1]
    assert b'"t"' not in puts[1][3] and b'"t"' not in puts[1][4]


def test_trace_report_off_and_on():
    ptr.reset_tracer()
    assert ptr.report() == {"enabled": False}
    tr = ptr.Tracer(rank=1)
    s = tr.begin("a", "allreduce")
    tr.finish(s, error=True)
    ptr._TRACER = tr
    try:
        rep = ptr.report()
        assert rep["enabled"] and rep["spans"] == 1 and rep["errors"] == 1
        assert rep["open_spans"] == 0
    finally:
        ptr.reset_tracer()


# --- perf ledger -------------------------------------------------------------

def _ledger_steps(seed: int) -> list:
    rng = np.random.RandomState(seed)
    steps = []
    for _ in range(30):
        wall = float(rng.uniform(1e-3, 0.05))
        neg = float(rng.uniform(0, wall / 2))
        disp = float(rng.uniform(0, wall - neg))
        ex = float(rng.uniform(0, disp))
        strag = ((int(rng.randint(3)), float(rng.uniform(0, neg)))
                 if rng.rand() < 0.4 else None)
        steps.append((wall, neg, disp, ex, int(rng.randint(1, 50)), strag,
                      int(rng.randint(1, 1 << 24))))
    return steps


def _strip_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def _run_ledgers(seed: int):
    out = []
    for mod, met in ((jperf, jmet), (pperf, pmet)):
        led = mod.PerfLedger(rank=1, capacity=64)
        c = met.get_registry().counter("hvd_allreduce_bytes_total", "b",
                                       dtype="float32")
        scores, cursor = [], 0
        for i, (wall, neg, disp, ex, n, strag, nb) in \
                enumerate(_ledger_steps(seed)):
            c.inc(nb)
            led.record_step(wall, negotiate_s=neg, dispatch_s=disp,
                            exec_s=ex, tensors=n, straggler=strag)
            if i % 5 == 4:
                cursor, score, _ = led.window_score(cursor)
                scores.append(score)
        out.append((led, scores))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_ledger_records_and_window_score_match_jax(seed):
    (jl, js), (pl, ps) = _run_ledgers(seed)
    pr, jr = pl.records(), jl.records()
    assert _strip_ts(pr) == _strip_ts(jr)
    assert ps == js and all(s is not None for s in ps)
    assert pl.stats() == jl.stats()
    assert pl.phase_summary() == jl.phase_summary()
    for r in pr:  # the five phases sum to the cycle's wall time
        total = sum(r[p + "_s"] for p in pperf.PHASES)
        assert abs(total - r["wall_s"]) <= 1e-12 * max(r["wall_s"], 1.0)


SLO_SPECS = ["negotiate_p95_ms<=5,plan_hit_rate>=0.95",
             '{"step_p95_ms": "<=20", "exposed_comm_frac": ">=0.1"}',
             "step_p50_ms<=1e-3 , host_overhead_p95_ms>=0"]


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_slo_spec_parses_match_jax(spec, tmp_path):
    assert pperf.parse_slo_spec(spec) == jperf.parse_slo_spec(spec)
    path = tmp_path / "slo.json"
    path.write_text(spec)  # the third grammar: a file holding either
    assert pperf.parse_slo_spec(str(path)) == jperf.parse_slo_spec(spec)


@pytest.mark.parametrize("bad", ["step_p95_ms=5", "{not json",
                                 "step_p95_ms<=fast", '["a"]'])
def test_slo_spec_refusals_match_jax(bad):
    for mod in (jperf, pperf):
        with pytest.raises(ValueError):
            mod.parse_slo_spec(bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_breach_sequence_matches_jax(seed):
    budgets = jperf.parse_slo_spec("step_p95_ms<=30,negotiate_p50_ms<=8")
    fired = []
    for mod in (jperf, pperf):
        led = mod.PerfLedger(rank=0, capacity=64)
        eng = mod.SloEngine(led, budgets)
        seq = []
        for i, (wall, neg, disp, ex, n, strag, _) in \
                enumerate(_ledger_steps(seed)):
            led.record_step(wall, negotiate_s=neg, dispatch_s=disp,
                            exec_s=ex, tensors=n, straggler=strag)
            if i % 3 == 2:
                seq.append(eng.evaluate())
        seq.append(eng.evaluate())  # no new records: nothing
        fired.append((seq, eng.state()))
    assert fired[1] == fired[0]


# --- step anatomy ------------------------------------------------------------

def _anatomy_steps(prof, seed: int):
    rng = np.random.RandomState(seed)
    for step in range(12):
        names = []
        for c in range(int(rng.randint(1, 5))):
            chunk = [f"grad.{step}.{c}.{i}"
                     for i in range(int(rng.randint(1, 4)))]
            names += chunk
            prof.note_chunk(chunk, int(rng.randint(1, 1 << 20)), len(chunk),
                            float(rng.uniform(0, 2e-3)))
        strag = ((int(rng.randint(3)), float(rng.uniform(0, 1e-3)))
                 if rng.rand() < 0.5 else None)
        prof.record_step(float(rng.uniform(5e-3, 2e-2)),
                         negotiate_s=float(rng.uniform(0, 2e-3)),
                         dispatch_s=float(rng.uniform(0, 4e-3)),
                         tensors=len(names), names=names, straggler=strag)


def _stable(obj):
    """Drop wall-clock stamps (``ts``, ``ts0``), which differ run to run."""
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items()
                if k not in ("ts", "ts0")}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


@pytest.mark.parametrize("seed", SEEDS)
def test_anatomy_records_and_headroom_match_jax(seed):
    profs = [mod.AnatomyProfiler(rank=1, capacity=64) for mod in (janat,
                                                                  panat)]
    for prof in profs:
        _anatomy_steps(prof, seed)
    jp, pp = profs
    assert _stable(pp.records()) == _stable(jp.records())
    assert pp.headroom() == jp.headroom()
    assert pp.critical_path() == jp.critical_path()
    assert pp.entity_table() == jp.entity_table()
    assert _stable(pp.report()) == _stable(jp.report())


class _Event:
    """A stand-in for a timed CUDA event pair: done after ``polls``
    queries."""

    def __init__(self, polls: int, ms: float = 0.0):
        self.polls, self.ms = polls, ms

    def query(self):
        self.polls -= 1
        return self.polls < 0

    def elapsed_time(self, end):
        return end.ms


def test_anatomy_device_time_comes_from_the_events():
    """A chunk's ``device_s`` is its events' time, read once the done event
    reports done, with no synchronize."""
    prof = panat.AnatomyProfiler()
    tok = panat.EventToken(_Event(0), _Event(1, ms=2.5))
    prof.note_chunk(["g"], 64, 1, 1e-4, token=tok)
    prof.record_step(1e-3, dispatch_s=1e-4, tensors=1, names=["g"])
    ent = prof.records()[-1]["entities"][0]
    assert ent["device_done"] and ent["device_s"] == 0.0025
    assert prof.snapshot()["inflight_tokens"] == 0


def test_reports_off():
    for mod, reset in ((pperf, pperf.reset_ledger),
                       (panat, panat.reset_profiler)):
        reset()
        assert mod.report() == {"enabled": False}
