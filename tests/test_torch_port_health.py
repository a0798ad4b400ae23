"""The port's health engine (``horovod_tpu_torch/utils/health.py``) against
the JAX package's (``horovod_tpu/utils/health.py``) on the same seeded
series: the detector's latch and clear indices, its frozen baselines and
the engine's verdicts, the downsampled tier, and ``fleet_view`` over the
same rank snapshots, all compared exactly (the arithmetic is the same
Python on the same floats). Then the port's own wiring: the stall
inspector's and the autotuner's hooks, the dumper's sampling pass and its
``health.sample`` fault point, the ``HOROVOD_HEALTH_FILE`` dump, and no
series while the engine is off."""

import json

import numpy as np
import pytest

import horovod_tpu.utils.health as JH
import horovod_tpu_torch.utils.health as PH
from horovod_tpu_torch.utils import metrics as pmetrics

SERIES = [name for name, _, _ in PH.SERIES]


def _series(seed: int, n: int = 60, shift_at: int = 30, shift: float = 0.0,
            spike_at=None):
    """A noisy level with a step of ``shift`` at ``shift_at`` and an
    optional spike, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = 100.0 + rng.normal(0.0, 1.0, n)
    x[shift_at:] += shift
    if spike_at is not None:
        x[spike_at] += 500.0
    return [float(v) for v in x]


def _drop_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_constants_and_series_equal_jax():
    assert PH.SERIES == JH.SERIES
    for name in ("DOWNSAMPLE_EVERY", "Z_DRIFT", "Z_SPIKE", "DEBOUNCE_SAMPLES",
                 "CLEAR_SAMPLES", "CRITICAL_ANOMALIES", "PUSH_WINDOW",
                 "ANOMALY_SUSPECT_WEIGHT", "STRAGGLER_SUSPECT_WEIGHT",
                 "DEFAULT_WARMUP", "AUTOTUNE_SERIES", "KV_SCOPE"):
        assert getattr(PH, name) == getattr(JH, name), name


@pytest.mark.parametrize("direction,seed,shift,spike_at,warmup", [
    ("high", 0, 30.0, None, 20),    # a step up: drift latches
    ("high", 1, 0.0, 40, 20),       # one spike, then clear
    ("low", 2, -30.0, None, 8),     # a step down on a "low" series
    ("high", 3, -30.0, None, 20),   # the good direction: nothing latches
    ("high", 4, 30.0, 45, 4),       # the warmup floor (4) and both kinds
])
def test_detector_latches_equal_jax(direction, seed, shift, spike_at,
                                    warmup):
    values = _series(seed, shift=shift, spike_at=spike_at)
    # a drift that later clears: back to the level after sample 50
    if shift:
        values = values[:50] + [v - shift for v in values[50:]]
    pd = PH._Detector("s", direction, warmup)
    jd = JH._Detector("s", direction, warmup)
    pe, je = [], []
    for i, v in enumerate(values):
        a, b = pd.observe(float(i), v), jd.observe(float(i), v)
        if a is not None:
            pe.append((i, dict(a)))
        if b is not None:
            je.append((i, dict(b)))
    assert pe == je
    assert (pd.median, pd.scale, pd.warmup) == (jd.median, jd.scale,
                                                jd.warmup)
    if shift > 0 and direction == "high" or shift < 0 and direction == "low":
        assert any(e["event"] == "latch" for _, e in pe)
    if direction == "high" and shift < 0 and spike_at is None:
        assert pe == []


def test_series_ring_downsamples_equal_jax():
    pr, jr = PH.SeriesRing(16), JH.SeriesRing(16)
    for i, v in enumerate(_series(5, n=100)):
        pr.append(float(i), v)
        jr.append(float(i), v)
    assert list(pr.raw) == list(jr.raw)
    assert list(pr.tier) == list(jr.tier)
    assert pr.total == jr.total == 100


def _feed(engine, rows):
    """Drive ``engine.sample_and_detect`` with ``rows`` (one dict of series
    values a pass) in place of its collection."""
    it = iter(rows)
    engine._collect = lambda: next(it)
    out = []
    for _ in rows:
        out.append(_drop_ts(engine.sample_and_detect()))
    return out


def _rows(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"step_time_ms": 50.0 + rng.normal(0, 0.5),
               "negotiate_ms": 5.0 + rng.normal(0, 0.1),
               "plan_hit_rate": 1.0 - abs(rng.normal(0, 0.001)),
               "wire_bytes_per_step": 4e8 + rng.normal(0, 1e5)}
        if i >= 25:
            row["step_time_ms"] += 20.0   # drift
            row["plan_hit_rate"] -= 0.5   # a "low" series drifts down
        if i == 30:
            row["negotiate_ms"] += 100.0  # a spike
        rows.append({k: float(v) for k, v in row.items()})
    return rows


def test_engine_events_baselines_verdicts_equal_jax():
    p = PH.HealthEngine(rank=3, capacity=32, warmup=10)
    j = JH.HealthEngine(rank=3, capacity=32, warmup=10)
    rows = _rows(7)
    pev, jev = _feed(p, rows), _feed(j, rows)
    assert pev == jev
    assert sum(len(e) for e in pev) >= 3
    pr, jr = p.report(), j.report()
    for rep in (pr, jr):
        rep["active"] = _drop_ts(rep["active"])
    assert pr == jr
    # the two drifts stay latched, the spike cleared
    assert pr["verdict"] == "degraded" and pr["anomalies_total"] == 3
    ps, js = p.snapshot(), j.snapshot()
    for snap in (ps, js):
        for body in snap["series"].values():
            body["samples"] = [v for _, v in body["samples"]]
            body["downsampled"] = [v for _, v in body["downsampled"]]
        for a in snap["active"]:
            a.pop("ts")
    assert ps == js


def _rank_snapshots(seed: int, n_ranks: int = 4, slow=2, named=None):
    rng = np.random.default_rng(seed)
    ranks = {}
    for r in range(n_ranks):
        series = {}
        for name in ("step_time_ms", "negotiate_ms", "plan_hit_rate"):
            v = float(100.0 + rng.normal(0, 1.0))
            if r == slow and name == "step_time_ms":
                v += 50.0
            series[name] = {"n": 10, "samples": [[0.0, v]],
                            "downsampled": []}
        active = ([{"series": "step_time_ms", "kind": "drift"}]
                  if r in (slow, 0) else [])
        ranks[str(r)] = {"verdict": "degraded" if active else "healthy",
                         "active": active, "series": series,
                         "suspect_rank": named if active else None,
                         "anomalies_total": len(active),
                         "baselines": {}, "stale": r == 1}
    return ranks


@pytest.mark.parametrize("seed,slow,named", [(0, 2, None), (1, 2, 2),
                                             (2, 3, 1), (3, 0, 0)])
def test_fleet_view_equal_jax(seed, slow, named):
    ranks = _rank_snapshots(seed, slow=slow, named=named)
    got = PH.fleet_view(json.loads(json.dumps(ranks)))
    want = JH.fleet_view(json.loads(json.dumps(ranks)))
    assert got == want
    assert got["verdict"] == "degraded"
    top = str(named) if named is not None else str(slow)
    assert got["suspects"][0]["rank"] == top


def test_fleet_view_empty_and_critical_equal_jax():
    assert PH.fleet_view({}) == JH.fleet_view({})
    crit = {str(r): {"verdict": "degraded",
                     "active": [{"series": s, "kind": "drift"}
                                for s in SERIES[:2]], "series": {}}
            for r in range(2)}
    assert PH.fleet_view(crit) == JH.fleet_view(crit)
    assert PH.fleet_view(crit)["verdict"] == "critical"


class _Inspector:
    def __init__(self):
        self.notes = []

    def note_health_anomaly(self, series, detail):
        self.notes.append((series, detail))

    def straggler_rank(self):
        return 1


class _Tuner:
    def __init__(self):
        self.drifts = []

    def note_health_drift(self, series):
        self.drifts.append(series)


def test_latch_escalates_to_inspector_tuner_and_counter():
    insp, tuner = _Inspector(), _Tuner()
    eng = PH.HealthEngine(rank=0, warmup=10, stall_inspector=insp,
                          autotuner=tuner)
    reg = pmetrics.get_registry()
    before = reg.counter_value("hvd_health_anomaly_total",
                               series="step_time_ms")
    _feed(eng, _rows(7))
    assert [s for s, _ in insp.notes].count("step_time_ms") == 1
    # a drift on a goodput series restarts the search once an episode
    assert tuner.drifts == ["step_time_ms"]
    assert reg.counter_value("hvd_health_anomaly_total",
                             series="step_time_ms") == before + 1
    assert eng.report()["suspect_rank"] == 1


def test_stall_inspector_and_autotuner_hooks_exist():
    from horovod_tpu_torch.utils.autotune import Autotuner
    from horovod_tpu_torch.utils.stall import StallInspector

    insp = StallInspector()
    assert insp.straggler_rank() is None
    insp.note_straggler("grad", 3, 0.5)
    assert insp.straggler_rank() == 3
    insp.note_health_anomaly("step_time_ms", "60 vs baseline 50")
    assert callable(Autotuner.note_health_drift)


def test_dumper_pass_samples_pushes_and_honours_fault(monkeypatch, tmp_path):
    from horovod_tpu_torch.utils import faults

    eng = PH.HealthEngine(rank=2, warmup=4)
    monkeypatch.setattr(PH, "_ENGINE", eng)
    it = iter(_rows(3))
    eng._collect = lambda: next(it)
    pushed = {}

    class KV:
        def put(self, scope, key, value):
            pushed[(scope, key)] = json.loads(value)

    dumper = pmetrics.MetricsDumper(pmetrics.get_registry(),
                                    kv_client=KV(), rank=2)
    dumper.flush()
    snap = pushed[("health", "rank2")]
    assert snap["rank"] == 2 and "push_ts" in snap
    assert set(snap["series"]) == set(_rows(3)[0])
    # a dropped pass leaves the rings as they were
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "health.sample:drop#1")
    faults.reset()
    n = eng.report()["series"]["step_time_ms"]["n"]
    dumper.flush()
    assert eng.report()["series"]["step_time_ms"]["n"] == n
    monkeypatch.delenv("HOROVOD_FAULT_SPEC")
    faults.reset()
    path = tmp_path / "history.json"
    monkeypatch.setenv("HOROVOD_HEALTH_FILE", str(path))
    PH.dump_on_exit()
    doc = json.loads(path.read_text())
    assert doc["rank"] == 2 and doc["series"]["step_time_ms"]["n"] == n


def test_off_means_no_engine_and_no_series(monkeypatch):
    monkeypatch.delenv("HOROVOD_HEALTH", raising=False)
    monkeypatch.setattr(PH, "_ENGINE", None)
    assert PH.init_engine(rank=0) is None
    assert PH.report() == {"enabled": False}
    fresh = pmetrics.MetricsRegistry()
    monkeypatch.setattr(pmetrics, "_REGISTRY", fresh)
    PH.init_engine(rank=0)
    assert not any(n.startswith("hvd_health_") for n in fresh.names())
    monkeypatch.setenv("HOROVOD_HEALTH", "1")
    monkeypatch.setenv("HOROVOD_HEALTH_WARMUP", "6")
    eng = PH.init_engine(rank=1)
    assert eng is not None and eng.warmup == 6
    assert "hvd_health_samples_total" in fresh.names()


def test_engine_takes_runtime_config_values(monkeypatch, tmp_path):
    """``hvd.init()`` starts the engine from its ``RuntimeConfig``: the
    arguments win over the environment."""
    monkeypatch.delenv("HOROVOD_HEALTH", raising=False)
    monkeypatch.setenv("HOROVOD_HEALTH_WARMUP", "9")
    monkeypatch.setattr(PH, "_ENGINE", None)
    assert PH.init_engine(rank=0, on=False) is None
    eng = PH.init_engine(rank=3, on=True, capacity=64, warmup=5)
    assert eng is not None and eng.warmup == 5 and eng.rank == 3
    path = tmp_path / "history.json"
    PH.dump_on_exit(str(path))
    assert json.loads(path.read_text())["rank"] == 3
