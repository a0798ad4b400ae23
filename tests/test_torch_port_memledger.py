"""The port's memory ledger (``horovod_tpu_torch/utils/memledger.py``) and
its kernel-library cache (``utils/compile_cache.py``, ``ops/_build.py``).

Against the JAX package (``horovod_tpu/utils/memledger.py``):
``suspect_component`` names the same component for the same seeded
attributions, sample by sample. The port's own: a CPU sample counts the
live tensors' bytes; a plan build is recorded by plan kind with a
``plan_build`` sample; ``note_sharded_state`` holds the optimizer's state
bytes and samples only when they change; a kernel-library load is
recorded with its bytes and its cache verdict (a miss builds, a second
load is a hit), in the directory ``enable_compilation_cache`` points at;
the dumper samples and pushes ``mem/rank{k}``; an OOM bundle names the
dominant component; and with the ledger off nothing is registered.
"""

import json
import os

import numpy as np
import pytest
import torch

import horovod_tpu.utils.memledger as JM
import horovod_tpu_torch.utils.memledger as PM
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.utils import compile_cache, diag
from horovod_tpu_torch.utils import metrics as pmetrics

COMPONENTS = ("plan_cache", "fusion_buffer", "ef_residuals", "sharded_state")


@pytest.fixture
def ledger(monkeypatch):
    led = PM.MemLedger(rank=1, capacity=32)
    monkeypatch.setattr(PM, "_LEDGER", led)
    return led


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_suspect_component_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p, j = PM.MemLedger(rank=0), JM.MemLedger(rank=0)
    assert p.suspect_component() is j.suspect_component() is None
    for _ in range(12):
        comp = COMPONENTS[int(rng.integers(len(COMPONENTS)))]
        # zero bytes are never the suspect; ties keep the first maximum
        nbytes = int(rng.choice([0, 1 << 20, 1 << 24, int(rng.integers(
            1, 1 << 30))]))
        p.set_component(comp, nbytes)
        j.set_component(comp, nbytes)
        assert p.suspect_component() == j.suspect_component()
        assert p.components() == j.components()


def test_cpu_sample_counts_live_tensors(ledger):
    big = torch.empty(3 << 20, dtype=torch.uint8)
    before = ledger.sample()["live_bytes"]
    assert before >= big.numel()
    snap = ledger.sample(event="elastic_resize")
    assert snap["source"] == "live_tensors" and snap["devices"] == []
    del big
    after = ledger.sample()["live_bytes"]
    assert after <= before - (3 << 20)
    assert [s["event"] for s in ledger.samples()] == [
        "interval", "elastic_resize", "interval"]
    reg = pmetrics.get_registry()
    assert reg.counter_value("hvd_mem_samples_total",
                             event="elastic_resize") >= 1
    assert ledger.snapshot()["peak_bytes"] >= before


def test_plan_builds_are_recorded_by_kind(ledger):
    C.invalidate_fused_plans()
    try:
        C.sharded_pack_plan(None, 2, [4, 6], [(4,), (2, 3)], torch.float32,
                            5, "digest")
        C.sharded_pack_plan(None, 2, [4, 6], [(4,), (2, 3)], torch.float32,
                            5, "digest")  # a hit builds nothing
        C.sharded_allgather_plan(None, 2, [4, 6], [(4,), (2, 3)],
                                 torch.float32, 5, "digest")
        table = C.plan_cache_table()
    finally:
        C.invalidate_fused_plans()
    stats = ledger.compile_stats()
    assert {k: v["compiles"] for k, v in stats["by_kind"].items()} == {
        "sharded_pack": 1, "sharded_ag": 1}
    builds = [s for s in ledger.samples() if s["event"] == "plan_build"]
    assert [s["kind"] for s in builds] == ["sharded_pack", "sharded_ag"]
    assert [r["kind"] for r in table] == ["sharded_ag", "sharded_pack"]
    assert C.plan_cache_bytes() == 0 and C.plan_cache_table() == []


def test_note_sharded_state_tracks_the_optimizer(ledger):
    from horovod_tpu_torch.opt.sharded import optimizer_state_bytes

    ps = [torch.nn.Parameter(torch.randn(10)),
          torch.nn.Parameter(torch.randn(3, 4))]
    opt = torch.optim.Adam(ps, lr=0.1)
    PM.note_sharded_state(opt)
    assert ledger.components()["sharded_state"] == 0
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    PM.note_sharded_state(opt)
    PM.note_sharded_state(opt)  # unchanged: no second sample
    assert ledger.components()["sharded_state"] == \
        optimizer_state_bytes(opt) > 0
    events = [s["event"] for s in ledger.samples()]
    assert events.count("sharded_state_build") == 2
    assert ledger.suspect_component() == "sharded_state"


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """``ops/_build.py`` with a stand-in compiler: a build writes a file of
    1234 bytes, a load opens nothing."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loads", [])
    monkeypatch.setattr(_build, "_build_dir", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/stand-in/nvcc")
    built = []

    def build(name):
        path = _build.lib_path(name)
        if os.path.exists(path):
            return ""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"\0" * 1234)
        built.append(name)
        return "report"

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(compile_cache, "_ACTIVE_DIR", None)
    return built


def test_kernel_loads_record_miss_then_hit(ledger, fake_nvcc, tmp_path,
                                           monkeypatch):
    cache = tmp_path / "kernels"
    assert compile_cache.enable_compilation_cache(str(cache)) is None
    assert compile_cache.active_cache_dir() == str(cache)
    assert _build.build_dir() == str(cache)
    reg = pmetrics.get_registry()
    assert reg.gauge_value("hvd_compile_cache_enabled") == 1
    _build.load("xent")
    _build.load("xent")  # loaded already: no second record
    _build._libs.pop("xent")
    _build.load("xent")  # the library is there: a hit
    recs = _build.load_records()
    assert [(r["kernel"], r["cache"], r["so_bytes"]) for r in recs] == [
        ("xent", "miss", 1234), ("xent", "hit", 1234)]
    assert fake_nvcc == ["xent"]
    assert all(r["dir"] == str(cache) for r in recs)
    stats = ledger.compile_stats()
    assert stats["by_kind"]["kernel"]["compiles"] == 2
    assert stats["by_kind"]["kernel"]["program_bytes"] == 2468
    assert stats["persistent_cache"] == {"hit": 1, "miss": 1, "unknown": 0}
    assert stats["kernel_loads"] == recs
    assert [s["kernel"] for s in ledger.samples()
            if s["event"] == "plan_build"] == ["xent", "xent"]
    # the knob moves the directory through enable_compilation_cache (which
    # init calls), and only through it
    monkeypatch.setattr(_build, "_build_dir", None)
    monkeypatch.setenv("HOROVOD_COMPILE_CACHE", str(tmp_path / "env"))
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR
    assert compile_cache.enable_compilation_cache() is None
    assert _build.build_dir() == str(tmp_path / "env")


def test_cache_that_cannot_be_enabled_says_why(fake_nvcc, tmp_path,
                                               monkeypatch, caplog):
    monkeypatch.setattr(compile_cache, "_WARNED", False)
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    reason = compile_cache.enable_compilation_cache(str(blocker / "sub"))
    assert reason and "Error" in reason
    assert compile_cache.active_cache_dir() is None
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR
    reg = pmetrics.get_registry()
    assert reg.gauge_value("hvd_compile_cache_enabled") == 0
    assert compile_cache.enable_compilation_cache(str(blocker / "s2"))
    assert sum("NOT enabled" in r.message for r in caplog.records) == 1
    # the knob set to a directory that cannot be used: the warning stands
    # and nvcc still builds in the default directory
    monkeypatch.setenv("HOROVOD_COMPILE_CACHE", str(blocker / "s3"))
    assert compile_cache.enable_compilation_cache()
    assert _build.build_dir() == _build.DEFAULT_BUILD_DIR
    assert _build.lib_path("xent").startswith(_build.DEFAULT_BUILD_DIR)


def test_dumper_samples_and_pushes(ledger):
    pushed = {}

    class KV:
        def put(self, scope, key, value):
            pushed[(scope, key)] = json.loads(value)

    pmetrics.MetricsDumper(pmetrics.get_registry(), kv_client=KV(),
                           rank=1).flush()
    snap = pushed[("mem", "rank1")]
    assert snap["rank"] == 1 and snap["samples"] == 1
    assert "push_ts" in snap and "kernel_loads" in snap["compile"]
    assert PM.report()["enabled"] is True


def test_oom_bundle_names_the_dominant_component(ledger, monkeypatch,
                                                 tmp_path):
    monkeypatch.setenv("HOROVOD_DIAG_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_RANK", "1")
    ledger.set_component("fusion_buffer", 128 << 20)
    ledger.set_component("sharded_state", 1 << 20)
    held = torch.ones(1 << 16)
    try:
        torch.empty(1 << 62, dtype=torch.uint8)
    except RuntimeError as e:
        path = diag.maybe_dump_alloc_failure(e)
    with open(path) as f:
        b = json.load(f)
    assert path.endswith("hvd_diag.rank1.oom.json")
    assert b["memory"]["suspect"] == "fusion_buffer"
    assert b["memory"]["top_live_buffers"][0]["nbytes"] >= held.nbytes
    merged = diag.merge_bundles({1: b})
    assert merged["suspects"] == [1]
    assert merged["attribution"].endswith("fusion_buffer")


def test_off_registers_nothing(monkeypatch):
    monkeypatch.delenv("HOROVOD_MEMLEDGER", raising=False)
    monkeypatch.setattr(PM, "_LEDGER", None)
    fresh = pmetrics.MetricsRegistry()
    monkeypatch.setattr(pmetrics, "_REGISTRY", fresh)
    assert PM.init_ledger(rank=0) is None
    PM.sample_event("elastic_resize")
    PM.note_plan_build("fused", 0.1)
    PM.note_sharded_state(torch.optim.SGD([torch.nn.Parameter(
        torch.ones(2))], lr=0.1))
    assert PM.report() == {"enabled": False}
    assert PM.forensics()["enabled"] is False
    assert not any(n.startswith(("hvd_mem_", "hvd_compile_"))
                   for n in fresh.names())
    monkeypatch.setenv("HOROVOD_MEMLEDGER", "1")
    monkeypatch.setenv("HOROVOD_MEMLEDGER_BUFFER", "40")
    led = PM.init_ledger(rank=2)
    assert led.capacity == 40 and led.rank == 2
    assert "hvd_mem_live_bytes" in fresh.names()


def test_ledger_takes_runtime_config_values(monkeypatch):
    """``hvd.init()`` starts the ledger from its ``RuntimeConfig``: the
    arguments win over the environment."""
    monkeypatch.setenv("HOROVOD_MEMLEDGER", "1")
    monkeypatch.setattr(PM, "_LEDGER", None)
    assert PM.init_ledger(rank=0, on=False) is None
    monkeypatch.delenv("HOROVOD_MEMLEDGER")
    led = PM.init_ledger(rank=1, on=True, capacity=24)
    assert led.capacity == 24 and led.rank == 1
