"""The port's postmortem layer (``horovod_tpu_torch/utils/diag.py``) and the
slice as a whole on the CPU.

Against the JAX package (``horovod_tpu/utils/diag.py``): ``merge_bundles``
names the same suspects with the same attribution for the same seeded
bundles. The port's own: the watchdog fires once a wedge, re-arms on a
beat and names the phase; the classifier knows ``torch.OutOfMemoryError``
and the CUDA allocator's text; a dump writes its file and pushes to the KV
store. In fresh processes (the hooks are process-wide): an idle one-rank
runtime never fires the watchdog, and a delayed dispatch fires it once
with the cycle thread's stack inside the dispatch; with every knob of the
slice off no thread, hook or signal handler exists and no series of the
slice is registered; SIGTERM under the async checkpointer flushes first
and dumps second; and a 2-layer LM trained with every knob of the slice on
is bitwise the run with every knob off.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import horovod_tpu.utils.diag as JD
import horovod_tpu_torch.utils.diag as PD
from horovod_tpu_torch.utils import metrics as pmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, env: dict, timeout: float = 120) -> dict:
    """Run ``script`` in a fresh interpreter that cannot import JAX or the
    JAX package; its last stdout line is a JSON result."""
    full = dict(os.environ, OMP_NUM_THREADS="1", **env)
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    prelude = ("import sys\nsys.modules['jax'] = None\n"
               "sys.modules['horovod_tpu'] = None\n")
    p = subprocess.run([sys.executable, "-c",
                        prelude + textwrap.dedent(script)],
                       cwd=REPO, env=full, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-6000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _bundles(seed: int, kind: str) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for r in range(4):
        b = {"reason": "watchdog", "hostname": f"h{r // 2}",
             "time_unix": 1000.0 + r, "threads": [{}] * (r + 1),
             "flight_events": [{}] * r,
             "stall": {"phase": "negotiate",
                       "age_s": round(float(rng.uniform(1, 9)), 3)},
             "probes": {}, "memory": {"enabled": True,
                                      "peak_bytes": 1000 * r}}
        out[r] = b
    if kind == "missing":
        out[0]["probes"]["coordinator"] = {"round": 7,
                                           "missing_ranks": [3, 1]}
    if kind == "oom":
        out[2]["reason"] = "oom"
        out[2]["memory"]["suspect"] = "fusion_buffer"
    if kind == "empty":
        out = {r: {"reason": "diagnose"} for r in range(2)}
    if kind == "torn":
        out[1] = "not a bundle"
    return out


@pytest.mark.parametrize("kind", ["stall", "missing", "oom", "empty",
                                  "torn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_bundles_equals_jax(kind, seed):
    b = _bundles(seed, kind)
    got = PD.merge_bundles(b)
    want = JD.merge_bundles(b)
    assert got == want
    if kind == "missing":
        assert got["suspects"] == [1, 3]
    if kind == "oom":
        assert got["suspects"] == [2]
        assert got["attribution"].endswith("fusion_buffer")


def test_watchdog_fires_once_a_wedge_and_rearms():
    fired = []
    wd = PD.Watchdog(0.2, dump=lambda reason, stall: fired.append(stall))
    reg = pmetrics.get_registry()
    before = reg.counter_value("hvd_watchdog_fired_total")
    wd.start()
    try:
        wd.enter("negotiate")
        import time

        time.sleep(0.7)
        assert len(fired) == 1 and fired[0]["phase"] == "negotiate"
        wd.exit_phase("negotiate")
        wd.beat()
        time.sleep(0.7)  # a second wedge after the beat: a second fire
        assert len(fired) == 2 and fired[1]["phase"] == ""
        for _ in range(8):
            wd.beat()
            time.sleep(0.05)
        assert len(fired) == 2 and wd.state()["fired_count"] == 2
    finally:
        wd.stop()
    assert reg.counter_value("hvd_watchdog_fired_total") == before + 2


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
     True),
    (RuntimeError("CUDA out of memory. Tried to allocate 80.00 GiB"), True),
    (RuntimeError("DefaultCPUAllocator: can't allocate memory: you tried "
                  "to allocate 1125899906842624 bytes"), True),
    (MemoryError(), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("shape mismatch"), False),
])
def test_alloc_failure_classifier(exc, want):
    assert PD.is_alloc_failure(exc) is want


def test_dump_writes_the_bundle_and_pushes_it(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_DIAG_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_RANK", "3")
    pushed = {}

    class KV:
        def put(self, scope, key, value):
            pushed[(scope, key)] = json.loads(value)

    monkeypatch.setattr(PD, "_kv_client", KV())
    PD.register_probe("test", lambda: {"state": 1})
    PD.register_probe("broken", lambda: 1 / 0)
    try:
        path = PD.dump_bundle("diagnose", stall={"age_s": 1.5})
    finally:
        PD.unregister_probe("test")
        PD.unregister_probe("broken")
    assert path == str(tmp_path / "hvd_diag.rank3.diagnose.json")
    with open(path) as f:
        b = json.load(f)
    assert pushed[("diag", "rank3")] == b
    for key in ("threads", "lockcheck", "metrics", "flight_events",
                "probes", "memory", "plan_cache", "stall"):
        assert key in b, key
    assert b["probes"]["test"] == {"state": 1}
    assert "ZeroDivisionError" in b["probes"]["broken"]["error"]
    assert any(t["name"] == "MainThread" for t in b["threads"])
    assert b["memory"]["enabled"] is False
    assert PD.maybe_dump_alloc_failure(ValueError("no")) == ""


WEDGE = """
    import json, time, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import diag, metrics
    hvd.init(device="cpu")
    time.sleep(2.0)  # idle: the cycle waits for work and beats
    idle = diag.get_watchdog().fired_count
    t0 = time.monotonic()
    out = hvd.allreduce(torch.ones(4), name="slow")
    step_s = time.monotonic() - t0
    time.sleep(0.3)
    res = {"idle_fired": idle, "fired": diag.get_watchdog().fired_count,
           "counter": metrics.get_registry().counter_value(
               "hvd_watchdog_fired_total"),
           "out": out.tolist(), "step_s": step_s}
    with open(diag.bundle_path("watchdog")) as f:
        b = json.load(f)
    cyc = [t for t in b["threads"] if t["name"] == "hvd-cycle"]
    res["cycle_stack"] = cyc[0]["stack"] if cyc else ""
    res["runtime_probe"] = b["probes"]["runtime"]
    hvd.shutdown()
    print(json.dumps(res))
"""


def test_idle_runtime_is_quiet_and_a_wedged_dispatch_fires_once(tmp_path):
    r = _run(WEDGE, {"HOROVOD_WATCHDOG_SECS": "0.5",
                     "HOROVOD_DIAG_DIR": str(tmp_path),
                     "HOROVOD_FAULT_SPEC": "plan.dispatch:delay=2s#1"})
    assert r["idle_fired"] == 0
    assert r["fired"] == 1 and r["counter"] == 1
    assert r["out"] == [1.0] * 4 and r["step_s"] >= 2.0
    assert "_dispatch" in r["cycle_stack"]
    assert "fault_point" in r["cycle_stack"]
    assert r["runtime_probe"]["watchdog"]["threshold_s"] == 0.5


OFF = """
    import json, signal, sys, threading, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import diag, health, memledger, metrics
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(4))
    names = metrics.get_registry().names()
    res = {"threads": sorted(t.name for t in threading.enumerate()),
           "usr1": signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL,
           "term": signal.getsignal(signal.SIGTERM) == signal.SIG_DFL,
           # torch.distributed's init installs one of its own
           "excepthook": sys.excepthook.__module__,
           "hooks": diag.hooks_installed(),
           "objects": [diag.get_watchdog(), memledger.get_ledger(),
                       health.get_engine(), diag._kv_client],
           "series": sorted(n for n in names if n.startswith(
               ("hvd_watchdog", "hvd_mem_", "hvd_health", "hvd_compile",
                "hvd_kv_")))}
    hvd.shutdown()
    print(json.dumps(res, default=repr))
"""


def test_every_knob_off_makes_nothing():
    r = _run(OFF, {})
    assert r["threads"] == ["MainThread", "hvd-cycle"]
    assert r["usr1"] and r["term"]
    assert not r["excepthook"].startswith("horovod_tpu_torch")
    assert r["hooks"] is False
    assert r["objects"] == [None, None, None, None]
    assert r["series"] == []


SIGTERM = """
    import json, os, signal, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import async_ckpt
    hvd.init(device="cpu")
    ckpt = async_ckpt.get_checkpointer()
    ckpt.snapshot(3, {"w": torch.arange(4.0)})
    os.kill(os.getpid(), signal.SIGTERM)
"""


def test_sigterm_flushes_the_checkpoint_then_dumps(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_FLIGHTREC="1",
               HOROVOD_WATCHDOG_SECS="30", HOROVOD_DIAG_DIR=str(tmp_path),
               HOROVOD_ASYNC_CKPT="1",
               HOROVOD_ASYNC_CKPT_DIR=str(tmp_path / "ckpt"))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(SIGTERM)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == -15, p.stderr[-4000:]
    with open(tmp_path / "hvd_diag.rank0.sigterm.json") as f:
        b = json.load(f)
    events = [(e["cat"], e["kv"].get("event")) for e in b["flight_events"]]
    # the checkpointer's handler ran first and chained to the dump
    assert ("checkpoint", "preempt") in events
    assert ("checkpoint", "preempt_flushed") in events


SLICE = """
    import json, os, torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import ring_attention
    from horovod_tpu_torch.utils import diag, health, memledger

    KNOBS = %(knobs)r

    def run(on):
        for k in KNOBS:
            os.environ.pop(k, None)
        if on:
            os.environ.update(KNOBS)
        hvd.init(device="cpu")
        cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                  n_layers=2, d_ff=64, max_seq=16,
                                  dtype=torch.float32)
        model = T.TransformerLM(cfg, device="cpu", seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        g = torch.Generator().manual_seed(0)
        losses = []
        for _ in range(3):
            tokens = torch.randint(0, 64, (2, 17), generator=g)
            opt.zero_grad()
            loss = T.lm_loss(model, tokens, attn_fn=ring_attention)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        params = torch.cat([p.detach().reshape(-1)
                            for p in model.parameters()])
        seen = {"watchdog": diag.get_watchdog() is not None,
                "ledger": memledger.get_ledger() is not None,
                "engine": health.get_engine() is not None}
        mem = hvd.memory_report()
        hvd.shutdown()
        return losses, params, seen, mem

    l0, p0, s0, _ = run(False)
    l1, p1, s1, mem = run(True)
    print(json.dumps({
        "losses_equal": l0 == l1,
        "params_equal": torch.equal(p0.view(torch.int32),
                                    p1.view(torch.int32)),
        "off": s0, "on": s1,
        "kinds": sorted(mem["compile"]["by_kind"]),
        "fusion_buffer": mem["components"].get("fusion_buffer"),
        "health_file": os.path.exists(KNOBS["HOROVOD_HEALTH_FILE"])}))
"""


def test_small_lm_bitwise_with_every_knob_on_and_off(tmp_path):
    knobs = {"HOROVOD_WATCHDOG_SECS": "5",
             "HOROVOD_DIAG_DIR": str(tmp_path),
             "HOROVOD_MEMLEDGER": "1", "HOROVOD_MEMLEDGER_BUFFER": "64",
             "HOROVOD_HEALTH": "1", "HOROVOD_HEALTH_BUFFER": "64",
             "HOROVOD_HEALTH_WARMUP": "4",
             "HOROVOD_HEALTH_FILE": str(tmp_path / "history.json"),
             "HOROVOD_COMPILE_CACHE": str(tmp_path / "kernels"),
             "HOROVOD_KV_SHARDS": "2",
             "HOROVOD_METRICS_FILE": str(tmp_path / "metrics.json"),
             "HOROVOD_METRICS_DUMP_INTERVAL": "0.5"}
    r = _run(SLICE % {"knobs": knobs}, {}, timeout=180)
    assert r["losses_equal"] and r["params_equal"]
    assert r["off"] == {"watchdog": False, "ledger": False, "engine": False}
    assert r["on"] == {"watchdog": True, "ledger": True, "engine": True}
    assert r["kinds"] == ["fused"]
    assert r["fusion_buffer"] == 128 * 1024 * 1024
    assert r["health_file"]
