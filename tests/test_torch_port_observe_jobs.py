"""The instruments and the autotuner across processes: two 2-process gloo
jobs through the port's ``hvdrun``, started at once.

- ``tune``: a tiny ResNet trained 6 steps through ``DistributedOptimizer``
  untuned, then again after a fresh ``init`` under ``HOROVOD_AUTOTUNE=1``
  with tracing, the perf ledger and the anatomy on. Rank 0's proposals
  ride the round responses, so both ranks' autotune logs hold the same
  knobs at every sample, and the parameters are bitwise the untuned run's
  (at two ranks a sum is the same in any chunking; four bandit samples
  keep the wire uncompressed). Then every rank flushes its dumper and rank
  0 scrapes the launcher's ``GET /metrics``, ``/timeline``, ``/perf`` and
  ``/anatomy``: both ranks are there, labelled, clock-aligned.
- ``faults``: a ``plan.dispatch:fail#1`` fault under tracing fails the
  first chunk on both ranks and leaves no span open; then, under
  ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=2``, rank 1 withholds one named
  allreduce, which fails on rank 0 with ``StalledTensorError`` naming
  rank 1, and the stall counters read it; rank 1 waits for rank 0's word
  in the launcher's store that the allreduce failed.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = """
    import json, os, sys, time, urllib.request
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.utils import metrics
    torch.set_num_threads(1)
    RANK = int(os.environ["HOROVOD_RANK"])
    REG = metrics.get_registry()

    def init(gen, **knobs):
        for k in list(os.environ):
            if k.startswith(("HOROVOD_AUTOTUNE", "HOROVOD_TRACE",
                             "HOROVOD_PERFLEDGER", "HOROVOD_ANATOMY",
                             "HOROVOD_FAULT", "HOROVOD_STALL",
                             "HOROVOD_METRICS")):
                os.environ.pop(k)
        os.environ.update(knobs)
        # each init's rounds under a prefix of their own in the store
        os.environ["HOROVOD_ELASTIC_GEN"] = str(gen)
        hvd.init(device="cpu")
"""

TUNE = """
    import resnet_probe as rp

    def train(steps=6):
        model = rp.build("tiny", torch.device("cpu"), 0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters())
        images, labels = rp.synthetic_batch(0, 2, 4, 32, 10, RANK,
                                            torch.device("cpu"))
        for _ in range(steps):
            opt.zero_grad()
            F.cross_entropy(model(images), labels).backward()
            opt.step()
        return torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])

    init(0)
    ref = train()
    hvd.shutdown()
    log = f"{OUT}.at{RANK}.csv"
    init(1, HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_LOG=log,
         HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
         HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="2",
         HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="4", HOROVOD_TRACE="1",
         HOROVOD_PERFLEDGER="1", HOROVOD_ANATOMY="1",
         HOROVOD_METRICS_DUMP_INTERVAL="3600")
    got = train()
    res = {"bitwise": torch.equal(got.view(torch.int32),
                                  ref.view(torch.int32)),
           "knobs": [r.split(",")[1:9] for r in
                     open(log).read().splitlines()[1:]],
           "open_spans": hvd.trace_report()["open_spans"]}
    context._ctx.metrics_dumper.flush()
    hvd.barrier()
    if RANK == 0:
        base = ("http://" + os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"] + ":"
                + os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"] + "/")

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.read().decode()

        res["metrics"] = get("metrics")
        res["timeline"] = json.loads(get("timeline"))
        res["perf"] = json.loads(get("perf"))
        res["anatomy"] = json.loads(get("anatomy"))
    hvd.barrier()
    hvd.shutdown()
    with open(f"{OUT}.{RANK}.json", "w") as f:
        json.dump(res, f)
    print("JOB_OK", RANK)
"""

FAULTS = """
    init(0, HOROVOD_TRACE="1", HOROVOD_FAULT_SPEC="plan.dispatch:fail#1")
    res = {}
    ts = [torch.full((64,), float(RANK + i)) for i in range(4)]
    try:
        for h in hvd.grouped_allreduce_async_(ts, name="f", op=hvd.Sum):
            hvd.synchronize(h)
        res["fault"] = None
    except hvd.HorovodInternalError as e:
        res["fault"] = type(e).__name__
    out = hvd.allreduce(torch.ones(8), name="after", op=hvd.Sum)
    res["after"] = out.tolist()
    rep = hvd.trace_report()
    res["spans"] = (rep["spans"], rep["open_spans"], rep["errors"])
    hvd.shutdown()

    init(1, HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="2",
         HOROVOD_STALL_CHECK_TIME_SECONDS="1")
    kv = context._launcher_kv()
    if RANK == 0:
        t0 = time.monotonic()
        try:
            hvd.allreduce(torch.ones(4), name="withheld")
            res["stall"] = None
        except hvd.HorovodInternalError as e:
            res["stall"] = [type(e).__name__, str(e)]
        res["stall_s"] = time.monotonic() - t0
        res["counters"] = {
            k: REG.counter_value(k) for k in (
                "hvd_stall_warnings_total",
                "hvd_coordinator_error_tensors_total",
                "hvd_negotiation_errors_total")}
        kv.put("stall_case", "failed", b"1")
    else:
        # the cycle keeps the lockstep while "withheld" never comes, until
        # rank 0 says its allreduce failed (a fixed sleep raced rank 0's
        # stall clock under load)
        kv.get("stall_case", "failed", timeout=120)
    hvd.barrier()
    hvd.shutdown()
    with open(f"{OUT}.{RANK}.json", "w") as f:
        json.dump(res, f)
    print("JOB_OK", RANK)
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{job: [result a rank]}; both jobs at once."""
    tmp = tmp_path_factory.mktemp("observe_jobs")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    for name, body in (("tune", TUNE), ("faults", FAULTS)):
        script = tmp / f"{name}_cases.py"
        script.write_text(f"OUT = {str(tmp / name)!r}\n"
                          + textwrap.dedent(COMMON) + textwrap.dedent(body))
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
             sys.executable, str(script)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
    out = {}
    try:
        for name, p in procs.items():
            try:
                log = p.communicate(timeout=180)[0]
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                log = p.communicate()[0]
            assert p.returncode == 0 and all(
                f"JOB_OK {k}" in log for k in range(2)), log[-6000:]
            out[name] = []
            for k in range(2):
                with open(tmp / f"{name}.{k}.json") as f:
                    out[name].append(json.load(f))
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return out


def test_autotune_logs_equal_on_both_ranks(jobs):
    r0, r1 = jobs["tune"]
    assert r0["knobs"] and r0["knobs"] == r1["knobs"]
    # the knobs moved: proposals were applied, on both ranks alike
    assert len({tuple(k) for k in r0["knobs"]}) > 1
    # fusion, cycle, hier flags, ring slots, chunk, wire, group
    assert all(k[6] in ("", "none") for k in r0["knobs"])


def test_autotuned_parameters_are_bitwise_the_untuned_job(jobs):
    assert all(r["bitwise"] for r in jobs["tune"])
    assert all(r["open_spans"] == 0 for r in jobs["tune"])


def test_metrics_scrape_labels_both_ranks(jobs):
    text = jobs["tune"][0]["metrics"]
    for k in range(2):
        assert f'hvd_cycles_total{{kind="work",rank="{k}"}}' in text
        assert f'rank="{k}"' in text
    assert "# TYPE hvd_perf_steps_total counter" in text


def test_timeline_scrape_merges_both_ranks_clock_aligned(jobs):
    tl = jobs["tune"][0]["timeline"]
    ev = tl["traceEvents"]
    assert {e["pid"] for e in ev} == {0, 1}
    for k in ("0", "1"):
        meta = tl["horovod"]["ranks"][k]
        assert meta["spans"] > 0 and meta["clock_uncertainty_s"] is not None
    assert {e["pid"] for e in ev if e.get("cat") == "anatomy"} == {0, 1}
    assert set(tl["horovod"]["critical_path"]) == {"0", "1"}


def test_perf_and_anatomy_scrapes_hold_both_ranks(jobs):
    r0 = jobs["tune"][0]
    for view in ("perf", "anatomy"):
        ranks = r0[view]["ranks"]
        assert set(ranks) == {"0", "1"}
        assert all(s["steps"] > 0 and not s["stale"]
                   for s in ranks.values())


def test_dispatch_fault_leaves_no_span_unfinished(jobs):
    for r in jobs["faults"]:
        assert r["fault"] == "HorovodInternalError"
        assert r["after"] == [2.0] * 8
        spans, open_spans, errors = r["spans"]
        assert open_spans == 0 and spans == 5 and errors == 4


def test_withheld_tensor_fails_with_stalled_tensor_error(jobs):
    r0 = jobs["faults"][0]
    name, msg = r0["stall"]
    assert name == "StalledTensorError"
    assert "'withheld'" in msg and "waiting on ranks [1]" in msg
    assert 2.0 <= r0["stall_s"]
    c = r0["counters"]
    assert c["hvd_stall_warnings_total"] >= 1
    assert c["hvd_coordinator_error_tensors_total"] >= 1
    assert c["hvd_negotiation_errors_total"] >= 1
