"""The postmortem, memory and health layer across processes: one 2-process
gloo job through the port's ``hvdrun``, its launcher's store split into two
binary shards (``HOROVOD_KV_SHARDS=2``, so every rank's negotiation and
pushes go through the shard listeners).

Each rank trains a 2-layer LM 3 steps through ``DistributedOptimizer``
with every knob of the slice off, then again after a fresh ``init`` with
the watchdog, the memory ledger, the health engine (over the perf ledger),
the async checkpointer and the flight recorder on: the parameters are
bitwise the first run's. Then each rank takes one checkpoint snapshot,
dumps a diagnostic bundle and flushes its dumper, and rank 0 reads the
launcher's ``GET /shards``, ``/debug``, ``/memory``, ``/checkpoint``,
``/history`` and ``/health``: both ranks are in each.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOB = """
    import json, os, sys, urllib.request
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.parallel import ring_attention
    from horovod_tpu_torch.utils import async_ckpt, diag
    torch.set_num_threads(1)
    RANK = int(os.environ["HOROVOD_RANK"])
    ON = {"HOROVOD_WATCHDOG_SECS": "60", "HOROVOD_DIAG_DIR": OUT + "_diag",
          "HOROVOD_MEMLEDGER": "1", "HOROVOD_HEALTH": "1",
          "HOROVOD_HEALTH_WARMUP": "4", "HOROVOD_PERFLEDGER": "1",
          "HOROVOD_FLIGHTREC": "1", "HOROVOD_ASYNC_CKPT": "1",
          "HOROVOD_METRICS_DUMP_INTERVAL": "3600"}

    def train(gen, knobs):
        for k in ON:
            os.environ.pop(k, None)
        os.environ.update(knobs)
        os.environ["HOROVOD_ELASTIC_GEN"] = str(gen)
        hvd.init(device="cpu")
        cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                  n_layers=2, d_ff=64, max_seq=16,
                                  dtype=torch.float32)
        model = T.TransformerLM(cfg, device="cpu", seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        g = torch.Generator().manual_seed(RANK)
        for _ in range(3):
            tokens = torch.randint(0, 64, (2, 17), generator=g)
            opt.zero_grad()
            T.lm_loss(model, tokens, attn_fn=ring_attention).backward()
            opt.step()
        return torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])

    ref = train(0, {})
    hvd.shutdown()
    got = train(1, ON)
    res = {"bitwise": torch.equal(got.view(torch.int32),
                                  ref.view(torch.int32)),
           "routed": context._launcher_kv().shard_ports()}
    ckpt = async_ckpt.get_checkpointer()
    ckpt.snapshot(3, {"w": got[:8].clone()})
    ckpt.flush()
    diag.dump_bundle("diagnose")
    context._ctx.metrics_dumper.flush()
    hvd.barrier()
    if RANK == 0:
        base = ("http://" + os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"] + ":"
                + os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"] + "/")
        for path in ("shards", "debug", "memory", "checkpoint",
                     "history?series=step_time_ms", "health"):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                res[path.split("?")[0]] = json.loads(r.read())
    hvd.barrier()
    hvd.shutdown()
    with open(f"{OUT}.{RANK}.json", "w") as f:
        json.dump(res, f)
    print("JOB_OK", RANK)
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """[result a rank] of the one job."""
    tmp = tmp_path_factory.mktemp("postmortem_jobs")
    # the launcher reads the checkpoint directory's manifest for /checkpoint
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_KV_SHARDS="2",
               HOROVOD_ASYNC_CKPT_DIR=str(tmp / "ckpt"))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = tmp / "postmortem_cases.py"
    script.write_text(f"OUT = {str(tmp / 'job')!r}\n"
                      + textwrap.dedent(JOB))
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, str(script)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        try:
            log = p.communicate(timeout=180)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            log = p.communicate()[0]
        assert p.returncode == 0 and all(
            f"JOB_OK {k}" in log for k in range(2)), log[-6000:]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    out = []
    for k in range(2):
        with open(tmp / f"job.{k}.json") as f:
            out.append(json.load(f))
    return out


def test_every_knob_on_is_bitwise_every_knob_off(job):
    assert all(r["bitwise"] for r in job)


def test_the_ranks_route_through_two_shards(job):
    assert job[0]["shards"]["shards"] == job[0]["routed"]
    assert len(job[0]["routed"]) == 2 and job[1]["routed"] == job[0]["routed"]


def test_debug_merges_both_ranks_bundles(job):
    dbg = job[0]["debug"]
    assert set(dbg["ranks"]) == {"0", "1"}
    assert all(r["reason"] == "diagnose" and r["threads"] > 1
               for r in dbg["ranks"].values())


def test_memory_holds_both_ranks_ledgers(job):
    ranks = job[0]["memory"]["ranks"]
    assert set(ranks) == {"0", "1"}
    for snap in ranks.values():
        assert snap["samples"] >= 1 and not snap["stale"]
        assert snap["components"]["fusion_buffer"] == 128 * 1024 * 1024
        assert "fused" in snap["compile"]["by_kind"]


def test_checkpoint_holds_both_ranks_and_the_manifest(job):
    ck = job[0]["checkpoint"]
    assert set(ck["ranks"]) == {"0", "1"}
    assert all(s["last_step"] == 3 for s in ck["ranks"].values())
    assert ck["manifest"]["step"] == 3


def test_history_and_health_hold_both_ranks(job):
    hist = job[0]["history"]["ranks"]
    assert set(hist) == {"0", "1"}
    for snap in hist.values():
        assert list(snap["series"]) == ["step_time_ms"]
        assert snap["series"]["step_time_ms"]["n"] >= 1
    health = job[0]["health"]
    assert health["verdict"] == "healthy"
    assert set(health["ranks"]) == {"0", "1"}
