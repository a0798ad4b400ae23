#!/usr/bin/env python3
"""The runtime's instruments and its autotuner on ResNet across ranks (root
script, not part of the package).

    python3 observe_probe.py [-np 4] [--device cpu] [--depth 50]
        [--batch 64] [--image 224] [--steps 8] [--rounds 2]
        [--tune-steps 100] [--fixed-steps 8] [--arms ...] [--out PATH]
        [--timeout S]
    hvdrun -np N python observe_probe.py [same options]

Run by itself, the script starts one ``hvdrun`` job of ``-np`` workers (one
GPU each; ``--device cpu`` runs them over gloo) and checks what they
report. Every run trains ResNet at ``--depth`` through
``DistributedOptimizer`` (``SGD(0.05, momentum=0.9)``, one synthetic batch
of ``--batch`` images a rank at ``--image``², bf16 compute on the card)
after a fresh ``hvd.init`` (``HOROVOD_ELASTIC_GEN`` bumped, so each init's
rounds have a prefix of their own in the launcher's store), and checks
every rank's parameters bitwise against rank 0's after every step (outside
the step's time). cuDNN is deterministic, so runs compare bit for bit.

The arms, in this order:

- ``instruments``: ``--steps`` steps with every instrument on (timeline,
  tracing, flight recorder, perf ledger, anatomy, a metrics file) and as
  many with none, in turns for ``--rounds`` rounds. Checks: at one or two
  ranks the state bitwise equal across every run (at more, a sum's order
  follows a tensor's place in its chunk, which timing forms, so the runs
  are reported, not held equal); rank 0's timeline parses, and every
  gradient has its ``NEGOTIATE_ALLREDUCE`` and ``FUSED_ALLREDUCE`` spans,
  paired, once a step; the perf ledger's five phases, summed over the
  working cycles of each hook step, come to at most that step's wall time
  (within 5 %), and their share of it is printed; the anatomy's chunk
  entities equal the runtime's chunks; the reports are enabled with the
  steps they saw; the metrics file holds the runtime's series.
- ``timeline`` (in the first instrumented run): every rank flushes its
  dumper, then rank 0 reads the launcher's ``GET /timeline`` (every rank's
  pid, each with a measured clock offset; the spread of one span's
  aligned start across the ranks) and ``GET /metrics`` (every rank's
  series labelled ``rank="k"``).
- ``straggler``: ``--steps`` steps under tracing with
  ``HOROVOD_FAULT_SPEC=controller.submit:delay=20ms`` in the environment
  of rank 2 alone (the last rank at two): the coordinator's verdicts and
  ``trace_report()`` must name it.
- ``stall``: under ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=5`` the last rank
  withholds one named allreduce; every other rank must fail it with
  ``StalledTensorError`` naming that rank, and the stall counters read it.
- ``autotune``: ``--tune-steps`` steps under ``HOROVOD_AUTOTUNE=1``
  (warm-up 2, 10 working cycles a sample, 16 samples): every proposal is
  the configuration the runtime runs at the next sample, each log row
  shows the runtime's knobs at its own sample, every rank's log holds the
  same knobs at every sample, and the parameters are bitwise equal across
  ranks after every step (a lossy wire, if chosen, is reported). Then the
  default and the settled configuration (rank 0's, for every rank) as
  fixed knobs, ``--fixed-steps`` steps each, in turns for ``--rounds``
  rounds.

The postmortem arms (``--arms debug,health,memory,kvshards``):

- ``debug``: under a 3 s watchdog (``HOROVOD_WATCHDOG_SECS``), rank n-1's
  next ``controller.submit`` after the first step waits 8 s: every rank's
  watchdog fires and pushes its bundle, and the launcher's ``GET /debug``
  merges them and names rank n-1 (the coordinator's missing rank). Fires
  in the first step (the communicators' set-up can outlast the threshold)
  count apart from the wedge's.
- ``health``: the health engine on every rank (warmup 6, the dumper's pass
  after each step, tracing on for the straggler verdicts); after 8 steps
  rank 2 sleeps 100 ms before each of its next 3 steps, as a slow host or
  input pipeline would, so every gradient of those steps arrives from it
  last: ``GET /health`` reads degraded or critical with rank 2 first
  among the suspects, and ``GET /history`` holds every rank's series.
- ``memory``: 2 steps replicated, then 2 with ``sharded_update=True``
  under the memory ledger; ``GET /memory`` holds every rank, each one's
  sharded-state component its optimizer's state bytes (the fraction of
  the replicated state is printed).
- ``kvshards``: the launcher's store in 4 binary shards
  (``HOROVOD_KV_SHARDS=4`` in the launcher's environment); each run's
  workers route over the shards or stay on HTTP, in turns for
  ``--rounds`` rounds, under the two-level negotiation (members submit
  and wait through ``put_get``) and one tensor a chunk: every run's state
  bitwise the first's, ``GET /shards`` lists 4 ports, and the cycle
  thread's host ms a round in ``put``, ``put_get``, ``get_prefix`` and the
  response poll (``megaplan_probe.RoundTimer``) beside the step ms.

Rank 0 prints each run's step ms and their median after the first, and
one JSON line of the arms' headline numbers; with ``--out PATH`` it also
writes every reading there as JSON. ``chip_smoke.py``'s ``observe`` path
runs ``instruments`` and ``autotune`` at a world of one through the
functions here.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

ARMS = ("instruments", "timeline", "straggler", "stall", "autotune",
        "debug", "health", "memory", "kvshards")
# every knob an arm sets, cleared before each init
KNOBS = ("HOROVOD_TIMELINE", "HOROVOD_TRACE", "HOROVOD_FLIGHTREC",
         "HOROVOD_PERFLEDGER", "HOROVOD_ANATOMY", "HOROVOD_METRICS_FILE",
         "HOROVOD_PERFLEDGER_BUFFER", "HOROVOD_ANATOMY_BUFFER",
         "HOROVOD_METRICS_DUMP_INTERVAL", "HOROVOD_FAULT_SPEC",
         "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
         "HOROVOD_STALL_CHECK_TIME_SECONDS", "HOROVOD_AUTOTUNE",
         "HOROVOD_AUTOTUNE_LOG", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
         "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
         "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
         "HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME",
         "HOROVOD_PLAN_CHUNK_TENSORS", "HOROVOD_HIERARCHICAL_ALLREDUCE",
         "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_COMPRESSION",
         "HOROVOD_HIER_GROUP_SIZE", "HOROVOD_WATCHDOG_SECS",
         "HOROVOD_DIAG_DIR", "HOROVOD_HEALTH", "HOROVOD_HEALTH_WARMUP",
         "HOROVOD_MEMLEDGER", "HOROVOD_KV_SHARDS",
         "HOROVOD_HIER_NEGOTIATION")
# the postmortem arms: the watchdog's threshold and rank n-1's submit
# delay (debug); the health engine's warmup, its clean and slowed steps
# and rank 2's sleep before each slowed step (health); the hook steps of the memory arm; the
# launcher's shards and the arms' shard counts, in turns (kvshards)
DEBUG_WATCHDOG_S, DEBUG_DELAY = 3, "8s"
# the slowed rank's sleep is longer than the spread of a four-GPU hook
# step (248-286 ms between clean steps on four H100s), so the other ranks
# cannot absorb it: every slowed step stays slow up to the read, and the
# latches do not re-arm before it
HEALTH_WARMUP, HEALTH_CLEAN, HEALTH_SLOW, HEALTH_DELAY_S = 6, 8, 3, 0.5
MEMORY_STEPS = 2
KV_SHARDS = 4
KV_ARMS = {"http": {"HOROVOD_KV_SHARDS": "1"},
           "shards": {"HOROVOD_KV_SHARDS": str(KV_SHARDS)}}
# members submit and wait through put_get under the two-level negotiation;
# one tensor a chunk, so the sum of an element is the same in every arm
KV_COMMON = {"HOROVOD_HIER_NEGOTIATION": "1", "HOROVOD_HIER_GROUP_SIZE": "2",
             "HOROVOD_FUSION_THRESHOLD": "0"}
PHASES = ("negotiate", "fuse_dispatch", "device_exec", "stall",
          "host_overhead")
PHASE_TOL = 0.05  # a hook step's phases against its wall time
RING = 1 << 14  # the ledger's and the anatomy's records
TUNE = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "2",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "10",
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "16",
        "HOROVOD_PERFLEDGER": "1"}
# an autotuner's knob -> the environment that fixes it at init
FIXED = {"fusion": "HOROVOD_FUSION_THRESHOLD", "cycle": "HOROVOD_CYCLE_TIME",
         "chunk": "HOROVOD_PLAN_CHUNK_TENSORS",
         "hier_ar": "HOROVOD_HIERARCHICAL_ALLREDUCE",
         "hier_ag": "HOROVOD_HIERARCHICAL_ALLGATHER",
         "compression": "HOROVOD_COMPRESSION",
         "hier_group": "HOROVOD_HIER_GROUP_SIZE"}
DEFAULT_CONFIG = {"fusion": 128 * 1024 * 1024, "cycle": 1.0, "chunk": 0,
                  "hier_ar": False, "hier_ag": False, "compression": "none"}


def instrument_env(tmp: str, tag: str) -> dict:
    """Every instrument on, its files under ``tmp``."""
    return {"HOROVOD_TIMELINE": os.path.join(tmp, f"timeline.{tag}.json"),
            "HOROVOD_TRACE": "1", "HOROVOD_FLIGHTREC": "1",
            "HOROVOD_PERFLEDGER": "1", "HOROVOD_ANATOMY": "1",
            "HOROVOD_METRICS_FILE": os.path.join(tmp, f"metrics.{tag}.json"),
            "HOROVOD_METRICS_DUMP_INTERVAL": "3600",
            # rings that hold a run's every working cycle (ResNet-50 at
            # one GPU runs about 64 a step)
            "HOROVOD_PERFLEDGER_BUFFER": str(RING),
            "HOROVOD_ANATOMY_BUFFER": str(RING)}


def fixed_env(config: dict) -> dict:
    return {FIXED[k]: (str(int(v)) if isinstance(v, bool) else str(v))
            for k, v in config.items() if k in FIXED}


def init(gen: int, knobs: dict, device):
    import horovod_tpu_torch as hvd

    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(knobs)
    os.environ["HOROVOD_ELASTIC_GEN"] = str(gen)
    hvd.init(device=device)


def state_bits(model):
    """The model's parameters and buffers as one byte tensor."""
    import torch

    return torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in model.state_dict().values()])


def hook_run(depth: str, images, labels, steps: int, seed: int = 0,
             check_ranks: bool = False, mark=None, after=None,
             sharded: bool = False) -> dict:
    """``steps`` hook steps of a fresh ResNet: losses, step seconds, each
    step's window on the wall clock, the runtime's chunks a step, the
    optimizer's state bytes and the final state's bytes; ``mark()``, when
    given, is called just before the first step (after the parameters'
    broadcast has written its records) and its value kept as ``"mark"``;
    ``after(i)``, when given, after step i; ``sharded`` is
    ``DistributedOptimizer``'s ``sharded_update``."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.common import context

    device = hvd.device()
    model = rp.build(depth, device, seed)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=rp.LR, momentum=rp.MOMENTUM),
        named_parameters=model.named_parameters(), sharded_update=sharded)
    rt = context.runtime()
    group = hvd.global_process_set().group
    if mark is not None:
        time.sleep(0.2)  # the broadcast's working cycle writes its records
    out = {"losses": [], "step_s": [], "windows": [], "chunks": [],
           "mark": mark() if mark is not None else None}
    for i in range(steps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        c0, w0, t0 = rt.chunks, time.time(), time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        out["losses"].append(loss.item())  # waits for the device work
        out["step_s"].append(time.perf_counter() - t0)
        out["windows"].append((w0, time.time()))
        out["chunks"].append(rt.chunks - c0)
        if check_ranks and not rp.same_as_rank0(model.parameters(), group):
            raise AssertionError(f"rank {hvd.rank()}: parameters differ "
                                 f"from rank 0's after step {i}")
        if after is not None:
            after(i)
    out["median_step_ms"] = statistics.median(
        out["step_s"][1:] or out["step_s"]) * 1e3
    from horovod_tpu_torch.opt.sharded import optimizer_state_bytes

    out["state_bytes"] = optimizer_state_bytes(opt)
    out["names"] = [n for n, _ in model.named_parameters()]
    out["state"] = state_bits(model).cpu()
    del model, opt
    return out


def check_timeline(path: str, names: list, steps: int) -> dict:
    """Rank 0's timeline file: it parses, and each of ``names`` has
    ``steps`` NEGOTIATE_ALLREDUCE spans, each holding one FUSED_ALLREDUCE
    span, every B closed by its E."""
    with open(path) as f:
        events = json.load(f)
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M"}
    by_lane: dict = {}
    for e in events:
        if e.get("ph") in ("B", "E"):
            by_lane.setdefault(lanes[e["tid"]], []).append(e)
    bad = []
    for n in names:
        evs = by_lane.get(n, [])
        seq = [(e["ph"], e.get("name", "")) for e in evs]
        want = [("B", "NEGOTIATE_ALLREDUCE"), ("B", "FUSED_ALLREDUCE"),
                ("E", ""), ("E", "")] * steps
        ts = [e["ts"] for e in evs]
        if seq != want or ts != sorted(ts):
            bad.append(n)
    if bad:
        raise AssertionError(f"timeline lanes not paired once a step: "
                             f"{bad[:5]} ({len(bad)} of {len(names)})")
    return {"events": len(events), "lanes": len(lanes),
            "gradients": len(names)}


def check_records(ledger_recs: list, anatomy_recs: list, chunks: int,
                  windows: list, step_s: list) -> dict:
    """The ledger's phases against each hook step's wall time, and the
    anatomy's chunk entities against the runtime's chunks.

    A working cycle belongs to the hook step in whose window it started
    (its record's time less its wall). Every cycle must fall in a step,
    every step must hold a cycle, and the five phases of a step's cycles
    must sum to no more than the step's wall time (within ``PHASE_TOL``):
    the cycles run one after another inside the step, and the rest of the
    step is the forward and backward pass outside the runtime. Their
    share of the step is reported."""
    per_step: list = [[] for _ in windows]
    for r in ledger_recs:
        start = r["ts"] - r["wall_s"]
        i = next((i for i, (a, b) in enumerate(windows) if a <= start <= b),
                 None)
        if i is None:
            raise AssertionError(f"a working cycle started at {start:.6f}, "
                                 "outside every hook step")
        per_step[i].append(sum(r[p + "_s"] for p in PHASES))
    shares = []
    for i, phases in enumerate(per_step):
        if not phases:
            raise AssertionError(f"hook step {i} recorded no working cycle")
        shares.append(sum(phases) / step_s[i])
    if max(shares) > 1 + PHASE_TOL:
        raise AssertionError(f"the ledger's phases exceed a hook step's wall "
                             f"time: {max(shares):.3f} of it")
    ents = [e for r in anatomy_recs for e in r["entities"]
            if e["kind"] == "chunk"]
    if len(ents) != chunks:
        raise AssertionError(f"the anatomy holds {len(ents)} chunks, the "
                             f"runtime ran {chunks}")
    dev = [e["device_s"] for e in ents if "device_s" in e]
    return {"cycles": len(ledger_recs), "steps": len(shares),
            "phase_share_of_step": {"min": min(shares),
                                    "median": statistics.median(shares),
                                    "max": max(shares)},
            "chunk_entities": len(ents),
            "device_ms_a_chunk": (statistics.mean(dev) * 1e3 if dev
                                  else None),
            "chunks_timed_on_device": len(dev)}


def instruments_run(gen: int, on: bool, tmp: str, depth: str, images,
                    labels, steps: int, device_arg, check_ranks: bool,
                    scrape: bool = False) -> dict:
    """One run with every instrument on, or none: its hook steps, and for
    the instrumented one the checks of ``check_records``, the reports, the
    timeline (rank 0) and the metrics file, and with ``scrape`` the
    launcher's endpoints."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import anatomy, flightrec, perfledger

    tag = f"g{gen}"
    init(gen, instrument_env(tmp, tag) if on else {}, device_arg)
    rank = hvd.rank()
    led, prof = perfledger.get_ledger(), anatomy.get_profiler()
    rd = hook_run(depth, images, labels, steps, check_ranks=check_ranks,
                  mark=(lambda: (led._total, prof._total)) if on else None)
    if on:
        time.sleep(0.2)  # the last working cycle writes its records
        reports = {"trace": hvd.trace_report(), "perf": hvd.perf_report(),
                   "anatomy": hvd.anatomy_report()}
        for name, rep in reports.items():
            if not rep.get("enabled") or not (rep.get("steps")
                                              or rep.get("spans")):
                raise AssertionError(f"{name}_report saw nothing: {rep}")
        rd["trace_spans"] = reports["trace"]["spans"]
        rd["open_spans"] = reports["trace"]["open_spans"]
        rd["perf_phases"] = reports["perf"]["phases"]
        rd["headroom"] = reports["anatomy"]["headroom"]
        rd["critical_path"] = reports["anatomy"]["critical_path"]
        l0, a0 = rd.pop("mark")
        new = (led._total - l0, prof._total - a0)
        if new[0] > len(led) or new[1] > len(prof):
            raise AssertionError(f"the rings lost records: {new}")
        rd["records"] = check_records(led.records()[len(led) - new[0]:],
                                      prof.records()[len(prof) - new[1]:],
                                      sum(rd["chunks"]), rd["windows"],
                                      rd["step_s"])
        rd["flightrec_events"] = len(flightrec.get_recorder())
        if scrape:
            rd["scrape"] = scrape_launcher()
    hvd.shutdown()
    if on:
        if rank == 0:
            rd["timeline"] = check_timeline(
                os.path.join(tmp, f"timeline.{tag}.json"), rd["names"],
                steps)
        path = os.path.join(tmp, f"metrics.{tag}.json")
        if rank:
            path += f".rank{rank}"
        with open(path) as f:
            snap = json.load(f)
        series = {c["name"] for c in snap["counters"]}
        need = {"hvd_cycles_total", "hvd_allreduce_bytes_total",
                "hvd_perf_steps_total", "hvd_anatomy_steps_total",
                "hvd_trace_spans_total", "hvd_flightrec_events_total"}
        if need - series:
            raise AssertionError(f"the metrics file lacks {need - series}")
        rd["metrics_file_series"] = len(series) + len(snap["histograms"]) \
            + len(snap["gauges"])
    return rd


def scrape_launcher() -> dict:
    """After every rank flushed its dumper: rank 0 reads the launcher's
    ``/timeline`` and ``/metrics``."""
    import urllib.request

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context

    context._ctx.metrics_dumper.flush()
    hvd.barrier()
    out = {}
    if hvd.rank() == 0:
        base = (f"http://{os.environ['HOROVOD_GLOO_RENDEZVOUS_ADDR']}:"
                f"{os.environ['HOROVOD_GLOO_RENDEZVOUS_PORT']}/")

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.read().decode()

        tl = json.loads(get("timeline"))
        n = hvd.size()
        pids = sorted({e["pid"] for e in tl["traceEvents"]})
        if pids != list(range(n)):
            raise AssertionError(f"/timeline holds pids {pids}")
        meta = tl["horovod"]["ranks"]
        if any(meta[str(k)]["clock_uncertainty_s"] is None
               for k in range(n)):
            raise AssertionError(f"a rank's clock was not aligned: {meta}")
        # a collective's k-th span on every rank: the spread of their
        # aligned starts (a rank's first round of a name may differ)
        starts: dict = {}
        for e in tl["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "collective":
                starts.setdefault(e["name"], {}).setdefault(
                    e["pid"], []).append(e["ts"])
        spread = [max(ts) - min(ts)
                  for by_pid in starts.values() if len(by_pid) == n
                  for ts in zip(*(sorted(v) for v in by_pid.values()))]
        text = get("metrics")
        missing = [k for k in range(n)
                   if f'hvd_cycles_total{{kind="work",rank="{k}"}}'
                   not in text]
        if missing:
            raise AssertionError(f"/metrics lacks ranks {missing}")
        out = {"pids": pids, "clock_offsets_s": {
            k: v["clock_offset_s"] for k, v in meta.items()},
            "clock_uncertainty_s": {k: v["clock_uncertainty_s"]
                                    for k, v in meta.items()},
            "spans_by_rank": {k: v["spans"] for k, v in meta.items()},
            "submit_spread_ms_median": (statistics.median(spread) / 1e3
                                        if spread else None),
            "metrics_lines": text.count("\n")}
    hvd.barrier()
    return out


def launcher_get(path: str):
    """Rank 0 reads one of the launcher's JSON endpoints."""
    import urllib.request

    base = (f"http://{os.environ['HOROVOD_GLOO_RENDEZVOUS_ADDR']}:"
            f"{os.environ['HOROVOD_GLOO_RENDEZVOUS_PORT']}/")
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def debug_arm(gen, depth, images, labels, device_arg, tmp, rank, n):
    """Rank n-1's next ``controller.submit`` after the first step waits
    ``DEBUG_DELAY`` under a ``DEBUG_WATCHDOG_S`` watchdog: every rank's
    watchdog fires and pushes its bundle; ``GET /debug`` names rank n-1."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import metrics

    late = n - 1
    reg = metrics.get_registry()
    fired = [reg.counter_value("hvd_watchdog_fired_total")]
    init(gen, {"HOROVOD_WATCHDOG_SECS": str(DEBUG_WATCHDOG_S),
               "HOROVOD_DIAG_DIR": os.path.join(tmp, "diag")}, device_arg)

    def wedge(i):
        if i == 0:
            fired.append(reg.counter_value("hvd_watchdog_fired_total"))
            if rank == late:
                os.environ["HOROVOD_FAULT_SPEC"] = \
                    f"controller.submit:delay={DEBUG_DELAY}#1"

    rd = hook_run(depth, images, labels, 2, check_ranks=True, after=wedge)
    os.environ.pop("HOROVOD_FAULT_SPEC", None)
    out = {"fired": reg.counter_value("hvd_watchdog_fired_total") - fired[1],
           "fired_first_step": fired[1] - fired[0], "step_s": rd["step_s"]}
    hvd.barrier()
    if rank == 0:
        merged = launcher_get("debug")
        out["debug"] = {"suspects": merged["suspects"],
                        "attribution": merged["attribution"],
                        "ranks": sorted(merged["ranks"]),
                        "stall": {k: v["stall"]
                                  for k, v in merged["ranks"].items()}}
    hvd.shutdown()
    return out


def health_arm(gen, depth, images, labels, device_arg, tmp, rank, n):
    """The health engine on every rank (warmup ``HEALTH_WARMUP``, the
    dumper's pass after each step, tracing for the straggler verdicts);
    after ``HEALTH_CLEAN`` steps rank 2 sleeps ``HEALTH_DELAY_S`` before
    each of the next ``HEALTH_SLOW`` steps, so it submits every gradient
    last and the coordinator's verdicts name it: ``GET /health`` names it
    first, ``GET /history`` holds every rank's series."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context

    slow = min(2, n - 1)
    init(gen, {"HOROVOD_HEALTH": "1",
               "HOROVOD_HEALTH_WARMUP": str(HEALTH_WARMUP),
               "HOROVOD_PERFLEDGER": "1",
               "HOROVOD_PERFLEDGER_BUFFER": str(RING),
               "HOROVOD_TRACE": "1",
               "HOROVOD_METRICS_DUMP_INTERVAL": "3600"}, device_arg)
    dumper = context._ctx.metrics_dumper

    def after(i):
        dumper.flush()  # one health sample: this step's window
        if rank == slow and \
                HEALTH_CLEAN - 1 <= i < HEALTH_CLEAN + HEALTH_SLOW - 1:
            time.sleep(HEALTH_DELAY_S)

    rd = hook_run(depth, images, labels, HEALTH_CLEAN + HEALTH_SLOW,
                  check_ranks=True, after=after)
    rep = hvd.health_report()
    out = {"slow_rank": slow, "step_s": rd["step_s"],
           "verdict": rep["verdict"],
           "active": [(a["series"], a["kind"]) for a in rep["active"]],
           "suspect_rank": rep["suspect_rank"]}
    hvd.barrier()
    if rank == 0:
        fleet = launcher_get("health")
        hist = launcher_get("history")["ranks"]
        out["fleet"] = {"verdict": fleet["verdict"],
                        "suspects": fleet["suspects"][:4],
                        "anomalies": len(fleet["anomalies"])}
        out["history"] = {k: {name: body["n"]
                              for name, body in v["series"].items()}
                          for k, v in hist.items()}
    hvd.barrier()
    hvd.shutdown()
    return out


def memory_arm(gen, depth, images, labels, device_arg, rank):
    """The replicated optimizer's state bytes, then
    ``sharded_update=True`` under the memory ledger: ``GET /memory``
    holds every rank, each one's sharded-state component its own."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context

    init(gen, {}, device_arg)
    rep = hook_run(depth, images, labels, MEMORY_STEPS, check_ranks=True)
    hvd.shutdown()
    init(gen + 1, {"HOROVOD_MEMLEDGER": "1",
                   "HOROVOD_METRICS_DUMP_INTERVAL": "3600"}, device_arg)
    rd = hook_run(depth, images, labels, MEMORY_STEPS, check_ranks=True,
                  sharded=True)
    context._ctx.metrics_dumper.flush()
    out = {"replicated_state_bytes": rep["state_bytes"],
           "sharded_state_bytes": rd["state_bytes"],
           "fraction": rd["state_bytes"] / rep["state_bytes"],
           "step_s": rd["step_s"]}
    hvd.barrier()
    if rank == 0:
        ranks = launcher_get("memory")["ranks"]
        out["memory"] = {k: {"sharded_state": v["components"].get(
                             "sharded_state"), "peak_bytes": v["peak_bytes"],
                             "stale": v["stale"]}
                         for k, v in ranks.items()}
    hvd.barrier()
    hvd.shutdown()
    return out


def kvshards_arm(gen, depth, images, labels, steps, rounds, device_arg,
                 rank):
    """The launcher's store split into ``KV_SHARDS`` binary shards against
    its HTTP path, in turns, under the two-level negotiation (members
    submit and wait through ``put_get``): step ms, and the cycle thread's
    host ms a round in the store's calls (``megaplan_probe.RoundTimer``)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from megaplan_probe import RoundTimer

    runs, ref = {}, None
    order = [a for i in range(rounds)
             for a in (("http", "shards") if i % 2 == 0
                       else ("shards", "http"))]
    for i, arm in enumerate(order):
        init(gen + i, dict(KV_COMMON, **KV_ARMS[arm]), device_arg)
        ctl = context.runtime().controller
        routed = len(ctl.client.shard_ports()) if arm == "shards" else 0
        timer = RoundTimer(ctl)
        rd = hook_run(depth, images, labels, steps, check_ranks=True)
        snap = timer.snapshot()
        hvd.shutdown()
        if ref is None:
            ref = rd["state"]
        rounds_n = max(snap["rounds"], 1)
        runs[f"{arm}#{i + 1}"] = {
            "shards_routed": routed, "step_s": rd["step_s"],
            "median_step_ms": rd["median_step_ms"],
            "bitwise_first": torch.equal(rd["state"], ref),
            "rounds": snap["rounds"],
            "host_ms_a_round": {k: snap[k] * 1e3 / rounds_n for k in (
                "put", "put_get", "get_prefix", "poll")}}
    return runs, gen + len(order)


def watch_autotuner(at) -> dict:
    """Wrap the autotuner ``at``: the runtime's knobs just before each
    sample (``"knobs"``), the sample at which each log row was written
    (``"logged"``) and each proposal with the sample that made it
    (``"proposals"``). ``check_watch`` holds them to each other."""
    w: dict = {"knobs": [], "logged": [], "proposals": []}
    sample, log, propose = at.sample, at._log, at._propose

    def sample_and_watch():
        w["knobs"].append(at.active_config())
        sample()

    def log_and_watch(score):
        w["logged"].append(len(w["knobs"]) - 1)
        log(score)

    def propose_and_watch(params, final):
        w["proposals"].append((len(w["knobs"]) - 1, dict(params)))
        propose(params, final)

    at.sample, at._log, at._propose = (sample_and_watch, log_and_watch,
                                       propose_and_watch)
    return w


def check_watch(w: dict, rows: list, proposer: bool) -> int:
    """Index by index: the log's ``rows`` (fusion, cycle, chunk) are the
    runtime's knobs at the samples that wrote them, and every proposal
    made at sample ``i`` is the configuration the runtime runs at sample
    ``i + 1``; the ``proposer`` (rank 0) must have made one. Returns the
    proposals so checked."""
    if len(rows) != len(w["logged"]):
        raise AssertionError(f"the autotune log holds {len(rows)} rows, "
                             f"the tuner logged {len(w['logged'])}")
    for j, (row, i) in enumerate(zip(rows, w["logged"])):
        k = w["knobs"][i]
        if row != [k["fusion"], k["cycle"], k.get("chunk", 0)]:
            raise AssertionError(f"log row {j} shows {row}, the runtime ran "
                                 f"{k} at sample {i}")
    checked = 0
    for i, params in w["proposals"]:
        if i + 1 >= len(w["knobs"]):
            continue  # made at the last sample
        ran = w["knobs"][i + 1]
        diff = {k: (v, ran.get(k)) for k, v in params.items()
                if ran.get(k) != v}
        if diff:
            raise AssertionError(f"sample {i + 1} ran other knobs than the "
                                 f"proposal of sample {i}: {diff} "
                                 "(proposed, ran)")
        checked += 1
    if proposer and not checked:
        raise AssertionError("no proposal was followed by a sample")
    return checked


def autotune_run(gen: int, tmp: str, depth: str, images, labels,
                 steps: int, device_arg, check_ranks: bool) -> dict:
    """``steps`` hook steps under ``HOROVOD_AUTOTUNE=1``: the log's rows,
    the runtime's knobs at every sample (``check_watch`` holds the rows
    and, on the proposing rank, the proposals to them), the settled
    configuration and the final state."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context

    rank = os.environ.get("HOROVOD_RANK", "0")
    log = os.path.join(tmp, f"autotune.g{gen}.r{rank}.csv")
    init(gen, dict(TUNE, HOROVOD_AUTOTUNE_LOG=log), device_arg)
    at = context.runtime().autotuner
    watch = watch_autotuner(at)
    rd = hook_run(depth, images, labels, steps, check_ranks=check_ranks)
    rd["done"] = bool(at.done)
    # converged, the live knobs are the best; else the best sampled yet
    rd["settled"] = (at.active_config() if at.done
                     else dict(at._best_params or at.active_config()))
    rd["best_score"] = at._best_score
    hvd.shutdown()
    with open(log) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    rd["samples"] = [{"sample": int(r[0]), "fusion": int(r[1]),
                      "cycle": float(r[2]), "hier_ar": r[3] == "1",
                      "hier_ag": r[4] == "1", "chunk": int(r[6] or 0),
                      "compression": r[7], "hier_group": r[8],
                      "score": float(r[9])} for r in rows]
    logged = [[s["fusion"], s["cycle"], s["chunk"]] for s in rd["samples"]]
    # only rank 0 proposes; the other ranks' logs are held to rank 0's
    rd["proposals_checked"] = check_watch(watch, logged, rank == "0")
    rd["knobs_at_samples"] = watch["knobs"]
    return rd


def fixed_runs(gen: int, configs: dict, depth: str, images, labels,
               steps: int, rounds: int, device_arg, check_ranks: bool):
    """Each configuration as fixed knobs, ``steps`` hook steps a run, in
    turns for ``rounds`` rounds; returns the runs and the next gen."""
    import horovod_tpu_torch as hvd

    out = {}
    for i in range(rounds):
        for name, cfg in configs.items():
            init(gen, fixed_env(cfg), device_arg)
            gen += 1
            rd = hook_run(depth, images, labels, steps,
                          check_ranks=check_ranks)
            hvd.shutdown()
            out[f"{name}#{i + 1}"] = {k: rd[k] for k in (
                "step_s", "median_step_ms", "chunks")}
    return out, gen


def summary(readings: dict) -> dict:
    """The arms' headline numbers (``--out`` holds the rest)."""
    out = {}
    for name, rd in readings.get("instruments", {}).items():
        out[f"instruments {name}"] = {
            k: rd[k] for k in ("median_step_ms", "state_equal_to_first",
                               "records", "timeline", "scrape",
                               "open_spans") if k in rd}
    for arm in ("straggler", "stall"):
        if arm in readings:
            out[arm] = {k: v for k, v in readings[arm].items()
                        if k != "step_s"}
    for arm in ("debug", "health", "memory"):
        if arm in readings:
            out[arm] = {k: v for k, v in readings[arm].items()
                        if k != "step_s"}
    if "kvshards" in readings:
        out["kvshards"] = {
            name: {"median_step_ms": r["median_step_ms"],
                   "put_get_ms_a_round": r["host_ms_a_round"]["put_get"]}
            for name, r in readings["kvshards"]["runs"].items()}
    if "autotune" in readings:
        a = readings["autotune"]
        out["autotune"] = {
            "samples": len(a["samples"]), "settled": a["settled"],
            "converged": a["converged"],
            "proposals_checked": a["proposals_checked"], "median_step_ms":
            a["median_step_ms"], "lossy_wire_sampled":
            a["lossy_wire_sampled"],
            "fixed_median_ms": {k: f["median_step_ms"]
                                for k, f in a["fixed"].items()}}
    return out


def card() -> str:
    """The cards' names and power limits, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _log(rank: int, msg: str):
    if rank == 0:
        print(msg, flush=True)


def worker(args) -> int:
    import torch

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.common.exceptions import StalledTensorError
    from horovod_tpu_torch.utils import metrics

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank, n = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
    device_arg = args.device
    device = (torch.device("cpu") if args.device == "cpu"
              else torch.device("cuda", int(os.environ.get(
                  "HOROVOD_LOCAL_RANK", rank))))
    images, labels = rp.synthetic_batch(args.seed, n, args.batch,
                                        args.image, rp.CONFIGS[args.depth][2],
                                        rank, device)
    arms = args.arms.split(",")
    tmp = tempfile.mkdtemp(prefix="observe_probe_")
    reg = metrics.get_registry()
    readings: dict = {}
    gen = 0
    failures = []
    if "instruments" in arms:
        runs, ref = {}, None
        for i in range(args.rounds):
            for on in (True, False):
                name = f"{'on' if on else 'off'}#{i + 1}"
                rd = instruments_run(gen, on, tmp, args.depth, images,
                                     labels, args.steps, device_arg, True,
                                     scrape=(on and i == 0
                                             and "timeline" in arms))
                gen += 1
                if ref is None:
                    ref = rd["state"]
                rd["state_equal_to_first"] = torch.equal(rd.pop("state"),
                                                         ref)
                # at more than two ranks the sum's order follows a tensor's
                # place in its chunk, which the cycle's timing forms
                if n <= 2 and not rd["state_equal_to_first"]:
                    failures.append(f"instruments {name}: state differs")
                rd.pop("names")
                runs[name] = rd
                _log(rank, f"  instruments {name}: step ms "
                     f"{[round(s * 1e3, 2) for s in rd['step_s']]}; median "
                     f"after the first {rd['median_step_ms']:.2f}; chunks "
                     f"a step {rd['chunks']}")
        readings["instruments"] = runs
    if "straggler" in arms:
        slow = min(2, n - 1)
        knobs = {"HOROVOD_TRACE": "1"}
        if rank == slow:
            knobs["HOROVOD_FAULT_SPEC"] = "controller.submit:delay=20ms"
        init(gen, knobs, device_arg)
        gen += 1
        before = {k: reg.counter_value("hvd_straggler_last_rank_total",
                                       rank=str(k)) for k in range(n)}
        rd = hook_run(args.depth, images, labels, args.steps,
                      check_ranks=True)
        rep = hvd.trace_report()
        hvd.shutdown()
        strag = rep.get("straggler") or {}
        counts = strag.get("last_rank_counts", {})
        verdicts = {k: reg.counter_value("hvd_straggler_last_rank_total",
                                         rank=str(k)) - before[k]
                    for k in range(n)}
        named = max(counts, key=counts.get) if counts else None
        if named != str(slow):
            failures.append(f"straggler: trace_report names {named}: "
                            f"{counts}")
        if rank == 0 and max(verdicts, key=verdicts.get) != slow:
            failures.append(f"straggler: the coordinator's verdicts "
                            f"{verdicts}")
        readings["straggler"] = {
            "slow_rank": slow, "trace_last_rank_counts": counts,
            "coordinator_verdicts": verdicts if rank == 0 else None,
            "wait_p50_ms": strag.get("wait_p50_ms"),
            "wait_p95_ms": strag.get("wait_p95_ms"),
            "step_s": rd["step_s"], "median_step_ms": rd["median_step_ms"]}
        _log(rank, f"  straggler (rank {slow} delayed 20 ms a submit): "
             f"trace_report last-rank counts {counts}; coordinator "
             f"verdicts {verdicts}; wait p50 {strag.get('wait_p50_ms')} ms; "
             f"step ms median {rd['median_step_ms']:.2f}")
    if "stall" in arms:
        late = n - 1
        init(gen, {"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "5",
                   "HOROVOD_STALL_CHECK_TIME_SECONDS": "2"}, device_arg)
        gen += 1
        keys = ("hvd_stall_warnings_total",
                "hvd_coordinator_error_tensors_total",
                "hvd_negotiation_errors_total")
        c0 = {k: reg.counter_value(k) for k in keys}
        rd = {}
        if rank != late:
            t0 = time.monotonic()
            try:
                hvd.allreduce(torch.ones(4, device=device), name="withheld")
                rd["error"] = None
            except hvd.HorovodInternalError as e:
                rd["error"] = [type(e).__name__, str(e)]
            rd["seconds"] = time.monotonic() - t0
            ok = (rd["error"] is not None
                  and rd["error"][0] == StalledTensorError.__name__
                  and f"waiting on ranks [{late}]" in rd["error"][1])
            if not ok:
                failures.append(f"stall: rank {rank} got {rd['error']}")
        else:
            time.sleep(8)  # the cycle keeps the lockstep; never submitted
        rd["counters"] = {k: reg.counter_value(k) - c0[k] for k in keys}
        if rank != late and rd["counters"]["hvd_negotiation_errors_total"] < 1:
            failures.append(f"stall: rank {rank}'s counters {rd['counters']}")
        hvd.barrier()
        hvd.shutdown()
        readings["stall"] = rd
        _log(rank, f"  stall: rank 0 {rd}")
    if "autotune" in arms:
        rd = autotune_run(gen, tmp, args.depth, images, labels,
                          args.tune_steps, device_arg, True)
        gen += 1
        # the knobs at every sample: rank 0 alone restarts its sample
        # count on a workload shift, and each rank scores its own window
        rows = [{k: v for k, v in s.items() if k not in ("sample", "score")}
                for s in rd["samples"]]
        init(gen, {}, device_arg)
        gen += 1
        every = hvd.allgather_object((rows, rd["settled"]))
        hvd.shutdown()
        if any(r != every[0][0] for r, _ in every):
            failures.append(f"autotune: the ranks' logs differ: "
                            f"{[r for r, _ in every]}")
        lossy = sorted({s["compression"] for s in rd["samples"]}
                       - {"", "none"})
        # unconverged, only rank 0 knows the best configuration sampled:
        # every rank fixes rank 0's
        settled = every[0][1]
        fixed, gen = fixed_runs(gen, {"default": DEFAULT_CONFIG,
                                      "settled": settled}, args.depth,
                                images, labels, args.fixed_steps,
                                args.rounds, device_arg, True)
        readings["autotune"] = {
            "samples": rd["samples"], "settled": settled,
            "converged": rd["done"], "lossy_wire_sampled": lossy,
            "step_s": rd["step_s"], "median_step_ms": rd["median_step_ms"],
            "proposals_checked": rd["proposals_checked"], "fixed": fixed}
        _log(rank, f"  autotune: {len(rd['samples'])} samples; settled on "
             f"{settled} (converged {rd['done']}); "
             f"{rd['proposals_checked']} proposals each ran at the next "
             f"sample; lossy wires sampled "
             f"{lossy or 'none'}; step ms median {rd['median_step_ms']:.2f}")
        for s in rd["samples"]:
            _log(rank, f"    sample {s}")
        for name, f in fixed.items():
            _log(rank, f"  fixed {name}: step ms "
                 f"{[round(x * 1e3, 2) for x in f['step_s']]}; median "
                 f"after the first {f['median_step_ms']:.2f}")
    if "debug" in arms:
        rd = debug_arm(gen, args.depth, images, labels, device_arg, tmp,
                       rank, n)
        gen += 1
        if rd["fired"] < 1:
            failures.append(f"debug: the watchdog did not fire: {rd}")
        if rank == 0 and rd["debug"]["suspects"] != [n - 1]:
            failures.append(f"debug: /debug names {rd['debug']}")
        if rank == 0 and rd["debug"]["ranks"] != [str(k) for k in range(n)]:
            failures.append(f"debug: /debug merged {rd['debug']['ranks']}")
        readings["debug"] = rd
        _log(rank, f"  debug: rank {n - 1} delayed {DEBUG_DELAY} under a "
             f"{DEBUG_WATCHDOG_S} s watchdog: fired {rd['fired']} on rank 0 "
             f"({rd['fired_first_step']} in the first step); "
             f"/debug {rd.get('debug')}")
    if "health" in arms:
        rd = health_arm(gen, args.depth, images, labels, device_arg, tmp,
                        rank, n)
        gen += 1
        if rank == 0:
            fleet = rd["fleet"]
            if fleet["verdict"] == "healthy" or not fleet["suspects"] or \
                    fleet["suspects"][0]["rank"] != str(rd["slow_rank"]):
                failures.append(f"health: /health read {fleet}")
            if sorted(rd["history"]) != [str(k) for k in range(n)] or \
                    not all(rd["history"].values()):
                failures.append(f"health: /history held {rd['history']}")
        readings["health"] = rd
        _log(rank, f"  health: rank {rd['slow_rank']} slowed after "
             f"{HEALTH_CLEAN} steps; rank 0 {rd['verdict']} {rd['active']}; "
             f"/health {rd.get('fleet')}; /history {rd.get('history')}")
    if "memory" in arms:
        rd = memory_arm(gen, args.depth, images, labels, device_arg, rank)
        gen += 2
        if rank == 0:
            got = {k: v["sharded_state"] for k, v in rd["memory"].items()}
            if sorted(got) != [str(k) for k in range(n)] or \
                    got["0"] != rd["sharded_state_bytes"]:
                failures.append(f"memory: /memory held {rd['memory']}")
        readings["memory"] = rd
        _log(rank, f"  memory: sharded state {rd['sharded_state_bytes']} of "
             f"{rd['replicated_state_bytes']} bytes "
             f"({rd['fraction']:.4f}); /memory {rd.get('memory')}")
    if "kvshards" in arms:
        runs, gen = kvshards_arm(gen, args.depth, images, labels,
                                 args.steps, args.rounds, device_arg, rank)
        for name, rd in runs.items():
            if not rd["bitwise_first"]:
                failures.append(f"kvshards {name}: state differs from the "
                                "first run's")
            if name.startswith("shards") and rd["shards_routed"] != KV_SHARDS:
                failures.append(f"kvshards {name}: routed over "
                                f"{rd['shards_routed']} shards")
            _log(rank, f"  kvshards {name}: step ms "
                 f"{[round(x * 1e3, 2) for x in rd['step_s']]}; median "
                 f"{rd['median_step_ms']:.2f}; {rd['rounds']} rounds; host "
                 f"ms a round {rd['host_ms_a_round']}")
        init(gen, {}, device_arg)
        gen += 1
        every = hvd.allgather_object({k: r["host_ms_a_round"]
                                      for k, r in runs.items()})
        shards = launcher_get("shards")["shards"] if rank == 0 else None
        hvd.shutdown()
        readings["kvshards"] = {"runs": runs, "host_ms_by_rank": every,
                                "shards": shards}
        if rank == 0 and len(shards) != KV_SHARDS:
            failures.append(f"kvshards: /shards lists {shards}")
    if rank == 0:
        head = {"ranks": n, "depth": args.depth, "batch": args.batch,
                "image": args.image, "device": str(device),
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "card": card() if device.type == "cuda" else None}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(head, observe_probe=readings), f,
                          default=str)
        print(json.dumps(dict(head, observe_probe=summary(readings)),
                         default=str), flush=True)
    if failures:
        raise AssertionError(f"rank {rank}: {failures}")
    print(f"OBSERVE_PROBE_OK {rank}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--depth", default="50")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tune-steps", type=int, default=100)
    ap.add_argument("--fixed-steps", type=int, default=8)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="rank 0 writes every reading here as JSON")
    ap.add_argument("--timeout", type=float, default=1500.0)
    args = ap.parse_args()
    if set(args.arms.split(",")) - set(ARMS):
        raise SystemExit(f"--arms takes {ARMS}")
    root = os.path.dirname(os.path.abspath(__file__))
    if "HOROVOD_RANK" in os.environ:
        sys.path.insert(0, root)
        return worker(args)
    if args.device != "cpu":
        print(card(), flush=True)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np), sys.executable, os.path.abspath(__file__)] \
        + sys.argv[1:]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    if "kvshards" in args.arms.split(","):
        # the launcher's store in shards; each arm's workers route or not
        env["HOROVOD_KV_SHARDS"] = str(KV_SHARDS)
    t0 = time.perf_counter()
    # a session of its own, so a timeout ends the launcher and its workers
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=args.timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        print(p.communicate()[0])
        raise AssertionError("observe_probe: the job timed out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"OBSERVE_PROBE_OK {k}" in out
                                    for k in range(args.np)):
        raise AssertionError("observe_probe: the job failed")
    print(f"observe_probe: {args.np} ranks on {args.device or 'cuda'}, "
          f"ResNet-{args.depth}, every arm passed; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
