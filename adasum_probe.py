#!/usr/bin/env python3
"""Adasum, the two-level allreduce and synchronized batch norm across ranks
on ResNet (root script, not part of the package).

    python3 adasum_probe.py [-np 4] [-H localhost:2,127.0.0.1:2]
        [--device cpu] [--depth 50] [--batch 64] [--image 224] [--steps 6]
        [--arms average,average_hier,adasum,adasum_hier,average_syncbn]
        [--timeout S] [--out PATH]
    hvdrun -np N [-H ...] python adasum_probe.py [same options]

Run by itself, the script starts one ``hvdrun`` job of ``-np`` workers
(``-H`` passed on: ``localhost:2,127.0.0.1:2`` makes one machine's four
GPUs two hosts of two, the launcher running every slot locally) and checks
what they report. A worker drives ``cuda:<rank>``, not ``cuda:<local_rank>``:
under ``-H`` the local ranks repeat across the "hosts" of one machine.
``--device cpu`` runs the workers over gloo.

Each worker runs the arms in the order given, each after a fresh
``hvd.init`` (``HOROVOD_ELASTIC_GEN`` bumped, so each init's negotiation
has a prefix of its own in the launcher's store) under its knobs:

- ``average``: ``DistributedOptimizer(op=Average)``, flat;
- ``average_hier``: the same under ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` and
  ``HOROVOD_HIERARCHICAL_ALLGATHER=1`` (reduce-scatter within a host,
  allreduce across hosts, allgather within the host);
- ``adasum``: ``DistributedOptimizer(op=Adasum)``, the delta optimizer,
  flat (an allgather of every rank's delta and the tree over K4);
- ``adasum_hier``: the same two-level (Adasum of the hosts' means);
- ``average_syncbn``: ``average`` with the model's batch norms synchronized
  over the global set (``sync_bn_group``).

An arm builds ResNet at ``--depth`` (``resnet_probe.build``: bf16 compute
over fp32 weights on the card, fp32 on the CPU) from seed ``--seed +
rank``, broadcasts rank 0's ``state_dict``, and takes ``--steps`` steps of
``SGD(0.05, momentum=0.9)`` on one synthetic batch of ``--batch`` images a
rank at ``--image``² (``resnet_probe.synthetic_batch``), cuDNN
deterministic. After every step each rank's parameters are compared bit
for bit with rank 0's (outside the timed step); a difference fails the job.

Rank 0 prints per arm the losses, the step ms (host clock, the device
synchronized at the step's end), their median after the first step and
img/s a GPU from it, and a step's K4 launches (by kernel), K1 launches,
the runtime's chunks and collective calls and the calls into
``torch.distributed`` by kind (counted by wrapping them in this script,
every thread's, sync BN's included); then one JSON line, which the parent
also writes to ``--out`` when given. The parent fails unless every arm
held its parameters bitwise on every rank after every step, every loss is
finite, the two Average arms' first losses are bitwise equal and the later
ones within ``AVERAGE_LOSS_TOL`` (relative: their gradients add in another
order), the two-level arms made reduce-scatters (and, with more than one
host, the Adasum one its send/recv pairs), and the Adasum arms launched K4
on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

HIER = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
        "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}
ARMS = {"average": {}, "average_hier": HIER, "adasum": {},
        "adasum_hier": HIER, "average_syncbn": {}}
KNOBS = tuple(HIER)
AVERAGE_LOSS_TOL = 1e-3
# the calls into torch.distributed counted by kind
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
         "batch_isend_irecv", "all_to_all_single")


class CallCounter:
    """Calls into ``torch.distributed`` by kind, from every thread, by
    wrapping the functions the port calls (``dist.*`` and the one-tensor
    allgather and reduce-scatter that ``ops/collectives.py`` binds)."""

    def __init__(self):
        import torch.distributed as dist

        from horovod_tpu_torch.ops import collectives as C

        self.lock = threading.Lock()
        self.counts = {k: 0 for k in KINDS}
        for kind in ("all_reduce", "broadcast", "batch_isend_irecv",
                     "all_to_all_single"):
            setattr(dist, kind, self._wrap(getattr(dist, kind), kind))
        C._all_gather = self._wrap(C._all_gather, "all_gather")
        C._reduce_scatter = self._wrap(C._reduce_scatter, "reduce_scatter")

    def _wrap(self, fn, kind):
        def counted(*a, **kw):
            with self.lock:
                self.counts[kind] += 1
            return fn(*a, **kw)

        return counted

    def snapshot(self) -> dict:
        with self.lock:
            return dict(self.counts)


def _counts(calls: CallCounter) -> dict:
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import fused_pack as fp

    out = {f"dist.{k}": v for k, v in calls.snapshot().items()}
    out.update({k: v for k, v in adasum.kernel_launches.items()})
    out["K1 launches"] = sum(fp.kernel_launches.values())
    out["chunks"] = context.runtime().chunks
    out["collective calls"] = context.runtime().collective_calls
    return out


def run_arm(args, gen, arm, device, images, labels, calls) -> dict:
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp

    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ARMS[arm])
    os.environ["HOROVOD_ELASTIC_GEN"] = str(gen)
    hvd.init(device=device)
    rank = hvd.rank()
    ps = hvd.global_process_set()
    model = rp.build(args.depth, device, args.seed + rank,
                     ps.group if arm == "average_syncbn" else None)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=rp.LR, momentum=rp.MOMENTUM),
        named_parameters=model.named_parameters(),
        op=hvd.Adasum if arm.startswith("adasum") else hvd.Average)
    rd = {"optimizer": type(opt).__name__, "losses": [], "step_ms": [],
          "per_step": [], "same_on_every_rank": [],
          "two_level": ps.runtime_hierarchy is not None}
    for _ in range(args.steps):
        c0 = _counts(calls)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        rd["losses"].append(loss.item())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rd["step_ms"].append((time.perf_counter() - t0) * 1e3)
        c1 = _counts(calls)
        rd["per_step"].append({k: c1[k] - c0[k] for k in c0})
        same = rp.same_as_rank0(params, ps.group)
        rd["same_on_every_rank"].append(same)
        if not same:
            raise AssertionError(f"rank {rank}: {arm}: parameters differ "
                                 f"from rank 0's after step "
                                 f"{len(rd['losses']) - 1}")
    later = rd["step_ms"][1:] or rd["step_ms"]
    rd["median_after_first_ms"] = statistics.median(later)
    rd["img_s_per_gpu"] = args.batch / rd["median_after_first_ms"] * 1e3
    # a step after the first: the communicators' and cuDNN's warm-up left
    # out
    steady = rd["per_step"][1:] or rd["per_step"]
    rd["a_step"] = {k: statistics.median(s[k] for s in steady)
                    for k in steady[0]}
    del model, params, opt
    gc.collect()
    hvd.shutdown()
    return rd


def worker(args) -> int:
    import torch

    import resnet_probe as rp

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank, n = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
    # one machine's GPUs as several hosts: the local ranks repeat, the
    # global rank is the GPU
    device = (torch.device("cpu") if args.device == "cpu"
              else torch.device("cuda", rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    images, labels = rp.synthetic_batch(args.seed, n, args.batch, args.image,
                                        rp.CONFIGS[args.depth][2], rank,
                                        device)
    calls = CallCounter()
    readings = {}
    for gen, arm in enumerate(args.arms.split(",")):
        readings[arm] = run_arm(args, gen, arm, device, images, labels,
                                calls)
    if rank == 0:
        for arm, rd in readings.items():
            print(f"  {arm} ({rd['optimizer']}, two levels "
                  f"{rd['two_level']}): losses {rd['losses']}", flush=True)
            print(f"  {arm}: step ms {[round(x, 2) for x in rd['step_ms']]}"
                  f"; median after the first "
                  f"{rd['median_after_first_ms']:.2f} ms, "
                  f"{rd['img_s_per_gpu']:.1f} img/s a GPU; parameters "
                  f"bitwise equal on every rank after every step: "
                  f"{all(rd['same_on_every_rank'])}", flush=True)
            print(f"  {arm}: a step: " + ", ".join(
                f"{k} {v}" for k, v in rd["a_step"].items()), flush=True)
        print(json.dumps({
            "adasum_probe": readings, "ranks": n,
            "local_size": int(os.environ.get("HOROVOD_LOCAL_SIZE", n)),
            "cross_size": int(os.environ.get("HOROVOD_CROSS_SIZE", 1)),
            "depth": args.depth, "batch": args.batch, "image": args.image,
            "device": str(device),
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")}), flush=True)
    print(f"ADASUM_PROBE_OK {rank}", flush=True)
    return 0


def check(reading: dict, cuda: bool) -> list:
    """What the parent holds the job's reading to; returns the failures."""
    arms = reading["adasum_probe"]
    bad = []
    for arm, rd in arms.items():
        if not all(rd["same_on_every_rank"]):
            bad.append(f"{arm}: parameters differ across ranks")
        if not all(math.isfinite(x) for x in rd["losses"]):
            bad.append(f"{arm}: losses {rd['losses']}")
        step = rd["a_step"]
        if arm.endswith("_hier"):
            if not rd["two_level"] or not step["dist.reduce_scatter"]:
                bad.append(f"{arm}: the two-level path did not run")
            if (arm == "adasum_hier" and reading["cross_size"] > 1
                    and not step["dist.batch_isend_irecv"]):
                bad.append(f"{arm}: no send/recv across hosts")
        if arm.startswith("adasum") and cuda and not (
                step["adasum_dot_norms"] and step["adasum_scaled_add"]):
            bad.append(f"{arm}: K4 never launched")
    if "average" in arms and "average_hier" in arms:
        a, h = arms["average"]["losses"], arms["average_hier"]["losses"]
        if a[0] != h[0] or any(abs(x - y) > AVERAGE_LOSS_TOL * abs(x)
                               for x, y in zip(a[1:], h[1:])):
            bad.append(f"the Average arms' losses differ: {a} against {h}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("-H", dest="hosts", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--depth", default="50")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None,
                    help="write the job's JSON reading to this file")
    args = ap.parse_args()
    if set(args.arms.split(",")) - set(ARMS):
        raise SystemExit(f"--arms takes {tuple(ARMS)}")
    root = os.path.dirname(os.path.abspath(__file__))
    if "HOROVOD_RANK" in os.environ:
        sys.path.insert(0, root)
        return worker(args)
    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card, flush=True)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np)] + (["-H", args.hosts] if args.hosts else []) + [
        sys.executable, os.path.abspath(__file__)] + sys.argv[1:]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for k in KNOBS:
        env.pop(k, None)
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
        raise AssertionError("adasum_probe: the job timed out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"ADASUM_PROBE_OK {k}" in out
                                    for k in range(args.np)):
        raise AssertionError("adasum_probe: the job failed")
    reading = None
    for line in out.splitlines():
        at = line.find('{"adasum_probe"')  # after the launcher's prefix
        if at >= 0:
            reading = json.loads(line[at:])
    if reading is None:
        raise AssertionError("adasum_probe: the job printed no reading")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(reading, card=card), f)
    bad = check(reading, args.device != "cpu")
    if bad:
        raise AssertionError("adasum_probe: " + "; ".join(bad))
    print(f"adasum_probe: {args.np} ranks ({reading['cross_size']} hosts of "
          f"{reading['local_size']}) on {args.device or 'cuda'}, "
          f"ResNet-{args.depth}, arms {list(reading['adasum_probe'])}: "
          f"parameters bitwise equal on every rank after every step; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
