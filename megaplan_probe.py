#!/usr/bin/env python3
"""The runtime's control plane across ranks: the megaplan and the
hierarchical rounds on ResNet-50's gradients (root script, not part of the
package).

    python3 megaplan_probe.py [-np 4] [--device cpu] [--depth 50]
        [--batch 64] [--image 224] [--steps 8] [--loop-steps 20]
        [--arms v1,v1_megaplan,hier,hier_megaplan] [--timeout S]
    hvdrun -np N python megaplan_probe.py [same options]

Run by itself, the script starts one ``hvdrun`` job of ``-np`` workers (one
GPU each; ``--device cpu`` runs them over gloo) and checks what they
report. Each worker runs two loops in each arm, each loop after a fresh
``hvd.init`` (``HOROVOD_ELASTIC_GEN`` bumped, so each init's rounds have a
prefix of their own in the launcher's store):

- ``resnet``: ResNet at ``--depth`` (``resnet_probe.build``, bf16 compute
  over fp32 weights on the card), one synthetic batch of ``--batch``
  images a rank at ``--image``², ``--steps`` steps of ``loss.backward()``,
  ``hvd.grouped_allreduce_`` of every gradient under one name
  (``resnet.grads``), then ``SGD(0.05, momentum=0.9).step()``;
- ``allreduce``: ``--loop-steps`` iterations of only the grouped allreduce
  of tensors shaped like the model's gradients (``loop``), each iteration
  refilled from the same seeded values.

The arms: ``v1`` (neither knob), ``v1_megaplan`` (``HOROVOD_MEGAPLAN=1``,
``HOROVOD_MEGAPLAN_STABLE_ROUNDS=3``), ``hier``
(``HOROVOD_HIER_NEGOTIATION=1``, ``HOROVOD_HIER_GROUP_SIZE=2``),
``hier_megaplan`` (both) and ``v1_megaplan_cycle50`` (the megaplan at
``HOROVOD_CYCLE_TIME=50``, where a back-to-back loop's rounds can all be
working ones). The cycle is the runtime's own thread, at the default 1 ms
but in the last arm. Each loop runs the arms in turns, in the order given
and then reversed, so every (arm, loop) runs twice (``#1``, ``#2``).
``torch.backends.cudnn.deterministic`` is set, so two runs may be compared
bit for bit.

Rank 0 prints for each run: the step ms (host clock, the device
synchronized at each step's end) and their median after the first step;
over the steps after the first (the first holds the communicators' and
cuDNN's warm-up): negotiation rounds, marker rounds and lease grants
(responses carrying ``"mp"``) a step, the controller's bytes sent and
received a round, and the host ms a round that the cycle thread spent in
the KV store's ``put``, in ``put_get`` (a member's submit and wait, a
leader's aggregate), in ``get_prefix`` (a leader's merge) and in the
response poll, timed by wrapping the calls in this script, on the cycle
thread only (the coordinator on rank 0 shares the client); the
megaplan's captures and replays, and ``wire_format`` on every rank. Then
one JSON line.

The job fails unless every rank's parameters (``resnet``) or reduced
tensors (``allreduce``) are bitwise rank 0's after every step, every v1
megaplan run is bitwise equal to the first ``v1`` run of its loop (losses
and final parameters or tensors), ``wire_format`` is ``v2`` on every rank
in the hierarchical arms, and no lease is granted under v2.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

MP = {"HOROVOD_MEGAPLAN": "1", "HOROVOD_MEGAPLAN_STABLE_ROUNDS": "3"}
HIER = {"HOROVOD_HIER_NEGOTIATION": "1", "HOROVOD_HIER_GROUP_SIZE": "2"}
ARMS = {"v1": {}, "v1_megaplan": MP, "hier": HIER,
        "hier_megaplan": dict(HIER, **MP),
        "v1_megaplan_cycle50": dict(MP, HOROVOD_CYCLE_TIME="50")}
LOOPS = ("resnet", "allreduce")
KNOBS = tuple(sorted(set().union(*ARMS.values())))


class RoundTimer:
    """Host seconds the cycle thread spends in the controller's KV calls,
    and the lease grants its responses carry; installed by wrapping the
    controller's client and methods on the instance."""

    CALLS = ("put", "put_get", "get_prefix")

    def __init__(self, ctl):
        self.ctl = ctl
        self.seconds = {k: 0.0 for k in self.CALLS + ("poll",)}
        self.grants = 0
        self._wrap(ctl.client, self.CALLS)
        self._wrap(ctl, ("_poll_response",), key="poll")
        finish = ctl._finish_round

        def finish_round(resp):
            self.grants += bool(resp.get("mp"))
            return finish(resp)

        ctl._finish_round = finish_round

    def _wrap(self, obj, names, key=None):
        for name in names:
            fn = getattr(obj, name)

            def timed(*a, _fn=fn, _key=key or name, **kw):
                if threading.current_thread().name != "hvd-cycle":
                    return _fn(*a, **kw)
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_key] += time.perf_counter() - t0

            setattr(obj, name, timed)

    def snapshot(self) -> dict:
        c = self.ctl
        return dict(self.seconds, grants=self.grants, rounds=c.round,
                    markers=c.fast_rounds, sent=c.bytes_sent,
                    received=getattr(c, "bytes_received", 0))


def _init(gen: int, knobs: dict, device):
    import horovod_tpu_torch as hvd

    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(knobs)
    os.environ["HOROVOD_ELASTIC_GEN"] = str(gen)
    hvd.init(device=device)


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _same_as_rank0(flat, group) -> bool:
    import torch
    import torch.distributed as dist

    ref = flat.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    return torch.equal(flat.view(torch.int32), ref.view(torch.int32))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resnet_loop(args, device, mark, images, labels):
    """``--steps`` grouped steps, ``mark()`` after the first; returns
    (losses, step seconds, the final parameters flat)."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp

    model = rp.build(args.depth, device, args.seed)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.SGD(params, lr=rp.LR, momentum=rp.MOMENTUM)
    group = hvd.global_process_set().group
    losses, step_s = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        hvd.grouped_allreduce_([p.grad for p in params],
                               name="resnet.grads")
        opt.step()
        losses.append(loss.item())  # waits for the step's device work
        step_s.append(time.perf_counter() - t0)
        if not _same_as_rank0(_flat(params), group):
            raise AssertionError(f"rank {hvd.rank()}: resnet parameters "
                                 f"differ from rank 0's after step {i}")
        if i == 0:
            mark()
    flat = _flat(params)
    del model, params, opt
    return losses, step_s, flat


def grad_shapes(depth: str) -> list:
    from horovod_tpu_torch.models.resnet import ResNet

    import resnet_probe as rp

    stages, filters, classes = rp.CONFIGS[depth]
    model = ResNet(stages, num_classes=classes, num_filters=filters,
                   device="meta")
    return [tuple(p.shape) for p in reversed(list(model.parameters()))]


def allreduce_loop(args, device, mark):
    """``--loop-steps`` grouped allreduces of the gradient-shaped tensors,
    ``mark()`` after the first; returns ([], step seconds, the last
    outputs flat)."""
    import torch

    import horovod_tpu_torch as hvd

    g = torch.Generator().manual_seed(args.seed + 1000 * hvd.rank())
    srcs = [torch.randn(s, generator=g).to(device)
            for s in grad_shapes(args.depth)]
    work = [torch.empty_like(s) for s in srcs]
    group = hvd.global_process_set().group
    step_s = []
    for i in range(args.loop_steps):
        for w, s in zip(work, srcs):
            w.copy_(s)
        _sync(device)
        t0 = time.perf_counter()
        hvd.grouped_allreduce_(work, name="loop")
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        if not _same_as_rank0(_flat(work), group):
            raise AssertionError(f"rank {hvd.rank()}: reduced tensors "
                                 f"differ from rank 0's after step {i}")
        if i == 0:
            mark()
    return [], step_s, _flat(work)


def run_arm(args, gen, arm, loop, device_arg, batch):
    """One (arm, loop) after a fresh init; returns its reading on every
    rank and this rank's final flat tensor."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context

    _init(gen, ARMS[arm], device_arg)
    device = hvd.device()
    ctl = context.runtime().controller
    timer = RoundTimer(ctl) if ctl is not None else None
    marks = []

    def mark():
        marks.append(timer.snapshot() if timer else None)

    if loop == "resnet":
        losses, step_s, flat = resnet_loop(args, device, mark, *batch)
    else:
        losses, step_s, flat = allreduce_loop(args, device, mark)
    steps = len(step_s) - 1  # the counters run from the first step's end
    rd = {"losses": losses,
          "step_ms": [round(s * 1e3, 3) for s in step_s],
          "median_after_first_ms": statistics.median(
              step_s[1:] or step_s) * 1e3,
          "megaplan": hvd.megaplan_report()}
    if timer:
        s0, s1 = marks[0], timer.snapshot()
        d = {k: s1[k] - s0[k] for k in s1}
        rounds = max(1, d["rounds"])
        rd.update({
            "rounds_a_step": d["rounds"] / steps,
            "markers_a_step": d["markers"] / steps,
            "grants": d["grants"],
            "sent_bytes_a_round": d["sent"] / rounds,
            "received_bytes_a_round": d["received"] / rounds,
            "host_ms_a_round": {k: d[k] * 1e3 / rounds
                                for k in RoundTimer.CALLS + ("poll",)},
            "wire_format": ctl.wire_format})
        rd["by_rank"] = hvd.allgather_object(
            {"wire_format": ctl.wire_format, "grants": d["grants"],
             "captures": rd["megaplan"].get("captures", 0)})
    flat = flat.clone()
    hvd.shutdown()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rd, flat


def worker(args) -> int:
    import torch

    import horovod_tpu_torch as hvd
    import resnet_probe as rp

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank, n = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
    device = (torch.device("cpu") if args.device == "cpu"
              else torch.device("cuda", int(os.environ.get(
                  "HOROVOD_LOCAL_RANK", rank))))
    batch = rp.synthetic_batch(args.seed, n, args.batch, args.image,
                               rp.CONFIGS[args.depth][2], rank, device)
    arms = args.arms.split(",")
    readings, finals = {}, {}
    gen = 0
    for loop in LOOPS:
        # in turns: the arms in order, then reversed
        for run, arm in [(1, a) for a in arms] + [(2, a) for a in arms[::-1]]:
            rd, flat = run_arm(args, gen, arm, loop, args.device, batch)
            gen += 1
            readings[f"{arm}/{loop}#{run}"] = rd
            finals[f"{arm}/{loop}#{run}"] = (rd["losses"], flat)
    same = {}
    for loop in LOOPS:
        ref = finals.get(f"v1/{loop}#1")
        for key, (losses, flat) in finals.items():
            if ref is None or not key.startswith(tuple(
                    f"{a}/{loop}#" for a in arms)) or key == f"v1/{loop}#1":
                continue
            same[key] = (losses == ref[0] and torch.equal(
                flat.view(torch.int32), ref[1].view(torch.int32)))
    if rank == 0:
        for key, rd in readings.items():
            print(f"  {key}: step ms {rd['step_ms']}; median after the "
                  f"first {rd['median_after_first_ms']:.3f} ms", flush=True)
            mp = rd["megaplan"]
            if mp.get("enabled"):
                print(f"  {key}: megaplan captures {mp['captures']}, "
                      f"replays {mp['replays']}, misses {mp['misses']}, "
                      f"hit rate {mp['replay_hit_rate']}", flush=True)
            if "rounds_a_step" in rd:
                print(f"  {key}: rounds a step {rd['rounds_a_step']:.2f}, "
                      f"markers a step {rd['markers_a_step']:.2f}, lease "
                      f"grants {rd['grants']}; bytes a round sent "
                      f"{rd['sent_bytes_a_round']:.1f}, received "
                      f"{rd['received_bytes_a_round']:.1f}; host ms a "
                      f"round " + ", ".join(
                          f"{k} {v:.4f}"
                          for k, v in rd["host_ms_a_round"].items())
                      + f"; wire by rank "
                      f"{[b['wire_format'] for b in rd['by_rank']]}",
                      flush=True)
        print(f"  bitwise equal to v1: {same}", flush=True)
        print(json.dumps({"megaplan_probe": readings, "same_as_v1": same,
                          "ranks": n, "depth": args.depth,
                          "batch": args.batch, "image": args.image,
                          "device": str(device),
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu")}),
              flush=True)
    failures = [k for k, v in same.items()
                if k.startswith(("v1/", "v1_megaplan")) and not v]
    for key, rd in readings.items():
        if key.startswith("hier") and "by_rank" in rd:
            if any(b["wire_format"] != "v2" for b in rd["by_rank"]):
                failures.append(f"{key}: not v2 on every rank")
            if any(b["grants"] for b in rd["by_rank"]):
                failures.append(f"{key}: a lease granted under v2")
    if failures:
        raise AssertionError(f"rank {rank}: {failures}")
    print(f"MEGAPLAN_PROBE_OK {rank}", flush=True)
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
    ap.add_argument("--loop-steps", type=int, default=20)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    if set(args.arms.split(",")) - set(ARMS):
        raise SystemExit(f"--arms takes {tuple(ARMS)}")
    root = os.path.dirname(os.path.abspath(__file__))
    if "HOROVOD_RANK" in os.environ:
        sys.path.insert(0, root)
        return worker(args)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np), sys.executable, os.path.abspath(__file__)] \
        + sys.argv[1:]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
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
        raise AssertionError("megaplan_probe: the job timed out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"MEGAPLAN_PROBE_OK {k}" in out
                                    for k in range(args.np)):
        raise AssertionError("megaplan_probe: the job failed")
    print(f"megaplan_probe: {args.np} ranks on {args.device or 'cuda'}, "
          f"ResNet-{args.depth} gradients, parameters equal on every rank, "
          f"v1 and v1_megaplan bitwise equal; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
