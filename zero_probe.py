#!/usr/bin/env python3
"""Training steps of the transformer LM on several ranks under three
update paths: the plain wrapper, ZeRO-1 with whole-leaf owners, and the
ZeRO-1 engine (root script, not part of the package).

    python3 zero_probe.py [-np 4] [--device cpu] [--steps 5]

One ``hvdrun`` job of ``-np`` workers (one GPU a worker; ``--device cpu``
runs them over gloo). Every worker builds the LM from seed 0 (on the card
the full width of ``benchmarks/bench_transformer.py``: vocab 32768,
d_model 2048, 16 heads, 12 layers, d_ff 8192, 1024 tokens, batch 8 a rank,
bf16 compute over fp32 weights; on the CPU a 2-layer LM of width 32, with
a replicate threshold of 1000 elements so that most of its leaves shard)
and trains ``--steps`` steps of SGD(lr=1e-3, momentum=0.9) on a batch of
its own (seed 100 + rank) in three arms, one after the other, each
dropped before the next:

- ``plain``: ``DistributedOptimizer``, every gradient allreduced by the
  runtime, every rank stepping every leaf;
- ``whole_leaf``: ``DistributedOptimizer(sharded_update=True)``, the same
  allreduce, each leaf stepped by its owner and broadcast from it;
- ``engine``: the bare model and ``ShardedUpdateEngine`` over the same
  SGD: each dtype group packed by K1, one reduce-scatter, the step on the
  shard, one allgather, K1's unpack; the 25 norm scales through the
  runtime.

After every step each rank compares its parameters, bit for bit, with
rank 0's (broadcast outside the timed step); a difference fails the job.
Rank 0 prints per arm the losses, the median step ms after the first
(host clock around ``loss.item()``), tokens/s a GPU, peak memory
(``max_memory_allocated`` over the arm's steps) and the optimizer state's
bytes, its own and every rank's, the wire bytes a step and rank by phase (ring
accounting: the allreduce 2(n-1)/n of the gradients' bytes; the engine's
``hvd_sharded_update_wire_bytes_total`` by phase; the owners' broadcast),
the plan cache's hit rate after the first step, and a checksum of the
parameters after each step (the int64 sum of their fp32 bit patterns).
Then one JSON line with the key names of ``benchmarks/sharded_update.py``
(``update_wire_bytes_replicated``, ``update_wire_bytes_sharded``,
``update_wire_reduction_x``, ``param_allgather_wire_bytes``,
``plan_hit_rate``, ``state_bytes_replicated``,
``state_bytes_sharded_per_rank``, ``state_ratio``).

The parent checks that every arm's losses are finite, that every arm's
first loss equals the plain arm's (the same weights and batch), and that
the later losses stay within ``BAND`` of the plain arm's, relative; at
two ranks, where a sum of two is the same in any order, the whole-leaf
arm's losses and checksums must equal the plain arm's at every step (the
owner's step is the step every rank would take). At more ranks the
allreduce's order of summation follows each element's place in its fused
chunk, and the runtime forms chunks from what its cycle finds ready, so
two runs of one arm may differ in the last bit: there the checksums'
equality is reported, not required. The exit code is 0 only when the job
and the checks passed.
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
import time

ARMS = ("plain", "whole_leaf", "engine")
BAND = 1e-4
CPU_MIN_SHARD_ELEMS = 1000


def _config(cuda: bool):
    import torch

    from horovod_tpu_torch.models.transformer import TransformerConfig

    if cuda:
        return TransformerConfig(vocab_size=32768, d_model=2048, n_heads=16,
                                 n_layers=12, d_ff=8192, max_seq=1024,
                                 dtype=torch.bfloat16), 8
    return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_seq=16,
                             dtype=torch.float32), 2


def _same_as_rank0(params, group) -> bool:
    """This rank's parameters bitwise equal to rank 0's."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in params])
    ref = flat.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    same = torch.equal(flat.view(torch.int32), ref.view(torch.int32))
    del flat, ref
    return same


def _checksum(params) -> int:
    """The int64 sum of the parameters' fp32 bit patterns."""
    import torch

    return int(sum(p.detach().view(torch.int32).to(torch.int64).sum()
                   for p in params))


def _counters() -> dict:
    from horovod_tpu_torch.utils import metrics

    reg = metrics.get_registry()
    out = {ph: reg.counter_value("hvd_sharded_update_wire_bytes_total",
                                 phase=ph)
           for ph in ("reduce_scatter", "allgather", "allreduce",
                      "broadcast")}
    for kind in ("fused", "sharded"):
        out[f"{kind} hits"] = reg.counter_value(f"hvd_{kind}_plan_hits_total")
        out[f"{kind} misses"] = reg.counter_value(
            f"hvd_{kind}_plan_misses_total")
    return out


def run_arm(arm: str, cfg, batch: int, steps: int, mse: int,
            tokens) -> dict:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.opt.sharded import (ShardedUpdateEngine,
                                               optimizer_state_bytes)
    from horovod_tpu_torch.parallel import ring_attention

    device, n = hvd.device(), hvd.size()
    cuda = device.type == "cuda"
    model = TransformerLM(cfg, device=device, seed=0)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    group = hvd.global_process_set().group

    def sgd(ps):
        return torch.optim.SGD(ps, lr=1e-3, momentum=0.9)

    engine = opt = None
    if arm == "engine":
        engine = ShardedUpdateEngine(sgd, process_set=hvd.global_process_set(),
                                     min_shard_elems=mse)
        engine.init(params)
    else:
        opt = hvd.DistributedOptimizer(
            sgd(params), named_parameters=model.named_parameters(),
            sharded_update=arm == "whole_leaf", min_shard_elems=mse)

    def step():
        if engine is not None:
            for p in params:
                p.grad = None
            loss = lm_loss(model, tokens, attn_fn=ring_attention)
            loss.backward()
            engine.step(params)
        else:
            opt.zero_grad()
            loss = lm_loss(model, tokens, attn_fn=ring_attention)
            loss.backward()
            opt.step()
        return loss.item()  # waits for the step's device work

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_s, sums, per_step = [], [], [], []
    for i in range(steps):
        c0 = _counters()
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
        c1 = _counters()
        per_step.append({k: c1[k] - c0[k] for k in c0})
        if not _same_as_rank0(params, group):
            raise AssertionError(f"rank {hvd.rank()}: parameters differ "
                                 f"from rank 0's after step {i} ({arm})")
        sums.append(_checksum(params))
    peak = torch.cuda.max_memory_allocated() if cuda else None
    state = optimizer_state_bytes(engine.optimizer if engine is not None
                                  else opt)
    # every rank's, in rank order: owners hold different leaves
    by_rank = hvd.allgather_object((state, peak))
    grad_bytes = sum(p.numel() * p.element_size() for p in params)
    layout = engine.layout if engine is not None else None
    del model, params, opt, engine
    gc.collect()  # the hook optimizers sit in reference cycles
    if cuda:
        torch.cuda.empty_cache()
    scale = (n - 1) / n if n > 1 else 0.0
    last = per_step[-1]
    later = per_step[1:] or per_step
    kind = "sharded" if arm == "engine" else "fused"
    hits = sum(c[f"{kind} hits"] for c in later)
    lookups = hits + sum(c[f"{kind} misses"] for c in later)
    wire = {"allreduce": (last["allreduce"] if arm == "engine"
                          else int(2 * scale * grad_bytes))}
    if arm == "engine":
        wire.update(reduce_scatter=last["reduce_scatter"],
                    allgather=last["allgather"])
    if arm == "whole_leaf":
        wire["broadcast"] = last["broadcast"]
    steady = statistics.median(step_s[1:]) if steps > 1 else step_s[0]
    return {"losses": losses, "step_ms": [s * 1e3 for s in step_s],
            "median_step_ms": steady * 1e3,
            "tokens_per_s_per_gpu": batch * cfg.max_seq / steady,
            "peak_bytes": peak, "state_bytes": state,
            "state_bytes_by_rank": [b[0] for b in by_rank],
            "peak_bytes_by_rank": [b[1] for b in by_rank],
            "grad_bytes": grad_bytes, "wire_bytes_per_step": wire,
            "plan_hit_rate": hits / lookups if lookups else None,
            "checksums": sums,
            "shard_fraction": (layout.shard_fraction if layout is not None
                               else None),
            "layout_digest": layout.digest[:12] if layout is not None
            else None}


def summary(arms: dict, n: int) -> dict:
    """The arms' comparison under ``benchmarks/sharded_update.py``'s key
    names (per rank and step)."""
    plain, eng = arms.get("plain"), arms.get("engine")
    out = {"world": n}
    if plain is None or eng is None:
        return out
    rep = plain["wire_bytes_per_step"]["allreduce"]
    w = eng["wire_bytes_per_step"]
    sharded = w["reduce_scatter"] + w["allreduce"]
    out.update(
        update_wire_bytes_replicated=rep,
        update_wire_bytes_sharded=sharded,
        update_wire_reduction_x=rep / sharded if sharded else None,
        param_allgather_wire_bytes=w["allgather"],
        plan_hit_rate=eng["plan_hit_rate"],
        shard_fraction=eng["shard_fraction"],
        state_bytes_replicated=plain["state_bytes"],
        state_bytes_sharded_per_rank=eng["state_bytes"],
        state_ratio=eng["state_bytes"] / plain["state_bytes"])
    if "whole_leaf" in arms:
        out["state_bytes_whole_leaf_per_rank"] = \
            arms["whole_leaf"]["state_bytes"]
    return out


def worker(device_arg, steps: int, arms) -> int:
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=device_arg)
    device, n, r = hvd.device(), hvd.size(), hvd.rank()
    cuda = device.type == "cuda"
    cfg, batch = _config(cuda)
    mse = None if cuda else CPU_MIN_SHARD_ELEMS
    g = torch.Generator(device=device).manual_seed(100 + r)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           generator=g, device=device)
    readings = {}
    for arm in arms:
        rd = readings[arm] = run_arm(arm, cfg, batch, steps, mse, tokens)
        if r == 0:
            peak = (f"{rd['peak_bytes'] / 2**30:.2f} GiB"
                    if rd["peak_bytes"] else "not measured")
            hit = rd["plan_hit_rate"]
            print(f"  {arm}: losses {rd['losses']}", flush=True)
            print(f"  {arm}: step ms "
                  f"{[round(s, 1) for s in rd['step_ms']]}, median after "
                  f"the first {rd['median_step_ms']:.1f} ms, "
                  f"{rd['tokens_per_s_per_gpu']:.0f} tokens/s a GPU; peak "
                  f"{peak}; optimizer state {rd['state_bytes'] / 1e9:.4f} "
                  f"GB a rank (by rank {rd['state_bytes_by_rank']}, peak by "
                  f"rank {rd['peak_bytes_by_rank']}); wire bytes a step and "
                  "rank "
                  f"{rd['wire_bytes_per_step']}; plan hit rate "
                  + (f"{hit:.4f}" if hit is not None else "none"),
                  flush=True)
    if r == 0:
        print(json.dumps({"zero_probe": readings, "ranks": n,
                          "device": str(device),
                          "summary": summary(readings, n)}), flush=True)
    hvd.shutdown()
    print(f"ZERO_PROBE_OK {r}", flush=True)
    return 0


def check(readings: dict, n: int):
    """Finite losses; every arm's first loss the plain arm's and the later
    ones within ``BAND``; at two ranks the whole-leaf arm bitwise the
    plain arm (losses and checksums)."""
    plain = readings.get("plain")
    for arm, rd in readings.items():
        if not all(math.isfinite(x) for x in rd["losses"]):
            raise AssertionError(f"{arm}: losses {rd['losses']}")
    if plain is None:
        return
    for arm in ("whole_leaf", "engine"):
        rd = readings.get(arm)
        if rd is None:
            continue
        gaps = [abs(a - b) / abs(b)
                for a, b in zip(rd["losses"], plain["losses"])]
        same = rd["checksums"] == plain["checksums"]
        print(f"  {arm}: loss gaps to the plain arm, relative "
              f"{[f'{x:.3g}' for x in gaps]} (band {BAND}); checksums "
              + ("equal" if same else "differ"), flush=True)
        if gaps[0] != 0.0 or max(gaps) > BAND:
            raise AssertionError(f"{arm}: losses {rd['losses']} leave the "
                                 f"band around {plain['losses']}")
        if arm == "whole_leaf" and n <= 2 and not (
                same and rd["losses"] == plain["losses"]):
            raise AssertionError("whole_leaf: not bitwise the plain arm at "
                                 f"{n} ranks")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    arms = args.arms.split(",")
    if set(arms) - set(ARMS):
        raise SystemExit(f"--arms takes {ARMS}")
    if args.worker:
        sys.path.insert(0, root)
        return worker(args.device, args.steps, arms)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np), sys.executable, os.path.abspath(__file__),
           "--worker", "--steps", str(args.steps), "--arms", args.arms] + (
               ["--device", args.device] if args.device else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("HOROVOD_SHARDED_UPDATE", "HOROVOD_SHARDED_MIN_ELEMS",
              "HOROVOD_COMPRESSION"):
        env.pop(k, None)
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
        raise AssertionError("zero_probe: the job timed out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"ZERO_PROBE_OK {k}" in out
                                    for k in range(args.np)):
        raise AssertionError("zero_probe: the job failed")
    reading = None
    for line in out.splitlines():
        at = line.find('{"zero_probe"')  # after the launcher's prefix
        if at >= 0:
            reading = json.loads(line[at:])
    if reading is None:
        raise AssertionError("zero_probe: the job printed no reading")
    check(reading["zero_probe"], args.np)
    print(json.dumps(reading), flush=True)
    print(f"zero_probe: {args.np} ranks on {args.device or 'cuda'}, "
          f"{len(arms)} arms, parameters equal on every rank after every "
          f"step; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
