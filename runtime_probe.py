#!/usr/bin/env python3
"""Where the background runtime's cost lands on the slice's step, on one
GPU (root script, not part of the package).

    python3 runtime_probe.py [--rounds 2] [--steps 6] [--configs a,b,...]

Trains the full-width transformer LM of ``chip_smoke.py`` for a few steps
under each configuration below, in turns (A B C ... A B C ...), each on a
fresh model and a fresh ``hvd.init()``, and prints per configuration the
median step and where the host's time went in it: the forward's enqueue,
``loss.backward()`` (the autograd engine's thread enqueues the backward
and fires the gradient hooks), ``opt.step()`` (``synchronize`` waits for
the cycle thread to dispatch every chunk, then the optimizer's launches)
and ``loss.item()`` (the device's remaining work), and the runtime's chunks a step. One more
step of each is traced with ``torch.profiler`` (``chip_smoke.profile_step``), whose idle
share (wall time in which no kernel ran on any stream) says whether the
cycle thread holds the traced step back.

- ``noinit``: the same loop with the bare optimizer, without
  ``hvd.init()``: no hooks, no cycle thread;
- ``bare``: the bare optimizer after ``hvd.init()``: the runtime is up,
  but nothing is enqueued, so its cycle thread sleeps;
- ``runtime``: ``DistributedOptimizer`` through the runtime, as shipped;
- ``cycle20``: the same with ``HOROVOD_CYCLE_TIME=20`` (a cycle starts
  every 20 ms instead of every 1 ms, so more gradients share a cycle);
- ``unfused``: the same with ``HOROVOD_FUSION_THRESHOLD=0`` (every tensor
  its own chunk).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

CONFIGS = {"noinit": None, "bare": {}, "runtime": {},
           "cycle20": {"HOROVOD_CYCLE_TIME": "20"},
           "unfused": {"HOROVOD_FUSION_THRESHOLD": "0"}}
UNITLESS = ("cycles", "chunks", "traced idle share")  # every other result is seconds


def run(name: str, env: dict | None, steps: int) -> dict:
    """``env`` None: no ``hvd.init()``; else the variables set for it."""
    import torch

    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import ring_attention

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        if env is not None:
            hvd.init()
        cfg = cs.full_width_config(12)
        device = torch.device("cuda", 0)
        model = TransformerLM(cfg, device=device, seed=0)
        tokens = cs.tokens_for(cfg, 8, 0, device)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
        if name not in ("noinit", "bare"):
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=model.named_parameters())

        def counts():
            if env is None:
                return 0, 0
            rt = context.runtime()
            return rt.cycles, rt.chunks

        def step():
            opt.zero_grad()
            loss = lm_loss(model, tokens, attn_fn=ring_attention)
            t1 = time.perf_counter()
            loss.backward()
            t2 = time.perf_counter()
            opt.step()
            t3 = time.perf_counter()
            loss.item()
            return t1, t2, t3

        parts = []
        for _ in range(steps):
            torch.cuda.synchronize()
            c0 = counts()
            t0 = time.perf_counter()
            t1, t2, t3 = step()
            t4 = time.perf_counter()
            c1 = counts()
            parts.append({"step": t4 - t0, "forward": t1 - t0,
                          "backward": t2 - t1, "opt.step": t3 - t2,
                          "item": t4 - t3, "cycles": c1[0] - c0[0],
                          "chunks": c1[1] - c0[1]})
        # one more step under torch.profiler: the share of its wall time in
        # which no kernel ran on any stream
        prof = cs.profile_step(step)
        idle = max(0.0, 1.0 - prof["union_ms"] / prof["wall_ms"])
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
        hvd.shutdown()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    steady = parts[1:]  # the first step warms up
    res = {k: statistics.median(p[k] for p in steady) for k in steady[0]}
    res.update({"traced wall": prof["wall_ms"] / 1e3,
                "traced busy": prof["union_ms"] / 1e3,
                "traced idle share": idle})
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated subset of " + ", ".join(CONFIGS))
    args = ap.parse_args()
    configs = {name: CONFIGS[name] for name in args.configs.split(",")}
    if not torch.cuda.is_available():
        print("runtime_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    results = {name: [] for name in configs}
    for r in range(args.rounds):
        for name, env in configs.items():
            res = run(name, env, args.steps)
            results[name].append(res)
            print(f"round {r} {name}: " + ", ".join(
                f"{k} {v * 1e3:.1f} ms" if k not in UNITLESS
                else f"{k} {v:.4g}" for k, v in res.items()), flush=True)
    print(json.dumps({name: [{k: v if k in UNITLESS else round(v * 1e3, 2)
                              for k, v in res.items()} for res in rs]
                      for name, rs in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
