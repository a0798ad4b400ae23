#!/usr/bin/env python3
"""Training steps of the transformer LM on several ranks with the gradient
wire off and compressed (root script, not part of the package).

    python3 wire_probe.py [-np 4] [--device cpu] [--steps 5]
                          [--modes off,bf16,int8,int4]

For each wire mode it starts ``-np`` workers through the port's
``hvdrun`` with ``HOROVOD_COMPRESSION`` set (one job a mode, one GPU a
worker; ``--device cpu`` runs them over gloo). Every worker builds the LM
from seed 0 (on the card the full width of
``benchmarks/bench_transformer.py``: vocab 32768, d_model 2048, 16 heads,
12 layers, d_ff 8192, 1024 tokens, batch 8 a rank, bf16 compute over fp32
weights; on the CPU a 2-layer LM of width 32, with
``HOROVOD_QUANT_MIN_ELEMS=100`` so that its tensors go on the wire), and
trains ``--steps`` timed steps of ``DistributedOptimizer(SGD(lr=1e-3,
momentum=0.9))`` on a batch of its own (seed 100 + rank), then one checked
step. After every step each rank compares its parameters, bit for bit,
with rank 0's (broadcast outside the timed step); a difference fails the
job.

The checked step holds the reduction itself, which the ranks' agreement
cannot: a fault that every rank computes alike (a rank's row dropped, a
wrong factor) leaves them equal. Each rank keeps its gradients as the
backward made them (a hook registered before the optimizer's) and its
error-feedback residuals before and after the step. What a rank puts on
the wire dequantizes to y = (g + old residual) - new residual (y = g
without a residual), so the reduced gradient must equal the exact average
of every rank's y, taken here by an uncompressed ``all_reduce``, to within
fp32 rounding: 2^-18 of the average of |g| + |old| + |new| a rank
(element by element); on the bf16 wire, whose cast keeps no residual,
2^-8 more (bf16 rounds to 8 significant bits). And every new residual must be at most half a step of its
block: max |new| <= (1 + 2^-7) max |g + old| / (2 qmax) over the wire's
tensors.

Rank 0 prints per mode the losses, the median step ms over the timed
steps after the first (host clock around ``loss.item()``), tokens/s per
GPU, the wire bytes a step (``hvd_quant_wire_bytes_total``, one rank's
row of every compressed chunk), the runtime's chunks and collective calls
a step, the K1 and K2/K3 launches a step, the tensors that found an
error-feedback residual and those that did not, peak memory
(``max_memory_allocated``, before the checked step), the residuals held at
the end (entries, one a tensor, and bytes) and the checked step's largest
error over its bound, then one JSON line. The parent then checks that
every mode's losses are finite and falling, that every mode's first loss
equals the uncompressed run's bit for bit (the same weights and batch:
the wire changes only the updates), and that the compressed runs' later
losses stay within ``BAND`` of the uncompressed run's, relative. The band
is 1e-4 for every wire: a few times the largest gaps read on four H100s
(under 1.8e-5 for bf16, int8 and int4 over 5 steps; PERF.md), and half
of what a dropped rank's row would make (3/4 of each update: about
1.9e-4 at the fifth loss of a run that falls by 7.7e-4).
The exit code is 0 only when every job and check passed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

BAND = {"off": 0.0, "bf16": 1e-4, "int8": 1e-4, "int4": 1e-4}


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


def _counts(rt) -> dict:
    from horovod_tpu_torch.ops import fused_pack as fp
    from horovod_tpu_torch.ops import quant_wire as qw
    from horovod_tpu_torch.utils import metrics

    store = rt._quant_residuals
    return {"chunks": rt.chunks, "collective calls": rt.collective_calls,
            "K1 launches": sum(fp.kernel_launches.values()),
            "K2/K3 launches": sum(qw.kernel_launches.values()),
            "wire bytes": int(metrics.get_registry().counter_value(
                "hvd_quant_wire_bytes_total")),
            "residual hits": store.hits if store is not None else 0,
            "residual misses": store.misses if store is not None else 0}


def _check_reduction(opt, rt, local: dict, old: dict, group) -> float:
    """The checked step's reduced gradients against the exact average of
    what the ranks sent (module docstring); returns the largest error
    over its bound, and raises past 1."""
    import torch
    import torch.distributed as dist

    spec, store = rt._quant, rt._quant_residuals
    sig = spec.signature() if spec is not None else None
    ys, mags, got, xs, news = [], [], [], [], []
    for p, name in opt._names.items():
        g = local[p].reshape(-1).float()
        new = (store.residual(name, sig)
               if store is not None and sig is not None else None)
        y, mag = g, g.abs()
        if new is not None:
            x = g + old[name] if name in old else g
            y = x - new
            mag = mag + new.abs() + (old[name].abs() if name in old else 0)
            xs.append(x.abs().max())
            news.append(new.abs().max())
        ys.append(y)
        mags.append(mag)
        got.append(p.grad.reshape(-1).float())
    y, mag, got = torch.cat(ys), torch.cat(mags), torch.cat(got)
    del ys, mags
    n = dist.get_world_size(group)
    dist.all_reduce(y, group=group)
    dist.all_reduce(mag, group=group)
    inv = torch.tensor(1.0 / n, dtype=torch.float32)
    ref = y * inv.to(y.device)
    rel = 2.0 ** -18 + (2.0 ** -8 if spec is not None and spec.bits == 16
                        else 0.0)
    bound = mag * inv.to(mag.device) * rel + torch.finfo(torch.float32).tiny
    worst = float(((got - ref).abs() / bound).max())
    if worst > 1.0:
        raise AssertionError(f"the reduced gradients leave their bound "
                             f"around the exact average by {worst:.3g} "
                             "times")
    if news:
        step = float(torch.stack(xs).max()) * (1 + 2.0 ** -7) / (
            2 * spec.qmax)
        if float(torch.stack(news).max()) > step:
            raise AssertionError(f"a residual of {float(max(news)):.3g} "
                                 f"past half a quantization step {step:.3g}")
    return worst


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


def worker(device_arg: str, steps: int, mode: str) -> int:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import ring_attention

    hvd.init(device=device_arg)
    device, n, r = hvd.device(), hvd.size(), hvd.rank()
    cuda = device.type == "cuda"
    cfg, batch = _config(cuda)
    model = TransformerLM(cfg, device=device, seed=0)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # the checked step keeps each gradient as the backward made it: this
    # hook runs before the optimizer's, which reduces the gradient in place
    local, capture = {}, [False]

    def keep(p):
        if capture[0]:
            local[p] = p.grad.detach().clone()

    for p in params:
        p.register_post_accumulate_grad_hook(keep)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=1e-3, momentum=0.9),
        named_parameters=model.named_parameters())
    g = torch.Generator(device=device).manual_seed(100 + r)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           generator=g, device=device)
    rt = context.runtime()
    group = hvd.global_process_set().group
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_s, per_step = [], [], []
    old, peak, worst = {}, None, None
    for i in range(steps + 1):
        checked = i == steps
        if checked:
            peak = torch.cuda.max_memory_allocated() if cuda else None
            store, spec = rt._quant_residuals, rt._quant
            if store is not None and spec is not None:
                for name in opt._names.values():
                    res = store.residual(name, spec.signature())
                    if res is not None:
                        old[name] = res.clone()
            capture[0] = True
        c0 = _counts(rt)
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lm_loss(model, tokens, attn_fn=ring_attention)
        loss.backward()
        opt.step()
        losses.append(loss.item())  # waits for the step's device work
        if not checked:
            step_s.append(time.perf_counter() - t0)
            c1 = _counts(rt)
            per_step.append({k: c1[k] - c0[k] for k in c0})
        if not _same_as_rank0(params, group):
            raise AssertionError(f"rank {r}: parameters differ from rank "
                                 f"0's after step {i} ({mode})")
    worst = _check_reduction(opt, rt, local, old, group)
    local.clear()
    old.clear()
    store = rt._quant_residuals
    residuals = ({"entries": len(store), "bytes": store.nbytes()}
                 if store is not None else None)
    if r == 0:
        steady = statistics.median(step_s[1:]) if steps > 1 else step_s[0]
        tok = batch * cfg.max_seq
        print(f"  {mode}: losses {losses}", flush=True)
        print(f"  {mode}: step ms {[round(s * 1e3, 1) for s in step_s]}, "
              f"median after the first {steady * 1e3:.1f} ms, "
              f"{tok / steady:.0f} tokens/s a rank; peak "
              + (f"{peak / 2**30:.2f} GiB" if peak else "not measured")
              + f"; per step {per_step[-1]}; error-feedback residuals "
              f"{residuals}; checked step: largest error {worst:.3g} of "
              "its bound", flush=True)
        print(json.dumps({"wire_probe": mode, "ranks": n,
                          "device": str(device), "losses": losses,
                          "step_ms": [s * 1e3 for s in step_s],
                          "median_step_ms": steady * 1e3,
                          "tokens_per_s_per_gpu": tok / steady,
                          "per_step": per_step, "peak_bytes": peak,
                          "residuals": residuals,
                          "checked_error_over_bound": worst}),
              flush=True)
    del model, opt, params
    hvd.shutdown()
    print(f"WIRE_PROBE_OK {r}", flush=True)
    return 0


def _job(args, root: str, mode: str):
    """One hvdrun job for ``mode``; returns rank 0's JSON reading."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np), sys.executable, os.path.abspath(__file__),
           "--worker", "--steps", str(args.steps), "--modes", mode] + (
               ["--device", args.device] if args.device else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("HOROVOD_COMPRESSION", None)
    if mode != "off":
        env["HOROVOD_COMPRESSION"] = mode
    if args.device == "cpu":
        env["HOROVOD_QUANT_MIN_ELEMS"] = "100"
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # a session of its own, so a timeout ends the launcher and its workers
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=args.timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        print(p.communicate()[0])
        raise AssertionError(f"wire_probe: the {mode} job timed out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"WIRE_PROBE_OK {k}" in out
                                    for k in range(args.np)):
        raise AssertionError(f"wire_probe: the {mode} job failed")
    for line in out.splitlines():
        at = line.find('{"wire_probe"')  # after the launcher's prefix
        if at >= 0:
            return json.loads(line[at:])
    raise AssertionError(f"wire_probe: the {mode} job printed no reading")


def check(readings: dict):
    """Finite and falling losses, the first loss of every mode bitwise the
    uncompressed one, the later ones within ``BAND``."""
    off = readings["off"]["losses"]
    for mode, rd in readings.items():
        ls = rd["losses"]
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"{mode}: losses {ls}")
        if ls[0] != off[0]:
            raise AssertionError(f"{mode}: first loss {ls[0]} against the "
                                 f"uncompressed {off[0]}")
        gap = max(abs(a - b) / abs(b) for a, b in zip(ls, off))
        print(f"  {mode}: largest relative gap to the uncompressed losses "
              f"{gap:.3g} (band {BAND[mode]})", flush=True)
        if gap > BAND[mode]:
            raise AssertionError(f"{mode}: losses {ls} leave the band "
                                 f"{BAND[mode]} around {off}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--modes", default="off,bf16,int8,int4")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    if args.worker:
        sys.path.insert(0, root)
        return worker(args.device, args.steps, args.modes)
    modes = args.modes.split(",")
    if modes[0] != "off":
        raise SystemExit("--modes starts with off, the run the others are "
                         "held against")
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    readings = {}
    for mode in modes:
        t0 = time.perf_counter()
        readings[mode] = _job(args, root, mode)
        print(f"  {mode} job: {time.perf_counter() - t0:.1f} s", flush=True)
    check(readings)
    print(json.dumps({"wire_probe": readings}), flush=True)
    print(f"wire_probe: {args.np} ranks on {args.device or 'cuda'}, "
          f"{len(modes)} wire modes, parameters equal on every rank after "
          "every step", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
