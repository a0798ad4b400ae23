#!/usr/bin/env python3
"""Training steps of the transformer LM with its sequence split over ranks:
ring, striped ring and Ulysses attention (root script, not part of the
package).

    python3 sp_probe.py [-np 4] [--device cpu] [--steps 5]
                        [--layouts ring,striped,ulysses]

It starts one ``-np 1`` job that trains the LM on the whole sequence (a
ring of one), then one ``-np`` job per layout through the port's
``hvdrun`` (one GPU a worker, one job after another; ``--device cpu``
runs them over gloo, all at once). Every
worker builds the LM from seed 0 and draws the same global tokens ``[1,
S + 1]`` from seed 0; on the card the long-context path at the full width
of ``benchmarks/bench_transformer.py`` (vocab 32768, d_model 2048, 16
heads of 128, 12 layers, d_ff 8192) at S = 8192, batch 1, bf16 compute
over fp32 weights, ``remat=True`` and ``xent_chunk=8192``; on the CPU a
2-layer LM of width 32 (4 heads) at S = 32 in fp32, ``remat=True`` and
``xent_chunk=16``. Each rank takes its shard of the inputs, targets and
positions: blocked (rank i holds ``[i*S/n, (i+1)*S/n)``) for the ring and
Ulysses, striped (rank i holds i, i+n, ...; ``stripe_tokens``) for the
striped ring. The attention runs over ``hvd.global_process_set().group``;
the loss is the chunked cross-entropy of the rank's shard (K5), and
``DistributedOptimizer(SGD(lr=1e-3, momentum=0.9))`` averages the
gradients through its hooks on the runtime's own communicator, while the
ring's and Ulysses' backward exchanges run on the caller's. Over equal
shards that average is the full sequence's gradient, and the mean of the
ranks' losses is the full sequence's loss.

After every step each rank compares its parameters, bit for bit, with rank
0's (broadcast outside the timed step); a difference fails the job. Rank 0
prints per layout the losses (the mean over ranks), the median step ms
over the steps after the first (host clock around the local
``loss.item()``), tokens/s per GPU (S over the step time over the ranks),
peak memory a rank (``max_memory_allocated`` over the steps, the
parameter check left out), each rank's host ms to enqueue a forward and
backward (median; where it nears the step, the host bounds it), the
exchanges a step
(``parallel._comm.exchanges``: neighbour exchanges and all-to-alls, forward,
remat's recompute and backward), the flash kernel's launches a step by
mask summed over the ranks (``mask_launches``: diagonal, full, strict),
K5's launches and the runtime's chunks a step, then one JSON line. On the
card every rank then takes one more step, which rank 0 and the last rank
trace with ``torch.profiler`` (``chip_smoke.profile_step``): wall ms, the
kernels' busy union, the idle share, device ms by kernel category, the
top kernels and the longest gaps. The
parent checks that every layout's losses are finite and falling and that
its first loss is within ``LOSS_TOL`` of the one-rank run's: on the card
1e-3 (a bf16 attention path changes the outputs in their last bits, and
at random weights the loss sits near ln V = 10.4: a tenth of a per mille
of it); on the CPU, in fp32, 1e-5 (summation order). The exit code is 0
only when every job and check passed.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

LOSS_TOL = {"cuda": 1e-3, "cpu": 1e-5}


def _config(cuda: bool):
    import torch

    from horovod_tpu_torch.models.transformer import TransformerConfig

    if cuda:
        return TransformerConfig(vocab_size=32768, d_model=2048, n_heads=16,
                                 n_layers=12, d_ff=8192, max_seq=8192,
                                 dtype=torch.bfloat16, remat=True,
                                 xent_chunk=8192)
    return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_seq=32,
                             dtype=torch.float32, remat=True, xent_chunk=16)


def shard(layout: str, n: int, r: int, inputs, targets, positions):
    """Rank r's shard of the global inputs, targets and positions."""
    from horovod_tpu_torch.parallel import stripe_tokens

    if layout == "striped":
        inputs, targets = stripe_tokens(inputs, n), stripe_tokens(targets, n)
        positions = stripe_tokens(positions, n, axis=0)
    s = inputs.shape[1] // n
    sl = slice(r * s, (r + 1) * s)
    return inputs[:, sl], targets[:, sl], positions[sl]


def attention(layout: str, group):
    from horovod_tpu_torch.parallel import (ring_attention,
                                            striped_ring_attention,
                                            ulysses_attention)

    if layout == "full":
        return ring_attention  # a ring of one
    fn = {"ring": ring_attention, "striped": striped_ring_attention,
          "ulysses": ulysses_attention}[layout]
    return functools.partial(fn, group=group)


def _counts(rt) -> dict:
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import xent
    from horovod_tpu_torch.parallel import _comm

    return {"ppermute": _comm.exchanges["ppermute"],
            "all_to_all": _comm.exchanges["all_to_all"], **fa.mask_launches,
            "K5 launches": sum(xent.kernel_launches.values()),
            "chunks": rt.chunks}


def _print_trace(layout: str, r: int, prof: dict):
    idle = max(0.0, 1.0 - prof["union_ms"] / prof["wall_ms"])
    print(f"  {layout} rank {r} traced step: wall {prof['wall_ms']:.1f} ms, "
          f"{prof['union_ms']:.1f} ms busy on any stream, idle share "
          f"{idle:.4f}; device ms by category: "
          + ", ".join(f"{k} {v:.3f}" for k, v in prof["categories"].items())
          + f"; longest gaps (ms, after, before): {prof['gaps']}",
          flush=True)
    for name, calls, ms in prof["top"][:10]:
        print(f"    {ms:9.3f}  {calls:5d}  {name}", flush=True)


def worker(device_arg, steps: int, layout: str) -> int:
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops.xent import chunked_softmax_xent
    from wire_probe import _same_as_rank0

    hvd.init(device=device_arg)
    device, n, r = hvd.device(), hvd.size(), hvd.rank()
    cuda = device.type == "cuda"
    if layout == "full" and n != 1:
        raise SystemExit("the full-sequence run takes one rank")
    cfg = _config(cuda)
    S = cfg.max_seq
    model = TransformerLM(cfg, device=device, seed=0)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=1e-3, momentum=0.9),
        named_parameters=model.named_parameters())
    g = torch.Generator().manual_seed(0)  # the same tokens on every rank
    tokens = torch.randint(0, cfg.vocab_size, (1, S + 1), generator=g)
    inp, tgt, pos = shard(layout, n, r, tokens[:, :-1], tokens[:, 1:],
                          torch.arange(S))
    inp, tgt, pos = inp.to(device), tgt.to(device), pos.to(device)
    group = hvd.global_process_set().group
    attn_fn = attention(layout, group)
    rt = context.runtime()

    host_s = []  # the host's time to enqueue a forward and backward

    def step():
        opt.zero_grad()
        t0 = time.perf_counter()
        h = model(inp, attn_fn=attn_fn, positions=pos, return_hidden=True)
        loss = chunked_softmax_xent(h.reshape(-1, cfg.d_model), model.embed,
                                    tgt.reshape(-1), cfg.xent_chunk)
        loss.backward()
        host_s.append(time.perf_counter() - t0)
        opt.step()
        return loss.detach()

    losses, step_s, per_step, peak = [], [], [], None
    for i in range(steps):
        if cuda:  # the steps' peak, not the parameter check's buffers
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        c0 = _counts(rt)
        t0 = time.perf_counter()
        loss = step()
        loss.item()  # waits for the step's device work
        step_s.append(time.perf_counter() - t0)
        if cuda:
            peak = max(peak or 0, torch.cuda.max_memory_allocated())
        c1 = _counts(rt)
        per_step.append({k: c1[k] - c0[k] for k in c0})
        dist.all_reduce(loss, group=group)
        losses.append(loss.item() / n)
        if not _same_as_rank0(params, group):
            raise AssertionError(f"rank {r}: parameters differ from rank "
                                 f"0's after step {i} ({layout})")
    if cuda:  # one more step, traced on the first and the last rank
        if r in (0, n - 1):
            from chip_smoke import profile_step

            _print_trace(layout, r, profile_step(lambda: step().item()))
        else:
            step().item()
    peaks = [None] * n
    dist.all_gather_object(peaks, peak, group=group)
    hosts = [None] * n
    dist.all_gather_object(hosts, statistics.median(host_s[1:steps] or host_s),
                           group=group)
    ranks_last = [None] * n
    dist.all_gather_object(ranks_last, per_step[-1], group=group)
    if r == 0:
        steady = statistics.median(step_s[1:]) if steps > 1 else step_s[0]
        summed = {k: sum(c[k] for c in ranks_last) for k in ranks_last[0]
                  if k in ("diagonal", "full", "strict")}
        print(f"  {layout}: losses {losses}", flush=True)
        print(f"  {layout}: step ms {[round(s * 1e3, 1) for s in step_s]}, "
              f"median after the first {steady * 1e3:.1f} ms, "
              f"{S / steady / n:.0f} tokens/s a GPU; peak a rank "
              + (f"{[round(p / 2**30, 2) for p in peaks]} GiB" if cuda
                 else "not measured")
              + f"; host ms to enqueue forward and backward by rank "
              f"{[round(x * 1e3, 1) for x in hosts]}"
              + f"; rank 0's last step {per_step[-1]}; flash launches a "
              f"step by mask over the ranks {summed}", flush=True)
        print(json.dumps({"sp_probe": layout, "ranks": n,
                          "device": str(device), "seq": S,
                          "losses": losses,
                          "step_ms": [s * 1e3 for s in step_s],
                          "median_step_ms": steady * 1e3,
                          "tokens_per_s_per_gpu": S / steady / n,
                          "peak_bytes": peaks, "per_step": per_step,
                          "host_enqueue_ms": [x * 1e3 for x in hosts],
                          "mask_launches_all_ranks": summed}), flush=True)
    del model, opt, params
    hvd.shutdown()
    print(f"SP_PROBE_OK {r}", flush=True)
    return 0


def _start(args, root: str, layout: str, nproc: int):
    """One hvdrun job, started."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(nproc), sys.executable, os.path.abspath(__file__), "--worker",
           "--steps", str(args.steps), "--layouts", layout] + (
               ["--device", args.device] if args.device else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # a session of its own, so a timeout ends the launcher and its workers
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(p, args, layout: str, nproc: int):
    """Waits for a job; returns rank 0's JSON reading."""
    try:
        out = p.communicate(timeout=args.timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        print(p.communicate()[0])
        raise AssertionError(f"sp_probe: the {layout} job timed out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"SP_PROBE_OK {k}" in out
                                    for k in range(nproc)):
        raise AssertionError(f"sp_probe: the {layout} job failed")
    for line in out.splitlines():
        at = line.find('{"sp_probe"')  # after the launcher's prefix
        if at >= 0:
            return json.loads(line[at:])
    raise AssertionError(f"sp_probe: the {layout} job printed no reading")


def check(readings: dict, tol: float):
    """Finite and falling losses; every layout's first loss within ``tol``
    of the one-rank run's."""
    ref = readings["full"]["losses"][0]
    for layout, rd in readings.items():
        ls = rd["losses"]
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"{layout}: losses {ls}")
        gap = abs(ls[0] - ref)
        print(f"  {layout}: first loss {ls[0]!r} against the one-rank run's "
              f"{ref!r}: |d| {gap:.3g} (tol {tol})", flush=True)
        if gap > tol:
            raise AssertionError(f"{layout}: first loss {ls[0]} leaves "
                                 f"{tol} of the one-rank run's {ref}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--layouts", default="ring,striped,ulysses")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    if args.worker:
        sys.path.insert(0, root)
        return worker(args.device, args.steps, args.layouts)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    jobs = [("full", 1)] + [(x, args.np) for x in args.layouts.split(",")]
    readings = {}
    if args.device == "cpu":
        # no card is shared: every job at once
        procs = [(_start(args, root, *job), job) for job in jobs]
        try:
            for p, job in procs:
                readings[job[0]] = _finish(p, args, *job)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
    for layout, nproc in jobs if args.device != "cpu" else ():
        t0 = time.perf_counter()
        readings[layout] = _finish(_start(args, root, layout, nproc), args,
                                   layout, nproc)
        print(f"  {layout} job ({nproc} ranks): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(readings, LOSS_TOL["cpu" if args.device == "cpu" else "cuda"])
    print(json.dumps({"sp_probe": readings}), flush=True)
    print(f"sp_probe: {args.np} ranks on {args.device or 'cuda'}, layouts "
          f"{args.layouts}, parameters equal on every rank after every step",
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
