#!/usr/bin/env python3
"""The port's collective surface across several ranks (root script, not
part of the package).

    python3 collectives_probe.py [-np 4] [--device cpu]

Starts ``-np`` workers through the port's ``hvdrun``, one a GPU (or on the
CPU over gloo with ``--device cpu``, as the tests run it). Every worker
makes every rank's inputs from seeds, integer-valued so that every sum and
average is exact in its dtype, and checks each result bit for bit against
what it computes itself:

- a ragged allgather at the LM's layout (rows [8192, 6000, 0, 1], cycled
  over the ranks, of [2048] bf16: pad, gather and the K1 compaction), and
  an even one of [8192] fp32;
- alltoall with uneven splits (and the received splits), and an even one
  of [1024·n, 2048] bf16;
- reducescatter SUM and AVERAGE, of [4·n, 3] fp32 and of the LM's
  embedding-gradient shape [32768, 2048] fp32;
- process sets of the even ranks, the odd ranks and the last rank, whose
  tensors are all named ``x``, one of them fused through K1;
- sparse allreduce of rows that overlap across ranks;
- the last rank joining while the others run an allreduce and an
  allgather, to which it contributes zeros and no rows;
- ``allgather_object``.

On the card, rank 0 also prints for the LM-shaped ops the mean ms of
back-to-back calls by CUDA events, the median host us from enqueue to
``synchronize``, the NCCL calls and K1 launches of one call, and the bus
rate of the reducescatter's allreduce, then one JSON line. The exit code
is 0 only when every rank checked every case.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import time

ROWS = (8192, 6000, 0, 1)  # a ragged allgather's rows, cycled over ranks
WIDTH = 2048


def _data(rank, rows, rest, dtype, device, salt):
    """Rank ``rank``'s input for case ``salt``: integers in [-8, 8)."""
    import torch

    g = torch.Generator(device=device).manual_seed(1000 * salt + rank)
    return torch.randint(-8, 8, (rows,) + tuple(rest), generator=g,
                         device=device).to(dtype)


def _exact(name, got, want):
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs")


def _timed(name, fn, nbytes, device, out):
    """Event ms of 5 back-to-back calls, median host us of 5 calls from an
    idle card, and the NCCL calls and K1 launches of one call. Every rank
    runs it (the ops are collective); rank 0 keeps the reading."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import fused_pack as fp

    rt = context.runtime()
    fn()
    host = []
    for _ in range(5):
        torch.cuda.synchronize(device)
        calls0 = rt.collective_calls
        k10 = sum(fp.kernel_launches.values())
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6)
    calls = rt.collective_calls - calls0
    k1 = sum(fp.kernel_launches.values()) - k10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(5):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 5
    if hvd.rank() == 0:
        print(f"  {name}: {ms:.4f} ms a call by events, "
              f"{statistics.median(host):.0f} us host enqueue to "
              f"synchronize; {nbytes} bytes on this rank; {calls} NCCL "
              f"calls, {k1} K1 launches a call", flush=True)
        out.append({"op": name, "ms": ms, "host_us": statistics.median(host),
                    "bytes": nbytes, "nccl_calls": calls, "k1_launches": k1})
    return ms


def worker(device_arg: str) -> int:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fused_pack as fp

    hvd.init(device=device_arg)
    device, n, r = hvd.device(), hvd.size(), hvd.rank()
    cuda = device.type == "cuda"
    bf16, f32 = torch.bfloat16, torch.float32

    # 1. allgather: ragged at the LM's layout, even at the losses' shape
    rows = [ROWS[k % len(ROWS)] for k in range(n)]
    if not cuda:
        rows = [k % 4 * 3 // 2 for k in range(n)]  # 0, 1, 3, 4 rows
    want = torch.cat([_data(k, rows[k], (WIDTH,), bf16, device, 1)
                      for k in range(n)])
    x = _data(r, rows[r], (WIDTH,), bf16, device, 1)
    k0 = dict(fp.kernel_launches)
    _exact("ragged allgather", hvd.allgather(x, name="ag.ragged"), want)
    packs = fp.kernel_launches["fused_pack"] - k0["fused_pack"]
    if cuda and n > 1 and packs != (2 if 0 < rows[r] < max(rows) else 1):
        raise AssertionError(f"ragged allgather launched {packs} K1 packs "
                             f"on rank {r} with {rows[r]} rows")
    y = _data(r, 8192, (), f32, device, 2)
    _exact("even allgather", hvd.allgather(y, name="ag.even"),
           torch.cat([_data(k, 8192, (), f32, device, 2)
                      for k in range(n)]))
    # 2. alltoall: rank k sends (k + 2j) % 3 rows to rank j
    splits = [[(k + 2 * j) % 3 for j in range(n)] for k in range(n)]
    xs = [_data(k, sum(splits[k]), (4,), f32, device, 3) for k in range(n)]
    out, recv = hvd.alltoall(xs[r], splits=splits[r], name="a2a.uneven")
    want = torch.cat([xs[k][sum(splits[k][:r]):sum(splits[k][:r + 1])]
                      for k in range(n)])
    _exact("uneven alltoall", out, want)
    if recv.tolist() != [splits[k][r] for k in range(n)]:
        raise AssertionError(f"received splits {recv.tolist()}")
    z = _data(r, 1024 * n, (WIDTH,), bf16, device, 4)
    out, _ = hvd.alltoall(z, name="a2a.even")
    _exact("even alltoall", out, torch.cat(
        [_data(k, 1024 * n, (WIDTH,), bf16, device, 4)[1024 * r:
                                                       1024 * (r + 1)]
         for k in range(n)]))
    # 3. reducescatter, SUM and AVERAGE (integer sums: exact)
    ins = [_data(k, 4 * n, (3,), f32, device, 5) for k in range(n)]
    total = torch.stack(ins).sum(0)[4 * r:4 * (r + 1)]
    _exact("reducescatter SUM",
           hvd.reducescatter(ins[r], name="rs", op=hvd.Sum), total)
    _exact("reducescatter AVERAGE",
           hvd.reducescatter(ins[r], name="rs", op=hvd.Average), total / n)
    # 4. process sets, created by every rank in one order; all named "x"
    sets = [hvd.add_process_set(range(0, n, 2), name="even"),
            hvd.add_process_set(range(1, n, 2), name="odd")
            if n > 1 else None,
            hvd.add_process_set([n - 1], name="last")]
    v = torch.full((3,), float(r + 1), device=device)
    for ps in filter(None, sets):
        if r in ps.ranks:
            want = torch.full((3,), float(sum(k + 1 for k in ps.ranks)),
                              device=device)
            _exact(f"allreduce on {ps.name}", hvd.allreduce(
                v, name="x", op=hvd.Sum, process_set=ps), want)
    if r in sets[0].ranks:
        outs = hvd.grouped_allreduce([v, v * 2], name="g", op=hvd.Sum,
                                     process_set=sets[0])
        s = float(sum(k + 1 for k in sets[0].ranks))
        _exact("fused allreduce on even", torch.cat(outs), torch.cat(
            [torch.full((3,), s, device=device),
             torch.full((3,), 2 * s, device=device)]))
    for ps in filter(None, sets):
        hvd.remove_process_set(ps)
    # 5. sparse allreduce: rank k holds rows k and k + 1 of [n + 1, 2]
    vals = [_data(k, 2, (2,), f32, device, 6) for k in range(n)]
    idx = torch.tensor([[r, r + 1]], device=device)
    sp = torch.sparse_coo_tensor(idx, vals[r], (n + 1, 2))
    want = torch.zeros(n + 1, 2, device=device)
    for k in range(n):
        want[k:k + 2] += vals[k]
    _exact("sparse allreduce",
           hvd.sparse_allreduce_async(sp, "sparse", op=hvd.Sum)().to_dense(),
           want)
    # 6. join: the last rank joins first and contributes zeros, no rows
    if r == n - 1:
        last = hvd.join()
    else:
        want = torch.full((2,), float(sum(range(1, n))), device=device)
        _exact("allreduce beside a joined rank", hvd.allreduce(
            torch.full((2,), float(r + 1), device=device), name="j.ar",
            op=hvd.Sum), want)
        _exact("allgather beside a joined rank", hvd.allgather(
            _data(r, r + 1, (2,), f32, device, 7), name="j.ag"),
            torch.cat([_data(k, k + 1, (2,), f32, device, 7)
                       for k in range(n - 1)]))
        last = hvd.join()
    lasts = hvd.allgather_object(last)
    if len(set(lasts)) != 1 or not 0 <= lasts[0] < n:
        raise AssertionError(f"join returned {lasts}")
    # 7. objects
    if hvd.allgather_object({"rank": r}) != [{"rank": k} for k in range(n)]:
        raise AssertionError("allgather_object")
    if r == 0:
        print(f"collectives_probe: {n} ranks on {device.type}, every case "
              "exact", flush=True)
    readings: list = []
    if cuda:
        rg = _data(r, rows[r], (WIDTH,), bf16, device, 1)
        _timed(f"ragged allgather rows {rows} of [{WIDTH}] bf16",
               lambda: hvd.allgather(rg, name="t.ag.ragged"),
               rg.numel() * 2, device, readings)
        _timed("allgather [8192] fp32",
               lambda: hvd.allgather(y, name="t.ag.even"), y.numel() * 4,
               device, readings)
        _timed(f"alltoall [{1024 * n}, {WIDTH}] bf16",
               lambda: hvd.alltoall(z, name="t.a2a"), z.numel() * 2,
               device, readings)
        grad = _data(r, 32768, (WIDTH,), f32, device, 8)
        ms = _timed(f"reducescatter SUM [32768, {WIDTH}] fp32",
                    lambda: hvd.reducescatter(grad, name="t.rs",
                                              op=hvd.Sum),
                    grad.numel() * 4, device, readings)
        if r == 0:
            # the allreduce under it, as NCCL counts a bus rate
            bus = grad.numel() * 4 * 2 * (n - 1) / n / (ms * 1e-3) / 1e9
            print(f"  reducescatter's allreduce: {bus:.1f} GB/s bus rate "
                  "(the clone and the slice included)", flush=True)
            print(json.dumps({"collectives_probe": readings,
                              "ranks": n}), flush=True)
    hvd.shutdown()
    print(f"PROBE_OK {r}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    if args.worker:
        sys.path.insert(0, root)
        return worker(args.device)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np), sys.executable, os.path.abspath(__file__),
           "--worker"] + (["--device", args.device] if args.device else [])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # a session of its own, so a timeout ends the launcher and its workers
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=args.timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0]
        print(out)
        print("collectives_probe: timed out", file=sys.stderr)
        return 124
    print(out, flush=True)
    ok = all(f"PROBE_OK {k}" in out for k in range(args.np))
    return 0 if p.returncode == 0 and ok else 1


if __name__ == "__main__":
    sys.exit(main())
