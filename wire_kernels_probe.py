#!/usr/bin/env python3
"""The compressed wire's kernels alone at the LM's size, for comparing two
trees of the port on one card (root script, not part of the package).

    python3 wire_kernels_probe.py [--root DIR] [--rounds 2]
                                  [--kernels reduce,quantize]

It imports ``horovod_tpu_torch`` from ``--root`` (default: this script's
directory), so a ``git archive`` of another commit unpacked into a
directory can be measured by the same script on the same card; run the
two in turns (parent, change, change, parent), one process each. The
inputs are the full-width LM's 74 wire gradients (673,185,792 fp32
elements of ``benchmarks/bench_transformer.py``'s shapes, the tensors of
at least ``HOROVOD_QUANT_MIN_ELEMS`` in backward order, chunked at 128 MiB
into 20 chunks, as ``chip_smoke.py``'s compression path chunks them),
filled from seeded normal draws on the card. Timed a step (every chunk,
rank 0's inputs), by CUDA events and by profiler device time, each kernel
once a round:

- K3 quantize pack, int8 and int4 at block 256, with error feedback (a
  zero residual a tensor in, the new residual out) and without;
- the reduce-unpack of 4 rows (each packed from its own draws), bf16, int8
  and int4 wires, AVERAGE, fp32 outputs.

Each number stands beside its byte bound (each input byte read once, each
output byte written once, at 3.35 TB/s). Prints the card's name and power
limit, a line a kernel, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default="reduce,quantize")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("wire_kernels_probe: CUDA is not available", file=sys.stderr)
        return 2
    # the timers and shapes of this tree's chip_smoke.py, whatever --root
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.ops import quant_wire as qw

    if not qw.__file__.startswith(root):
        raise RuntimeError(f"imported {qw.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    cfg = cs.full_width_config(12)
    shapes = [s for s in reversed(cs.lm_param_shapes(cfg))
              if math.prod(s) >= comp.quant_min_elems()]
    chunks, chunk, nbytes = [], [], 0
    for s in shapes:
        sz = math.prod(s) * 4
        if chunk and nbytes + sz > cs.FUSION_THRESHOLD:
            chunks.append(chunk)
            chunk, nbytes = [], 0
        chunk.append(s)
        nbytes += sz
    chunks.append(chunk)
    ins = [[torch.empty(s, device=dev) for s in c] for c in chunks]
    sizes = [sum(t.numel() for t in c) for c in ins]
    total = sum(sizes)

    def fill(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        for c in ins:
            for t in c:
                t.normal_(generator=g)

    timings = {}

    def timed(name, fn, nbytes):
        ev = [cs.time_ms(fn, iters=5) for _ in range(args.rounds)]
        dv = [cs.device_ms(fn, iters=3, warmup=1)
              for _ in range(args.rounds)]
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        timings[name] = {"ms": statistics.mean(ev),
                         "device_ms": statistics.mean(dv),
                         "ms_rounds": ev, "device_ms_rounds": dv,
                         "bound_ms": bound,
                         "share": bound / statistics.mean(dv)}
        print(f"{name}: {timings[name]['ms']:.4f} ms by events, "
              f"{timings[name]['device_ms']:.4f} device, bound "
              f"{bound:.4f} ({timings[name]['share']:.3f})", flush=True)

    world = 4
    kinds = args.kernels.split(",")
    for label, spec in (("bf16", comp.make_cast_spec()),
                        ("int8", comp.make_quant_spec(8, 256, False)),
                        ("int4", comp.make_quant_spec(4, 256, False))):
        if "reduce" not in kinds:
            break
        gath = [torch.empty(world * qw.row_bytes(n, spec), dtype=torch.uint8,
                            device=dev) for n in sizes]
        for r in range(world):
            fill(100 + r)
            for c, g in zip(ins, gath):
                nb = g.numel() // world
                row = g[r * nb:(r + 1) * nb]
                if spec.bits == 16:
                    qw.cast_pack(c, row)
                else:
                    qw.quantize_pack(c, row, spec)
        outs = [[torch.empty_like(t) for t in c] for c in ins]
        timed(f"wire_reduce_{label}",
              lambda: [qw.reduce_unpack(g, o, spec, world, True)
                       for g, o in zip(gath, outs)],
              sum(g.numel() for g in gath) + total * 4)
        del gath, outs
    fill(100)
    for bits in (8, 4) if "quantize" in kinds else ():
        for ef in (True, False):
            spec = comp.make_quant_spec(bits, 256, ef)
            lay = [comp.quant_wire_layout(n, spec) for n in sizes]
            rows = [torch.empty(p + s, dtype=torch.uint8, device=dev)
                    for _, _, p, s in lay]
            res = ([[torch.zeros(t.numel(), device=dev) for t in c]
                    for c in ins] if ef else [None] * len(ins))
            new = ([torch.empty(n, device=dev) for n in sizes] if ef
                   else [None] * len(ins))
            timed(f"wire_quantize_int{bits}" + ("" if ef else "_no_ef"),
                  lambda: [qw.quantize_pack(c, r, spec, 1.0, x, y)
                           for c, r, x, y in zip(ins, rows, res, new)],
                  total * (12 if ef else 4)
                  + sum(p + s for _, _, p, s in lay))
            del rows, res, new
    print(json.dumps({"root": root, "card": cs.card_line(),
                      "elements": total, "chunks": len(chunks),
                      "tensors": len(shapes), "kernels": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
