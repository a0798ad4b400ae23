#!/usr/bin/env python3
"""Timing probes of the port's flash-attention kernels on one GPU.

    python3 flash_probe.py [--dtype bfloat16|float32] [--ablate]
                           [--out DIR]

``--dtype`` picks the kernel: bfloat16 (default) ``csrc/
flash_attention_sm90.cu``, float32 the 3xTF32 ``csrc/
flash_attention_tf32.cu``.
Prints the card's name and power limit, then:

- host: microseconds of host work per call along the launch path
  (``attention_stats`` without and with inputs that need a gradient,
  ``_kernel_fwd``, the bare C entry point, the output allocations, the
  stream lookup) and of ``F.scaled_dot_product_attention``,
  at a shape whose device work is a few microseconds, so back-to-back calls
  run at the host's pace;
- sweep: the kernel's device time beside sdpa's at the slice shape and at
  longer sequences, in TFLOP/s of the kept (causal) pairs;
- ``--ablate``: variants of the kernel's source with one piece of work
  taken out (their results are wrong by design; only their time is read),
  built into DIR and timed in turns with the unchanged source built the
  same way. The variants patch the source, or the header it shares with
  the other kernel (``csrc/flash_sm90_common.cuh``), by text: an edit that
  moves a patched line fails loudly.

Device times come from ``chip_smoke.device_ms``. sdpa is a yardstick only;
the port never calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

from chip_smoke import card_line, device_ms

HEADER = "flash_sm90_common.cuh"
NO_EXP = [("s[i] = exp2_ftz(fmaf(", "s[i] = (fmaf("),
          ("alpha[r] = exp2_ftz(", "alpha[r] = (")]
NO_SPLIT = [("i0 < kChunks; i0 +=", "i0 < 0; i0 +="),    # K lo
            ("w0 < kWarpItems; w0 +=", "w0 < 0; w0 +=")]  # V^T hi, lo
# by dtype: (source, C function, [(name, [(text in the source or the
# header, replacement), ...]), ...]); every occurrence is replaced
ABLATIONS = {
    "bfloat16": ("flash_attention_sm90", "hvd_flash_fwd_sm90", (
        ("no QK^T", [("        Wgmma<BK>::ss(sc,", "        if (kk < 0) "
                      "Wgmma<BK>::ss(sc,")]),
        ("no P V", [("        Wgmma<D>::rs(acc,", "        if (kk < 0) "
                     "Wgmma<D>::rs(acc,")]),
        ("no exp", NO_EXP),
        ("no compute", [("        Wgmma<BK>::ss(sc,", "        if (kk < 0) "
                         "Wgmma<BK>::ss(sc,"),
                        ("        Wgmma<D>::rs(acc,", "        if (kk < 0) "
                         "Wgmma<D>::rs(acc,")] + NO_EXP),
        ("half the K/V bytes", [
            ("mbar_expect_tx(bar_full + 8 * st, 2 * G::KV_BYTES);",
             "mbar_expect_tx(bar_full + 8 * st, G::KV_BYTES);"),
            ("            tma_load(sV + off, &tm_v,",
             "            if (i < 0) tma_load(sV + off, &tm_v,")]),
        ("2 K/V stages", [("constexpr int STAGES = 3;",
                           "constexpr int STAGES = 2;")]))),
    "float32": ("flash_attention_tf32", "hvd_flash_fwd_tf32", (
        ("no QK^T", [("        Tf32<BK>::ss(sc,", "        if (kk < 0) "
                      "Tf32<BK>::ss(sc,"),
                     ("        Tf32<BK>::rs(sc,", "        if (kk < 0) "
                      "Tf32<BK>::rs(sc,")]),
        ("no P V", [("        Tf32<D>::rs(acc,", "        if (kk < 0) "
                     "Tf32<D>::rs(acc,")]),
        ("no split pass", NO_SPLIT),
        ("no K split", NO_SPLIT[:1]),
        ("no V split", NO_SPLIT[1:]),
        ("no exp", NO_EXP),
        ("no compute", [("        Tf32<BK>::ss(sc,", "        if (kk < 0) "
                         "Tf32<BK>::ss(sc,"),
                        ("        Tf32<BK>::rs(sc,", "        if (kk < 0) "
                         "Tf32<BK>::rs(sc,"),
                        ("        Tf32<D>::rs(acc,", "        if (kk < 0) "
                         "Tf32<D>::rs(acc,")] + NO_EXP),
        ("one producer warpgroup (3 split warps; 56, 224 registers)", [
            ("kProducers = 256;", "kProducers = 128;"),
            ("kProducerRegs = 40;", "kProducerRegs = 56;")]),
        ("producers 48, consumers 208 registers", [
            ("kProducerRegs = 40;", "kProducerRegs = 48;")]),
        ("loads alone", [("        Tf32<BK>::ss(sc,", "        if (kk < 0) "
                          "Tf32<BK>::ss(sc,"),
                         ("        Tf32<BK>::rs(sc,", "        if (kk < 0) "
                          "Tf32<BK>::rs(sc,"),
                         ("        Tf32<D>::rs(acc,", "        if (kk < 0) "
                          "Tf32<D>::rs(acc,")] + NO_EXP + NO_SPLIT))),
}

SHAPES = ((128, 1024, True), (128, 1024, False), (32, 4096, True),
          (32, 4096, False))


def _qkv(B, s, d, seed, dtype):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, s, d), generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def _tflops(B, s, d, causal, ms):
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * B * pairs * d / ms / 1e9


def _entry(fn, q, k, v, causal: bool):
    """The bare C entry point ``fn`` on preallocated outputs: a closure
    that launches it once on the current stream."""
    import torch

    B, s, d = q.shape
    o = torch.empty_like(q)
    m = torch.empty((B, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, s, s, d, int(causal), 0, d ** -0.5,
            q.device.index, torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args) != 0:
            raise RuntimeError("flash kernel launch failed")
    call.outputs = (o, m, l)
    return call


def host_us(fn, iters: int = 2000, warmup: int = 50) -> float:
    """Host microseconds per call over back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def host(dtype, B: int = 1, s: int = 128, d: int = 128):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(B, s, d, 3, dtype)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    q4, k4, v4 = q[None], k[None], v[None]
    fn = fa._kernel_fn(dtype)

    def alloc():
        torch.empty_like(q)
        m = torch.empty((B, s), dtype=torch.float32, device=q.device)
        torch.empty_like(m)

    parts = (("attention_stats", lambda: fa.attention_stats(q, k, v, True)),
             ("attention_stats (grad)",
              lambda: fa.attention_stats(qg, kg, vg, True)),
             ("_kernel_fwd", lambda: fa._kernel_fwd(q, k, v, True, 0)),
             ("C entry point", _entry(fn, q, k, v, True)),
             ("3 output allocations", alloc),
             ("current stream",
              lambda: torch.cuda.current_stream(q.device).cuda_stream),
             ("sdpa", lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, is_causal=True)))
    print(f"host us per call, B={B} s={s} d={d} {str(dtype)[6:]} causal:",
          flush=True)
    for name, f in parts:
        print(f"  {name:24s} {host_us(f):8.2f}", flush=True)


def sweep(dtype, d: int = 128):
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    for B, s, causal in SHAPES:
        q, k, v = _qkv(B, s, d, 7, dtype)
        ms = device_ms(lambda: fa.attention_stats(q, k, v, causal))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal))
        print(f"B={B} s={s} d={d} causal={causal}: kernel {ms:.4f} ms "
              f"({_tflops(B, s, d, causal, ms):.0f} TFLOP/s), sdpa "
              f"{lib:.4f} ms ({_tflops(B, s, d, causal, lib):.0f} TFLOP/s)",
              flush=True)


def ablate(out_dir: str, dtype, rounds: int = 3):
    """Times the unchanged source and each variant in turns at the slice
    shape, each through its bare C entry point. Each variant is built in a
    directory of its own beside its copy of the shared header, which its
    ``#include`` finds first."""
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    source, symbol, ablations = ABLATIONS[str(dtype)[6:]]
    files = {}
    for name in (source + ".cu", HEADER):
        with open(os.path.join(_build.CSRC, name)) as f:
            files[name] = f.read()
    variants = {"kernel": files}
    for name, patches in ablations:
        texts = dict(files)
        for old, new in patches:
            hit = [f for f, t in texts.items() if old in t]
            if not hit:
                raise ValueError(f"ablation {name!r}: {old!r} is in neither "
                                 "the source nor the header")
            for f in hit:
                texts[f] = texts[f].replace(old, new)
        variants[name] = texts

    def build(item):
        i, texts = item
        vdir = os.path.join(out_dir, f"{source}-variant{i}")
        os.makedirs(vdir, exist_ok=True)
        for name, text in texts.items():
            with open(os.path.join(vdir, name), "w") as f:
                f.write(text)
        lib = os.path.join(vdir, source + ".so")
        run = subprocess.run(_build.nvcc_command(
            os.path.join(vdir, source + ".cu"), lib), check=True,
            capture_output=True, text=True)
        return lib, [line.split(", ", 1)[1].strip()
                     for line in (run.stdout + run.stderr).splitlines()
                     if "spill stores" in line]

    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, enumerate(variants.values())))
    q, k, v = _qkv(128, 1024, 128, 7, dtype)
    calls = {}
    for name, (lib, spills) in zip(variants, built):
        print(f"{name}: ptxas {spills}", flush=True)
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = fa.ARGTYPES
        fn.restype = ctypes.c_int
        calls[name] = _entry(fn, q, k, v, True)
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, call in calls.items():
            times[name].append(device_ms(call))
    for name, ts in times.items():
        print(f"{name:58s} " + " ".join(f"{t:.4f}" for t in ts) + " ms",
              flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the kernel to probe")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the ablation variants")
    ap.add_argument("--out", default=None,
                    help="directory for the variants' sources and builds "
                         "(default: horovod_tpu_torch/_build/ablation)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dtype = getattr(torch, args.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False  # sdpa's fp32 in fp32
    host(dtype)
    sweep(dtype)
    from horovod_tpu_torch.ops import _build

    out = args.out or os.path.join(_build.build_dir(), "ablation")
    if args.ablate:
        ablate(out, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
