#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build both kernels from ``horovod_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` each, started together, and print each build's
   seconds and ``ptxas`` report; count the ``HGMMA`` (``wgmma``)
   instructions in the bf16 kernel's SASS (``cuobjdump``) and fail on none;
3. kernel phase: the flash-attention forward, through ``attention_stats``
   (bf16 inputs launch the tensor-core kernel ``flash_attention_sm90.cu``,
   fp32 inputs the SIMT kernel ``flash_attention.cu``), against its plain
   version ``lax_stats`` on the same inputs in fp32 on the card (TF32 off),
   at small shapes for every head dim, dtype and mask the kernels take, at
   the tile edges of the bf16 kernel, and at the slice's shape
   (B = batch*heads = 128, s = 1024, d = 128, causal); each kernel, its
   plain version and ``F.scaled_dot_product_attention`` (a yardstick only,
   never called by the port) are timed at the slice shape in the kernel's
   dtype with CUDA events around back-to-back calls, and the kernel and
   sdpa also by their device time under ``torch.profiler``;
4. main path: ``hvd.init()`` (NCCL), ``broadcast_parameters`` and
   ``DistributedOptimizer(SGD(lr=1e-3, momentum=0.9))`` train the
   transformer LM at the full width of ``benchmarks/bench_transformer.py``
   (vocab 32768, d_model 2048, 16 heads, 12 layers, d_ff 8192, attention
   length 1024, batch 8, bf16 compute over fp32 weights) for 5 steps on one
   batch, with attention through ``ring_attention`` and the flash kernel;
   the losses must be finite and falling, and the bf16 kernel must have
   launched once per layer and step (the fp32 kernel never);
5. the slice against plain: a 2-layer model of the same widths, one loss and
   its gradients through the kernel path and through ``causal_attention``.

The line before the last is one JSON object with the kernels' launches,
errors and times; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the repository beside it, the script fails and
prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "float32": 67e12}    # fp32 outside the tensor cores


def _log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call: the CUDA kernels' own time under
    ``torch.profiler``, summed over ``iters`` calls. The host's work and the
    gaps between launches are left out, which ``time_ms`` counts wherever
    the host's work per call outlasts the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / iters / 1e3


def flash_bound(B: int, sq: int, sk: int, d: int, dtype: str,
                causal: bool) -> tuple[float, str]:
    """Least time (ms) for the forward at these shapes: q, k, v read once,
    o, m, l written once, over HBM bandwidth; or the products over the
    causally kept (row, col) pairs, over the peak rate of the input type."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * sq * d + 2 * B * sk * d) * item + 2 * B * sq * 4
    pairs = (sum(min(sk, r + 1) for r in range(sq)) if causal
             else sq * sk)
    flops = 2 * 2 * B * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 2: build ---------------------------------------------------------

SOURCES = ("flash_attention_sm90", "flash_attention")


def build_phase():
    """Builds every kernel source at once (one nvcc each) and checks that
    the bf16 kernel's SASS runs on the tensor cores."""
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.ops import _build

    def one(name):
        t0 = time.perf_counter()
        report = _build.build(name)
        return name, time.perf_counter() - t0, report

    _log("[build]")
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(one, SOURCES))
    for name, seconds, report in results:
        _log(f"  {name}: {seconds:.1f} s")
        for line in report.splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "arning")):
                _log(f"    {line.strip()}")
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "--dump-sass",
                           _build.lib_path("flash_attention_sm90")],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    _log(f"  flash_attention_sm90 SASS: {hgmma} HGMMA instructions")
    if hgmma == 0:
        raise AssertionError("the bf16 kernel has no HGMMA instruction: it "
                             "does not run on the tensor cores")


# --- phase 3: the kernels against their plain version ----------------------

def _qkv(B, s, d, dtype, seed, device, sk=None):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, n, d), generator=g, device=device,
                        dtype=torch.float32).to(dtype)
            for n in (s, sk or s, sk or s)]


U_BF16 = 2.0 ** -8  # unit roundoff of bfloat16 (8 significant bits)


def check_flash(B, s, d, dtype, causal, offset, device, sk=None):
    """The kernel, through ``attention_stats`` (the main path's dispatch),
    against its plain version ``lax_stats`` on the same inputs in fp32,
    which the kernel reads exactly. Returns max |o - o_plain|.

    m and l: fp32 summation order only, 1e-5 (l relative). o: fp32 inputs
    at the JAX kernel test's 1e-4. bf16 inputs: the kernel rounds p to bf16
    before P.V and o to bf16, as its contract says, which bounds each
    element by u (|o| + (P|V|)/l), u = 2^-8, times 1.01 for the product of
    the two roundings, plus 1e-5 of fp32 order. On rows the mask empties
    (row < offset) only m == NEG_INF and a finite o and l are held, as the
    JAX package's strict-offset test does."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(B, s, d, dtype, 1000 + s + d, device, sk)
    o, m, l = fa.attention_stats(q, k, v, causal, causal_offset=offset)
    q32, k32, v32 = q.float(), k.float(), v.float()
    o_p, m_p, l_p = fa.lax_stats(q32, k32, v32, causal, offset)
    r0 = offset if causal else 0
    if r0:
        if not bool((m[:, :r0] == fa.NEG_INF).all()):
            raise AssertionError("fully masked rows must keep m == NEG_INF")
        if not (torch.isfinite(o).all() and torch.isfinite(l).all()):
            raise AssertionError("fully masked rows must give finite o, l")
    d_o = (o[:, r0:].float() - o_p[:, r0:]).abs()
    if dtype == torch.bfloat16:
        o_abs = fa.lax_stats(q32, k32, v32.abs(), causal, offset)[0]
        tol_o = (1.01 * U_BF16 * (o_p[:, r0:].abs() + o_abs[:, r0:])
                 + 1e-5)
        del o_abs
    else:
        tol_o = torch.full_like(d_o, 1e-4)
    o_err = d_o.max().item()
    o_share = (d_o / tol_o).max().item()
    m_err = (m[:, r0:] - m_p[:, r0:]).abs().max().item()
    l_rel = ((l[:, r0:] - l_p[:, r0:]).abs()
             / l_p[:, r0:].abs()).max().item()
    _log(f"  flash B={B} s={s}{f' sk={sk}' if sk else ''} d={d} "
         f"{str(dtype)[6:]} causal={causal} "
         f"offset={offset}: max|do|={o_err:.3g} (max share of its bound "
         f"{o_share:.3g}) max|dm|={m_err:.3g} max rel dl={l_rel:.3g} "
         f"(tol m 1e-05, l 1e-05)")
    if not (o_share <= 1.0 and m_err <= 1e-5 and l_rel <= 1e-5):
        raise AssertionError(f"flash kernel disagrees with lax_stats at "
                             f"B={B} s={s} sk={sk} d={d} {dtype}")
    return o_err


def kernel_phase(device) -> list:
    import torch

    # the plain version in full fp32 (no TF32 anywhere)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            for causal, offset in ((False, 0), (True, 0), (True, 1)):
                check_flash(2, 256, d, dtype, causal, offset, device)
        # a length that leaves the last tiles ragged
        check_flash(2, 200, 64, dtype, True, 0, device)
        # the bf16 kernel's tile edges (128-row Q and K tiles): ragged Q and
        # K tiles at a batch boundary, whose rows past s must neither read
        # nor write the next batch row; a length below one Q tile; sq < sk
        check_flash(3, 200, 128, dtype, True, 1, device)
        check_flash(2, 64, 128, dtype, True, 0, device)
        check_flash(2, 256, 128, dtype, False, 0, device, sk=512)

    B, s, d = 128, 1024, 128
    kernels = []
    for dtype, name, iters in ((torch.bfloat16, "flash_attention_fwd", 50),
                               (torch.float32, "flash_attention_fwd_fp32",
                                10)):
        kernels.append(time_flash(name, B, s, d, dtype, iters, device))
    return kernels


def time_flash(name, B, s, d, dtype, iters, device) -> dict:
    """One kernel at the slice shape: checked against its plain version,
    then timed beside it, its bound and ``scaled_dot_product_attention``
    on the same inputs. ``ms``, ``plain_ms`` and ``library_ms`` are CUDA
    events around back-to-back calls, the host's work per call included;
    ``device_ms`` and ``library_device_ms`` are the kernels' own time."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    err = check_flash(B, s, d, dtype, True, 0, device)
    torch.cuda.empty_cache()
    q, k, v = _qkv(B, s, d, dtype, 7, device)
    q4, k4, v4 = q[None], k[None], v[None]

    def kernel():
        fa.attention_stats(q, k, v, True)

    def library():
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    ms = time_ms(kernel, iters=iters)
    lib_ms = time_ms(library, iters=iters)
    dev_ms = device_ms(kernel, iters=iters)
    lib_dev_ms = device_ms(library, iters=iters)
    plain_ms = time_ms(lambda: fa.lax_stats(q, k, v, True, 0), iters=5)
    dt = str(dtype)[6:]
    bound_ms, bound_by = flash_bound(B, s, s, d, dt, True)
    flops = 2 * 2 * B * (s * (s + 1) // 2) * d
    _log(f"  {name} at the slice shape ({dt}): kernel {ms:.4f} ms a call "
         f"back to back, {dev_ms:.4f} ms of device time "
         f"({flops / dev_ms / 1e9:.1f} TFLOP/s, {bound_ms / dev_ms:.3f} of "
         f"its bound); sdpa {lib_ms:.4f} ms a call, {lib_dev_ms:.4f} ms of "
         f"device time; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
         f"({bound_by})")
    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    source = fa.KERNELS[dtype][1]
    return {"name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{source}.cu",
            "replaces": "horovod_tpu/ops/pallas/flash_attention.py:122",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms}


# --- phase 4: the main path at full width ---------------------------------

def fwd_flops_per_token(cfg, seq: int) -> int:
    """Matmul FLOPs per token of one forward pass, counted as
    benchmarks/bench_transformer.py:34-38 counts them (attention in full,
    not causally halved); a training step is 3x forward."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    per_block = 8 * d * d + 4 * d * f + 4 * seq * d
    return cfg.n_layers * per_block + 2 * d * v


def full_width_config(n_layers: int):
    import torch

    from horovod_tpu_torch.models.transformer import TransformerConfig

    # benchmarks/bench_transformer.py:41-43
    return TransformerConfig(vocab_size=32768, d_model=2048, n_heads=16,
                             n_layers=n_layers, d_ff=8192, max_seq=1024,
                             dtype=torch.bfloat16)


def tokens_for(cfg, batch: int, seed: int, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    # lm_loss drops one token, so attention runs at exactly max_seq
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=g, device=device)


def train(cfg, batch: int, steps: int, device) -> dict:
    """Horovod's training loop through the port's entry points. Returns
    the losses, step times, kernel launches and peak memory of ``steps``
    steps; on CUDA, one more step is traced with ``torch.profiler``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import ring_attention

    model = TransformerLM(cfg, device=device, seed=0)
    tokens = tokens_for(cfg, batch, 0, device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9),
        named_parameters=model.named_parameters())

    def step():
        opt.zero_grad()
        loss = lm_loss(model, tokens, attn_fn=ring_attention)
        loss.backward()
        opt.step()
        return loss.item()  # waits for the step's device work

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for name in fa.kernel_launches:
        fa.kernel_launches[name] = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.kernel_launches)
    res = {"losses": losses, "step_s": step_s, "launches": launches,
           "peak_bytes": None, "profile": None}
    if device.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        res["profile"] = profile_step(step)
    return res


# kernel-name patterns of the step's device work, first match wins
_CATEGORIES = (("flash forward kernel", r"flash_fwd"),
               ("fp32 GEMM", r"f32f32|sgemm"),
               ("other GEMM (bf16)", r"gemm|nvjet|xmma|cutlass"),
               ("NCCL", r"nccl"),
               ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
               ("elementwise, reduce, copy", r""))


def profile_step(step) -> dict:
    """Device time of one traced step by kernel and by category, beside
    its wall time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    cats = {name: 0.0 for name, _ in _CATEGORIES}
    for e in events:
        name = next(n for n, pat in _CATEGORIES if re.search(pat, e.key))
        cats[name] += e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "categories": cats,
            "top": [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


def main_path_phase(device) -> dict:
    import torch

    cfg = full_width_config(12)
    batch, steps = 8, 5
    res = train(cfg, batch, steps, device)
    losses = res["losses"]
    _log(f"  losses: {losses}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = {"flash_attention_fwd": cfg.n_layers * steps,
            "flash_attention_fwd_fp32": 0}
    if res["launches"] != want:
        raise AssertionError(f"flash kernels launched {res['launches']} "
                             f"times on the main path, expected {want}")
    steady = statistics.median(res["step_s"][1:])
    tok = batch * cfg.max_seq
    mfu = (tok / steady * 3 * fwd_flops_per_token(cfg, cfg.max_seq)
           / PEAK_FLOPS["bfloat16"])
    _log(f"  step ms: first {res['step_s'][0] * 1e3:.1f}, then "
         f"{[round(x * 1e3, 1) for x in res['step_s'][1:]]}; median "
         f"{steady * 1e3:.1f} ms, {tok / steady:.0f} tokens/s, model "
         f"FLOPs utilization {mfu:.4f} of 989 TFLOP/s; "
         f"max_memory_allocated {res['peak_bytes'] / 2**30:.2f} GiB; "
         f"flash launches {res['launches']}")
    prof = res["profile"]
    _log(f"  traced step: wall {prof['wall_ms']:.1f} ms, device kernels "
         f"{prof['device_ms']:.1f} ms (summed over streams); top kernels "
         "(calls, ms):")
    for name, calls, ms in prof["top"]:
        _log(f"    {ms:9.3f}  {calls:5d}  {name}")
    _log("  device ms by category:")
    for name, ms in prof["categories"].items():
        _log(f"    {ms:9.3f}  {name}")
    gc.collect()  # the optimizer's gradient hooks hold it in a cycle
    torch.cuda.empty_cache()
    return res["launches"]


# --- phase 5: the slice against plain attention ---------------------------

def loss_and_grads(model, tokens, attn_fn):
    from horovod_tpu_torch.models.transformer import lm_loss

    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, attn_fn=attn_fn)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def slice_vs_plain_phase(device, n_layers: int = 2):
    import torch

    from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                      causal_attention)
    from horovod_tpu_torch.parallel import ring_attention

    cfg = full_width_config(n_layers)
    model = TransformerLM(cfg, device=device, seed=1)
    tokens = tokens_for(cfg, 8, 1, device)
    loss_k, g_k = loss_and_grads(model, tokens, ring_attention)
    loss_p, g_p = loss_and_grads(model, tokens, causal_attention)
    worst = max((((g_k[n] - g_p[n]).norm() / g_p[n].norm()).item(), n)
                for n in g_p)
    # bf16 compute on both sides, rounded at other places: the plain path
    # rounds scores and probabilities to bf16 and backpropagates in bf16,
    # the kernel path keeps scores in fp32 and recomputes its backward in
    # fp32 (scan_stats). At random weights the loss is near ln(vocab)
    # whatever attention does, so the gradients are the discriminating
    # check; both tolerances are a few times the gap measured on an H100.
    tol_loss, tol_grad = 2e-4, 3e-2
    _log(f"  {n_layers}-layer loss kernel {loss_k:.6f} vs plain "
         f"{loss_p:.6f} (|d| {abs(loss_k - loss_p):.3g}, tol {tol_loss}); "
         f"worst grad rel err {worst[0]:.3g} at {worst[1]} (tol {tol_grad})")
    if not (abs(loss_k - loss_p) <= tol_loss and worst[0] <= tol_grad):
        raise AssertionError("kernel path disagrees with plain attention")
    del model, g_k, g_p
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd

    _log(card_line())
    kind = torch.cuda.get_device_name(0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")

    build_phase()

    hvd.init()
    device = hvd.device()
    _log(f"[kernel] on {device} ({torch.distributed.get_backend()})")
    kernels = kernel_phase(device)

    _log("[main path] 12 layers at full width, 5 steps")
    launches = main_path_phase(device)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]

    _log("[slice vs plain]")
    slice_vs_plain_phase(device)
    hvd.shutdown()

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
