#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``horovod_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (the two flash-attention sources, ``fused_pack.cu``,
   ``quant_wire.cu``, ``xent.cu`` and ``adasum.cu``), one ``nvcc`` each, started
   together, and print each build's seconds and ``ptxas`` report
   (registers, spills); count the tensor-core
   instructions (``HGMMA``) in both flash kernels' SASS (``cuobjdump``),
   by opcode, and fail on none;
3. flash phase: the flash-attention forward, through ``attention_stats``
   (bf16 inputs launch ``flash_attention_sm90.cu``, fp32 inputs the 3xTF32
   kernel ``flash_attention_tf32.cu``), against its plain version
   ``lax_stats`` on the same inputs in fp32 on the card (TF32 off), at
   small shapes for every head dim, dtype and mask the kernels take, at
   the bf16 kernel's tile edges, and at the slice's shape (B =
   batch*heads = 128, s = 1024, d = 128, causal): 14 shapes a dtype; each
   kernel, its plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only, never called by the port) are timed at the slice shape
   in the kernel's dtype with CUDA events around back-to-back calls, and
   the kernel and sdpa also by their device time under ``torch.profiler``,
   kernel and sdpa in turns;
4. K1 phase: the fused-chunk pack and unpack (``fused_pack.cu``) through
   the port's dispatch, held bitwise against their plain version on the
   card in 144 cases (ragged lengths with 0 and 1 element, starts off
   16-byte alignment, more tensors than one launch's table holds, chunks
   of millions of elements, fp32, bf16, fp16 and fp64, factors 1, 0.5,
   1/3, 0.1 and 0.7, AVERAGE with and without the divide in the unpack;
   bf16 and fp16 round the factor to their dtype first); then, at the
   slice's gradient set (the full-width LM's 99 fp32 gradients chunked at
   128 MiB, the chunks the main path's grouped steps form), every packed
   chunk is held bitwise against the plain version again, and pack and
   unpack are timed by CUDA events and device time, in turns with
   ``torch.cat``/``split`` + ``copy_`` (a yardstick only), beside their
   bound and their plain version; then the compaction of a ragged
   allgather (``compact_rows``: K1's pack over the table of the ``nproc``
   row slices ``gathered[i*maxn : i*maxn + size_i]``), held bitwise
   against the plain version in 72 layouts (``nproc`` 2, 4 and 8, row
   counts with 0 and 1, rows of [2048], [3] and [] elements, fp32, bf16,
   int32 and uint8, aligned and misaligned slice starts) and timed at
   ``nproc`` 4, rows [8192, 6000, 0, 1] of [2048] bf16, beside
   ``torch.cat`` of the same slices and its bound; then K2/K3, the
   compressed wire (``quant_wire.cu``): the cast pack, the quantize pack
   and the reduce-unpack held bitwise against their plain versions in 171
   cases (bf16, int8 and int4 at blocks 8, 9 (int4: 10), 256 and 1000;
   fp32, bf16 and fp16 chunks; lengths 1, block - 1 and block + 1, a
   chunk of 4.3 million elements, 300 tensors a chunk, misaligned starts;
   at block 256 odd block counts (rows off 16-byte alignment), a block
   across two tensors, starts 1, 2 and 3 elements in, one LM layer in
   bf16 and fp16; all-zero, saturating and exact-tie blocks; error
   feedback on and off over two rounds, prescale 1 and 0.7, 1 to 8 ranks,
   SUM and AVERAGE, postscale 1 and 0.5), K3's own count of its
   register-path blocks equal to the wrapper's;
5. main path: ``hvd.init()`` (NCCL and the background runtime),
   ``broadcast_parameters`` and ``DistributedOptimizer(SGD(lr=1e-3,
   momentum=0.9))`` train the transformer LM at the full width of
   ``benchmarks/bench_transformer.py`` (vocab 32768, d_model 2048, 16
   heads, 12 layers, d_ff 8192, attention length 1024, batch 8, bf16
   compute over fp32 weights) for 5 steps on one batch, with attention
   through ``ring_attention`` and the flash kernel and every gradient
   through the runtime, which fuses what its hooks enqueue within one
   cycle; then the same model and batch 3 steps with the bare optimizer
   after one ``hvd.grouped_allreduce_`` of all gradients, which one cycle
   takes whole, so its chunks, collective calls and K1 launches per step
   are known in advance and are checked. Per step it prints the chunks,
   collective calls, K1 launches, negotiation rounds and cycles. The
   losses must be finite and falling, the bf16 flash kernel must have
   launched once per layer and step (the fp32 one never), and both runs'
   losses must equal, bit for bit, 5 steps of the same model and batch
   under ``HOROVOD_FUSION_THRESHOLD=0`` (every tensor its own chunk, no
   pack): at a world of one the fused chain may change no bit. One more
   hook step is traced with ``torch.profiler``;
6. fp32 path: the same LM, batch and loop in fp32 (``cfg.dtype =
   torch.float32``, TF32 off) for 3 steps through the runtime: exactly one
   fp32 flash launch per layer and step (the bf16 kernel's none), finite
   and falling losses, the first loss within 1e-4 (relative) of the same
   step with ``use_flash=False``; median step, tokens/s and peak memory;
7. the slice against plain: a 2-layer model of the same widths, one loss and
   its gradients through the kernel path and through ``causal_attention``;
8. collectives path: the same LM at full width and ``hvd.init()``,
   through the rest of Horovod's surface, each result checked exactly
   (a world of one, so every result is its input, through the NCCL calls
   and K1 launches a multi-GPU run makes): ``allgather`` of one
   evaluation forward's per-token losses ([8192] fp32) and of its final
   hidden states ([8192, 2048] bf16, with its backward through the
   autograd op), ``alltoall`` of the hidden states with ``splits=[8192]``
   (and its backward), ``reducescatter`` of the embedding gradient
   ([32768, 2048] fp32) with SUM and AVERAGE, ``sparse_allreduce_async``
   of the input embedding's gradient rows as COO, one hook step of
   ``DistributedOptimizer(process_set=add_process_set([0]))`` (fused
   through K1 on the set's group) bitwise equal to one step on the global
   set, ``join()`` and an allreduce after it, ``allgather_object``. Per
   per op it prints event and device ms, host us from enqueue to
   ``synchronize``, bytes, and the NCCL calls and K1 launches of one call,
   and the reducescatter's 256 MiB copy alone by events and by profiler;
   then the compression path: the same LM's gradients from four seeded
   batches stand in for four ranks; the 74 that the runtime sends on the
   wire (the 25 norm scales are small leaves) chunk at 128 MiB and go
   through ``quant_sim_chunk_plan(4, AVERAGE, ...).execute_simulated`` for
   the bf16, int8 and int4 wires, error feedback over two rounds, then
   int8 and int4 without it, every chunk's outputs and residuals bitwise
   equal to the plain version; K2's, K3's (with and without error
   feedback) and the reduce-unpack's launches are counted over that run,
   then each is timed a step by events and device time beside its byte
   bound and a composite yardstick (``torch.cat(...).to(bfloat16)``,
   ``gathered.float().sum(0)``), K3 with its blocks by path (every block
   that lies in one tensor must take the register path) and the
   reduce-unpack with its rows' load widths; and the world-of-one
   fallback: one hook step with ``HOROVOD_COMPRESSION=int8`` at a world of
   one bitwise equal to the uncompressed step,
   ``hvd_quant_fallback_total{reason="world_size"}`` counting each of the
   99 gradients once;
9. the long-context path: the sp phase runs the simulated rings of
   ``parallel.sp`` (every rank of a ring in one process, each rank's rounds
   through the flash kernel) at the full-width LM's attention shape (b = 1,
   seq 8192, 16 heads of 128, bf16) for n = 2 and 4 in the blocked and
   striped layouts, and Ulysses at n = 4 (its core the kernel at seq
   8192): outputs against an fp32 reference and the kernel's
   full-sequence output under the bf16 bound, dq, dk and dv against the
   full sequence's ``scan_stats`` gradients, the kernel's launches by mask
   (diagonal, full, strict) checked; the K5 phase holds the chunked
   cross-entropy's two kernels (``xent.cu``) against their plain version on
   one chunk at N = 8192, V = 32768, d = 2048, chunk 8192, fp32, and times
   them beside their byte bound, the plain version and ``torch.logsumexp``;
   then the full-width LM at ``max_seq`` 8192, batch 1, ``remat=True`` and
   ``xent_chunk=8192`` trains 4 steps through ``DistributedOptimizer``,
   then 4 without remat, then 4 without remat and with the dense loss:
   launches checked, step ms, tokens/s, MFU and peak memory of each, the
   losses bitwise equal with and without remat and the dense loss's within
   a stated band, peak memory lower with remat and lower again with the
   chunked loss; then the zero-1 path (the plain wrapper, the whole-leaf
   front end and ``ShardedUpdateEngine`` at a world of one, bitwise the
   plain wrapper after every step; four simulated ranks bitwise a
   replicated update; K1 timed over the shard layout);
10. the resnet path: ResNet-50 (``models/resnet.py``) at 224², batch 64,
   bf16 compute over fp32 weights, ``channels_last`` activations, through
   ``resnet_probe``'s arms on one synthetic batch: ``hooks``
   (``broadcast_parameters`` of the state_dict, parameters and BN buffers,
   and ``DistributedOptimizer(SGD(0.05, momentum=0.9))``: 161 gradients
   a step through the runtime and K1) for 5 steps and ``bare`` (no
   runtime) for 3, one step of each in every round; losses finite and
   falling, the arms' first losses equal, K1 launched; img/s, MFU (8.18
   GFLOP an image forward, ``bench.py:92-94``), peak memory, the hooks'
   cost a step over bare and the runtime's counters a step; one traced
   hook step by category (convolutions and batch norm counted before the
   GEMMs). K1's check phase also holds ResNet-50's 161 fp32 gradient
   shapes bitwise, misaligned by 0, 1 and 3 elements;
11. the megaplan path: ResNet-50 as in the resnet path, 8 steps of
   ``loss.backward()``, ``hvd.grouped_allreduce_`` of every gradient
   under one name and ``opt.step()``, without ``HOROVOD_MEGAPLAN`` and
   with it at ``HOROVOD_MEGAPLAN_STABLE_ROUNDS=3``, in the order without,
   with, with, without, each run after a fresh ``hvd.init`` and with cuDNN
   deterministic: the losses and the parameters of every run bitwise the
   first's, one capture and a replay
   (``_native.chain_dispatch``: K1 pack, NCCL, K1 unpack under the stream
   contract) in each of the last 5 steps; step ms, counters a step (K1
   launches, chunks, cycles) and host ms a working cycle
   (``hvd_cycle_seconds``) of each arm; then the megaplan's counters
   after one ``DistributedOptimizer`` hook step under the megaplan;
12. K4 (``csrc/adasum.cu``, Adasum's two kernels over a table of items,
   each item a pair of rows and its row of sums): K4a (the fp32 dot and
   squared norms, no floating-point atomic) over ResNet-50's 161 pairs as
   one table, in fp32 (the path's) and off 16-byte alignment in fp32, bf16
   and fp16, twice bitwise the same, each item's sums bitwise K4a on that
   pair alone and within ``K4_SUMS_TOL`` of its plain version's; K4b (the
   scaled add) bitwise its plain version on the same sums, into a new
   buffer and in place; as tables of one at the 161 shapes in fp32,
   25.6 million elements in bf16 and fp16, rows off 16-byte alignment; a
   zero-norm side, identical rows (the mean) and orthogonal rows (the sum)
   bit for bit; a tree of four rows of one tensor, and packed rows of the
   161 tensors at 4, 5 and 8 ranks (8: a first round of 644 items, two
   launches of each kernel, checked), each tensor within ``K4_TREE_TOL``
   of the plain tree's; then each kernel timed over the 161-pair table
   (one launch) by events and device time beside its byte bound and its
   plain version, and as a table of one pair of 25.6 million fp32 rows
   beside (K4a) three ``torch.dot`` calls;
   the adasum path: four seeded batches of ResNet-50 at full width (64 at
   224², bf16 over fp32 weights), each one local SGD step from the same
   weights, give 161 deltas a virtual rank, packed into four rows as the
   runtime's Adasum chunk packs them, which go through
   ``adasum_tree_reduce_`` on K4 (the counts set to 0 just before: two
   rounds of 322 and 161 items, 2 launches of each kernel, checked) and on
   the plain version, each tensor within ``K4_TREE_TOL``; the tree of a
   step timed by events and device time beside its byte bound; the
   two-level Adasum of the packed rows as 2 hosts of 2 on K4 against the
   plain version on the CPU, per tensor; at a world of one
   ``DistributedOptimizer(op=hvd.Adasum)`` trains 3 steps bitwise equal to
   ``op=hvd.Average`` (the regular wrapper, as the JAX package's
   fallback), ``hvd.SyncBatchNorm`` agrees with ``nn.BatchNorm2d`` within
   ``SYNC_BN_TOL`` and ResNet-50 in fp32 with ``sync_bn_group`` over the
   world of one with the unsynchronized path within ``SYNC_RESNET_*_TOL``;
13. the elastic path (cuDNN deterministic, benchmark off, in every run):
   (a) ResNet-50 as in the resnet path under ``hvd.elastic.run`` with
   ``TorchState(model, optimizer, sampler, epoch, batch)`` over a seeded
   synthetic dataset read through ``ElasticSampler``
   (``elastic_probe.train_resnet``), committing every 2 steps, 8 steps
   uninterrupted, then again with a one-shot ``plan.dispatch`` fault in
   step 4: the step fails with ``HorovodInternalError``, the state goes
   back to the step-2 commit, the process builds a new NCCL communicator
   of one under generation 1 and finishes; parameters and buffers bitwise
   the uninterrupted run's; milliseconds from the failure to the next
   finished step and a commit's; (b) ``hvdrun --min-np 1 --max-np 1
   --host-discovery-script`` runs the same worker, which ``os._exit(1)``s
   after its step-4 commit to ``HOROVOD_ELASTIC_STORE``; the driver
   respawns it, it resumes from the store and its final parameters and
   buffers are bitwise (a)'s uninterrupted run's; seconds from the exit to
   incarnation 1's first step, by part; (c) the full-width LM at 2 layers
   through ``ShardedUpdateEngine`` with ``HOROVOD_ASYNC_CKPT=1``: a
   snapshot and a flush after step 1 (it allocates the pinned buffers) and
   after step 2 (it reuses them: the hot path), each with its host ms,
   copy device ms (pinned copies on a side stream), bytes and the
   writer's ms, a third step, then a
   restore into a fresh engine bitwise the snapshot's state and
   parameters; four simulated ranks' shards written and restored into
   three, bitwise ``load_full_state`` of the gathered state. The free
   disk and the bytes written are printed, the files removed. K1's
   launches over (a) and (c) are the path's;
14. observe: ResNet-50 at 224², 64 images, bf16, through
   ``DistributedOptimizer`` (cuDNN deterministic), every run after a fresh
   ``init`` (``observe_probe.py``'s functions at a world of one): (a) 8 hook
   steps with every instrument on (timeline, tracing, flight recorder,
   perf ledger, anatomy, a metrics file) and 8 with none, in turns for 3
   rounds: parameters and buffers bitwise equal across every run; the
   timeline parses, every one of the 161 gradients has its
   ``NEGOTIATE_ALLREDUCE`` and ``FUSED_ALLREDUCE`` spans, paired, once a
   step; the perf ledger's five phases, summed over each hook step's
   working cycles, come to at most the step's wall time (within 5 %); the
   anatomy's chunk entities equal the runtime's
   chunks (each timed on the card by its events); the metrics file holds
   the runtime's series and the three reports are enabled with the steps
   they saw; the median hook step of each arm beside the resnet path's;
   (b) 60 hook steps under ``HOROVOD_AUTOTUNE=1`` against 60 untuned:
   bitwise equal; every proposal is the configuration the runtime runs at
   the next sample, and each log row shows the knobs of its sample; the
   samples, their scores and the settled configuration; then the default
   and the settled configuration as fixed knobs, 8 steps each, in turns
   for 2 rounds. K1's launches over the path are the ``observe`` path's;
15. launcher: ``python -m horovod_tpu_torch.runner -np 1`` starts a worker
   that comes up through the ``TCPStore`` (on the port rank 0 bound and
   published; no ``MASTER_PORT`` is set) and the HMAC-signed KV store,
   runs ``allreduce_async_`` on named CUDA tensors, checks the results and
   exits 0; the phase fails when the worker fails.

The line before the last is one JSON object with the kernels' launches
(each on the path that runs it: the fp32 flash kernel's on the fp32 path,
K2's and K3's on the compression path, K5's on the long-context path,
K4's on the adasum path, the others' on the main path;
``launches_by_path`` gives every path's count, the resnet, megaplan,
adasum, elastic and observe paths' included), errors, times, bounds
and shares; the last line is
``{"ok": true, "device": {...}}``.
Without CUDA, or without the repository beside it, the script fails and
prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "tf32": 495e12,      # dense tensor cores
              "float32": 67e12}    # fp32 outside the tensor cores


def _log(msg: str):
    print(msg, flush=True)


def _phase(title: str):
    """A phase's heading, after dropping what earlier phases left for the
    garbage collector, with the memory still allocated on the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    _log(f"{title} (allocated at the start: "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB)")


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
    the host's work per call outlasts the device's. A device-to-device
    memcpy (``clone``) is not counted whole: on the card's machine the
    profiler records the copy's device time in some profiles and not in
    others (``clone_reading``), so an op whose device work is such a copy
    reads low here and is read by ``time_ms``."""
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
                causal: bool, route: str = "") -> tuple[float, str]:
    """Least time (ms) for the forward at these shapes: q, k, v read once,
    o, m, l written once, over HBM bandwidth; or the products over the
    causally kept (row, col) pairs, over the peak rate of the input type.
    fp32 runs on the tensor cores in 3xTF32 (three TF32 products for each
    fp32 one, the least that holds fp32's accuracy there); ``route="fma"``
    gives its bound on the fp32 FMA pipes instead."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * sq * d + 2 * B * sk * d) * item + 2 * B * sq * 4
    pairs = (sum(min(sk, r + 1) for r in range(sq)) if causal
             else sq * sk)
    flops = 2 * 2 * B * pairs * d
    if dtype == "bfloat16":
        t_ops = flops / PEAK_FLOPS["bfloat16"]
    elif route == "fma":
        t_ops = flops / PEAK_FLOPS["float32"]
    else:
        t_ops = 3 * flops / PEAK_FLOPS["tf32"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops *= 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(fns: dict, timer, rounds: int = 2) -> dict:
    """Mean of ``timer(fn)`` for each of ``fns``, taken in turns (a b b a
    for two), so drift in the card's clock or its host's load falls on
    every function alike."""
    names = list(fns)
    order = []
    for r in range(rounds):
        order += names if r % 2 == 0 else names[::-1]
    got = {name: [] for name in names}
    for name in order:
        got[name].append(timer(fns[name]))
    return {name: statistics.mean(v) for name, v in got.items()}


def share_of(bound_ms: float, dev_ms: float, ev_ms: float) -> tuple:
    """(the bound's share of a kernel's time, which time it was read
    from): its device ms, or its event ms where the device reading is
    none or under the bound by more than 5 % (the profiler dropped
    records; no kernel beats its bound). Raises if the event ms is under
    it too."""
    if dev_ms > 0 and bound_ms / dev_ms <= 1.05:
        return bound_ms / dev_ms, "device"
    if bound_ms / ev_ms > 1.05:
        raise AssertionError(f"a time under its bound: {ev_ms:.4f} ms by "
                             f"events, {dev_ms:.4f} device, bound "
                             f"{bound_ms:.4f} ms")
    _log(f"    (device time {dev_ms:.4f} ms reads under the bound "
         f"{bound_ms:.4f} ms: the share is read from events)")
    return bound_ms / ev_ms, "events"


# --- phase 2: build ---------------------------------------------------------

SOURCES = ("flash_attention_sm90", "flash_attention_tf32", "fused_pack",
           "quant_wire", "xent", "adasum")


def _tensor_core_ops(lib: str) -> dict:
    """The library's SASS tensor-core instructions (``cuobjdump``), counted
    by opcode."""
    from horovod_tpu_torch.ops import _build

    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "--dump-sass",
                           _build.lib_path(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops: dict = {}
    for line in sass.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith(("HGMMA", "HMMA")):
                ops[word] = ops.get(word, 0) + 1
    return ops


def build_phase():
    """Builds every kernel source at once (one nvcc each) and checks that
    both flash kernels' SASS runs on the tensor cores: HGMMA (wgmma) in
    the bf16 one, HGMMA in TF32 in the fp32 one."""
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
    for lib, kind in (("flash_attention_sm90", "BF16"),
                      ("flash_attention_tf32", "TF32")):
        ops = _tensor_core_ops(lib)
        n = sum(c for op, c in ops.items() if kind in op)
        _log(f"  {lib} SASS: {sum(ops.values())} tensor-core instructions, "
             f"{n} of them {kind}: {ops}")
        if n == 0:
            raise AssertionError(f"{lib} has no {kind} HGMMA/HMMA "
                                 "instruction: it does not run on the "
                                 "tensor cores")


# --- phase 3: flash attention against its plain version ----------------------

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
    kernels[0]["long_context_shape"] = time_flash_long_context(device)
    return kernels


def time_flash_long_context(device, B: int = 16, s: int = 8192,
                            d: int = 128) -> dict:
    """The bf16 kernel at the long-context path's shape (B = heads = 16,
    s = 8192, causal) in turns with ``scaled_dot_product_attention`` on
    the same inputs, by events and device time, beside its bound."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(B, s, d, torch.bfloat16, 11, device)
    q4, k4, v4 = q[None], k[None], v[None]
    fns = {"kernel": lambda: fa.attention_stats(q, k, v, True),
           "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)}
    ev = in_turns(fns, lambda fn: time_ms(fn, iters=20))
    dev = in_turns(fns, lambda fn: device_ms(fn, iters=20))
    bound_ms, bound_by = flash_bound(B, s, s, d, "bfloat16", True)
    _log(f"  flash_attention_fwd at the long-context shape (B = {B}, s = "
         f"{s}, d = {d}, bf16, causal): kernel {ev['kernel']:.4f} ms a "
         f"call, {dev['kernel']:.4f} device ({bound_ms / dev['kernel']:.3f}"
         f" of its bound {bound_ms:.4f} ms, {bound_by}); sdpa "
         f"{ev['sdpa']:.4f} ms, {dev['sdpa']:.4f} device")
    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    return {"B": B, "s": s, "d": d, "ms": ev["kernel"],
            "device_ms": dev["kernel"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ev["sdpa"],
            "library_device_ms": dev["sdpa"]}


def time_flash(name, B, s, d, dtype, iters, device) -> dict:
    """One kernel at the slice shape: checked against its plain version,
    then timed beside it, its bound and ``scaled_dot_product_attention``
    on the same inputs. ``ms``, ``plain_ms`` and ``library_ms`` are CUDA
    events around back-to-back calls, the host's work per call included;
    ``device_ms`` and ``library_device_ms`` are the kernels' own time,
    and ``share`` is the bound over ``device_ms``. Kernel and sdpa are
    timed in turns (kernel, sdpa, sdpa, kernel)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    err = check_flash(B, s, d, dtype, True, 0, device)
    torch.cuda.empty_cache()
    q, k, v = _qkv(B, s, d, dtype, 7, device)
    q4, k4, v4 = q[None], k[None], v[None]
    fns = {"kernel": lambda: fa.attention_stats(q, k, v, True),
           "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)}
    ev = in_turns(fns, lambda fn: time_ms(fn, iters=iters))
    dev = in_turns(fns, lambda fn: device_ms(fn, iters=iters))
    plain_ms = time_ms(lambda: fa.lax_stats(q, k, v, True, 0), iters=5)
    dt = str(dtype)[6:]
    bound_ms, bound_by = flash_bound(B, s, s, d, dt, True)
    flops = 2 * 2 * B * (s * (s + 1) // 2) * d
    extra = ""
    if dtype == torch.float32:
        fma_ms = flash_bound(B, s, s, d, dt, True, route="fma")[0]
        extra = (f"; on the fp32 FMA pipes the bound would be {fma_ms:.4f} "
                 f"ms ({fma_ms / dev['kernel']:.3f} of it)")
    _log(f"  {name} at the slice shape ({dt}): kernel {ev['kernel']:.4f} ms "
         f"a call back to back, {dev['kernel']:.4f} ms of device time "
         f"({flops / dev['kernel'] / 1e9:.1f} TFLOP/s of the kept pairs, "
         f"{bound_ms / dev['kernel']:.3f} of its bound); sdpa "
         f"{ev['sdpa']:.4f} ms a call, {dev['sdpa']:.4f} ms of device time; "
         f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})"
         + extra)
    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    source = fa.KERNELS[dtype][1]
    return {"name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{source}.cu",
            "replaces": "horovod_tpu/ops/pallas/flash_attention.py:122",
            "launches": None, "max_abs_err": err, "ms": ev["kernel"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": ev["sdpa"], "device_ms": dev["kernel"],
            "library_device_ms": dev["sdpa"],
            **dict(zip(("share", "share_by"),
                       share_of(bound_ms, dev["kernel"], ev["kernel"])))}


# --- phase 4: K1, the fused-chunk pack and unpack --------------------------

def _same_bits(a, b) -> bool:
    """Bit for bit, any dtype (NaNs and signed zeros included)."""
    import torch

    iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
          8: torch.int64}[a.element_size()]
    return (a.dtype == b.dtype
            and torch.equal(a.contiguous().view(iv), b.contiguous().view(iv)))


def _k1_case(dtype, sizes, pre, unpack_factor, device, seed, misalign=0):
    """Pack then unpack one chunk through the port's dispatch and through
    the plain version, on the same inputs; both directions must agree bit
    for bit. ``misalign`` starts every tensor and the flat buffer that
    many elements past an allocation's 16-byte-aligned start."""
    import torch

    from horovod_tpu_torch.ops import fused_pack as fp

    g = torch.Generator(device=device).manual_seed(seed)

    def buf(n):
        t = torch.randn(n + misalign, generator=g, device=device,
                        dtype=torch.float32).to(dtype)
        return t[misalign:]

    srcs = [buf(n) for n in sizes]
    total = sum(sizes)
    flat_k, flat_p = buf(total), buf(total)
    fp.pack(srcs, flat_k, pre)
    fp.plain_pack(srcs, flat_p, pre)
    ok = _same_bits(flat_k, flat_p)
    outs_k = [buf(n) for n in sizes]
    outs_p = [o.clone() for o in outs_k]
    fp.unpack(flat_k, outs_k, unpack_factor)
    fp.plain_unpack(flat_k, outs_p, unpack_factor)
    return ok and all(_same_bits(a, b) for a, b in zip(outs_k, outs_p))


# (prescale, unpack factor): factors 1, 0.5 and 1/3; AVERAGE over 3 ranks
# with the 1/n in the unpack (a backend without AVG) and without it (NCCL's
# AVG divides, the unpack applies the postscale alone); factors that no
# half-precision type holds exactly (0.1, 0.7), which bf16 and fp16 chunks
# round to their dtype before they multiply
K1_FACTORS = ((1.0, 1.0), (0.5, 1.0), (1.0 / 3.0, 1.0), (1.0, 0.5),
              (1.0, 1.0 / 3.0), (2.0, 0.5 / 3.0), (0.1, 0.7))


def k1_check_phase(device) -> float:
    """Every case bitwise; returns the largest |kernel - plain| (0)."""
    import random

    import torch

    rng = random.Random(0)
    ragged = [0, 1, 7, 33, 1024, 4099, 3 * 4096 + 5]
    many = [rng.randint(0, 70) for _ in range(300)]  # > 128 per launch
    # millions of elements: many blocks, whose tiles start and end inside
    # tensors, and odd lengths that leave later tensors off the flat
    # buffer's 16-byte phase
    large = [1_000_003, 5, 777_777, 0, 2_500_001]
    layouts = (("ragged", ragged, 0), ("ragged, unaligned starts", ragged, 1),
               ("300 tensors", many, 0), ("300 tensors, unaligned", many, 3),
               ("large", large, 0), ("large, unaligned", large, 2))
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64):
        factors = K1_FACTORS if dtype != torch.float64 else K1_FACTORS[:3]
        for pre, post in factors:
            for label, sizes, mis in layouts:
                n += 1
                if not _k1_case(dtype, sizes, pre, post, device, n, mis):
                    raise AssertionError(
                        f"K1 differs from its plain version: {dtype}, "
                        f"prescale {pre}, unpack factor {post}, {label}")
    # ResNet-50's 161 gradients in the order the backward makes them
    # ready, fp32, from aligned and misaligned starts, at factors 1 and
    # AVERAGE over 4 ranks with the divide in the unpack
    sizes = resnet50_grad_sizes()
    for pre, post in ((1.0, 1.0), (1.0, 0.25)):
        for mis in (0, 1, 3):
            n += 1
            if not _k1_case(torch.float32, sizes, pre, post, device, n,
                            mis):
                raise AssertionError(
                    "K1 differs from its plain version on ResNet-50's "
                    f"gradients: prescale {pre}, unpack factor {post}, "
                    f"misaligned by {mis}")
    torch.cuda.synchronize()
    _log(f"  K1: {n} cases (fp32, bf16, fp16, fp64; ragged lengths with 0 "
         "and 1 element; unaligned starts; 300 tensors a chunk; 4.3 million "
         "elements a chunk; factors "
         f"{sorted({f for c in K1_FACTORS for f in c})}; ResNet-50's "
         f"{len(sizes)} fp32 gradients, {sum(sizes)} elements, misaligned by "
         "0, 1 and 3): pack and unpack bitwise equal to the plain version")
    return 0.0


def resnet50_grad_sizes() -> list:
    """The element counts of ResNet-50's parameters, in the order the
    backward makes their gradients ready (the reverse of
    ``named_parameters``)."""
    from horovod_tpu_torch.models.resnet import ResNet50

    model = ResNet50(device="meta")
    return [p.numel() for p in reversed(list(model.parameters()))]


def lm_param_shapes(cfg) -> list:
    """The LM's parameter shapes in ``named_parameters`` order."""
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    block = [(d, h, hd), (d, h, hd), (d, h, hd), (h, hd, d), (d, f), (f, d),
             (d,), (d,)]
    return ([(cfg.vocab_size, d), (cfg.max_seq, d), (d,)]
            + block * cfg.n_layers)


FUSION_THRESHOLD = 128 << 20  # the runtime's default (common/env.py)


def slice_chunks(cfg, threshold: int = FUSION_THRESHOLD) -> list:
    """The chunks, as lists of shapes, that the runtime forms when one
    cycle takes every fp32 gradient of a step: in the order the backward
    makes them ready (the reverse of ``named_parameters``), cut at the
    fusion threshold."""
    chunks, chunk, nbytes = [], [], 0
    for s in reversed(lm_param_shapes(cfg)):
        sz = math.prod(s) * 4
        if chunk and nbytes + sz > threshold:
            chunks.append(chunk)
            chunk, nbytes = [], 0
        chunk.append(s)
        nbytes += sz
    chunks.append(chunk)
    return chunks


def k1_time_phase(device, cfg) -> list:
    """Pack and unpack of one step's gradients in the chunks that the main
    path's grouped steps form (``slice_chunks``); the chunks of one tensor
    are reduced in place with no pack and are left out. Each packed chunk
    is first held bitwise against the plain version, both directions, on
    the same inputs. Factor 1, as on the main path (AVERAGE through NCCL's
    AVG, no scale factors)."""
    import torch

    from horovod_tpu_torch.ops import fused_pack as fp

    chunks = [[torch.randn(s, device=device) for s in c]
              for c in slice_chunks(cfg)]
    grads = [t for c in chunks for t in c]
    packed = [c for c in chunks if len(c) > 1]
    flats = [torch.empty(sum(t.numel() for t in c), device=device)
             for c in packed]
    moved = sum(f.numel() * 4 for f in flats)
    _log(f"  K1 at the slice's gradients: {len(grads)} fp32 gradients, "
         f"{sum(t.numel() for t in grads) * 4 / 1e9:.3f} GB, "
         f"{len(chunks)} chunks at {FUSION_THRESHOLD >> 20} MiB, "
         f"{len(packed)} packed ({moved / 1e9:.3f} GB)")
    # every packed chunk, both directions, bitwise against the plain version
    for i, (c, f) in enumerate(zip(packed, flats)):
        ref = torch.empty_like(f)
        fp.pack(c, f)
        fp.plain_pack(c, ref)
        outs_k = [torch.empty_like(t) for t in c]
        outs_p = [torch.empty_like(t) for t in c]
        fp.unpack(f, outs_k)
        fp.plain_unpack(f, outs_p)
        if not (_same_bits(f, ref)
                and all(_same_bits(a, b) and _same_bits(a, t)
                        for a, b, t in zip(outs_k, outs_p, c))):
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"packed chunk {i} ({len(c)} tensors)")
        del ref, outs_k, outs_p
    _log(f"  K1: the {len(packed)} packed chunks, pack and unpack, bitwise "
         "equal to the plain version (and unpack restores every gradient)")

    def pack():
        for c, f in zip(packed, flats):
            fp.pack(c, f)

    def unpack():
        for c, f in zip(packed, flats):
            fp.unpack(f, c)

    def plain_pack():
        for c, f in zip(packed, flats):
            fp.plain_pack(c, f)

    def plain_unpack():
        for c, f in zip(packed, flats):
            fp.plain_unpack(f, c)

    def lib_pack():
        for c, f in zip(packed, flats):
            torch.cat([t.view(-1) for t in c], out=f)

    def lib_unpack():
        for c, f in zip(packed, flats):
            for t, part in zip(c, torch.split(f, [t.numel() for t in c])):
                t.view(-1).copy_(part)

    bound_ms = 2 * moved / HBM_BYTES_PER_S * 1e3  # each byte read + written
    out = []
    for name, kfn, pfn, lfn, src in (
            ("fused_pack", pack, plain_pack, lib_pack,
             "horovod_tpu/ops/collectives.py:777"),
            ("fused_unpack", unpack, plain_unpack, lib_unpack,
             "horovod_tpu/ops/collectives.py:740")):
        # kernel and library in turns (kernel, library, library, kernel)
        fns = {"kernel": kfn, "library": lfn}
        ev = in_turns(fns, lambda fn: time_ms(fn, iters=10))
        dev = in_turns(fns, lambda fn: device_ms(fn, iters=5, warmup=1))
        plain = time_ms(pfn, iters=5)
        _log(f"  {name}: {ev['kernel']:.4f} ms a step by events, "
             f"{dev['kernel']:.4f} ms of device time "
             f"({2 * moved / dev['kernel'] / 1e6:.0f} GB/s, "
             f"{bound_ms / dev['kernel']:.3f} of its bound {bound_ms:.4f} "
             f"ms); torch.cat/split + copy_ {ev['library']:.4f} ms "
             f"({dev['library']:.4f} device, kernel/library "
             f"{dev['kernel'] / dev['library']:.4f}); plain {plain:.4f} ms")
        out.append({"name": name, "route": "cuda",
                    "source": "horovod_tpu_torch/csrc/fused_pack.cu",
                    "replaces": src, "launches": None, "max_abs_err": 0.0,
                    "ms": ev["kernel"], "plain_ms": plain,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": ev["library"], "device_ms": dev["kernel"],
                    "library_device_ms": dev["library"],
                    **dict(zip(("share", "share_by"),
                               share_of(bound_ms, dev["kernel"],
                                        ev["kernel"])))})
    _log(f"  pack + unpack a step: {out[0]['ms'] + out[1]['ms']:.4f} ms by "
         f"events, {out[0]['device_ms'] + out[1]['device_ms']:.4f} ms of "
         f"device time; bound {2 * bound_ms:.4f} ms")
    del chunks, grads, packed, flats
    torch.cuda.empty_cache()
    return out


# the layouts of a ragged allgather's compaction: per nproc, each rank's
# rows, with ranks of 0 and 1 rows
COMPACT_SIZES = {2: [3, 0], 4: [5, 0, 1, 2], 8: [1, 0, 4, 0, 1, 3, 2, 0]}
COMPACT_TIMED = (4, [8192, 6000, 0, 1], (2048,))  # sized from the LM


def _ragged(nproc, sizes, rest, dtype, device, seed, mis=0):
    """A gathered buffer of ``nproc * max(sizes)`` rows of ``rest``,
    starting ``mis`` elements past its allocation."""
    import torch

    maxn, row = max(sizes), math.prod(rest)
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(nproc * maxn * row + mis, generator=g, device=device)
    if dtype in (torch.int32, torch.uint8):
        buf = (buf * 30).abs()
    buf = buf.to(dtype)[mis:]
    return buf.view((nproc * maxn,) + rest), maxn, row


def k1_compaction_phase(device) -> dict:
    """K1 as a ragged allgather's compaction: bitwise against its plain
    version in every layout, then timed at the LM-sized layout, kernel
    and ``torch.cat`` of the same slices in turns. Returns the readings."""
    import torch

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import fused_pack as fp

    n = 0
    for nproc, sizes in COMPACT_SIZES.items():
        for rest in ((2048,), (3,), ()):
            for dtype in (torch.float32, torch.bfloat16, torch.int32,
                          torch.uint8):
                for mis in (0, 1):
                    n += 1
                    gathered, maxn, row = _ragged(nproc, sizes, rest, dtype,
                                                  device, n, mis)
                    out = torch.empty((sum(sizes),) + rest, dtype=dtype,
                                      device=device)
                    ref = torch.empty_like(out)
                    C.compact_rows(gathered, sizes, maxn, row, out)
                    parts = [gathered.view(-1)[i * maxn * row:
                                               (i * maxn + s) * row]
                             for i, s in enumerate(sizes) if s]
                    fp.plain_pack(parts, ref.view(-1))
                    if not _same_bits(out, ref):
                        raise AssertionError(
                            f"K1's compaction differs from its plain version"
                            f": nproc {nproc}, rows {sizes}, rest {rest}, "
                            f"{dtype}, misaligned by {mis}")
    _log(f"  K1 compaction: {n} layouts (nproc 2, 4, 8; rows with 0 and 1; "
         "rows of [2048], [3], []; fp32, bf16, int32, uint8; aligned and "
         "misaligned slice starts) bitwise equal to the plain version")
    nproc, sizes, rest = COMPACT_TIMED
    gathered, maxn, row = _ragged(nproc, sizes, rest, torch.bfloat16,
                                  device, 0)
    out = torch.empty((sum(sizes),) + rest, dtype=torch.bfloat16,
                      device=device)
    parts = [gathered[i * maxn:i * maxn + s] for i, s in enumerate(sizes)
             if s]
    C.compact_rows(gathered, sizes, maxn, row, out)
    if not _same_bits(out, torch.cat(parts)):
        raise AssertionError("K1's compaction differs from torch.cat at "
                             "the timed layout")
    fns = {"kernel": lambda: C.compact_rows(gathered, sizes, maxn, row, out),
           "library": lambda: torch.cat(parts, out=out)}
    ev = in_turns(fns, lambda fn: time_ms(fn, iters=20))
    dev = in_turns(fns, lambda fn: device_ms(fn, iters=10))
    plain = time_ms(lambda: fp.plain_pack([p.view(-1) for p in parts],
                                          out.view(-1)), iters=5)
    moved = out.numel() * out.element_size()
    bound = 2 * moved / HBM_BYTES_PER_S * 1e3
    _log(f"  K1 compaction at nproc {nproc}, rows {sizes} of {list(rest)} "
         f"bf16 ({moved / 2**20:.1f} MiB): {ev['kernel']:.4f} ms by events, "
         f"{dev['kernel']:.4f} ms of device time ({bound / dev['kernel']:.3f}"
         f" of its bound {bound:.4f} ms); torch.cat {ev['library']:.4f} ms "
         f"({dev['library']:.4f} device); plain {plain:.4f} ms")
    del gathered, out, parts
    torch.cuda.empty_cache()
    return {"compact_cases": n, "compact_ms": ev["kernel"],
            "compact_device_ms": dev["kernel"], "compact_plain_ms": plain,
            "compact_bound_ms": bound, "compact_library_ms": ev["library"],
            "compact_library_device_ms": dev["library"],
            **dict(zip(("compact_share", "compact_share_by"),
                       share_of(bound, dev["kernel"], ev["kernel"])))}


# --- K2 and K3: the compressed wire against its plain version --------------

# (ranks, AVERAGE, postscale) cycled over the cases
WIRE_REDUCE = ((1, False, 1.0), (2, True, 0.5), (3, True, 1.0),
               (4, False, 0.5), (8, True, 0.5), (3, False, 0.5))
# one layer's wire gradients of the full-width LM, in backward order:
# the FFN's two matrices, then o, v, k, q
LM_LAYER = [8192 * 2048, 2048 * 8192] + [2048 * 2048] * 4


def _wire_specs() -> list:
    """The bf16 cast wire, and int8 and int4 at blocks 8, 9 (int4: 10),
    256 and 1000."""
    from horovod_tpu_torch.ops import compression as comp

    return [comp.make_cast_spec()] + [
        comp.make_quant_spec(bits, block, True)
        for bits in (8, 4) for block in (8, 9, 256, 1000)]


def _wire_tensors(sizes, dtype, device, seed, mis, spec, special):
    """A chunk's tensors, each starting ``mis`` elements past an
    allocation; with ``special`` the chunk's first three blocks are all
    zeros, a block whose absmax recurs at both signs (q = +-qmax), and a
    block of exact .5 ties of x / scale (absmax qmax * 0.5, so the bf16
    scale is 0.5, and values (k + 0.5) * 0.5)."""
    import torch

    total, block, qmax = sum(sizes), spec.block, spec.qmax
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    if special and spec.bits != 16 and total >= 3 * block:
        flat[:block] = 0
        sat = flat[block:2 * block]
        sat[::3] = 5.0
        sat[1::3] = -5.0
        ties = flat[2 * block:3 * block]
        k = torch.arange(block, device=device) % int(qmax)
        ties.copy_((k + 0.5) * 0.5 * torch.where(k % 2 == 0, 1.0, -1.0))
        ties[0] = qmax * 0.5
    out, off = [], 0
    for n in sizes:
        buf = torch.empty(n + mis, dtype=dtype, device=device)[mis:]
        buf.copy_(flat[off:off + n])
        out.append(buf)
        off += n
    return out


def _wire_case(spec, dtype, sizes, mis, special, pre, nrows, average, post,
               device, seed) -> None:
    """``nrows`` virtual ranks through the kernels and through the plain
    versions on the same inputs: every rank's row and new residual, over
    two rounds with error feedback (the second folds the first's
    residual, one tensor of its own a tensor, every third tensor
    without), and the reduce-unpack of the gathered rows, bit for
    bit."""
    import torch

    from horovod_tpu_torch.ops import quant_wire as qw

    total = sum(sizes)
    nb = qw.row_bytes(total, spec)
    ef = spec.bits != 16 and spec.error_feedback
    gathered = torch.empty(nrows * nb, dtype=torch.uint8, device=device)
    res = [None] * nrows
    # the kernel's own count of its register-path blocks, against the
    # wrapper's count by the same rule
    reg_blocks = torch.zeros(1, dtype=torch.int64, device=device)
    reg0 = qw.quantize_paths["register"]
    for rnd in range(2 if ef else 1):
        for r in range(nrows):
            ts = _wire_tensors(sizes, dtype, device, seed + 97 * r + rnd,
                               mis, spec, special)
            row = gathered[r * nb:(r + 1) * nb]
            ref = torch.empty(nb, dtype=torch.uint8, device=device)
            if spec.bits == 16:
                qw.cast_pack(ts, row, pre)
                qw.plain_cast_pack(ts, ref, pre)
            else:
                new = torch.empty(total, device=device) if ef else None
                new_p = torch.empty(total, device=device) if ef else None
                if res[r] is not None:
                    res[r] = [None if i % 3 == 1 else part.clone()
                              for i, part in enumerate(torch.split(
                                  res[r], list(sizes)))]
                qw.quantize_pack(ts, row, spec, pre, res[r], new,
                                 reg_blocks=reg_blocks)
                qw.plain_quantize_pack(ts, ref, spec, pre, res[r], new_p)
                if ef and not _same_bits(new, new_p):
                    raise AssertionError("K3's residual differs")
                res[r] = new
            if not _same_bits(row, ref):
                raise AssertionError("the packed row differs")
        outs = _wire_tensors(sizes, dtype, device, seed + 1, mis, spec,
                             False)
        outs_p = [o.clone() for o in outs]
        qw.reduce_unpack(gathered, outs, spec, nrows, average, post)
        qw.plain_reduce_unpack(gathered, outs_p, spec, nrows, average, post)
        if not all(_same_bits(a, b) for a, b in zip(outs, outs_p)):
            raise AssertionError("the reduce-unpack differs")
    if int(reg_blocks.item()) != qw.quantize_paths["register"] - reg0:
        raise AssertionError(
            f"K3 took {int(reg_blocks.item())} blocks on the register path, "
            f"the wrapper counted {qw.quantize_paths['register'] - reg0}")


def wire_check_phase(device) -> int:
    """K2, K3 and the reduce-unpack bitwise against their plain versions:
    every wire and block, chunk dtypes fp32, bf16 and fp16, lengths 1,
    block - 1 and block + 1, the special blocks, 300 tensors a chunk (more
    than a table holds), misaligned starts, a chunk of 4.3 million
    elements; at block 256 also odd block counts (rows that start off
    16-byte alignment), a block across a tensor boundary, starts 1, 2 and
    3 elements in, and one LM layer's gradients in bf16 and fp16; error
    feedback on and off, prescale 1 and 0.7, and ranks, op and postscale
    cycled over ``WIRE_REDUCE``. K3's register-path blocks, counted by the
    kernel itself, must equal the wrapper's count in every case, and both
    paths must run."""
    import random

    import torch

    from horovod_tpu_torch.ops import quant_wire as qw

    rng = random.Random(1)
    n, seen = 0, set()
    paths0 = dict(qw.quantize_paths)
    for spec in _wire_specs():
        b = spec.block if spec.bits != 16 else 256
        layouts = [([1], 0, False), ([b - 1], 0, False),
                   ([b + 1], 0, False),
                   ([3 * b + 5, 7, b + 3], 0, True),
                   ([3 * b + 5, 7, 2 * b + 1], 1, True),
                   ([rng.randint(0, 70) for _ in range(300)], 0, False)]
        if b == 256:
            layouts += [
                ([1_000_003, 5, 777_777, 0, 2_500_001], 3, True),
                # odd block counts: rows 1-3 start off 16-byte alignment
                ([3 * b + 1], 0, False), ([2 * b + 1], 0, True),
                # a block across a tensor boundary
                ([300, 500, 4 * b], 0, True),
                # starts 1, 2 and 3 elements past an allocation
                ([1000, 3 * b + 7, 40], 1, False),
                ([1000, 3 * b + 7, 40], 2, True),
                ([1000, 3 * b + 7, 40], 3, False)]
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            lm = ([(LM_LAYER, 0, False)] if b == 256
                  and dtype != torch.float32 else [])
            for sizes, mis, special in layouts + lm:
                n += 1
                ef = spec.bits != 16 and n % 2 == 0
                case = spec._replace(error_feedback=ef)
                pre = (1.0, 0.7)[(n // 2) % 2]
                nrows, average, post = WIRE_REDUCE[n % len(WIRE_REDUCE)]
                seen.add((ef, pre, nrows, average, post))
                try:
                    _wire_case(case, dtype, sizes, mis, special, pre, nrows,
                               average, post, device, n)
                except AssertionError as e:
                    raise AssertionError(
                        f"{e}: {case}, {dtype}, {len(sizes)} tensors of "
                        f"{sum(sizes)} elements, misaligned by {mis}, "
                        f"prescale {pre}, {nrows} ranks, "
                        f"{'AVERAGE' if average else 'SUM'}, postscale "
                        f"{post}") from None
    torch.cuda.synchronize()
    paths = {k: v - paths0[k] for k, v in qw.quantize_paths.items()}
    _log(f"  K2/K3: {n} cases (bf16, int8 and int4 at blocks 8, 9/10, 256, "
         "1000; fp32, bf16, fp16 chunks; lengths 1, block -+ 1; zero, "
         "saturating and tie blocks; 300 tensors; misaligned by 1-3 "
         "elements; odd block counts (rows off 16-byte alignment); a block "
         "across tensors; 4.3 million elements; an LM layer's "
         f"{sum(LM_LAYER)} elements in bf16 and fp16; {len(seen)} "
         "combinations of error feedback, prescale 1/0.7, 1-8 ranks, "
         "SUM/AVERAGE, postscale 1/0.5): rows, residuals and outputs "
         f"bitwise equal to the plain version; K3's blocks by path {paths}, "
         "the kernel's own count of register blocks equal to the "
         "wrapper's in every case")
    if not (paths["register"] and paths["general"]):
        raise AssertionError(f"a K3 path never ran in the wire check: "
                             f"{paths}")
    return n


# --- phase 5: the main path at full width ---------------------------------

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


def _runtime_counts() -> dict:
    """The runtime's counters that a step moves."""
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import fused_pack as fp
    from horovod_tpu_torch.utils import metrics

    rt = context.runtime()
    return {"chunks": rt.chunks, "collective calls": rt.collective_calls,
            "K1 launches": sum(fp.kernel_launches.values()),
            "negotiation rounds": int(metrics.get_registry().counter_value(
                "hvd_negotiation_rounds_total")),
            "cycles": rt.cycles}


def train(cfg, batch: int, steps: int, device, trace: bool = True,
          mode: str = "hooks") -> dict:
    """Horovod's training loop through the port's entry points. Returns
    the losses, step times, kernel launches, the runtime's counters per
    step and peak memory of ``steps`` steps; with ``trace``, one more step
    is traced with ``torch.profiler``. ``mode``: ``"hooks"``,
    ``DistributedOptimizer``'s gradient hooks; ``"grouped"``, the bare
    optimizer after one ``hvd.grouped_allreduce_`` of every gradient in
    the order the backward makes them ready; ``"bare"``, the bare
    optimizer with no runtime, the floor the runtime's cost is read
    against."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import ring_attention

    model = TransformerLM(cfg, device=device, seed=0)
    tokens = tokens_for(cfg, batch, 0, device)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=1e-3, momentum=0.9)
    horovod = mode != "bare"
    if horovod:
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    if [tuple(p.shape) for p in params] != lm_param_shapes(cfg):
        raise AssertionError("lm_param_shapes does not list the model's "
                             "parameters in order")
    if mode == "hooks":
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())

    def step():
        opt.zero_grad()
        loss = lm_loss(model, tokens, attn_fn=ring_attention)
        loss.backward()
        if mode == "grouped":
            hvd.grouped_allreduce_([p.grad for p in reversed(params)],
                                   name="grads")
        opt.step()
        return loss.item()  # waits for the step's device work

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, per_step = [], [], []
    _zero_launch_counts()  # just before the path runs
    for _ in range(steps):
        c0 = _runtime_counts() if horovod else {}
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
        c1 = _runtime_counts() if horovod else {}
        per_step.append({k: c1[k] - c0[k] for k in c0})
    launches = _launch_counts()
    res = {"losses": losses, "step_s": step_s, "launches": launches,
           "per_step": per_step,
           "peak_bytes": torch.cuda.max_memory_allocated(), "profile": None}
    if trace:
        res["profile"] = profile_step(step)
    del model, params, opt
    gc.collect()  # the optimizer's gradient hooks hold it in a cycle
    torch.cuda.empty_cache()
    return res


# kernel-name patterns of the step's device work, first match wins
_CATEGORIES = (("flash forward kernel", r"flash_fwd"),
               # K1 and K2 are one template over the tensor table, K1 with
               # fused_pack.cu's ops, K2 with quant_wire.cu's CastOp
               ("fused pack/unpack (K1)",
                r"table_copy_kernel<(Copy|F32|F64|BF16|F16)Op"),
               ("wire kernels (K2, K3, reduce-unpack)",
                r"table_copy_kernel<CastOp|quantize_pack_kernel|"
                r"reduce_unpack_kernel"),
               ("chunked cross-entropy (K5)", r"xent_(fwd|bwd)_chunk"),
               ("Adasum (K4)", r"adasum_(dot_norms|scaled_add)"),
               # cuDNN's and torch's batch-norm kernels, then cuDNN's
               # convolutions (their Hopper kernels carry xmma in their
               # names, as cuBLAS's do) and its layout transposes
               ("batch norm", r"batch_norm|bn_fw|bn_bw|batchnorm"),
               ("convolution", r"conv|fprop|dgrad|wgrad|nchwToNhwc|"
                r"nhwcToNchw"),
               ("fp32 GEMM", r"f32f32|sgemm"),
               ("other GEMM (bf16)", r"gemm|nvjet|xmma|cutlass"),
               ("NCCL (one-rank kernels included)", r"nccl|onerank"),
               ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
               ("elementwise, reduce, copy", r""))


def _annotation(name: str) -> bool:
    """A user annotation that the profiler lists on the device beside the
    kernels it spans (``nccl:<op>``, ``Optimizer.step#SGD.step``):
    counted, their time would count twice, and its span would cover gaps.
    (Kernel names may hold a ``#`` too, in a lambda's ``{lambda()#1}``.)"""
    return name.startswith(("nccl:", "Optimizer.", "ProfilerStep"))


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
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == cuda and not _annotation(e.key)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    # the union of the kernels' intervals over all streams (overlapping
    # streams counted once), and the longest gaps in it
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == cuda and not _annotation(e.name))
    union, gaps = 0.0, []
    s0, e0, n0 = spans[0]
    for s1, e1, n1 in spans[1:]:
        if s1 > e0:
            gaps.append(((s1 - e0) / 1e3, n0[:40], n1[:40]))
            union += e0 - s0
            s0, e0 = s1, e1
        elif e1 > e0:
            e0 = e1
        n0 = n1 if e1 >= e0 else n0
    union = (union + e0 - s0) / 1e3
    cats = {name: 0.0 for name, _ in _CATEGORIES}
    for e in events:
        name = next(n for n, pat in _CATEGORIES if re.search(pat, e.key))
        cats[name] += e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "union_ms": union,
            "gaps": sorted(gaps, reverse=True)[:6], "categories": cats,
            "top": [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


def _log_profile(prof: dict):
    idle = max(0.0, 1.0 - prof["union_ms"] / prof["wall_ms"])
    _log(f"  traced step: wall {prof['wall_ms']:.1f} ms, device kernels "
         f"{prof['device_ms']:.1f} ms summed over streams, "
         f"{prof['union_ms']:.1f} ms busy on any stream; idle share "
         f"{idle:.4f}; longest gaps (ms, after, before): {prof['gaps']}")
    _log("  top kernels (calls, ms):")
    for name, calls, ms in prof["top"]:
        _log(f"    {ms:9.3f}  {calls:5d}  {name}")
    _log("  device ms by category:")
    for name, ms in prof["categories"].items():
        _log(f"    {ms:9.3f}  {name}")


def main_path_phase(device) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    cfg = full_width_config(12)
    batch, steps, grouped_steps = 8, 5, 3
    res = train(cfg, batch, steps, device)
    losses = res["losses"]
    _log(f"  losses: {losses}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for i, counts in enumerate(res["per_step"]):
        _log(f"  step {i}: " + ", ".join(f"{k} {v}"
                                          for k, v in counts.items()))
    want = {"flash_attention_fwd": cfg.n_layers * steps,
            "flash_attention_fwd_fp32": 0}
    if {k: res["launches"][k] for k in want} != want:
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
         f"launches {res['launches']}")
    _log_profile(res["profile"])

    # every gradient enqueued at once: the chunks are known in advance
    grp = train(cfg, batch, grouped_steps, device, trace=False,
                mode="grouped")
    chunks = slice_chunks(cfg)
    n_packed = sum(len(c) > 1 for c in chunks)
    expect = {"chunks": len(chunks), "collective calls": len(chunks),
              "K1 launches": 2 * n_packed}
    for i, counts in enumerate(grp["per_step"]):
        _log(f"  grouped step {i}: " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))
        if {k: counts[k] for k in expect} != expect:
            raise AssertionError(f"grouped step {i} ran {counts}, expected "
                                 f"{expect}")
    _log(f"  grouped losses: {grp['losses']}; step ms "
         f"{[round(x * 1e3, 1) for x in grp['step_s']]}")
    launches = {k: v + grp["launches"][k]
                for k, v in res["launches"].items()}
    if grp["launches"]["flash_attention_fwd"] != cfg.n_layers * grouped_steps:
        raise AssertionError(f"grouped run launched {grp['launches']}")

    # the same steps with every tensor its own chunk: no pack, no unpack
    hvd.shutdown()
    os.environ["HOROVOD_FUSION_THRESHOLD"] = "0"
    try:
        hvd.init()
        ref = train(cfg, batch, steps, device, trace=False)
        hvd.shutdown()
    finally:
        del os.environ["HOROVOD_FUSION_THRESHOLD"]
    hvd.init()
    _log(f"  unfused (HOROVOD_FUSION_THRESHOLD=0) losses: {ref['losses']}; "
         f"per step {ref['per_step'][-1]}; step ms "
         f"{[round(x * 1e3, 1) for x in ref['step_s']]}")
    if ref["launches"]["fused_pack"] or ref["launches"]["fused_unpack"]:
        raise AssertionError("the unfused run packed: "
                             f"{ref['launches']}")
    if ref["losses"] != losses:
        raise AssertionError(
            f"the hook run's losses {losses} differ from the unfused run's "
            f"{ref['losses']}")
    if grp["losses"] != ref["losses"][:grouped_steps]:
        raise AssertionError(
            f"the fused chain changed the losses: grouped {grp['losses']} "
            f"against {ref['losses'][:grouped_steps]} unfused")
    _log("  hook and grouped (fused) losses bitwise equal to the unfused "
         "run's")
    if not (launches["fused_pack"] > 0 and launches["fused_unpack"] > 0):
        raise AssertionError(f"K1 never launched on the main path: "
                             f"{launches}")
    bare = train(cfg, batch, steps, device, trace=False, mode="bare")
    _log(f"  the same loop without the runtime (bare SGD): step ms "
         f"{[round(x * 1e3, 1) for x in bare['step_s']]}; median "
         f"{statistics.median(bare['step_s'][1:]) * 1e3:.1f} ms")
    if bare["losses"][0] != losses[0]:
        raise AssertionError("the bare loop's first loss differs")
    torch.cuda.empty_cache()
    return launches


# --- phase 6: the fp32 path ------------------------------------------------

def fp32_path_phase(device, steps: int = 3) -> dict:
    """The same LM, batch and loop as the main path with
    ``cfg.dtype = torch.float32``: every product in fp32 (TF32 off), the
    attention forward in the 3xTF32 kernel. Checks its launches (one per
    layer and step, the bf16 kernel's none), finite and falling losses, and
    the first step's loss against the same step with ``use_flash=False``
    (the blockwise plain path). Returns the launches."""
    import dataclasses
    import functools

    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import ring_attention

    cfg = dataclasses.replace(full_width_config(12), dtype=torch.float32)
    batch = 8
    res = train(cfg, batch, steps, device, trace=False)
    losses = res["losses"]
    want = {"flash_attention_fwd_fp32": cfg.n_layers * steps,
            "flash_attention_fwd": 0}
    _log(f"  losses: {losses}; launches {res['launches']}")
    if {k: res["launches"][k] for k in want} != want:
        raise AssertionError(f"flash kernels launched {res['launches']} "
                             f"times on the fp32 path, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # the first step again, attention through the blockwise plain path
    model = TransformerLM(cfg, device=device, seed=0)
    with torch.no_grad():
        plain = lm_loss(model, tokens_for(cfg, batch, 0, device),
                        attn_fn=functools.partial(ring_attention,
                                                  use_flash=False)).item()
    del model
    torch.cuda.empty_cache()
    rel = abs(losses[0] - plain) / abs(plain)
    _log(f"  first-step loss {losses[0]:.7f} against {plain:.7f} with "
         f"use_flash=False: relative {rel:.3g} (tol 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("the fp32 kernel path disagrees with the plain "
                             "path on the first step")
    steady = statistics.median(res["step_s"][1:])
    tok = batch * cfg.max_seq
    _log(f"  step ms: first {res['step_s'][0] * 1e3:.1f}, then "
         f"{[round(x * 1e3, 1) for x in res['step_s'][1:]]}; median "
         f"{steady * 1e3:.1f} ms, {tok / steady:.0f} tokens/s; "
         f"max_memory_allocated {res['peak_bytes'] / 2**30:.2f} GiB; "
         f"per step {res['per_step'][-1]}")
    return res["launches"]


# --- phase 7: the slice against plain attention ---------------------------

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


# --- phase 8: the collectives path ---------------------------------------

def _launch_counts() -> dict:
    """Every kernel's launches by name, and the flash kernel's by mask."""
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_pack as fp
    from horovod_tpu_torch.ops import quant_wire as qw
    from horovod_tpu_torch.ops import xent

    counts = dict(fa.kernel_launches)
    counts.update(fp.kernel_launches)
    counts.update(qw.kernel_launches)
    counts.update(xent.kernel_launches)
    counts.update(adasum.kernel_launches)
    counts.update(fa.mask_launches)
    return counts


def _zero_launch_counts():
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_pack as fp
    from horovod_tpu_torch.ops import quant_wire as qw
    from horovod_tpu_torch.ops import xent

    for counts in (fa.kernel_launches, fp.kernel_launches,
                   qw.kernel_launches, xent.kernel_launches,
                   adasum.kernel_launches, fa.mask_launches):
        for name in counts:
            counts[name] = 0


def _exact(name: str, got, want):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    if not _same_bits(got, want):
        raise AssertionError(f"{name}: not bitwise equal")


def op_readings(name: str, fn, nbytes: int, readings: list):
    """One op's NCCL calls and K1 launches in one call, host us from
    enqueue to ``synchronize`` (the median of 5 calls, each from an idle
    card, after one more), event ms and device ms of back-to-back
    calls."""
    import torch

    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import fused_pack as fp

    rt = context.runtime()
    fn()
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        calls0, k10 = rt.collective_calls, sum(fp.kernel_launches.values())
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6)
    host_us = statistics.median(host)
    calls, k1 = (rt.collective_calls - calls0,
                 sum(fp.kernel_launches.values()) - k10)
    ev = time_ms(fn, iters=5)
    dev = device_ms(fn, iters=5, warmup=1)
    _log(f"  {name}: {ev:.4f} ms by events, {dev:.4f} ms of device time, "
         f"{host_us:.0f} us host enqueue to synchronize; {nbytes} bytes; "
         f"{calls} NCCL calls, {k1} K1 launches a call")
    readings.append({"op": name, "ms": ev, "device_ms": dev,
                     "host_us": host_us, "bytes": nbytes,
                     "nccl_calls": calls, "k1_launches": k1})


def clone_reading(t, readings: list):
    """The reducescatter's copy of its input alone (``x.clone()``): event
    ms, profiler device ms, and the profiler's records of one call, beside
    the copy's byte bound (read once, written once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ev = time_ms(lambda: t.clone(), iters=10)
    dev = device_ms(lambda: t.clone(), iters=5, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t.clone()
        torch.cuda.synchronize()
    recs = [(e.key[:40], round(e.self_device_time_total / 1e3, 4))
            for e in prof.key_averages()]
    nbytes = t.numel() * t.element_size()
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    _log(f"  the {nbytes >> 20} MiB clone alone: {ev:.4f} ms by events, "
         f"{dev:.4f} ms of device time, bound {bound:.4f} ms; the "
         f"profiler's records of one clone (name, device ms): {recs}")
    readings.append({"op": "clone (the reducescatter's copy)", "ms": ev,
                     "device_ms": dev, "bound_ms": bound, "bytes": nbytes,
                     "records": recs})


def _set_step(cfg, batch, device, process_set):
    """One hook step of ``DistributedOptimizer`` on ``process_set`` from
    the weights and tokens of seed 0; returns the parameters after it."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import ring_attention

    model = TransformerLM(cfg, device=device, seed=0)
    tokens = tokens_for(cfg, batch, 0, device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9),
        named_parameters=model.named_parameters(), process_set=process_set)
    opt.zero_grad()
    lm_loss(model, tokens, attn_fn=ring_attention).backward()
    opt.step()
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def collectives_path_phase(device) -> tuple:
    """Allgather, alltoall, reducescatter, sparse allreduce, a process
    set's hook step, join and ``allgather_object`` on the full-width LM's
    tensors, each checked exactly (see the module docstring). Returns the
    path's kernel launches and the per-op readings."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import ring_attention

    cfg = full_width_config(12)
    batch = 8
    readings: list = []
    _zero_launch_counts()
    model = TransformerLM(cfg, device=device, seed=0)
    tokens = tokens_for(cfg, batch, 0, device)
    # one evaluation forward: per-token losses and the final hidden states
    seen = {}
    hook = model.blocks[-1].register_forward_hook(
        lambda m, i, o: seen.update(hidden=o))
    with torch.no_grad():
        logits = model(tokens[:, :-1], attn_fn=ring_attention)
        losses = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                 tokens[:, 1:].reshape(-1), reduction="none")
    hook.remove()
    del logits
    hidden = seen.pop("hidden").reshape(-1, cfg.d_model)
    if (losses.shape, hidden.shape, hidden.dtype) != (
            (batch * cfg.max_seq,), (batch * cfg.max_seq, cfg.d_model),
            torch.bfloat16):
        raise AssertionError(f"unexpected shapes {losses.shape} "
                             f"{hidden.shape} {hidden.dtype}")
    _exact("allgather of the per-token losses",
           hvd.allgather(losses, name="losses"), losses)
    op_readings(f"allgather {list(losses.shape)} fp32",
                lambda: hvd.allgather(losses, name="losses"),
                losses.numel() * 4, readings)
    g = torch.Generator(device=device).manual_seed(1)
    dy = torch.randn(hidden.shape, generator=g, device=device).to(
        torch.bfloat16)
    h = hidden.clone().requires_grad_()
    y = hvd.allgather(h, name="hidden")
    _exact("allgather of the hidden states", y.detach(), hidden)
    y.backward(dy)
    _exact("allgather's backward", h.grad, dy)
    nb = hidden.numel() * 2
    op_readings(f"allgather {list(hidden.shape)} bf16",
                lambda: hvd.allgather(hidden, name="hidden"), nb, readings)
    h = hidden.clone().requires_grad_()
    out, recv = hvd.alltoall(h, splits=[batch * cfg.max_seq], name="a2a")
    _exact("alltoall of the hidden states", out.detach(), hidden)
    if recv.tolist() != [batch * cfg.max_seq] or recv.device.type != "cpu":
        raise AssertionError(f"alltoall received splits {recv}")
    out.backward(dy)
    _exact("alltoall's backward", h.grad, dy)
    op_readings(f"alltoall {list(hidden.shape)} bf16",
                lambda: hvd.alltoall(hidden, splits=[batch * cfg.max_seq],
                                     name="a2a"), nb, readings)
    del h, y, out, dy
    # the embedding's gradient, and its input rows' part of it
    seen.clear()
    hook = model.blocks[0].register_forward_pre_hook(
        lambda m, args: seen.update(x=args[0]) or args[0].retain_grad())
    model.zero_grad()
    lm_loss(model, tokens, attn_fn=ring_attention).backward()
    hook.remove()
    grad = model.embed.grad
    for opn, op in (("SUM", hvd.Sum), ("AVERAGE", hvd.Average)):
        _exact(f"reducescatter {opn} of the embedding gradient",
               hvd.reducescatter(grad, name=f"rs.{opn}", op=op), grad)
        op_readings(f"reducescatter {opn} {list(grad.shape)} fp32",
                    lambda op=op: hvd.reducescatter(grad, name="rs", op=op),
                    grad.numel() * 4, readings)
    clone_reading(grad, readings)
    dense = torch.zeros_like(grad)
    dense.index_add_(0, tokens[:, :-1].reshape(-1),
                     seen.pop("x").grad.reshape(-1, cfg.d_model).float())
    rows = dense.abs().sum(1).nonzero().view(-1)
    sparse = torch.sparse_coo_tensor(rows[None], dense[rows], dense.shape)
    _exact("sparse allreduce of the input embedding's gradient",
           hvd.sparse_allreduce_async(sparse, "emb.sparse")().to_dense(),
           dense)
    op_readings(f"sparse_allreduce_async ({rows.numel()} rows of "
                f"{cfg.vocab_size})",
                lambda: hvd.sparse_allreduce_async(sparse, "emb.sparse")(),
                rows.numel() * (cfg.d_model * 4 + 8), readings)
    _log(f"  every result above bitwise equal to its input; the sparse "
         f"gradient has {rows.numel()} nonzero rows")
    del model, grad, dense, sparse, rows, losses, hidden
    gc.collect()
    torch.cuda.empty_cache()
    # a process set's hook step against the global set's
    C.invalidate_fused_plans()
    ps = hvd.add_process_set([0], name="solo")
    k0 = _launch_counts()
    on_set = _set_step(cfg, batch, device, ps)
    k1 = _launch_counts()
    plans = [p for key, p in C._PLANS.items() if key[2] == "solo"]
    if not plans or any(p.group is not ps.runtime_group for p in plans):
        raise AssertionError("the set's chunks did not run on its group")
    if k1["fused_pack"] == k0["fused_pack"]:
        raise AssertionError("the set's step never launched K1")
    on_global = _set_step(cfg, batch, device, None)
    for n, p in on_set.items():
        _exact(f"the set's step, parameter {n}", p, on_global[n])
    _log(f"  process set [0]: one hook step, {len(plans)} fused plans on "
         f"the set's group, K1 {k1['fused_pack'] - k0['fused_pack']} packs "
         f"and {k1['fused_unpack'] - k0['fused_unpack']} unpacks; "
         f"parameters bitwise equal to the global set's step")
    hvd.remove_process_set(ps)
    del on_set, on_global
    torch.cuda.empty_cache()
    if hvd.join() != 0:
        raise AssertionError("join() did not return 0")
    after = hvd.allreduce(torch.ones(4, device=device), name="after.join",
                          op=hvd.Sum)
    _exact("an allreduce after join", after, torch.ones(4, device=device))
    metrics = {"loss": 1.5, "tokens": batch * cfg.max_seq}
    if hvd.allgather_object(metrics) != [metrics]:
        raise AssertionError("allgather_object")
    _log("  join() returned 0, an allreduce after it completed, "
         "allgather_object returned [dict]")
    launches = _launch_counts()
    _log(f"  the path's kernel launches: {launches}")
    for name in ("flash_attention_fwd", "fused_pack", "fused_unpack"):
        if not launches[name]:
            raise AssertionError(f"{name} never launched on the "
                                 f"collectives path: {launches}")
    return launches, readings


# --- the compression path: the LM's gradients at four virtual ranks ------

def _plain_simulate(plan, rank_inputs, residuals):
    """``plan.execute_simulated`` through the plain versions."""
    import torch

    from horovod_tpu_torch.ops import quant_wire as qw

    spec, nb = plan.spec, plan.row_bytes
    dev = rank_inputs[0][0].device
    gathered = torch.empty(plan.nproc * nb, dtype=torch.uint8, device=dev)
    new_rs = []
    for r, inputs in enumerate(rank_inputs):
        row = gathered[r * nb:(r + 1) * nb]
        if spec.bits == 16:
            qw.plain_cast_pack(inputs, row, plan.pre)
            new_rs.append(None)
            continue
        new = (torch.empty(plan.flat_size, device=dev)
               if spec.error_feedback else None)
        qw.plain_quantize_pack(inputs, row, spec, plan.pre,
                               None if residuals is None else residuals[r],
                               new)
        new_rs.append(new)
    outs = [torch.empty(s, dtype=plan.dtype, device=dev)
            for s in plan.shapes]
    qw.plain_reduce_unpack(gathered, outs, spec, plan.nproc, plan.average,
                           plan.post)
    return outs, new_rs


def compression_path_phase(device, world: int = 4) -> list:
    """The full-width LM stands in for ``world`` ranks: one backward on
    each of ``world`` seeded batches. Its gradients split as the runtime
    splits them (small leaves stay off the wire), the rest chunk at 128
    MiB in backward order, and every chunk goes through
    ``quant_sim_chunk_plan(world, AVERAGE, ...).execute_simulated`` for
    the bf16, int8 and int4 wires, error feedback carried over two rounds
    (the second cuts the chunks otherwise, as the runtime's timing may,
    and each virtual rank's ``ResidualStore`` hands each tensor its own
    residual), and int8 and int4 without error feedback
    (``HOROVOD_QUANT_EF=0``);
    outputs and residuals must equal the plain version's bit for bit.
    Then each kernel is timed per step (all chunks) by events and device
    time beside its bound and a composite yardstick. Returns the kernel
    entries, each with its launches on the path."""
    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.parallel import ring_attention

    cfg = full_width_config(12)
    model = TransformerLM(cfg, device=device, seed=0)
    named = list(model.named_parameters())
    grads = []
    for r in range(world):
        model.zero_grad(set_to_none=True)
        lm_loss(model, tokens_for(cfg, 8, 100 + r, device),
                attn_fn=ring_attention).backward()
        grads.append([p.grad.detach().clone() for _, p in named])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the runtime's split and chunks, in the order the backward makes the
    # gradients ready
    pats, min_elems = comp.quant_optout_patterns(), comp.quant_min_elems()
    reasons = {}
    eligible = []
    for i in reversed(range(len(named))):
        n, p = named[i]
        why = comp.quant_fallback_reason(n, p.numel(), p.dtype, pats,
                                         min_elems)
        reasons[why] = reasons.get(why, 0) + 1
        if why is None:
            eligible.append(i)
    def cut(threshold):
        out, chunk, nbytes = [], [], 0
        for i in eligible:
            sz = named[i][1].numel() * 4
            if chunk and nbytes + sz > threshold:
                out.append(chunk)
                chunk, nbytes = [], 0
            chunk.append(i)
            nbytes += sz
        return out + [chunk]

    # the runtime's chunks follow its cycle's timing: the second round
    # cuts them otherwise, and each tensor's residual follows it
    chunks, recut = cut(FUSION_THRESHOLD), cut(FUSION_THRESHOLD * 3 // 4)
    total = sum(named[i][1].numel() for i in eligible)
    _log(f"  {len(named)} gradients: {reasons.get(None, 0)} on the wire "
         f"({total} elements, {total * 4 / 1e9:.3f} GB, {len(chunks)} "
         f"chunks), kept off: { {k: v for k, v in reasons.items() if k} }")
    if reasons.get("optout_match") or set(reasons) - {None, "small_leaf"}:
        raise AssertionError(f"an LM gradient matched an opt-out: {reasons}")
    wires = [("bf16", comp.make_cast_spec()),
             ("int8", comp.make_quant_spec(8, 256, True)),
             ("int4", comp.make_quant_spec(4, 256, True)),
             ("int8_no_ef", comp.make_quant_spec(8, 256, False)),
             ("int4_no_ef", comp.make_quant_spec(4, 256, False))]
    plans = {}
    _zero_launch_counts()  # just before the path runs
    for label, spec in wires:
        stores = [comp.ResidualStore() for _ in range(world)]
        sig = spec.signature()
        for rnd in range(2 if spec.error_feedback else 1):
            for c, idx in enumerate((chunks, recut)[rnd]):
                names = [named[i][0] for i in idx]
                sizes = [named[i][1].numel() for i in idx]
                plan = C.quant_sim_chunk_plan(
                    world, C.ReduceOp.AVERAGE, 1.0, 1.0, names, sizes,
                    [tuple(named[i][1].shape) for i in idx], torch.float32,
                    spec)
                plans[label, c] = plan
                inputs = [[grads[r][i] for i in idx] for r in range(world)]
                res = [st.get(names, sizes, sig) for st in stores]
                if spec.bits == 16:
                    outs, new = plan.execute_simulated(inputs), [None]
                else:
                    outs, new = plan.execute_simulated(inputs, res)
                ref, ref_new = _plain_simulate(plan, inputs, res)
                if not (all(_same_bits(a, b) for a, b in zip(outs, ref))
                        and all(a is None or _same_bits(a, b)
                                for a, b in zip(new, ref_new))):
                    raise AssertionError(f"{label} wire: chunk {c} (round "
                                         f"{rnd}) differs from the plain "
                                         "version")
                for st, n in zip(stores, new):
                    if n is not None:
                        st.commit(names, sizes, sig, n)
                del outs, ref, ref_new, res
        if spec.error_feedback and stores[0].hits != len(eligible):
            raise AssertionError(f"{label} wire: the second round found "
                                 f"{stores[0].hits} residuals of "
                                 f"{len(eligible)}")
        _log(f"  {label}: {len(chunks)} chunks at {world} virtual ranks"
             + (f", then {len(recut)} chunks cut otherwise, each tensor's "
                "residual carried into them" if spec.error_feedback else "")
             + ": outputs and residuals bitwise equal to the plain version")
        del stores
    launches = {k: v for k, v in _launch_counts().items()
                if k.startswith("wire_")}
    _log(f"  the path's K2/K3 launches: {launches}")
    for k, v in launches.items():
        if not v:
            raise AssertionError(f"{k} never launched on the compression "
                                 "path")
    entries = _time_wire(chunks, grads, plans, world)
    for e in entries:
        e["launches"] = launches[e["name"]]
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def _time_wire(chunks, grads, plans, world) -> list:
    """Each kernel's time a step (every chunk, rank 0's inputs) by events
    and device time, its plain version's, a composite yardstick where one
    exists, and its byte bound."""
    import torch

    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.ops import quant_wire as qw

    dev = grads[0][0].device
    ins = [[grads[0][i] for i in idx] for idx in chunks]
    sizes = [sum(t.numel() for t in c) for c in ins]
    total = sum(sizes)
    outs = [[torch.empty_like(t) for t in c] for c in ins]
    out = []

    def entry(name, src, replaces, fns, nbytes, extra=None):
        ev = in_turns({k: v for k, v in fns.items() if k != "plain"},
                      lambda fn: time_ms(fn, iters=5))
        dv = in_turns({k: v for k, v in fns.items() if k != "plain"},
                      lambda fn: device_ms(fn, iters=3, warmup=1))
        plain = time_ms(fns["plain"], iters=1, warmup=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        e = {"name": name, "route": "cuda",
             "source": "horovod_tpu_torch/csrc/quant_wire.cu",
             "replaces": replaces, "launches": None, "max_abs_err": 0.0,
             "ms": ev["kernel"], "plain_ms": plain, "bound_ms": bound,
             "bound_by": "bytes", "library_ms": ev.get("library"),
             "library_device_ms": dv.get("library"),
             "device_ms": dv["kernel"],
             **dict(zip(("share", "share_by"),
                        share_of(bound, dv["kernel"], ev["kernel"]))),
             "composite_ms": ev.get("composite"),
             "composite_device_ms": dv.get("composite"), "bytes": nbytes}
        e.update(extra or {})
        out.append(e)
        _log(f"  {name}: {ev['kernel']:.4f} ms a step by events, "
             f"{dv['kernel']:.4f} ms of device time "
             f"({nbytes / dv['kernel'] / 1e6:.0f} GB/s, "
             f"{e['share']:.3f} of its bound {bound:.4f} ms); plain "
             f"{plain:.4f} ms"
             + (f"; {src} {ev['composite']:.4f} ms ({dv['composite']:.4f} "
                "device)" if "composite" in ev else "")
             + (f"; library {ev['library']:.4f} ms ({dv['library']:.4f} "
                "device)" if "library" in ev else ""))

    # K2: the cast pack; at a prescale of 1 one PyTorch call computes the
    # same: torch.cat casting into a bf16 out
    rows16 = [torch.empty(2 * n, dtype=torch.uint8, device=dev)
              for n in sizes]
    lib16 = [torch.empty(n, dtype=torch.bfloat16, device=dev) for n in sizes]
    flats = [[t.view(-1) for t in c] for c in ins]
    fns = {"kernel": lambda: [qw.cast_pack(c, r) for c, r in
                              zip(ins, rows16)],
           "composite": lambda: [torch.cat(f).to(torch.bfloat16)
                                 for f in flats],
           "library": lambda: [torch.cat(f, out=o)
                               for f, o in zip(flats, lib16)],
           "plain": lambda: [qw.plain_cast_pack(c, r) for c, r in
                             zip(ins, rows16)]}
    try:
        fns["library"]()
        fns["kernel"]()
        same = all(_same_bits(r.view(torch.bfloat16), o)
                   for r, o in zip(rows16, lib16))
        _log(f"  torch.cat(ts, out=bf16) runs on the card; "
             f"{'bitwise equal to' if same else 'differs from'} K2's row")
    except RuntimeError as e:
        _log(f"  torch.cat(ts, out=bf16) does not run on the card ({e}); "
             "K2 has no library call")
        del fns["library"]
    entry("wire_cast_pack", "torch.cat(ts).to(bfloat16)",
          "horovod_tpu/ops/collectives.py:1065", fns, total * (4 + 2))
    del rows16, lib16, flats
    # K3: the quantize pack, int8 and int4, with error feedback (the
    # residual in and out) and without; the blocks that lie in one tensor
    # must all take the register path
    starts = [[0] for _ in ins]
    for c, st in zip(ins, starts):
        for t in c:
            st.append(st[-1] + t.numel())
    in_one = sum(max(0, min(st[i + 1], st[-1]) // 256 - -(-st[i] // 256))
                 for st in starts for i in range(len(st) - 1))
    for bits in (8, 4):
        lay = [comp.quant_wire_layout(n, comp.make_quant_spec(bits, 256,
                                                              True))
               for n in sizes]
        rows = [torch.empty(p + s, dtype=torch.uint8, device=dev)
                for _, _, p, s in lay]
        wire = sum(p + s for _, _, p, s in lay)
        for ef in (True, False):
            spec = comp.make_quant_spec(bits, 256, ef)
            # one residual a tensor, as the runtime's store keeps them
            res = ([[torch.zeros(t.numel(), device=dev) for t in c]
                    for c in ins] if ef else [None] * len(ins))
            new = ([torch.empty(n, device=dev) for n in sizes] if ef
                   else [None] * len(ins))
            reg_blocks = torch.zeros(1, dtype=torch.int64, device=dev)
            paths0 = dict(qw.quantize_paths)
            for c, r, x, y in zip(ins, rows, res, new):
                qw.quantize_pack(c, r, spec, 1.0, x, y, reg_blocks=reg_blocks)
            paths = {k: v - paths0[k] for k, v in qw.quantize_paths.items()}
            if (paths["register"] != in_one
                    or int(reg_blocks.item()) != in_one):
                raise AssertionError(
                    f"K3 int{bits}: {paths} blocks by path (the kernel "
                    f"counted {int(reg_blocks.item())} register blocks), "
                    f"but {in_one} blocks lie in one tensor")
            _log(f"  K3 int{bits}{'' if ef else ' without error feedback'}"
                 f" a step: blocks by path {paths} (every block in one "
                 "tensor on the register path; the kernel's own count "
                 "agrees)")
            entry(f"wire_quantize_int{bits}" + ("" if ef else "_no_ef"), "",
                  "horovod_tpu/ops/compression.py:299 (in "
                  "collectives.py:987)",
                  {"kernel": lambda: [qw.quantize_pack(c, r, spec, 1.0, x, y)
                                      for c, r, x, y in
                                      zip(ins, rows, res, new)],
                   "plain": lambda: [qw.plain_quantize_pack(c, r, spec, 1.0,
                                                            x, y)
                                     for c, r, x, y in
                                     zip(ins, rows, res, new)]},
                  total * (12 if ef else 4) + wire,
                  {"block_paths": paths})
            del res, new
        del rows
    # the reduce-unpack at `world` rows, each wire, fp32 outputs
    for label in ("bf16", "int8", "int4"):
        spec = plans[label, 0].spec
        gath = [torch.zeros(world * qw.row_bytes(n, spec), dtype=torch.uint8,
                            device=dev) for n in sizes]
        if label == "bf16":
            for g in gath:
                g.view(torch.bfloat16).copy_(torch.randn(
                    g.numel() // 2, device=dev))
        else:
            # rows packed from the gradients of every rank
            for c, (g, n) in enumerate(zip(gath, sizes)):
                nb = g.numel() // world
                for r in range(world):
                    qw.quantize_pack([grads[r][i] for i in chunks[c]],
                                     g[r * nb:(r + 1) * nb],
                                     spec._replace(error_feedback=False))
        widths = sorted({tuple(qw.row_load_widths(
            g.data_ptr(), g.numel() // world, world, spec.bits))
            for g in gath})
        _log(f"  reduce-unpack {label}: rows' load widths (bytes) "
             f"{widths}")
        fns = {"kernel": lambda: [qw.reduce_unpack(g, o, spec, world, True)
                                  for g, o in zip(gath, outs)],
               "plain": lambda: [qw.plain_reduce_unpack(g, o, spec, world,
                                                        True)
                                 for g, o in zip(gath, outs)]}
        src = ""
        if label == "bf16":
            src = "gathered.float().sum(0)"
            fns["composite"] = lambda: [
                g.view(torch.bfloat16).view(world, -1).float().sum(0)
                for g in gath]
        entry(f"wire_reduce_{label}", src,
              "horovod_tpu/ops/collectives.py:1072" if label == "bf16"
              else "horovod_tpu/ops/collectives.py:996",
              fns, sum(g.numel() for g in gath) + total * 4,
              {"row_load_widths": [list(w) for w in widths]})
        del gath
    return out


def fallback_phase(device) -> None:
    """One hook step at the real world of one with
    ``HOROVOD_COMPRESSION=int8`` against the same step uncompressed: the
    parameters bitwise equal, and ``hvd_quant_fallback_total{reason=
    "world_size"}`` counting each gradient once."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import metrics

    cfg = full_width_config(12)
    reg = metrics.get_registry()

    def world_size_fallbacks():
        return reg.counter_value("hvd_quant_fallback_total",
                                 reason="world_size")

    plain = _set_step(cfg, 8, device, None)
    hvd.shutdown()
    os.environ["HOROVOD_COMPRESSION"] = "int8"
    try:
        hvd.init()
        f0 = world_size_fallbacks()
        wired = _set_step(cfg, 8, device, None)
        counted = world_size_fallbacks() - f0
        hvd.shutdown()
    finally:
        del os.environ["HOROVOD_COMPRESSION"]
    hvd.init()
    for n, p in plain.items():
        _exact(f"the int8 step at a world of one, parameter {n}", wired[n],
               p)
    if counted != len(plain):
        raise AssertionError(f"world_size fallbacks counted {counted}, "
                             f"expected one for each of {len(plain)} "
                             "gradients")
    _log(f"  HOROVOD_COMPRESSION=int8 at a world of one: the hook step's "
         f"{len(plain)} parameters bitwise equal to the uncompressed "
         f"step's; hvd_quant_fallback_total{{reason=\"world_size\"}} "
         f"+{counted:.0f}")
    del plain, wired
    torch.cuda.empty_cache()


# --- phase 9: the long-context path: sequence parallelism, K5, remat -------

SP_SHAPE = (1, 8192, 16, 128)  # b, seq, heads, head dim of the LM at 8192
SP_GRAD_TOL = 1e-2


def _sp_reference(q, k, v, co):
    """Full-sequence references in the kernel layout: the fp32 output and
    P|V| (``scan_stats`` on fp32 copies, for the bf16 bound), and the
    gradients of sum(o * co) through ``scan_stats`` on the bf16 inputs."""
    import torch

    from horovod_tpu_torch.ops.flash_attention import scan_stats
    from horovod_tpu_torch.parallel.sp import _to_flat

    qf, kf, vf, cf = (_to_flat(x) for x in (q, k, v, co))
    with torch.no_grad():
        o32 = scan_stats(qf.float(), kf.float(), vf.float(), True)[0]
        o_abs = scan_stats(qf.float(), kf.float(), vf.float().abs(),
                           True)[0]
    ins = [x.detach().requires_grad_() for x in (qf, kf, vf)]
    o = scan_stats(*ins, True)[0]
    grads = torch.autograd.grad((o.float() * cf.float()).sum(), ins)
    return o32, o_abs, grads


def _unflat(x, shape):
    b, s, h, d = shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def sp_phase(device) -> dict:
    """The simulated rings (n = 2, 4, blocked and striped) and Ulysses (n =
    4) at the full-width LM's attention shape, b = 1, seq 8192, 16 heads
    of 128, bf16, each rank's rounds through the flash kernel. Outputs are
    held against an fp32 reference under the kernel's bound (check_flash's,
    with P|V| once more for the ring's rounding of each round's o) and
    against the kernel's full-sequence output under the sum of both bounds;
    dq, dk and dv against the full sequence's ``scan_stats`` gradients,
    within ``SP_GRAD_TOL`` of their norm (bf16 gradients: the ring also
    rounds each round's cotangent to bf16 and sums a block's n rounds in
    bf16, a few units of 2^-9 each). Prints the kernel's launches by mask
    for each and checks them. Returns the launches summed over the runs."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import (ring_attention, sp,
                                            stripe_tokens, unstripe_tokens)

    g = torch.Generator(device=device).manual_seed(9)
    q, k, v, co = (torch.randn(SP_SHAPE, generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    t0 = time.perf_counter()
    o32, o_abs, ref_grads = _sp_reference(q, k, v, co)
    o32, o_abs = _unflat(o32, SP_SHAPE), _unflat(o_abs, SP_SHAPE)
    ref_grads = [_unflat(x, SP_SHAPE) for x in ref_grads]
    with torch.no_grad():
        full = ring_attention(q, k, v).float()  # the kernel at seq 8192
    b_kernel = 1.01 * U_BF16 * (o32.abs() + o_abs) + 1e-5
    b_ring = 1.01 * U_BF16 * (o32.abs() + 2 * o_abs) + 1e-5
    share = ((full - o32).abs() / b_kernel).max().item()
    _log(f"  references at b=1 s=8192 h=16 d=128 bf16: "
         f"{time.perf_counter() - t0:.1f} s; the kernel's full-sequence "
         f"output at {share:.3g} of its bound")
    if share > 1.0:
        raise AssertionError("the kernel's full-sequence output leaves its "
                             "bound")
    total = {"diagonal": 0, "full": 0, "strict": 0}
    runs = [("ring", 2), ("striped", 2), ("ring", 4), ("striped", 4),
            ("ulysses", 4)]
    for layout, n in runs:
        striped = layout == "striped"
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        g_in = [stripe_tokens(x, n) for x in ins] if striped else ins
        c = stripe_tokens(co, n) if striped else co
        for key in fa.mask_launches:
            fa.mask_launches[key] = 0
        t0 = time.perf_counter()
        if layout == "ulysses":
            out = sp._simulated_ulysses(*g_in, n)
        else:
            out = sp._simulated_ring(*g_in, n, striped=striped)
        grads = torch.autograd.grad((out.float() * c.float()).sum(), ins)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        masks = dict(fa.mask_launches)
        if striped:
            out = unstripe_tokens(out, n)
        out = out.detach().float()
        bound = b_kernel if layout == "ulysses" else b_ring
        s_ref = ((out - o32).abs() / bound).max().item()
        s_full = ((out - full).abs() / (bound + b_kernel)).max().item()
        g_err = [((a.float() - r.float()).norm() / r.float().norm()).item()
                 for a, r in zip(grads, ref_grads)]
        want = ({"diagonal": n, "full": 0, "strict": 0} if layout == "ulysses"
                else {"diagonal": n * (n + 1) // 2, "full": 0,
                      "strict": n * (n - 1) // 2} if striped
                else {"diagonal": n, "full": n * (n - 1) // 2, "strict": 0})
        _log(f"  {layout} n={n}: {secs:.2f} s forward and backward; output "
             f"at {s_ref:.3g} of its bound against fp32, {s_full:.3g} of "
             f"the summed bound against the kernel's full sequence (max "
             f"|d| {(out - full).abs().max().item():.3g}); dq, dk, dv "
             f"relative to the full sequence's {[f'{e:.3g}' for e in g_err]}"
             f" (tol {SP_GRAD_TOL}); kernel launches by mask {masks}")
        if masks != want:
            raise AssertionError(f"{layout} n={n} launched {masks}, "
                                 f"expected {want}")
        if not (s_ref <= 1.0 and s_full <= 1.0
                and max(g_err) <= SP_GRAD_TOL):
            raise AssertionError(f"{layout} n={n} disagrees with the full "
                                 "sequence")
        for key in total:
            total[key] += masks[key]
        del out, grads, ins, g_in
    del q, k, v, co, o32, o_abs, full, ref_grads, b_kernel, b_ring
    torch.cuda.empty_cache()
    return total


XENT_SHAPE = (8192, 32768, 2048, 8192)  # N tokens, V, d, chunk


def xent_phase(device) -> list:
    """K5 against its plain version on one chunk of the long-context
    path's loss (N = 8192 tokens, chunk 8192 of V = 32768, d = 2048,
    fp32), the running state taken from the chunk before it: m and tgt
    bit for bit (a max and a pick), l within 1e-5 relative (a sum of 8192
    terms in another order), dlogits within 2^-20 of ct/N (exp to a few
    ulps). Each kernel timed by events and device time beside its byte
    bound, its plain version and the library call (``torch.logsumexp``
    over the chunk for the forward; none for the backward, whose
    composite is the plain version). Returns the two kernel entries."""
    import torch

    from horovod_tpu_torch.ops import xent

    N, V, d, C = XENT_SHAPE
    g = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((N, d), generator=g, device=device)
    w = torch.randn((C, d), generator=g, device=device) * 0.02
    targets = torch.randint(0, V, (N,), generator=g, device=device)
    logits = x @ w.T  # chunk 1 of V // C, classes [C, 2C)
    base = C
    state0 = [torch.full((N,), xent.NEG_INF, device=device),
              torch.zeros(N, device=device),
              torch.full((N,), xent.NEG_INF, device=device)]
    xent.fwd_chunk_plain(logits.roll(1, dims=1), targets, 0, *state0)
    state_k = [t.clone() for t in state0]
    state_p = [t.clone() for t in state0]
    xent.xent_fwd_chunk(logits, targets, base, *state_k)
    xent.fwd_chunk_plain(logits, targets, base, *state_p)
    m_ok = torch.equal(state_k[0], state_p[0])
    t_ok = torch.equal(state_k[2], state_p[2])
    l_rel = ((state_k[1] - state_p[1]).abs() / state_p[1]).max().item()
    l_abs = (state_k[1] - state_p[1]).abs().max().item()
    lse = state_p[0] + torch.log(state_p[1])
    scale = torch.full((1,), 0.7 / N, device=device)
    dk, dp = logits.clone(), logits.clone()
    xent.xent_bwd_chunk(dk, targets, base, lse, scale)
    xent.bwd_chunk_plain(dp, targets, base, lse, scale)
    d_err = (dk - dp).abs().max().item()
    d_tol = 2.0 ** -20 * scale.item()
    in_chunk = ((targets >= base) & (targets < base + C)).sum().item()
    _log(f"  K5 at N={N} C={C} (chunk 1 of {V // C}, {in_chunk} targets "
         f"in it): forward m {'bitwise' if m_ok else 'DIFFERS'}, tgt "
         f"{'bitwise' if t_ok else 'DIFFERS'}, l max rel {l_rel:.3g} (tol "
         f"1e-05); backward max |d| {d_err:.3g} (tol {d_tol:.3g})")
    if not (m_ok and t_ok and l_rel <= 1e-5 and d_err <= d_tol):
        raise AssertionError("K5 disagrees with its plain version")
    entries = []
    nbytes = {"xent_fwd_chunk": N * C * 4 + N * 8 + 3 * N * 4 * 2,
              "xent_bwd_chunk": 2 * N * C * 4 + N * 8 + N * 4 + 4}
    errs = {"xent_fwd_chunk": l_abs, "xent_bwd_chunk": d_err}
    fns = {
        "xent_fwd_chunk": (
            lambda: xent.xent_fwd_chunk(logits, targets, base, *state_k),
            lambda: xent.fwd_chunk_plain(logits, targets, base, *state_p),
            lambda: torch.logsumexp(logits, dim=-1)),
        "xent_bwd_chunk": (
            lambda: xent.xent_bwd_chunk(dk, targets, base, lse, scale),
            lambda: xent.bwd_chunk_plain(dp, targets, base, lse, scale),
            None)}
    for name, (kern, plain, lib) in fns.items():
        timed = {"kernel": kern} if lib is None else {"kernel": kern,
                                                      "library": lib}
        ev = in_turns(timed, lambda fn: time_ms(fn, iters=50))
        dev = in_turns(timed, lambda fn: device_ms(fn, iters=50))
        plain_ms = time_ms(plain, iters=10)
        bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        sh, sh_by = share_of(bound_ms, dev["kernel"], ev["kernel"])
        _log(f"  {name}: {ev['kernel']:.4f} ms by events, "
             f"{dev['kernel']:.4f} device; bound {bound_ms:.4f} ms (bytes); "
             f"share {sh:.3f} ({sh_by}); plain {plain_ms:.4f} ms; "
             + (f"torch.logsumexp {ev['library']:.4f} ms, "
                f"{dev['library']:.4f} device" if lib else
                f"library none (the composite, the plain version, "
                f"{plain_ms:.4f} ms)"))
        entries.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/xent.cu",
            "replaces": ("horovod_tpu/ops/xent.py:65" if "fwd" in name
                         else "horovod_tpu/ops/xent.py:106"),
            "launches": None, "max_abs_err": errs[name],
            "ms": ev["kernel"], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": ev.get("library"),
            "device_ms": dev["kernel"],
            "library_device_ms": dev.get("library"), "share": sh,
            "share_by": sh_by})
    del x, w, logits, dk, dp
    torch.cuda.empty_cache()
    return entries


def long_context_config(remat: bool, xent_chunk):
    import dataclasses

    return dataclasses.replace(full_width_config(12), max_seq=8192,
                               remat=remat, xent_chunk=xent_chunk)


# the first step's loss, chunked against dense: the same forward, the loss
# summed over 32768 classes in another order (about 1e-6 of it)
FIRST_LOSS_TOL = 1e-5
# later steps, chunked against dense: the two losses' dx differ in a few
# in 10^4 of their bf16 elements by one unit in the last place, which the
# bf16 backward spreads into differences of about 1% of the front layers'
# gradients (PERF.md, "the loss band"): the trajectories part at bf16's
# noise floor, some 1e-5 of the loss within 4 steps (a few % of its fall)
LATER_LOSS_TOL = 1e-4


def long_context_phase(device) -> dict:
    """The full-width LM at seq 8192, batch 1, bf16, ``remat=True`` and
    ``xent_chunk=8192`` (``benchmarks/bench_transformer.py:128``'s row at
    8192), 4 steps through ``DistributedOptimizer`` at a ring of one; then
    the same without remat, and without remat with the dense loss. Checks
    each run's launches (the flash kernel once a layer and step, twice
    under remat; K5 once a chunk and step in each direction, never with
    the dense loss) and finite, falling losses; remat changes no bit of
    any loss (the recompute runs the same kernels on the same inputs); the
    dense loss's first step within ``FIRST_LOSS_TOL`` and its later steps
    within ``LATER_LOSS_TOL`` relative of the chunked run's; peak memory
    falls with remat and again with the chunked loss. Returns the first
    run's launches."""
    import torch

    steps, runs = 4, {}
    for label, remat, chunk in (("remat, chunked loss", True, 8192),
                                ("no remat, chunked loss", False, 8192),
                                ("no remat, dense loss", False, None)):
        cfg = long_context_config(remat, chunk)
        res = train(cfg, 1, steps, device, trace=remat)
        steady = statistics.median(res["step_s"][1:])
        tok = cfg.max_seq
        mfu = (tok / steady * 3 * fwd_flops_per_token(cfg, cfg.max_seq)
               / PEAK_FLOPS["bfloat16"])
        runs[label] = res
        la = res["launches"]
        _log(f"  {label}: losses {res['losses']}; step ms "
             f"{[round(x * 1e3, 1) for x in res['step_s']]}, median "
             f"{steady * 1e3:.1f} ms, {tok / steady:.0f} tokens/s, MFU "
             f"{mfu:.4f}; max_memory_allocated "
             f"{res['peak_bytes'] / 2**30:.2f} GiB; flash "
             f"{la['flash_attention_fwd']}, K5 {la['xent_fwd_chunk']} + "
             f"{la['xent_bwd_chunk']}; per step {res['per_step'][-1]}")
        if res["profile"] is not None:
            prof = res["profile"]
            idle = max(0.0, 1.0 - prof["union_ms"] / prof["wall_ms"])
            _log(f"  traced step: wall {prof['wall_ms']:.1f} ms, "
                 f"{prof['union_ms']:.1f} ms busy on any stream, idle share "
                 f"{idle:.4f}; device ms by category: "
                 + ", ".join(f"{n_} {ms:.3f}"
                             for n_, ms in prof["categories"].items()))
            for name, calls, ms in prof["top"][:8]:
                _log(f"    {ms:9.3f}  {calls:5d}  {name}")
        n_chunks = 32768 // chunk if chunk else 0
        want = {"flash_attention_fwd": (2 if remat else 1) * 12 * steps,
                "xent_fwd_chunk": n_chunks * steps,
                "xent_bwd_chunk": n_chunks * steps}
        if {k_: la[k_] for k_ in want} != want:
            raise AssertionError(f"{label}: launches {la}, expected {want}")
        ls = res["losses"]
        if not (all(math.isfinite(x) for x in ls) and ls[-1] < ls[0]):
            raise AssertionError(f"{label}: losses {ls}")
    lc, plain, dense = runs.values()
    if lc["losses"] != plain["losses"]:
        raise AssertionError(f"remat changed the losses: {lc['losses']} "
                             f"against {plain['losses']}")
    gaps = [abs(x - y) / abs(y) for x, y in zip(lc["losses"],
                                                dense["losses"])]
    peaks = [r["peak_bytes"] / 2**30 for r in (lc, plain, dense)]
    _log(f"  remat: losses bitwise equal to the run without it; the dense "
         f"loss's gaps, relative: {[f'{x:.3g}' for x in gaps]} (tol "
         f"{FIRST_LOSS_TOL} first, {LATER_LOSS_TOL} later); peak "
         f"{[round(p, 2) for p in peaks]} GiB")
    if gaps[0] > FIRST_LOSS_TOL or max(gaps[1:]) > LATER_LOSS_TOL:
        raise AssertionError("the chunked loss left the dense loss's band")
    if not peaks[0] < peaks[1] < peaks[2]:
        raise AssertionError("remat and the chunked loss did not each lower "
                             "peak memory")
    torch.cuda.empty_cache()
    return lc["launches"]


# --- phase 10: the zero-1 path ----------------------------------------------

def _sgd(params):
    import torch

    return torch.optim.SGD(params, lr=1e-3, momentum=0.9)


def _zero_counts() -> dict:
    """The counters a sharded step moves."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import fused_pack as fp
    from horovod_tpu_torch.utils import metrics

    reg = metrics.get_registry()
    out = {f"wire {ph}": reg.counter_value(
        "hvd_sharded_update_wire_bytes_total", phase=ph)
        for ph in ("reduce_scatter", "allgather", "allreduce", "broadcast")}
    out.update({"sharded plan hits": reg.counter_value(
        "hvd_sharded_plan_hits_total"), "sharded plan misses":
        reg.counter_value("hvd_sharded_plan_misses_total"),
        "K1 launches": sum(fp.kernel_launches.values()),
        "dist calls": C.dist_calls})
    return out


def _zero_arm(arm: str, cfg, batch: int, steps: int, device,
              ref=None) -> tuple:
    """``steps`` steps of one arm of the zero-1 path from the weights and
    tokens of seed 0: ``plain`` (``DistributedOptimizer``), ``whole_leaf``
    (``sharded_update=True``) or ``engine`` (``ShardedUpdateEngine`` over
    the set of one: NCCL's reduce-scatter and allgather on a communicator
    of one). With ``ref`` (the plain arm's parameters after each step)
    each step's parameters must equal them bit for bit; without, they are
    kept, in buffers taken before the first step (so the steps' own
    allocations stay as they would be). Peak memory is the arm's own: the
    most allocated during a step above what was allocated before the arm
    was built, less the kept parameters. Returns (readings, kept
    parameters)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.opt.sharded import (ShardedUpdateEngine,
                                               optimizer_state_bytes)
    from horovod_tpu_torch.parallel import ring_attention

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = TransformerLM(cfg, device=device, seed=0)
    tokens = tokens_for(cfg, batch, 0, device)
    params = list(model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    engine = opt = None
    if arm == "engine":
        engine = ShardedUpdateEngine(_sgd,
                                     process_set=hvd.global_process_set())
        engine.init(params)
    else:
        opt = hvd.DistributedOptimizer(
            _sgd(params), named_parameters=model.named_parameters(),
            sharded_update=arm == "whole_leaf")
        want = "ShardedDistributedSGD" if arm == "whole_leaf" \
            else "DistributedSGD"
        if type(opt).__name__ != want:
            raise AssertionError(f"{arm}: {type(opt).__name__}")

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

    losses, step_s, per_step = [], [], []
    kept = ([[torch.empty_like(p) for p in params] for _ in range(steps)]
            if ref is None else [])
    held = sum(t.numel() * t.element_size() for ts in kept for t in ts)
    peak = 0
    for i in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = _zero_counts()
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
        c1 = _zero_counts()
        per_step.append({k: c1[k] - c0[k] for k in c0})
        peak = max(peak, torch.cuda.max_memory_allocated() - base - held)
        if ref is None:
            for t, p in zip(kept[i], params):
                t.copy_(p.detach())
        elif not all(_same_bits(a, b) for a, b in zip(params, ref[i])):
            raise AssertionError(f"zero-1 path, {arm}: parameters differ "
                                 f"from the plain wrapper's after step {i}")
    state = optimizer_state_bytes(engine.optimizer if engine is not None
                                  else opt)
    digest = engine.layout.digest[:12] if engine is not None else None
    del model, params, opt, engine
    gc.collect()  # the hook optimizers sit in reference cycles
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [x * 1e3 for x in step_s],
            "median_step_ms": statistics.median(step_s[1:]) * 1e3,
            "peak_bytes": peak, "state_bytes": state, "digest": digest,
            "per_step": per_step[-1]}, kept


def _zero_simulated(cfg, batch: int, device, world: int = 4,
                    steps: int = 3) -> tuple:
    """``world`` simulated ranks on the card: the LM's gradients from
    ``world`` seeded batches, the layout at that world, each rank's K1
    pack, the simulated reduce in rank order, ``world`` shard steps and
    K1's pack of the shards and unpack into the parameters; each step's
    parameters bitwise equal to a replicated SGD step over the same
    reduce (``sim_reduce`` a leaf). Returns (readings, the gradients, the
    layout)."""
    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.opt import sharded as S
    from horovod_tpu_torch.parallel import ring_attention

    model = TransformerLM(cfg, device=device, seed=0)
    params = list(model.parameters())
    grads = []
    for r in range(world):
        lm_loss(model, tokens_for(cfg, batch, 100 + r, device),
                attn_fn=ring_attention).backward()
        grads.append([p.grad for p in params])
        for p in params:
            p.grad = None
    sim = [p.detach().clone() for p in params]
    rep = [p.detach().clone() for p in params]
    del model, params
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engines = S.make_simulated_engines(_sgd, world)
    for e in engines:
        e.init(sim)
    rep_opt = _sgd(rep)
    c0 = _zero_counts()
    step_s = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.simulated_step(engines, sim, grads)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        for j, p in enumerate(rep):
            p.grad = C.sim_reduce([g[j] for g in grads],
                                  C.ReduceOp.AVERAGE)
        rep_opt.step()
        for p in rep:
            p.grad = None
        if not all(_same_bits(a, b) for a, b in zip(sim, rep)):
            raise AssertionError(f"zero-1 path, {world} simulated ranks: "
                                 f"parameters differ from the replicated "
                                 f"update's after step {i}")
    c1 = _zero_counts()
    peak = torch.cuda.max_memory_allocated() - base
    per = {k: (c1[k] - c0[k]) / steps for k in c0}
    for k in per:
        if k.startswith("wire "):
            per[k] /= world  # the counters sum the world's engines
    layout = engines[0].layout
    rd = {"step_ms": [x * 1e3 for x in step_s],
          "median_step_ms": statistics.median(step_s) * 1e3,
          "peak_bytes": peak,
          "state_bytes": S.optimizer_state_bytes(engines[0].optimizer),
          "replicated_state_bytes": S.optimizer_state_bytes(rep_opt),
          "digest": layout.digest[:12], "per_step": per,
          "shard_fraction": layout.shard_fraction}
    del engines, rep_opt, sim, rep
    gc.collect()
    torch.cuda.empty_cache()
    return rd, grads, layout


def _time_zero_layout(grads, layout) -> dict:
    """K1 over the shard layout at world 4: the pack of one rank's 74
    gradients into the padded group (the zero pad included) and the
    unpack of the gathered flat into 74 parameters; each held bitwise
    against its plain version first, then timed by events and device
    time in turns with the library's ``torch.cat`` plus the pad's fill
    (pack) and ``split`` + ``copy_`` (unpack), beside its byte bound."""
    import torch

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import fused_pack as fp

    (g,) = layout.groups
    padded = layout.group_padded(g)
    leaves = [grads[0][i] for i in g.indices]
    pack = C.sharded_pack_plan(None, layout.world_size, g.sizes, g.shapes,
                               g.torch_dtype, g.shard_elems, layout.digest)
    flat = torch.empty(padded, dtype=g.torch_dtype, device=leaves[0].device)
    ref = torch.zeros_like(flat)
    pack.execute(leaves, flat)
    fp.plain_pack(leaves, ref)
    outs = [torch.empty_like(t) for t in leaves]
    fp.unpack(flat, outs)
    if not (_same_bits(flat, ref)
            and all(_same_bits(a, b) for a, b in zip(outs, leaves))):
        raise AssertionError("K1 over the shard layout differs from its "
                             "plain version")
    del ref

    def lib_pack():
        torch.cat([t.view(-1) for t in leaves], out=flat[:g.total])
        flat[g.total:].zero_()

    def lib_unpack():
        for t, part in zip(outs, torch.split(flat[:g.total], list(g.sizes))):
            t.view(-1).copy_(part)

    item = flat.element_size()
    out = {}
    for name, kfn, pfn, lfn, nbytes in (
            ("pack", lambda: pack.execute(leaves, flat),
             lambda: fp.plain_pack(leaves, flat), lib_pack,
             (g.total + padded) * item),
            ("unpack", lambda: fp.unpack(flat, outs),
             lambda: fp.plain_unpack(flat, outs), lib_unpack,
             2 * g.total * item)):
        fns = {"kernel": kfn, "library": lfn}
        ev = in_turns(fns, lambda fn: time_ms(fn, iters=10))
        dev = in_turns(fns, lambda fn: device_ms(fn, iters=5, warmup=1))
        plain = time_ms(pfn, iters=3)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        share, by = share_of(bound, dev["kernel"], ev["kernel"])
        _log(f"  K1 {name} over the shard layout ({len(leaves)} tensors, "
             f"{g.total} elements, padded {padded}): {ev['kernel']:.4f} ms "
             f"by events, {dev['kernel']:.4f} device ({share:.3f} of its "
             f"bound {bound:.4f} ms, read from {by}); library "
             f"{ev['library']:.4f} ms ({dev['library']:.4f} device); plain "
             f"{plain:.4f} ms")
        # a device time of 0 is the profiler's dropped records: none read
        out[name] = {"ms": ev["kernel"], "device_ms": dev["kernel"] or None,
                     "plain_ms": plain, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": ev["library"],
                     "library_device_ms": dev["library"] or None,
                     "share": share,
                     "share_by": by, "tensors": len(leaves),
                     "padded": padded}
    del flat, outs
    torch.cuda.empty_cache()
    return out


def zero1_phase(device) -> tuple:
    """The zero-1 path at full width, one GPU (module docstring): the
    plain wrapper, then the whole-leaf front end and the engine at a world
    of one, each bitwise the plain wrapper after every step; then four
    simulated ranks, bitwise a replicated update. Returns the path's
    kernel launches and K1's readings over the shard layout."""
    import torch

    cfg = full_width_config(12)
    batch, steps = 8, 3
    _zero_launch_counts()  # just before the path runs
    plain, ref = _zero_arm("plain", cfg, batch, steps, device)
    arms = {"plain": plain}
    arms["whole_leaf"], _ = _zero_arm("whole_leaf", cfg, batch, steps,
                                      device, ref)
    arms["engine"], _ = _zero_arm("engine", cfg, batch, steps, device, ref)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    sim, grads, layout = _zero_simulated(cfg, batch, device)
    launches = _launch_counts()
    for name, rd in list(arms.items()) + [("4 simulated ranks", sim)]:
        _log(f"  {name}: step ms {[round(x, 1) for x in rd['step_ms']]}, "
             f"median {rd['median_step_ms']:.1f}; peak "
             f"{rd['peak_bytes'] / 2**30:.2f} GiB; optimizer state "
             f"{rd['state_bytes'] / 1e9:.4f} GB a rank; layout digest "
             f"{rd['digest']}; a step: {rd['per_step']}"
             + (f"; losses {rd['losses']}" if "losses" in rd else ""))
    _log(f"  whole-leaf and engine (a world of one): parameters bitwise "
         f"the plain wrapper's after each of {steps} steps; 4 simulated "
         f"ranks: bitwise the replicated update's (its state "
         f"{sim['replicated_state_bytes'] / 1e9:.4f} GB); launches "
         f"{launches}")
    for k in ("fused_pack", "fused_unpack", "flash_attention_fwd"):
        if not launches[k]:
            raise AssertionError(f"{k} never launched on the zero-1 path: "
                                 f"{launches}")
    timed = _time_zero_layout(grads, layout)
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timed, {**arms, "simulated": sim}


# --- phase 11: the resnet path ---------------------------------------------

RESNET_BATCH, RESNET_IMAGE = 64, 224  # the reference's 64 a GPU at 224^2
RESNET_STEPS = {"hooks": 5, "bare": 3}


def resnet_path_phase(device) -> tuple:
    """ResNet-50 at 224^2, batch 64, bf16 compute over fp32 weights,
    channels_last activations, through ``resnet_probe``'s arms on one
    batch: ``hooks`` (``broadcast_parameters`` of the state_dict and
    ``DistributedOptimizer(SGD(0.05, momentum=0.9))``) for 5 steps and
    ``bare`` (no runtime) for 3, one step of each in every round. Losses
    finite and falling, the arms' first losses equal, K1 launched; img/s,
    MFU, peak memory and the runtime's counters a step; one traced hook
    step. Returns the path's launches and its readings."""
    import torch

    import resnet_probe as rp

    images, labels = rp.synthetic_batch(0, 1, RESNET_BATCH, RESNET_IMAGE,
                                        rp.CONFIGS["50"][2], 0, device)
    _zero_launch_counts()  # just before the path runs
    arms = {name: rp.Arm(name, "50", device, 0, images, labels)
            for name in RESNET_STEPS}
    rd = rp.run_in_turns(arms, RESNET_STEPS, compare_ranks=False)
    launches = _launch_counts()
    for name, r in rd.items():
        r.update(rp.summarize(r, RESNET_BATCH, "50", RESNET_IMAGE, True))
        losses = r["losses"]
        _log(f"  {name}: losses {losses}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: loss did not fall: {losses}")
        _log(f"  {name}: step ms {[round(x * 1e3, 2) for x in r['step_s']]}"
             f"; median after the first {r['median_step_ms']:.2f} ms, "
             f"{r['img_s_per_rank']:.1f} img/s, MFU {r['mfu']:.4f} of 989 "
             f"TFLOP/s; peak {r['peak_bytes'] / 2**30:.2f} GiB")
        for i, c in enumerate(r["per_step"]):
            _log(f"  {name} step {i}: " + ", ".join(
                f"{k} {v}" for k, v in c.items()))
    if rd["hooks"]["losses"][0] != rd["bare"]["losses"][0]:
        raise AssertionError("the arms' first losses differ")
    gap = rd["hooks"]["median_step_ms"] - rd["bare"]["median_step_ms"]
    _log(f"  hooks - bare: {gap:.2f} ms a step; launches {launches}")
    if not (launches["fused_pack"] and launches["fused_unpack"]):
        raise AssertionError(f"K1 never launched on the resnet path: "
                             f"{launches}")
    prof = profile_step(arms["hooks"].step)
    _log_profile(prof)
    for arm in arms.values():
        arm.close()
    del arms, images, labels
    torch.cuda.empty_cache()
    readings = {name: {k: r[k] for k in (
        "losses", "median_step_ms", "img_s_per_rank", "mfu", "peak_bytes",
        "per_step")} for name, r in rd.items()}
    readings["hooks_minus_bare_ms"] = gap
    readings["traced_step"] = {k: prof[k] for k in (
        "wall_ms", "device_ms", "union_ms", "categories")}
    return launches, readings


# --- phase 12: the megaplan path ------------------------------------------

MEGAPLAN_STEPS, MEGAPLAN_STABLE = 8, 3


def _megaplan_arm(arm: str, device, images, labels) -> dict:
    """``MEGAPLAN_STEPS`` grouped steps of ResNet-50 (seed 0) after a fresh
    ``hvd.init``, the megaplan on or off: ``loss.backward()``, one
    ``grouped_allreduce_`` of every gradient, ``opt.step()``. Returns the
    losses, step seconds, counters a step, host seconds a working cycle,
    the megaplan's report and the final parameters."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.common import context

    os.environ.pop("HOROVOD_MEGAPLAN", None)
    if arm == "megaplan":
        os.environ["HOROVOD_MEGAPLAN"] = "1"
        os.environ["HOROVOD_MEGAPLAN_STABLE_ROUNDS"] = str(MEGAPLAN_STABLE)
    hvd.init()
    rt = context.runtime()
    model = rp.build("50", device, 0)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=rp.LR, momentum=rp.MOMENTUM)
    out = {"losses": [], "step_s": [], "per_step": []}
    cyc0 = (rt._m_cycle.sum, rt._m_cycle.count)
    for _ in range(MEGAPLAN_STEPS):
        c0 = _runtime_counts()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        hvd.grouped_allreduce_([p.grad for p in params],
                               name="resnet.grads")
        opt.step()
        out["losses"].append(loss.item())  # waits for the device work
        out["step_s"].append(time.perf_counter() - t0)
        c1 = _runtime_counts()
        out["per_step"].append({k: c1[k] - c0[k] for k in c0})
    cycles = rt._m_cycle.count - cyc0[1]
    out["host_ms_a_cycle"] = (rt._m_cycle.sum - cyc0[0]) * 1e3 / cycles
    out["report"] = hvd.megaplan_report()
    out["params"] = torch.cat([p.detach().reshape(-1) for p in params])
    del model, params, opt
    hvd.shutdown()
    return out


def _megaplan_hook_step(device, images, labels) -> dict:
    """One ``DistributedOptimizer`` hook step under ``HOROVOD_MEGAPLAN=1``:
    the megaplan's counters and the runtime's after it."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp

    os.environ["HOROVOD_MEGAPLAN"] = "1"
    hvd.init()
    arm = rp.Arm("hooks", "50", device, 0, images, labels)
    c0 = _runtime_counts()
    arm.opt.zero_grad()
    F.cross_entropy(arm.model(images), labels).backward()
    arm.opt.step()
    c1 = _runtime_counts()
    out = {"report": hvd.megaplan_report(),
           "step": {k: c1[k] - c0[k] for k in c0}}
    arm.close()
    hvd.shutdown()
    return out


def megaplan_path_phase(device) -> tuple:
    """ResNet-50 at its published widths, 64 images at 224^2, bf16 over
    fp32 weights, seed 0: ``MEGAPLAN_STEPS`` grouped steps without the
    megaplan (``negotiated``) and as many with ``HOROVOD_MEGAPLAN=1`` at
    ``HOROVOD_MEGAPLAN_STABLE_ROUNDS=3`` (``megaplan``), each run after a
    fresh ``init``, in the order negotiated, megaplan, megaplan,
    negotiated (cuDNN deterministic, so the runs may be compared bit for
    bit). Fails unless every run's losses and parameters are bitwise the
    first's, each megaplan run captured once and replayed every step after
    the third, and K1 launched as often in every run. Then one hook step
    under the megaplan. Returns the path's launches and its readings."""
    import torch

    import resnet_probe as rp

    images, labels = rp.synthetic_batch(0, 1, RESNET_BATCH, RESNET_IMAGE,
                                        rp.CONFIGS["50"][2], 0, device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _zero_launch_counts()  # just before the path runs
        arms = {f"{arm}_{i}": _megaplan_arm(arm, device, images, labels)
                for arm, i in (("negotiated", 1), ("megaplan", 1),
                               ("megaplan", 2), ("negotiated", 2))}
        launches = _launch_counts()
        hook = _megaplan_hook_step(device, images, labels)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.environ.pop("HOROVOD_MEGAPLAN", None)
        os.environ.pop("HOROVOD_MEGAPLAN_STABLE_ROUNDS", None)
    for arm, r in arms.items():
        later = r["step_s"][MEGAPLAN_STABLE:]
        r["median_step_ms"] = statistics.median(later) * 1e3
        _log(f"  {arm}: losses {r['losses']}")
        _log(f"  {arm}: step ms {[round(x * 1e3, 2) for x in r['step_s']]}"
             f"; median of the steps after the {MEGAPLAN_STABLE}rd "
             f"{r['median_step_ms']:.2f} ms; host ms a working cycle "
             f"{r['host_ms_a_cycle']:.3f}")
        for i, c in enumerate(r["per_step"]):
            _log(f"  {arm} step {i}: " + ", ".join(
                f"{k} {v}" for k, v in c.items()))
    _log(f"  megaplan report: {arms['megaplan_1']['report']}")
    _log(f"  one hook step under HOROVOD_MEGAPLAN=1: {hook['report']}; "
         + ", ".join(f"{k} {v}" for k, v in hook["step"].items()))
    first = arms["negotiated_1"]
    for arm, r in arms.items():
        if r["losses"] != first["losses"] or not torch.equal(
                r["params"].view(torch.int32),
                first["params"].view(torch.int32)):
            raise AssertionError(f"{arm} differs from negotiated_1")
        rep = r["report"]
        if arm.startswith("megaplan") and (
                rep["captures"] != 1
                or rep["replays"] != MEGAPLAN_STEPS - MEGAPLAN_STABLE):
            raise AssertionError(f"{arm}: the megaplan did not capture once "
                                 f"and replay every later step: {rep}")
    k1 = {sum(c["K1 launches"] for c in r["per_step"])
          for r in arms.values()}
    if len(k1) != 1 or not (launches["fused_pack"]
                            and launches["fused_unpack"]):
        raise AssertionError(f"K1 launches differ between the runs or are "
                             f"missing: {k1}, {launches}")
    _log(f"  losses and parameters bitwise equal across the runs; "
         f"launches {launches}")
    readings = {arm: {k: r[k] for k in ("losses", "median_step_ms",
                                        "host_ms_a_cycle", "per_step",
                                        "report")}
                for arm, r in arms.items()}
    readings["hook_step"] = hook
    del arms, images, labels
    gc.collect()
    torch.cuda.empty_cache()
    return launches, readings


# --- phase 13: K4 (Adasum) and the adasum path ------------------------------

# K4a's sums against the plain version's, each relative to its own scale
# (|a| |b| for the dot, the squared norm for itself): fp32 sums of up to
# 25.6 million products in another order (a block tree against cuBLAS)
K4_SUMS_TOL = 1e-5
# a tree's result against the plain tree's, relative to the largest
# magnitude of the tensor: the coefficients inherit K4a's relative error
K4_TREE_TOL = 1e-4
# fp32 rounding: E[x^2] - E[x]^2 against cuDNN's Welford statistics
SYNC_BN_TOL = 1e-4
# ResNet-50 in fp32 (TF32 off): the synchronized batch norm's variance,
# flax's E[x^2] - E[x]^2, against torch's Welford kernel, through 53 batch
# norms; logits, then each gradient against its own largest magnitude.
# The fp32 subtraction cancels where a channel's mean is large against its
# spread, so a small gradient behind such a layer moves by a few percent
# of itself (1.64e-2 for the last stage's projection, on the card)
SYNC_RESNET_LOGIT_TOL, SYNC_RESNET_GRAD_TOL = 1e-3, 5e-2
SYNC_BN_SHAPE = (64, 256, 56, 56)  # ResNet-50's second stage at batch 64
ADASUM_RANKS = 4


def _k4_sums_err(k, p) -> float:
    import torch

    scale = torch.stack([(p[1] * p[2]).sqrt(), p[1], p[2]]).clamp_min(1e-30)
    return ((k - p).abs() / scale).max().item()


def _k4_case(a, b, name: str) -> tuple:
    """K4a twice (bitwise the same) and against its plain version; K4b
    bitwise its plain version on K4a's sums. Returns (K4a's relative
    error, K4a's largest absolute error, K4b's output)."""
    from horovod_tpu_torch.ops import adasum

    sk = adasum.dot_norms(a, b)
    if not _same_bits(sk, adasum.dot_norms(a, b)):
        raise AssertionError(f"K4a is not bitwise the same from run to run "
                             f"({name})")
    sp = adasum.dot_norms_plain(a, b)
    err = _k4_sums_err(sk, sp)
    if not err <= K4_SUMS_TOL:
        raise AssertionError(f"K4a against its plain version: {err:.3g} "
                             f"(tol {K4_SUMS_TOL}) ({name}): {sk.tolist()} "
                             f"against {sp.tolist()}")
    out = adasum.scaled_add(a, b, sk)
    if not _same_bits(out, adasum.scaled_add_plain(a, b, sk)):
        raise AssertionError(f"K4b differs from its plain version on the "
                             f"same sums ({name})")
    return err, (sk - sp).abs().max().item(), out


def _pair_table(sizes, dtype, device, g, shift_a=0, shift_b=0) -> tuple:
    """ResNet-50's pairs as one K4 table: A and B hold the a rows and the
    b rows back to back from elements ``shift_a`` and ``shift_b`` (a shift
    that is no multiple of 16 bytes' elements puts items off alignment)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops import adasum

    total = sum(sizes)
    A = torch.randn(total + shift_a, generator=g, device=device).to(dtype)
    B = torch.randn(total + shift_b, generator=g, device=device).to(dtype)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return A, B, adasum.Items(offs + shift_a, offs + shift_b, sizes)


def _k4_table_case(A, B, items, name: str) -> tuple:
    """K4a over the table twice (bitwise the same), each item's sums
    bitwise K4a on that pair alone and within ``K4_SUMS_TOL`` of the plain
    version's; K4b bitwise its plain version on the same sums, into a new
    buffer and in place. Returns (K4a's relative error, its largest
    absolute error)."""
    import torch

    from horovod_tpu_torch.ops import adasum

    sums = adasum.dot_norms_table(items, A, B)
    if not _same_bits(sums, adasum.dot_norms_table(items, A, B)):
        raise AssertionError(f"K4a over a table is not bitwise the same "
                             f"from run to run ({name})")
    for k, (a0, b0, n) in enumerate(zip(items.a_off.tolist(),
                                        items.b_off.tolist(),
                                        items.n.tolist())):
        alone = adasum.dot_norms(A[a0:a0 + n], B[b0:b0 + n])
        if not _same_bits(sums[k], alone):
            raise AssertionError(f"K4a's item {k} ({n} elements) in a "
                                 f"table of {len(items)} is not bitwise K4a "
                                 f"on the pair alone ({name}): "
                                 f"{sums[k].tolist()} against "
                                 f"{alone.tolist()}")
    plain = adasum.dot_norms_table_plain(items, A, B)
    err = max(_k4_sums_err(k, p) for k, p in zip(sums, plain))
    if not err <= K4_SUMS_TOL:
        raise AssertionError(f"K4a over a table against its plain version: "
                             f"{err:.3g} (tol {K4_SUMS_TOL}) ({name})")
    out = adasum.scaled_add_table(items, A, B, sums, torch.zeros_like(A))
    want = adasum.scaled_add_table_plain(items, A, B, sums,
                                         torch.zeros_like(A))
    if not _same_bits(out, want):
        raise AssertionError(f"K4b over a table differs from its plain "
                             f"version on the same sums ({name})")
    A2 = A.clone()
    adasum.scaled_add_table(items, A2, B, sums, A2)
    ends = (items.a_off + items.n).tolist()
    for a0, e in zip(items.a_off.tolist(), ends):
        if not _same_bits(A2[a0:e], out[a0:e]):
            raise AssertionError(f"K4b in place differs from K4b into a new "
                                 f"buffer ({name})")
    return err, (sums - plain).abs().max().item()


def _tree_err(got, want, sizes) -> float:
    """The largest error of a packed tree's tensors, each against its own
    largest magnitude."""
    import numpy as np

    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return max(((got[a:b] - want[a:b]).abs().max()
                / want[a:b].abs().max().clamp_min(1e-30)).item()
               for a, b in zip(offs[:-1], offs[1:]) if b > a)


def k4_check_phase(device) -> dict:
    """K4 against its plain version on the card. Tables: ResNet-50's 161
    parameter pairs as one table in fp32 (the path's), and off 16-byte
    alignment in fp32, bf16 and fp16, each item's K4a sums bitwise K4a on
    the pair alone, K4b bitwise its plain version (into a new buffer and in
    place). Tables of one: the 161 shapes in fp32, ResNet-50's 25.6 million
    elements in bf16 and fp16, rows off 16-byte alignment, the zero-norm
    sides (coefficient 0: the other row, bitwise), identical rows (the
    mean: the row, bitwise), orthogonal rows (the sum, bitwise). Trees:
    four rows of one tensor, and packed rows of the 161 tensors at 4, 5
    (the odd row carried) and 8 ranks (a first round of 644 items, past a
    launch's 512: two launches of each kernel), each tensor within
    ``K4_TREE_TOL`` of the plain tree's. Returns the largest errors."""
    import torch

    from horovod_tpu_torch.ops import adasum

    sizes = resnet50_grad_sizes()
    total = sum(sizes)
    g = torch.Generator(device=device).manual_seed(13)
    worst, worst_abs, n = 0.0, 0.0, 0
    for dtype, sa, sb in ((torch.float32, 0, 0), (torch.float32, 1, 2),
                          (torch.bfloat16, 1, 3), (torch.float16, 3, 0)):
        A, B, items = _pair_table(sizes, dtype, device, g, sa, sb)
        e, ea = _k4_table_case(A, B, items, f"{dtype} shifted {sa}/{sb}")
        _log(f"  161 ResNet-50 pairs as one table, {dtype}, shifted "
             f"{sa}/{sb}: each item's K4a bitwise the pair alone, within "
             f"{e:.3g} of the plain sums (tol {K4_SUMS_TOL}); K4b bitwise "
             f"the plain version, in place too")
        worst, worst_abs, n = max(worst, e), max(worst_abs, ea), n + 1
        del A, B
    for i, size in enumerate(sizes):
        a, b = torch.randn((2, size), generator=g, device=device)
        e, ea, _ = _k4_case(a, b, f"ResNet-50 shape {i}, {size}")
        worst, worst_abs, n = max(worst, e), max(worst_abs, ea), n + 1
    _log(f"  161 ResNet-50 shapes in fp32, a table of one each: K4a within "
         f"{worst:.3g} of the plain sums' scale (tol {K4_SUMS_TOL}), "
         f"bitwise from run to run; K4b bitwise the plain version")
    for dtype in (torch.bfloat16, torch.float16):
        a, b = torch.randn((2, total), generator=g, device=device).to(dtype)
        e, ea, _ = _k4_case(a, b, f"{dtype} at {total}")
        _log(f"  {dtype} at {total} elements: K4a {e:.3g}; K4b bitwise")
        worst, worst_abs, n = max(worst, e), max(worst_abs, ea), n + 1
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn(2 * 1_000_003 + 2, generator=g,
                          device=device).to(dtype)
        a, b = buf[1:1_000_004], buf[1_000_005:2_000_008]  # misaligned
        e, ea, _ = _k4_case(a, b, f"misaligned {dtype}")
        worst, worst_abs, n = max(worst, e), max(worst_abs, ea), n + 1
    a, b = torch.randn((2, 1_000_003), generator=g, device=device)
    zero = torch.zeros_like(a)
    for x, y, want, name in (
            (zero, b, b, "a zero side: the other row"),
            (a, zero, a, "b zero side: the other row"),
            (zero, zero, zero, "both zero: zeros"),
            (a, a.clone(), a, "identical rows: the mean"),
            (torch.cat([a[:500_000], zero[500_000:]]),
             torch.cat([zero[:500_000], b[500_000:]]),
             torch.cat([a[:500_000], b[500_000:]]),
             "orthogonal rows: the sum")):
        got = adasum.adasum_combine(x, y)
        if not _same_bits(got, want):
            raise AssertionError(f"K4 on {name} is not exact")
        n += 1
    _log("  exact cases: a zero side gives the other row, identical rows "
         "their mean, orthogonal rows their sum, bit for bit")
    rows = torch.randn((4, total), generator=g, device=device)
    tree = adasum.adasum_tree_reduce(rows)
    plain = adasum.adasum_tree_reduce_plain(rows)
    tree_err = ((tree - plain).abs().max() / plain.abs().max()).item()
    if not tree_err <= K4_TREE_TOL:
        raise AssertionError(f"the K4 tree of four rows against the plain "
                             f"tree: {tree_err:.3g} (tol {K4_TREE_TOL})")
    _log(f"  a tree of 4 rows of {total}: within {tree_err:.3g} of the "
         f"plain tree's largest magnitude (tol {K4_TREE_TOL})")
    del rows, tree, plain
    for nrows in (4, 5, 8):
        rows = torch.randn((nrows, total), generator=g, device=device)
        rounds = adasum.tree_items(nrows, sizes)
        want = {"adasum_dot_norms": sum(
            -(-len(it) // adasum.MAX_ITEMS) for it in rounds)}
        want["adasum_scaled_add"] = want["adasum_dot_norms"]
        before = dict(adasum.kernel_launches)
        tree = adasum.adasum_tree_reduce(rows, sizes)
        made = {k: adasum.kernel_launches[k] - before[k] for k in want}
        plain = adasum.adasum_tree_reduce_plain(rows, sizes)
        err = _tree_err(tree, plain, sizes)
        _log(f"  packed rows of the 161 tensors at {nrows} ranks: "
             f"{len(rounds)} rounds, items {[len(it) for it in rounds]}, "
             f"launches {made}; each tensor within {err:.3g} of the plain "
             f"tree's (tol {K4_TREE_TOL})")
        if made != want:
            raise AssertionError(f"the packed tree at {nrows} ranks launched "
                                 f"{made}, not {want}")
        if not err <= K4_TREE_TOL:
            raise AssertionError(f"the packed tree at {nrows} ranks against "
                                 f"the plain tree: {err:.3g}")
        tree_err = max(tree_err, err)
        n += 1
        del rows, tree, plain
    del a, b, zero
    torch.cuda.empty_cache()
    return {"sums_rel_err": worst, "sums_abs_err": worst_abs,
            "tree_rel_err": tree_err, "cases": n}


def k4_time_phase(device) -> list:
    """K4a and K4b over the adasum path's table, ResNet-50's 161 pairs of
    fp32 deltas in one launch, by events and device time, beside the byte
    bound and the plain version (no one PyTorch call computes a ragged
    table's sums); and as a table of one pair of ResNet-50's 25.6 million
    fp32 elements (a flat gradient a rank), in turns with the library
    yardstick (K4a: three ``torch.dot`` calls over the same rows; K4b:
    none, the composite is the plain version). Returns the two kernel
    entries; the adasum path adds the tree of a step."""
    import torch

    from horovod_tpu_torch.ops import adasum

    sizes = resnet50_grad_sizes()
    total = sum(sizes)
    g = torch.Generator(device=device).manual_seed(17)
    A, B, items = _pair_table(sizes, torch.float32, device, g)
    sums = adasum.dot_norms_table(items, A, B)
    out = torch.empty_like(A)
    errs = {"adasum_dot_norms": (sums - adasum.dot_norms_table_plain(
                items, A, B)).abs().max().item(),
            "adasum_scaled_add": (
                adasum.scaled_add_table(items, A, B, sums, out)
                - adasum.scaled_add_table_plain(items, A, B, sums,
                                                torch.empty_like(A)))
            .abs().max().item()}
    a, b = torch.randn((2, total), generator=g, device=device)
    pair_sums = adasum.dot_norms(a, b)
    pair_out = torch.empty_like(a)
    sums_bytes = len(items) * 12
    fns = {
        "adasum_dot_norms": (
            lambda: adasum.dot_norms_table(items, A, B, sums),
            lambda: adasum.dot_norms_table_plain(items, A, B, sums),
            2 * total * 4 + sums_bytes,
            lambda: adasum.dot_norms(a, b),
            lambda: (torch.dot(a, b), torch.dot(a, a), torch.dot(b, b))),
        "adasum_scaled_add": (
            lambda: adasum.scaled_add_table(items, A, B, sums, out),
            lambda: adasum.scaled_add_table_plain(items, A, B, sums, out),
            3 * total * 4 + sums_bytes,
            lambda: adasum.scaled_add(a, b, pair_sums, pair_out),
            None)}
    entries = []
    for name, (kern, plain, nbytes, pair, lib) in fns.items():
        timed = {"table": kern, "pair": pair}
        if lib is not None:
            timed["library"] = lib
        ev = in_turns(timed, lambda fn: time_ms(fn, iters=50))
        dev = in_turns(timed, lambda fn: device_ms(fn, iters=50))
        plain_ms = time_ms(plain, iters=3, warmup=1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        pair_bound = (nbytes - sums_bytes + 12) / HBM_BYTES_PER_S * 1e3
        sh, sh_by = share_of(bound_ms, dev["table"], ev["table"])
        psh, psh_by = share_of(pair_bound, dev["pair"], ev["pair"])
        _log(f"  {name} over the 161-pair table ({total} fp32 a side), one "
             f"launch: {ev['table']:.4f} ms by events, {dev['table']:.4f} "
             f"device; bound {bound_ms:.4f} ms (bytes); share {sh:.3f} "
             f"({sh_by}); plain {plain_ms:.4f} ms; as one pair: "
             f"{ev['pair']:.4f} ms, {dev['pair']:.4f} device, bound "
             f"{pair_bound:.4f}, share {psh:.3f} ({psh_by})"
             + (f"; three torch.dot calls {ev['library']:.4f} ms, "
                f"{dev['library']:.4f} device" if lib else ""))
        entries.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/adasum.cu",
            "replaces": "horovod_tpu/ops/adasum.py:26",
            "launches": None, "max_abs_err": errs[name],
            "ms": ev["table"], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "library_note": "none for a ragged table",
            "device_ms": dev["table"], "share": sh, "share_by": sh_by,
            "table_items": len(items),
            "pair_ms": ev["pair"], "pair_device_ms": dev["pair"],
            "pair_bound_ms": pair_bound, "pair_share": psh,
            "pair_library_ms": ev.get("library"),
            "pair_library_device_ms": dev.get("library"),
            "pair_library_note": ("three torch.dot calls" if lib else
                                  "none (composite)")})
    del A, B, out, a, b, pair_out
    torch.cuda.empty_cache()
    return entries


def _local_deltas(device, model, params, ranks: int) -> list:
    """Each virtual rank's one local step (SGD(0.05, momentum=0.9) from
    the same weights, on its own seeded batch of 64 at 224^2): the
    parameters' deltas, one list of ``ranks`` flat rows a parameter."""
    import torch
    import torch.nn.functional as F

    import resnet_probe as rp

    start = [p.detach().clone() for p in params]
    deltas = [[] for _ in params]
    for r in range(ranks):
        images, labels = rp.synthetic_batch(0, ranks, RESNET_BATCH,
                                            RESNET_IMAGE, 1000, r, device)
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        opt = torch.optim.SGD(params, lr=rp.LR, momentum=rp.MOMENTUM)
        opt.zero_grad()
        F.cross_entropy(model(images), labels).backward()
        opt.step()
        for d, p, s in zip(deltas, params, start):
            d.append((p.detach() - s).reshape(-1))
    return deltas


def _optimizer_arm(device, op, images, labels, steps: int = 3) -> dict:
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp

    model = rp.build("50", device, 0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=rp.LR, momentum=rp.MOMENTUM),
        named_parameters=model.named_parameters(), op=op)
    out = {"class": type(opt).__name__, "losses": [], "step_ms": []}
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        out["losses"].append(loss.item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["params"] = torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()])
    del model, opt
    gc.collect()
    return out


def _sync_bn_check(device) -> dict:
    """``hvd.SyncBatchNorm`` at a world of one against ``nn.BatchNorm2d``
    on a ``SYNC_BN_SHAPE`` fp32 activation: output, input, weight and bias
    gradients and the running statistics within ``SYNC_BN_TOL`` of each
    tensor's largest magnitude."""
    import torch

    import horovod_tpu_torch as hvd

    g = torch.Generator(device=device).manual_seed(19)
    x = torch.randn(SYNC_BN_SHAPE, generator=g, device=device) * 2 + 0.5
    cot = torch.randn(SYNC_BN_SHAPE, generator=g, device=device)
    c = SYNC_BN_SHAPE[1]
    errs = {}
    outs = []
    for bn in (hvd.SyncBatchNorm(c, device=device),
               torch.nn.BatchNorm2d(c, device=device)):
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c, device=device))
        xi = x.clone().requires_grad_()
        y = bn(xi)
        (y * cot).sum().backward()
        outs.append({"out": y.detach(), "grad_in": xi.grad,
                     "grad_weight": bn.weight.grad,
                     "grad_bias": bn.bias.grad,
                     "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()})
    for k, want in outs[1].items():
        errs[k] = ((outs[0][k] - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
    _log(f"  hvd.SyncBatchNorm against nn.BatchNorm2d, one rank: "
         f"{ {k: f'{v:.3g}' for k, v in errs.items()} } (tol {SYNC_BN_TOL})")
    if max(errs.values()) > SYNC_BN_TOL:
        raise AssertionError("hvd.SyncBatchNorm disagrees with nn.BatchNorm2d")
    del x, cot, outs
    return errs


def _sync_resnet_check(device) -> dict:
    """ResNet-50 in fp32 (TF32 off) with ``sync_bn_group`` over a world of
    one against the unsynchronized path (torch's batch-norm kernel), on 16
    images: logits within ``SYNC_RESNET_LOGIT_TOL`` and each gradient
    within ``SYNC_RESNET_GRAD_TOL`` of its largest magnitude."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.models.resnet import ResNet50

    images, labels = rp.synthetic_batch(0, 1, 16, RESNET_IMAGE, 1000, 0,
                                        device)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    # no TF32 and no atomics in cuDNN's backward: only the batch norms
    # differ between the two runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for group in (None, hvd.global_process_set().group):
            model = ResNet50(dtype=torch.float32, device=device, seed=0,
                             sync_bn_group=group)
            logits = model(images)
            F.cross_entropy(logits, labels).backward()
            runs.append((logits.detach(),
                         {k: p.grad for k, p in model.named_parameters()}))
            del model
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    (l0, g0), (l1, g1) = runs
    logit_err = ((l1 - l0).abs().max() / l0.abs().max()).item()
    errs = {k: ((g1[k] - a).abs().max() / a.abs().max().clamp_min(1e-30))
            .item() for k, a in g0.items()}
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    _log(f"  ResNet-50 fp32, sync_bn_group over one rank against the "
         f"unsynchronized path: logits within {logit_err:.3g} (tol "
         f"{SYNC_RESNET_LOGIT_TOL}), gradients within {grad_err:.3g} of "
         f"each one's largest (tol {SYNC_RESNET_GRAD_TOL}; the worst "
         f"{worst}, largest {g0[worst].abs().max().item():.3g})")
    if logit_err > SYNC_RESNET_LOGIT_TOL or grad_err > SYNC_RESNET_GRAD_TOL:
        raise AssertionError("ResNet with sync_bn_group disagrees with its "
                             "unsynchronized path at one rank")
    return {"logits_rel_err": logit_err, "grads_rel_err": grad_err}


def adasum_path_phase(device) -> tuple:
    """The adasum path on one GPU (module docstring, phase 12). Returns the
    path's launches and its readings."""
    import torch

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.ops import adasum

    model = rp.build("50", device, 0)
    params = list(model.parameters())
    deltas = _local_deltas(device, model, params, ADASUM_RANKS)
    del model, params
    gc.collect()
    # each virtual rank's row: its 161 deltas packed back to back, as the
    # runtime's Adasum chunk packs them
    sizes = [d[0].numel() for d in deltas]
    rows = torch.stack([torch.cat([d[r] for d in deltas])
                        for r in range(ADASUM_RANKS)])
    del deltas
    rounds = adasum.tree_items(ADASUM_RANKS, sizes)
    orig, plain_rows, work = rows.clone(), rows.clone(), rows.clone()
    _zero_launch_counts()  # just before the path runs
    t0 = time.perf_counter()
    got = adasum.adasum_tree_reduce_(rows, rounds=rounds)
    torch.cuda.synchronize()
    tree_host_ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    want_launches = sum(-(-len(it) // adasum.MAX_ITEMS) for it in rounds)
    _log(f"  161 deltas of {ADASUM_RANKS} virtual ranks, packed, through "
         f"adasum_tree_reduce_ on K4: {len(rounds)} rounds of "
         f"{[len(it) for it in rounds]} items, {tree_host_ms:.2f} ms (first "
         f"pass, host clock); launches {launches}")
    if not (launches["adasum_dot_norms"] == want_launches
            and launches["adasum_scaled_add"] == want_launches):
        raise AssertionError(f"K4 launched {launches} times, not "
                             f"{want_launches} of each kernel")
    plain = adasum.adasum_tree_reduce_(plain_rows, rounds=rounds, plain=True)
    tree_err = _tree_err(got, plain, sizes)
    _log(f"  against the plain tree: within {tree_err:.3g} of each "
         f"tensor's largest magnitude (tol {K4_TREE_TOL})")
    if tree_err > K4_TREE_TOL:
        raise AssertionError("the K4 tree disagrees with the plain tree")
    # the tree of a step: every byte of its four launches once
    tree_bytes = sum(5 * it.elements * 4 + 2 * len(it) * 12
                     for it in rounds)
    tree_bound = tree_bytes / HBM_BYTES_PER_S * 1e3

    def step_tree():
        adasum.adasum_tree_reduce_(work, rounds=rounds)

    tree_ms = time_ms(step_tree, iters=20)
    tree_dev = device_ms(step_tree, iters=20)
    tree_share, tree_share_by = share_of(tree_bound, tree_dev, tree_ms)
    _log(f"  the tree of all 161 tensors a step ({2 * want_launches} "
         f"launches): {tree_ms:.4f} ms by events, {tree_dev:.4f} device; "
         f"bound {tree_bound:.4f} ms (bytes); share {tree_share:.3f} "
         f"({tree_share_by})")
    del plain_rows, work, plain
    # the two-level Adasum of the same packed deltas as 2 hosts of 2, on
    # K4, against the same arithmetic on the CPU (the plain version)
    hier = adasum.simulated_hierarchical
    k = hier(list(orig), 2, sizes)[0]
    p = hier([x.cpu() for x in orig], 2, sizes)[0]
    hier_err = _tree_err(k.cpu(), p, sizes)
    _log(f"  two levels (2 hosts of 2) over the packed chunk on K4 against "
         f"the plain version: within {hier_err:.3g} (tol {K4_TREE_TOL})")
    if hier_err > K4_TREE_TOL:
        raise AssertionError("the two-level Adasum on K4 disagrees with the "
                             "plain version")
    del rows, got, orig, k, p
    gc.collect()
    torch.cuda.empty_cache()

    hvd.init()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        images, labels = rp.synthetic_batch(0, 1, RESNET_BATCH, RESNET_IMAGE,
                                            1000, 0, device)
        arms = {"average": _optimizer_arm(device, hvd.Average, images,
                                          labels),
                "adasum": _optimizer_arm(device, hvd.Adasum, images, labels)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, d = arms["average"], arms["adasum"]
    _log(f"  DistributedOptimizer at a world of one: op=Average "
         f"({a['class']}) losses {a['losses']}, op=Adasum ({d['class']}) "
         f"losses {d['losses']}; step ms {[round(x, 1) for x in a['step_ms']]}"
         f" / {[round(x, 1) for x in d['step_ms']]}")
    if d["class"] != "DistributedSGD" or a["losses"] != d["losses"] or not \
            _same_bits(a["params"], d["params"]):
        raise AssertionError("op=Adasum at a world of one is not bitwise the "
                             "plain wrapper")
    del arms, images, labels
    gc.collect()
    sync_bn = _sync_bn_check(device)
    sync_resnet = _sync_resnet_check(device)
    hvd.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    readings = {"tree_rel_err": tree_err, "tree_ms": tree_ms,
                "tree_device_ms": tree_dev, "tree_bound_ms": tree_bound,
                "tree_share": tree_share, "tree_share_by": tree_share_by,
                "tree_items": [len(it) for it in rounds],
                "tree_launches_each": want_launches,
                "tree_first_host_ms": tree_host_ms,
                "hier_rel_err": hier_err,
                "world_one_losses": a["losses"], "sync_bn": sync_bn,
                "sync_resnet": sync_resnet}
    return launches, readings


# --- phase 14: the launcher ------------------------------------------------

LAUNCHED_WORKER = """
import os
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner.http_server import KVStoreClient

hvd.init()
assert hvd.device() == torch.device("cuda", hvd.local_rank()), hvd.device()
# rank 0 bound its store's port itself (the launcher sets none)
assert "MASTER_PORT" not in os.environ and os.environ["HOROVOD_SECRET_KEY"]
kv = KVStoreClient(os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
                   int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]))
kv.put("smoke", f"rank{hvd.rank()}", b"up")
assert kv.get("smoke", f"rank{hvd.rank()}") == b"up"
xs = [torch.full((n,), float(i + 1), device=hvd.device())
      for i, n in enumerate((3, 1000, 257))]
hs = [hvd.allreduce_async_(x, name=f"smoke.{i}", op=hvd.Sum,
                           prescale_factor=2.0) for i, x in enumerate(xs)]
for h in hs:
    hvd.synchronize(h)
for i, x in enumerate(xs):
    assert torch.equal(x, torch.full_like(x, 2.0 * (i + 1) * hvd.size())), x
rank = hvd.rank()
hvd.shutdown()
print("LAUNCHED_WORKER_OK", rank)
"""


# --- phase 13: the elastic path --------------------------------------------

ELASTIC_STEPS, ELASTIC_COMMIT, ELASTIC_FAULT_STEP = 8, 2, 4
ELASTIC_DEPTH = "50"


def _elastic_args(**kw):
    """``elastic_probe.train_resnet``'s arguments for the path."""
    import types

    a = types.SimpleNamespace(
        depth=ELASTIC_DEPTH, image=RESNET_IMAGE, batch=RESNET_BATCH,
        steps=ELASTIC_STEPS, commit_every=ELASTIC_COMMIT, seed=0,
        max_world=1, exit_rank=-1, exit_step=-1, fault_rank=-1,
        fault_step=-1, fault_site="plan.dispatch")
    a.__dict__.update(kw)
    return a


def _elastic_inprocess(device) -> dict:
    """(a): an uninterrupted run, then the run with the fault."""
    import horovod_tpu_torch as hvd
    import elastic_probe as ep

    runs = {}
    for name, kw in (("uninterrupted", {}),
                     ("fault", {"fault_rank": 0,
                                "fault_step": ELASTIC_FAULT_STEP})):
        events = []
        out = ep.train_resnet(_elastic_args(**kw), device=device,
                              log=lambda **e: events.append(e))
        out.pop("model")
        out["events"] = events
        runs[name] = out
        hvd.shutdown()
    ref, got = runs["uninterrupted"], runs["fault"]
    failures = [e for e in got["events"] if e["event"] == "failure"]
    r = got["readings"]
    _log(f"  (a) failure in step {[e['step'] for e in failures]}; "
         f"generation {got['gen']}; failure to the next finished step "
         f"{[round(x * 1e3, 2) for x in r['recovery_s']]} ms; commit ms "
         f"{[round(x, 2) for x in r['commit_ms']]}; losses {r['losses']}")
    if [e["step"] for e in failures] != [ELASTIC_FAULT_STEP]:
        raise AssertionError(f"(a): failures {failures}")
    if got["gen"] != 1 or got["steps"] != ELASTIC_STEPS:
        raise AssertionError(f"(a): generation {got['gen']}, steps "
                             f"{got['steps']}")
    if (got["params"], got["buffers"]) != (ref["params"], ref["buffers"]):
        raise AssertionError("(a): the recovered run's state is not bitwise "
                             "the uninterrupted run's")
    _log("  (a) parameters and buffers bitwise the uninterrupted run's")
    return runs


def _elastic_relaunch(device, root: str, tmp: str, ref: dict) -> dict:
    """(b): the worker crashes after its step-4 commit under the elastic
    launcher and resumes from the store."""
    import elastic_probe as ep

    disc = os.path.join(tmp, "discover.sh")
    with open(disc, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(disc, 0o755)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "--min-np",
           "1", "--max-np", "1", "--host-discovery-script", disc,
           sys.executable, os.path.join(root, "elastic_probe.py"),
           "--worker", "resnet", "--depth", ELASTIC_DEPTH, "--image",
           str(RESNET_IMAGE), "--batch", str(RESNET_BATCH), "--steps",
           str(ELASTIC_STEPS), "--commit-every", str(ELASTIC_COMMIT),
           "--max-world", "1", "--exit-rank", "0", "--exit-step",
           str(ELASTIC_FAULT_STEP)] + (
               ["--device", "cpu"] if device.type == "cpu" else [])
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_ELASTIC_GEN", "HOROVOD_FAULT_SPEC",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=root, HOROVOD_ELASTIC_STORE=os.path.join(
        tmp, "store.pkl"), HOROVOD_ELASTIC_RESPAWN_BACKOFF="0.1")
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    ev = ep.events(out)
    _log(f"  (b) hvdrun --min-np 1 --max-np 1: exit {p.returncode} after "
         f"{time.perf_counter() - t0:.1f} s, {len(ev)} events")
    if p.returncode != 0:
        for line in out.strip().splitlines()[-30:]:
            _log(f"    {line}")
        raise AssertionError("(b): the elastic job failed")
    finals = [e for e in ev if e["event"] == "final"]
    exit_t = [e["t"] for e in ev if e["event"] == "exit"]
    starts = [e for e in ev if e["event"] == "start" and e["inc"] == 1]
    first = min(e["t"] for e in ev if e["event"] == "step" and e["inc"] == 1)
    reading = {"exit_to_first_step_s": first - exit_t[0],
               "parts_s": {"exit_to_worker_start": starts[0]["t_start"]
                           - exit_t[0],
                           "init_and_build": starts[0]["t_built"]
                           - starts[0]["t_start"],
                           "state_restore": starts[0]["t_state"]
                           - starts[0]["t_built"],
                           "sync_and_first_step": first
                           - starts[0]["t_state"]},
               "commit_ms_with_store": [e["ms"] for e in ev
                                        if e["event"] == "commit"],
               "resumed_at": starts[0]["batch_done"]}
    _log(f"  (b) exit to incarnation 1's first step "
         f"{reading['exit_to_first_step_s']:.2f} s "
         f"({ {k: round(v, 3) for k, v in reading['parts_s'].items()} }); "
         f"resumed after step {reading['resumed_at']}; commit ms with the "
         f"store {[round(x, 1) for x in reading['commit_ms_with_store']]}")
    if (len(finals) != 1 or finals[0]["inc"] != 1
            or reading["resumed_at"] != ELASTIC_FAULT_STEP):
        raise AssertionError(f"(b): finals {finals}, resumed at "
                             f"{reading['resumed_at']}")
    if (finals[0]["params"], finals[0]["buffers"]) != (ref["params"],
                                                       ref["buffers"]):
        raise AssertionError("(b): the relaunched run's state is not "
                             "bitwise (a)'s uninterrupted run's")
    _log("  (b) parameters and buffers bitwise (a)'s uninterrupted run's")
    return reading


def _state_on_cpu(sd: dict) -> dict:
    return {"state": {i: {k: v.detach().cpu().clone() for k, v in st.items()}
                      for i, st in sd["state"].items()},
            "param_groups": sd["param_groups"]}


def _same_state(name: str, got: dict, want: dict):
    if set(got["state"]) != set(want["state"]):
        raise AssertionError(f"{name}: state positions differ")
    for i, st in want["state"].items():
        for k, v in st.items():
            _exact(f"{name}: state {i} {k}", got["state"][i][k].cpu(), v)


def _elastic_ckpt(device, tmp: str) -> dict:
    """(c): the async checkpointer under the ZeRO-1 engine."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.opt import sharded as S
    from horovod_tpu_torch.parallel import ring_attention
    from horovod_tpu_torch.utils import async_ckpt

    def sgd(ps):
        return torch.optim.SGD(ps, lr=1e-3, momentum=0.9)

    os.environ.update(HOROVOD_ASYNC_CKPT="1", HOROVOD_ASYNC_CKPT_DIR=os.path.join(
        tmp, "ckpt"))
    try:
        hvd.init(device=device)
        ckpt = async_ckpt.get_checkpointer()
        cfg = full_width_config(2)
        model = TransformerLM(cfg, device=device, seed=0)
        params = list(model.parameters())
        engine = S.ShardedUpdateEngine(sgd, process_set=hvd.global_process_set())
        engine.init(params)
        reading, saved = {"step_ms": []}, None
        for step in (1, 2, 3):
            for p in params:
                p.grad = None
            t0 = time.perf_counter()
            lm_loss(model, tokens_for(cfg, 8, 100 + step, device),
                    attn_fn=ring_attention).backward()
            engine.step(params)
            if device.type == "cuda":
                torch.cuda.synchronize()
            reading["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if step in (1, 2):
                # step 1's snapshot allocates the pinned buffers; step 2's
                # reuses them: the hot path
                t0 = time.perf_counter()
                ckpt.snapshot(step, engine.optimizer.state_dict(),
                              replicated=params, layout=engine.layout)
                reading.setdefault("snapshot_host_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
                reading["snapshot_bytes"] = ckpt.last_snapshot_bytes
                if step == 2:
                    saved = (_state_on_cpu(engine.full_state()),
                             [p.detach().cpu().clone() for p in params])
                t0 = time.perf_counter()
                if not ckpt.flush(deadline_s=300.0):
                    raise AssertionError("(c): the flush failed")
                reading.setdefault("flush_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
                reading.setdefault("writer_ms", []).append(
                    ckpt.last_write_s * 1e3)
                reading.setdefault("copy_device_ms", []).append(
                    ckpt.last_copy_device_ms)
                reading["shard_file_bytes"] = ckpt.last_shard_bytes
        fresh = S.ShardedUpdateEngine(sgd, process_set=hvd.global_process_set())
        t0 = time.perf_counter()
        m, _, replicated = async_ckpt.restore_sharded(ckpt.directory, params,
                                                      fresh)
        reading["restore_ms"] = (time.perf_counter() - t0) * 1e3
        _same_state("(c) restore", _state_on_cpu(fresh.full_state()),
                    saved[0])
        for i, (a, b) in enumerate(zip(replicated, saved[1])):
            _exact(f"(c) parameter {i}", torch.from_numpy(a), b)
        _log(f"  (c) snapshots at steps 1 and 2 (the first allocates the "
             f"pinned buffers): host "
             f"{[round(x, 2) for x in reading['snapshot_host_ms']]} ms, copy "
             f"{[round(x, 2) for x in reading['copy_device_ms']]} device ms, "
             f"{reading['snapshot_bytes']} bytes each; flush "
             f"{[round(x, 1) for x in reading['flush_ms']]} ms, writer "
             f"{[round(x, 1) for x in reading['writer_ms']]} ms, file "
             f"{reading['shard_file_bytes']} bytes; restore "
             f"{reading['restore_ms']:.1f} ms; step ms "
             f"{[round(x, 2) for x in reading['step_ms']]}; restored state "
             "and parameters bitwise the snapshot's")
        del engine, fresh, saved, replicated
        async_ckpt.reset_checkpointer()
        # four simulated ranks' shards restored into three
        leaves = [p.detach().clone() for p in params]
        del model, params
        gc.collect()
        eng4 = S.make_simulated_engines(sgd, 4)
        for e in eng4:
            e.init(leaves)
        grads = [[torch.randn(p.shape, generator=torch.Generator(
            device=device).manual_seed(10 * r + i), device=device)
            for i, p in enumerate(leaves)] for r in range(4)]
        S.simulated_step(eng4, leaves, grads)
        del grads
        sim_dir = os.path.join(tmp, "sim")
        for r, e in enumerate(eng4):
            c = async_ckpt.AsyncCheckpointer(rank=r, world=4,
                                             directory=sim_dir)
            c.snapshot(1, e.optimizer.state_dict(),
                       replicated=leaves if r == 0 else None,
                       layout=e.layout)
            if not c.flush(deadline_s=300.0):
                raise AssertionError("(c): a simulated rank's flush failed")
            c.stop()
        gathered = S.simulated_full_state(eng4)
        del eng4
        t0 = time.perf_counter()
        eng3 = S.make_simulated_engines(sgd, 3)
        for e in eng3:
            async_ckpt.restore_sharded(sim_dir, leaves, e)
        reading["restore_4_to_3_ms"] = (time.perf_counter() - t0) * 1e3
        direct = S.make_simulated_engines(sgd, 3)
        for e in direct:
            e.load_full_state(gathered, leaves)
        _same_state("(c) 4 -> 3", _state_on_cpu(S.simulated_full_state(eng3)),
                    _state_on_cpu(S.simulated_full_state(direct)))
        _log(f"  (c) 4 simulated ranks -> 3 through the files in "
             f"{reading['restore_4_to_3_ms']:.1f} ms: bitwise "
             "load_full_state of the gathered state")
        del eng3, direct, gathered, leaves
        hvd.shutdown()
        return reading
    finally:
        for k in ("HOROVOD_ASYNC_CKPT", "HOROVOD_ASYNC_CKPT_DIR"):
            os.environ.pop(k, None)
        async_ckpt.reset_checkpointer()


def elastic_path_phase(device, root: str) -> tuple:
    """The elastic path (module docstring, phase 13). Returns the path's
    launches (over (a) and (c)) and its readings."""
    import shutil
    import tempfile

    import torch

    import horovod_tpu_torch as hvd

    hvd.shutdown()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    env0 = {k: os.environ.get(k) for k in ("HOROVOD_ELASTIC_GEN",
                                           "HOROVOD_FAULT_SPEC")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    _log(f"  {shutil.disk_usage(tmp).free} bytes free under {tmp}")
    try:
        _zero_launch_counts()  # just before the path runs
        runs = _elastic_inprocess(device)
        for k, v in env0.items():  # the reset bumped the generation
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ckpt = _elastic_ckpt(device, tmp)
        launches = _launch_counts()
        relaunch = _elastic_relaunch(device, root, tmp,
                                     runs["uninterrupted"])
        if not (launches["fused_pack"] and launches["fused_unpack"]):
            raise AssertionError(f"K1 never launched on the elastic path: "
                                 f"{launches}")
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(tmp) for f in fs)
        _log(f"  {written} bytes written under {tmp}; launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fault = runs["fault"]["readings"]
    readings = {"inprocess": {"recovery_ms": [x * 1e3
                                              for x in fault["recovery_s"]],
                              "commit_ms": fault["commit_ms"],
                              "losses": fault["losses"],
                              "uninterrupted_losses":
                              runs["uninterrupted"]["readings"]["losses"]},
                "relaunch": relaunch, "async_ckpt": ckpt,
                "bytes_written": written}
    return launches, readings


# --- phase 14: the observe path --------------------------------------------

OBSERVE_STEPS, OBSERVE_ROUNDS = 8, 3
OBSERVE_TUNE_STEPS, OBSERVE_FIXED_STEPS = 60, 8


def observe_path_phase(device, resnet_hook_ms: float) -> tuple:
    """The observe path (module docstring, phase 14). Returns the path's
    launches and its readings."""
    import shutil
    import tempfile

    import torch

    import horovod_tpu_torch as hvd
    import observe_probe as op
    import resnet_probe as rp

    hvd.shutdown()
    images, labels = rp.synthetic_batch(0, 1, RESNET_BATCH, RESNET_IMAGE,
                                        rp.CONFIGS["50"][2], 0, device)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    env0 = {k: os.environ.get(k) for k in op.KNOBS + ("HOROVOD_ELASTIC_GEN",)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    gen = 0
    try:
        _zero_launch_counts()  # just before the path runs
        runs = {}
        for i in range(OBSERVE_ROUNDS):
            for on in (True, False):
                runs[f"{'on' if on else 'off'}#{i + 1}"] = op.instruments_run(
                    gen, on, tmp, "50", images, labels, OBSERVE_STEPS, None,
                    False)
                gen += 1
        op.init(gen, {}, None)
        gen += 1
        untuned = op.hook_run("50", images, labels, OBSERVE_TUNE_STEPS)
        hvd.shutdown()
        tuned = op.autotune_run(gen, tmp, "50", images, labels,
                                OBSERVE_TUNE_STEPS, None, False)
        gen += 1
        fixed, gen = op.fixed_runs(gen, {"default": op.DEFAULT_CONFIG,
                                         "settled": tuned["settled"]},
                                   "50", images, labels, OBSERVE_FIXED_STEPS,
                                   2, None, False)
        launches = _launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    first = runs["on#1"]["state"]
    for name, rd in runs.items():
        if not torch.equal(rd.pop("state"), first):
            raise AssertionError(f"observe {name}: parameters or buffers "
                                 "differ from on#1's")
        rd.pop("names")
        rd.pop("windows")
        _log(f"  instruments {name}: step ms "
             f"{[round(x * 1e3, 2) for x in rd['step_s']]}; median after the "
             f"first {rd['median_step_ms']:.2f}; chunks a step {rd['chunks']}")
        if "records" in rd:
            _log(f"    {rd['records']}; timeline {rd['timeline']}; "
                 f"{rd['trace_spans']} spans, {rd['open_spans']} open; "
                 f"{rd['flightrec_events']} flight-recorder events; "
                 f"{rd['metrics_file_series']} series in the metrics file")
            _log(f"    perf phases {rd['perf_phases']}")
            _log(f"    anatomy headroom {rd['headroom']}; critical path "
                 f"{rd['critical_path']}")
    on = [rd["median_step_ms"] for k, rd in runs.items() if k.startswith("on")]
    off = [rd["median_step_ms"] for k, rd in runs.items()
           if k.startswith("off")]
    _log(f"  hook step median: instruments on {statistics.median(on):.2f} ms "
         f"({on}), off {statistics.median(off):.2f} ms ({off}); the resnet "
         f"path's hooks {resnet_hook_ms:.2f} ms")
    if not torch.equal(tuned.pop("state"), untuned.pop("state")):
        raise AssertionError("the autotuned run's parameters differ from "
                             "the untuned run's")
    for s in tuned["samples"]:
        _log(f"    autotune sample {s}")
    _log(f"  autotune: {len(tuned['samples'])} samples, settled on "
         f"{tuned['settled']} (converged {tuned['done']}); median step "
         f"{tuned['median_step_ms']:.2f} ms against the untuned "
         f"{untuned['median_step_ms']:.2f}; parameters bitwise the untuned "
         f"run's; {tuned['proposals_checked']} proposals each ran at the "
         f"next sample")
    for name, f in fixed.items():
        _log(f"  fixed {name}: step ms "
             f"{[round(x * 1e3, 2) for x in f['step_s']]}; median after the "
             f"first {f['median_step_ms']:.2f}; chunks a step {f['chunks']}")
    if not (launches["fused_pack"] and launches["fused_unpack"]):
        raise AssertionError(f"K1 never launched on the observe path: "
                             f"{launches}")
    _log(f"  launches {launches}")
    readings = {"instruments": runs,
                "hook_median_ms": {"on": statistics.median(on),
                                   "off": statistics.median(off),
                                   "resnet_path_hooks": resnet_hook_ms},
                "autotune": {k: tuned[k] for k in (
                    "samples", "settled", "done", "median_step_ms",
                    "step_s", "knobs_at_samples", "proposals_checked")},
                "untuned": {k: untuned[k] for k in ("median_step_ms",
                                                    "step_s")},
                "fixed": fixed}
    del images, labels
    gc.collect()
    torch.cuda.empty_cache()
    return launches, readings


def launcher_phase(root: str):
    """One worker through the port's hvdrun, on the card."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
           sys.executable, "-c", LAUNCHED_WORKER]
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("MASTER_PORT", None)  # rank 0 picks its store's port
    t0 = time.perf_counter()
    # a session of its own, so a timeout ends the launcher and its worker
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    _log(f"  hvdrun -np 1: exit {p.returncode} after "
         f"{time.perf_counter() - t0:.1f} s")
    for line in out.strip().splitlines()[-10:]:
        _log(f"    {line}")
    if p.returncode != 0 or "LAUNCHED_WORKER_OK" not in out:
        raise AssertionError("the launched worker failed")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import horovod_tpu_torch as hvd

    _log(card_line())
    kind = torch.cuda.get_device_name(0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")

    build_phase()

    hvd.init()
    device = hvd.device()
    _log(f"[flash] on {device} ({torch.distributed.get_backend()})")
    kernels = kernel_phase(device)

    _phase("[K1]")
    k1_check_phase(device)
    kernels += k1_time_phase(device, full_width_config(12))
    kernels[-2].update(k1_compaction_phase(device))  # the pack's entry
    _phase("[K2/K3] the compressed wire against its plain version")
    t_wire = time.perf_counter()
    wire_check_phase(device)
    _log(f"  wire phase: {time.perf_counter() - t_wire:.1f} s")

    _phase("[main path] 12 layers at full width, 5 steps, through the runtime")
    launches = main_path_phase(device)
    _phase("[fp32 path] the same LM in fp32, 3 steps, through the runtime")
    fp32_launches = fp32_path_phase(device)

    _phase("[slice vs plain]")
    slice_vs_plain_phase(device)
    _phase("[collectives path] allgather, alltoall, reducescatter, sparse, "
         "a process set, join, objects, on the full-width LM's tensors")
    t_coll = time.perf_counter()
    coll_launches, readings = collectives_path_phase(device)
    _log(f"  collectives path: {time.perf_counter() - t_coll:.1f} s")
    _phase("[compression path] the full-width LM's gradients at 4 virtual "
         "ranks through the bf16, int8 and int4 wires")
    t_comp = time.perf_counter()
    wire_entries = compression_path_phase(device)
    _log(f"  compression path: {time.perf_counter() - t_comp:.1f} s")
    _phase("[world-of-one fallback] HOROVOD_COMPRESSION=int8 at one rank")
    fallback_phase(device)
    _phase("[sp] the simulated rings (n = 2, 4, blocked and striped) and "
         "Ulysses (n = 4) at seq 8192 through the flash kernel")
    t_sp = time.perf_counter()
    _zero_launch_counts()  # just before the path runs
    sp_phase(device)
    sp_launches = _launch_counts()
    _log(f"  sp phase: {time.perf_counter() - t_sp:.1f} s")
    _phase("[K5] the chunked cross-entropy's two kernels against their plain "
         "version")
    t_k5 = time.perf_counter()
    k5_entries = xent_phase(device)
    _log(f"  K5 phase: {time.perf_counter() - t_k5:.1f} s")
    _phase("[long-context path] 12 layers at full width, seq 8192, batch 1, "
         "remat and the chunked loss, 4 steps through the runtime; then "
         "without remat, then also with the dense loss")
    t_lc = time.perf_counter()
    lc_launches = long_context_phase(device)
    _log(f"  long-context path: {time.perf_counter() - t_lc:.1f} s")
    _phase("[zero-1 path] 12 layers at full width, 3 steps each: the plain "
           "wrapper, the whole-leaf front end, the engine at a world of "
           "one; then 4 simulated ranks")
    t_z = time.perf_counter()
    zero_launches, zero_timed, zero_arms = zero1_phase(device)
    _log(f"  zero-1 path: {time.perf_counter() - t_z:.1f} s")
    _phase("[resnet path] ResNet-50 at 224^2, batch 64, bf16, channels_last: "
           "5 hook steps and 3 bare ones in turns")
    t_r = time.perf_counter()
    resnet_launches, resnet_readings = resnet_path_phase(device)
    _log(f"  resnet path: {time.perf_counter() - t_r:.1f} s")
    hvd.shutdown()
    _phase("[megaplan path] ResNet-50 at 224^2, batch 64, bf16: 8 grouped "
           "steps negotiated and 8 under HOROVOD_MEGAPLAN=1, in the order "
           "N M M N, each run after a fresh init; one hook step under the "
           "megaplan")
    t_m = time.perf_counter()
    mp_launches, mp_readings = megaplan_path_phase(device)
    _log(f"  megaplan path: {time.perf_counter() - t_m:.1f} s")
    _phase("[K4] Adasum's two kernels over tables against their plain "
           "versions, then timed over ResNet-50's 161 pairs as one table")
    t_k4 = time.perf_counter()
    k4_check = k4_check_phase(device)
    k4_entries = k4_time_phase(device)
    _log(f"  K4 phase: {time.perf_counter() - t_k4:.1f} s")
    _phase("[adasum path] ResNet-50's 161 deltas of 4 virtual ranks through "
           "the Adasum tree on K4; Adasum, SyncBatchNorm and sync_bn_group "
           "at a world of one")
    t_a = time.perf_counter()
    ada_launches, ada_readings = adasum_path_phase(device)
    ada_readings["k4_check"] = k4_check
    for entry in k4_entries:  # the tree of a step: both kernels, 2 rounds
        entry.update({f"step_tree_{k}": ada_readings[f"tree_{k}"] for k in (
            "ms", "device_ms", "bound_ms", "share", "items",
            "launches_each")})
    _log(f"  adasum path: {time.perf_counter() - t_a:.1f} s")
    _phase("[elastic path] ResNet-50 under hvd.elastic.run: an in-process "
           "recovery and a relaunch from the store, each bitwise an "
           "uninterrupted run; the async checkpointer under the ZeRO-1 "
           "engine (the LM at 2 layers) and a 4 -> 3 restore")
    t_e = time.perf_counter()
    el_launches, el_readings = elastic_path_phase(device, root)
    _log(f"  elastic path: {time.perf_counter() - t_e:.1f} s")
    _phase("[observe path] ResNet-50 at 224^2, batch 64, bf16: 8 hook steps "
           "with every instrument on and 8 with none, in turns for 3 "
           "rounds; 60 steps under HOROVOD_AUTOTUNE=1 against 60 untuned; "
           "the default and the settled configuration as fixed knobs")
    t_o = time.perf_counter()
    ob_launches, ob_readings = observe_path_phase(
        device, resnet_readings["hooks"]["median_step_ms"])
    _log(f"  observe path: {time.perf_counter() - t_o:.1f} s")
    # each kernel's launches on the path that runs it: the fp32 flash
    # kernel's on the fp32 path, K2's and K3's on the compression path,
    # K5's on the long-context path, the others' on the main path
    for entry in wire_entries:
        entry["launches_by_path"] = {
            "compression": entry["launches"],
            "observe": ob_launches.get(entry["name"], 0)}
    for entry in kernels:
        path = (fp32_launches if entry["name"] == "flash_attention_fwd_fp32"
                else launches)
        entry["launches"] = path[entry["name"]]
        entry["launches_by_path"] = {
            "main": launches[entry["name"]],
            "fp32": fp32_launches[entry["name"]],
            "collectives": coll_launches[entry["name"]],
            "sp": sp_launches[entry["name"]],
            "long_context": lc_launches[entry["name"]],
            "zero1": zero_launches[entry["name"]],
            "resnet": resnet_launches[entry["name"]],
            "megaplan": mp_launches[entry["name"]],
            "adasum": ada_launches[entry["name"]],
            "elastic": el_launches[entry["name"]],
            "observe": ob_launches[entry["name"]]}
        if entry["name"] in ("fused_pack", "fused_unpack"):
            entry["zero1_layout"] = zero_timed[entry["name"][6:]]
    for entry in k5_entries:  # K5's path is the long-context one
        entry["launches"] = lc_launches[entry["name"]]
        entry["launches_by_path"] = {
            "long_context": entry["launches"],
            "observe": ob_launches.get(entry["name"], 0)}
    for entry in k4_entries:  # K4's path is the adasum one
        entry["launches"] = ada_launches[entry["name"]]
        entry["launches_by_path"] = {
            "adasum": entry["launches"],
            **{path: counts[entry["name"]] for path, counts in (
                ("main", launches), ("fp32", fp32_launches),
                ("collectives", coll_launches), ("sp", sp_launches),
                ("long_context", lc_launches), ("zero1", zero_launches),
                ("resnet", resnet_launches), ("megaplan", mp_launches),
                ("elastic", el_launches), ("observe", ob_launches))}}

    kernels += wire_entries + k5_entries + k4_entries

    _phase("[launcher]")
    launcher_phase(root)

    _log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"collectives": readings}))
    print(json.dumps({"zero1": zero_arms}))
    print(json.dumps({"resnet": resnet_readings}))
    print(json.dumps({"megaplan": mp_readings}))
    print(json.dumps({"adasum": ada_readings}))
    print(json.dumps({"elastic": el_readings}))
    print(json.dumps({"observe": ob_readings}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
