#!/usr/bin/env python3
"""Synthetic image-model training through the port's
``DistributedOptimizer``, Horovod's ``pytorch_synthetic_benchmark`` shape
(root script, not part of the package).

    python3 resnet_probe.py [-np N] [--model resnet] [--depth 50]
        [--batch 64] [--steps 10] [--image 224]
        [--wires off,bf16,int8] [--arms hooks,bare,spmd,spmd_zero1]
        [--device cpu] [--seed 0] [--dump PATH] [--out PATH]
    hvdrun -np N python resnet_probe.py [same options]

Run by itself, the script starts one ``hvdrun`` job of ``-np`` workers for
each model in ``--model`` (a comma-separated list) and each wire in
``--wires`` (``HOROVOD_COMPRESSION`` set to it; the default is ``off`` at
one rank, ``off,bf16`` at more) and checks what they report; ``--out``
writes every job's reading and the summary to one JSON file. Started by a
launcher (``HOROVOD_RANK`` set) it is one worker of a job, the wire being
what ``HOROVOD_COMPRESSION`` says. One GPU a worker; ``--device cpu`` runs
the workers over gloo.

Every worker builds ``--model`` from ``horovod_tpu_torch.models``:
``resnet`` at ``--depth`` (50, 101 or 152 at full width, 1000 classes;
``tiny``: one block a stage of 8 filters, 10 classes), or ``vgg16``,
``inception3`` or ``vit_b16`` at their published widths and 1000 classes;
``--image`` defaults to the model's published side (its module's
``IMAGE``: 299 for Inception V3, 224 else). VGG-16 is the
communication-heavy one:
138,357,544 parameters, 553 MB of fp32 gradients a step. Compute is bf16
over fp32 weights on the card and fp32 on the CPU. Each trains on one
synthetic batch, ``--batch`` images a rank of ``--image``² (numpy from
``--seed``: the global batch, each rank its slice, the same batch every
step, as ``bench.py:177-181``), with ``SGD(lr=0.05, momentum=0.9)``
(``bench.py:201``) and cross-entropy; dropout (VGG-16, Inception V3) draws
from each model's own generator, seeded from its seed. The arms take their
steps in turns, one step each in every round, in one process:

- ``hooks``: ``hvd.init()``, a model from seed ``--seed + rank``,
  ``hvd.broadcast_parameters(model.state_dict())`` (parameters and BN
  buffers) and ``hvd.DistributedOptimizer``: every gradient through the
  runtime (K1 pack, NCCL, K1 unpack; on the bf16 wire K2 and the
  reduce-unpack);
- ``bare``: a model from seed ``--seed`` and the plain optimizer, no
  runtime: the floor against which the runtime's cost a step is read;
- ``spmd``: the JAX package's own loop (``bench.py::bench_resnet``): the
  model as ``hooks`` builds it, stepped through ``data_parallel_step``
  and the in-step ``hvd.opt.DistributedOptimizer(SGD(0.05,
  momentum=0.9), group=step.group)``: one fused collective a dtype from
  the caller's thread after the backward, no runtime; on the ``bf16``
  wire the cast compressor (K2), on ``int8`` EQuARX with error feedback
  (K3, ``all_to_all_single``, the reduce-unpack, ``all_gather``);
- ``spmd_zero1``: ``spmd`` with ``sharded_update=True`` (ZeRO-1 in the
  step), on the ``off`` wire only: the JAX package refuses compression
  with a sharded update, so the other wires' jobs leave it out.

After every step of ``hooks``, ``spmd`` and ``spmd_zero1`` each rank
compares its parameters bit for bit with rank 0's (broadcast outside the
timed step; BN buffers are per rank and are not compared); a difference
fails the job. Rank 0 prints per arm
the losses, the step ms (host clock around ``loss.item()``, which waits
for the step's device work), img/s a rank and, on the card, MFU from the
median of the steps after the first, peak memory (``max_memory_allocated`` over the
arm's steps; the other arm's model stays resident) and, for ``hooks``, the
runtime's counters a step (cycles, chunks, collective calls, fused-plan
hits and misses, K1 and wire-kernel launches, the gradient bytes the
allreduces took and the bytes they put on the wire: the bf16 wire's
chunks at two bytes an element, the rest at their own width; for the
in-step arms their calls into the communicator), each arm's optimizer
state bytes a rank, then one JSON line. MFU is img/s x 3 x the forward FLOPs of an image over 989
TFLOP/s (bf16); for VGG-16 and Inception V3 it is given at the published
side only (their modules' figures).
``--trace`` takes one more step of each arm under ``torch.profiler`` on
every rank (``chip_smoke.profile_step``) and reports rank 0's wall, busy
union, idle share and device ms by category.
``--dump PATH`` makes each rank save its ``hooks`` model's ``state_dict``
after the last step to ``PATH`` with ``.rank<r>`` before the suffix.

The parent checks that every loss is finite and that, on rank 0, every
arm's first loss is the same (the same weights and batch). The exit code
is 0 only when every job and check passed.
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

# stage sizes, filters, classes
CONFIGS = {"50": ([3, 4, 6, 3], 64, 1000), "101": ([3, 4, 23, 3], 64, 1000),
           "152": ([3, 8, 36, 3], 64, 1000), "tiny": ([1, 1, 1, 1], 8, 10)}
# bench.py:92-94: FLOPs as 2 x MACs; ResNet-50 4.09 GMACs and ResNet-101
# 7.8 GMACs an image at 224^2 (forward). Other depths and sizes: counted
# from the shapes (fwd_flops)
FWD_FLOP_PER_IMG_224 = {"50": 2 * 4.09e9, "101": 2 * 7.8e9}
TRAIN_FLOP_MULT = 3.0          # forward and backward, bench.py:94
PEAK_BF16_FLOPS = 989e12       # H100 SXM, dense tensor cores
LR, MOMENTUM = 0.05, 0.9       # bench.py:201
ARMS = ("hooks", "bare", "spmd", "spmd_zero1")
WIRES = ("off", "bf16", "int8")
# the model zoo beside ResNet: module and constructor in
# horovod_tpu_torch.models, and the module's forward FLOPs of an image at
# its published side (2 x MACs, the JAX package's figures; ViT-B/16's
# counted from its shapes by vit_fwd_flops at any side)
ZOO = {"vgg16": ("vgg", "VGG16", "VGG16_FWD_FLOP_PER_IMG"),
       "inception3": ("inception", "InceptionV3",
                      "INCEPTION3_FWD_FLOP_PER_IMG"),
       "vit_b16": ("vit", "ViT_B16", None)}
MODELS = ("resnet",) + tuple(ZOO)
ZOO_CLASSES = 1000


def vit_fwd_flops(image: int = 224, classes: int = 1000, p: int = 16,
                  d: int = 768, layers: int = 12, mlp: int = 3072) -> float:
    """Forward FLOPs of one image through ViT-B/16 (2 x the MACs of the
    patch embedding, the projections, attention's two products, the MLP
    and the head)."""
    n = (image // p) ** 2
    t = n + 1
    macs = n * 3 * p * p * d
    macs += layers * (t * (4 * d * d + 2 * d * mlp) + 2 * t * t * d)
    return 2.0 * (macs + d * classes)


def _module(model: str):
    """``model``'s module in ``horovod_tpu_torch.models``."""
    import importlib

    name = ZOO[model][0] if model in ZOO else "resnet"
    return importlib.import_module(f"horovod_tpu_torch.models.{name}")


def image_of(model: str, image) -> int:
    """``image``, or the model's published side (its module's ``IMAGE``)."""
    return image or _module(model).IMAGE


def classes_of(model: str, depth: str) -> int:
    """ResNet's classes by depth; 1000 for the zoo."""
    return ZOO_CLASSES if model in ZOO else CONFIGS[depth][2]


def fwd_flops(depth: str, image: int) -> float:
    """Forward FLOPs of one image (2 x the MACs of the convolutions and the
    head), counted from the shapes."""
    stages, filters, classes = CONFIGS[depth]
    h = (image + 6 - 7) // 2 + 1           # the 7x7 stride-2 stem
    macs = h * h * filters * 3 * 49
    h = (h + 2 - 3) // 2 + 1               # the 3x3 stride-2 max pool
    cin = filters
    for i, blocks in enumerate(stages):
        f = filters * 2 ** i
        for j in range(blocks):
            s = 2 if i > 0 and j == 0 else 1
            ho = -(-h // s)
            macs += h * h * cin * f + ho * ho * f * f * 9 + ho * ho * f * 4 * f
            if cin != 4 * f or s != 1:
                macs += ho * ho * cin * 4 * f
            h, cin = ho, 4 * f
    return 2.0 * (macs + cin * classes)


def flop_per_img(depth: str, image: int, model: str = "resnet"):
    """Forward FLOPs of an image; a zoo model's at its published side
    only (else None)."""
    if model in ZOO:
        flops = ZOO[model][2]
        if flops is None:
            return vit_fwd_flops(image)
        mod = _module(model)
        return getattr(mod, flops) if image == mod.IMAGE else None
    if image == 224 and depth in FWD_FLOP_PER_IMG_224:
        return FWD_FLOP_PER_IMG_224[depth]
    return fwd_flops(depth, image)


def build(depth: str, device, seed: int, sync_bn_group=None,
          model: str = "resnet", image: int = None):
    """``model`` (ResNet at ``depth``, or a zoo model) for ``image``² inputs
    (default: its published side); ``sync_bn_group`` synchronizes a
    ResNet's batch norms over that group (``models/resnet.py``)."""
    import torch

    from horovod_tpu_torch.models.resnet import ResNet

    kw = dict(num_classes=classes_of(model, depth), image=image,
              dtype=torch.bfloat16 if device.type == "cuda" else
              torch.float32, device=device, seed=seed)
    if model == "resnet":
        stages, filters, _ = CONFIGS[depth]
        return ResNet(stages, num_filters=filters,
                      sync_bn_group=sync_bn_group, **kw)
    return getattr(_module(model), ZOO[model][1])(**kw)


def synthetic_batch(seed: int, ranks: int, batch: int, image: int,
                    classes: int, rank: int, device):
    """This rank's slice of the global batch of ``ranks * batch`` NCHW
    images and labels drawn from ``seed``."""
    import numpy as np
    import torch

    lo, hi = rank * batch, (rank + 1) * batch
    images = np.random.RandomState(seed).randn(
        ranks * batch, 3, image, image).astype(np.float32)[lo:hi]
    labels = np.random.RandomState(seed + 1).randint(
        0, classes, ranks * batch)[lo:hi]
    return (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


def in_step_compression(wire: str):
    """The in-step optimizer's compressor for a wire: the bf16 cast
    compressor, or the int8 marker (EQuARX, error feedback on)."""
    from horovod_tpu_torch import opt as O

    return {"off": None, "bf16": O.Compression.bf16,
            "int8": O.Compression.int8}[wire]


class Arm:
    """One arm's model, optimizer and training step. ``wire`` is the
    in-step arms' (the hooks arm's is the runtime's,
    ``HOROVOD_COMPRESSION``)."""

    def __init__(self, name: str, depth: str, device, seed: int,
                 images, labels, model: str = "resnet", wire: str = "off"):
        import torch

        import horovod_tpu_torch as hvd

        self.name, self.images, self.labels = name, images, labels
        self.synced = name != "bare"
        self.spmd = name.startswith("spmd")
        rank = hvd.rank() if self.synced else 0
        self.model = build(depth, device, seed + rank, model=model,
                           image=images.shape[-1])
        self.params = list(self.model.parameters())
        self.opt = torch.optim.SGD(self.params, lr=LR, momentum=MOMENTUM)
        if self.synced:
            hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)
        if name == "hooks":
            self.opt = hvd.DistributedOptimizer(
                self.opt, named_parameters=self.model.named_parameters())
        elif self.spmd:
            from horovod_tpu_torch.parallel import data_parallel_step

            self.dp = data_parallel_step(self._train, batch_argnums=(2, 3))
            self.opt = hvd.opt.DistributedOptimizer(
                lambda ps: torch.optim.SGD(ps, lr=LR, momentum=MOMENTUM),
                self.model.named_parameters(), group=self.dp.group,
                compression=in_step_compression(wire),
                sharded_update=name == "spmd_zero1")

    @staticmethod
    def _train(model, opt, images, labels) -> float:
        import torch.nn.functional as F

        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        return loss.item()  # waits for the step's device work

    def step(self) -> float:
        if self.spmd:
            return self.dp(self.model, self.opt, self.images, self.labels)
        return self._train(self.model, self.opt, self.images, self.labels)

    def state_bytes(self) -> int:
        """The optimizer's state on this rank (the inner one's for the
        in-step arms)."""
        from horovod_tpu_torch.opt import optimizer_state_bytes

        return optimizer_state_bytes(self.opt.optimizer if self.spmd
                                     else self.opt)

    def close(self):
        del self.model, self.params, self.opt
        gc.collect()  # the hook optimizer sits in a reference cycle


def runtime_counts() -> dict:
    """The runtime's counters that a step moves."""
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import fused_pack as fp
    from horovod_tpu_torch.ops import quant_wire as qw
    from horovod_tpu_torch.utils import metrics

    rt = context.runtime()
    reg = metrics.get_registry()
    payload = int(reg.counter_value("hvd_allreduce_bytes_total"))
    return {"cycles": rt.cycles, "chunks": rt.chunks,
            "collective calls": rt.collective_calls,
            "plan hits": int(reg.counter_value("hvd_fused_plan_hits_total")),
            "plan misses": int(reg.counter_value(
                "hvd_fused_plan_misses_total")),
            "in-step calls": sum(C.spmd_calls.values()),
            "K1 launches": sum(fp.kernel_launches.values()),
            "wire kernel launches": sum(qw.kernel_launches.values()),
            "allreduce bytes": payload,
            "wire bytes": payload - int(reg.counter_value(
                "hvd_compression_bytes_total", stage="pre")) + int(
                    reg.counter_value("hvd_compression_bytes_total",
                                      stage="post"))}


def same_as_rank0(params, group) -> bool:
    """This rank's parameters bitwise equal to rank 0's."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in params])
    ref = flat.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    return torch.equal(flat.view(torch.int32), ref.view(torch.int32))


def run_in_turns(arms: dict, steps: dict, compare_ranks: bool) -> dict:
    """``steps[name]`` steps of each arm, one step of each in every round
    while it has steps left. Returns per arm the losses, step seconds,
    peak bytes, and for the synced arms the runtime's counters a step and
    whether every rank's parameters equalled rank 0's after each step."""
    import torch

    import horovod_tpu_torch as hvd

    device = hvd.device()
    cuda = device.type == "cuda"
    group = hvd.global_process_set().group
    out = {name: {"losses": [], "step_s": [], "per_step": [], "peak_bytes": 0,
                  "same_on_every_rank": []} for name in arms}
    for i in range(max(steps.values())):
        for name, arm in arms.items():
            if i >= steps[name]:
                continue
            rd = out[name]
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            c0 = runtime_counts() if arm.synced else None
            t0 = time.perf_counter()
            rd["losses"].append(arm.step())
            rd["step_s"].append(time.perf_counter() - t0)
            if arm.synced:
                c1 = runtime_counts()
                rd["per_step"].append({k: c1[k] - c0[k] for k in c0})
            if cuda:
                rd["peak_bytes"] = max(
                    rd["peak_bytes"], torch.cuda.max_memory_allocated(device))
            if arm.synced and compare_ranks:
                same = same_as_rank0(arm.params, group)
                rd["same_on_every_rank"].append(same)
                if not same:
                    raise AssertionError(
                        f"rank {hvd.rank()}: parameters differ from rank "
                        f"0's after step {i} ({name})")
    return out


def summarize(rd: dict, batch: int, depth: str, image: int,
              cuda: bool, model: str = "resnet") -> dict:
    """Median step after the first (the only one if there is one), img/s
    a rank and, on the card, MFU (where the FLOPs are known)."""
    later = rd["step_s"][1:] or rd["step_s"]
    steady = statistics.median(later)
    img_s = batch / steady
    flops = flop_per_img(depth, image, model)
    mfu = (img_s * TRAIN_FLOP_MULT * flops / PEAK_BF16_FLOPS
           if cuda and flops else None)
    return {"median_step_ms": steady * 1e3, "img_s_per_rank": img_s,
            "mfu": mfu}


def worker(args) -> int:
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=args.device)
    device, n, r = hvd.device(), hvd.size(), hvd.rank()
    wire = os.environ.get("HOROVOD_COMPRESSION", "") or "off"
    image = image_of(args.model, args.image)
    classes = classes_of(args.model, args.depth)
    images, labels = synthetic_batch(args.seed, n, args.batch, image,
                                     classes, r, device)
    names = [a for a in args.arms.split(",")
             if a != "spmd_zero1" or wire == "off"]
    arms = {name: Arm(name, args.depth, device, args.seed, images, labels,
                      args.model, wire)
            for name in names}
    readings = run_in_turns(arms, {name: args.steps for name in arms},
                            compare_ranks=n > 1)
    for name, arm in arms.items():
        readings[name]["state_bytes"] = arm.state_bytes()
    if args.trace and device.type == "cuda":
        import chip_smoke

        for name, arm in arms.items():  # every rank steps, rank 0 reads
            prof = chip_smoke.profile_step(arm.step)
            readings[name]["traced_step"] = {
                "wall_ms": prof["wall_ms"], "union_ms": prof["union_ms"],
                "idle_share": max(0.0, 1 - prof["union_ms"]
                                  / prof["wall_ms"]),
                "categories": prof["categories"], "gaps": prof["gaps"]}
    if args.dump and "hooks" in arms:
        stem, ext = os.path.splitext(args.dump)
        np.savez(f"{stem}.rank{r}{ext or '.npz'}",
                 **{k: v.detach().cpu().numpy()
                    for k, v in arms["hooks"].model.state_dict().items()})
    for arm in arms.values():
        arm.close()
    for name, rd in readings.items():
        rd.update(summarize(rd, args.batch, args.depth, image,
                            device.type == "cuda", args.model))
        rd["peak_bytes_by_rank"] = hvd.allgather_object(rd["peak_bytes"])
    if r == 0:
        for name, rd in readings.items():
            peak, mfu = (("not measured",) * 2 if device.type != "cuda" else
                         (f"{rd['peak_bytes'] / 2**30:.2f} GiB",
                          "not computed" if rd["mfu"] is None else
                          f"{rd['mfu']:.4f}"))
            print(f"  {wire} wire, {name}: losses {rd['losses']}", flush=True)
            print(f"  {wire} wire, {name}: step ms "
                  f"{[round(s * 1e3, 2) for s in rd['step_s']]}; median "
                  f"after the first {rd['median_step_ms']:.2f} ms, "
                  f"{rd['img_s_per_rank']:.1f} img/s a rank, MFU {mfu}; "
                  f"peak {peak}", flush=True)
            for i, c in enumerate(rd["per_step"]):
                print(f"  {wire} wire, {name}: step {i}: "
                      + ", ".join(f"{k} {v}" for k, v in c.items()),
                      flush=True)
            print(f"  {wire} wire, {name}: optimizer state "
                  f"{rd['state_bytes']} bytes a rank", flush=True)
            if "traced_step" in rd:
                t = rd["traced_step"]
                print(f"  {wire} wire, {name}: traced step wall "
                      f"{t['wall_ms']:.2f} ms, busy {t['union_ms']:.2f} ms, "
                      f"idle share {t['idle_share']:.4f}; "
                      f"{ {k: round(v, 3) for k, v in t['categories'].items() if v} }",
                      flush=True)
            if rd["same_on_every_rank"]:
                print(f"  {wire} wire, {name}: parameters bitwise equal on "
                      f"every rank after every step: "
                      f"{all(rd['same_on_every_rank'])}", flush=True)
        print(json.dumps({"resnet_probe": readings, "wire": wire,
                          "ranks": n, "model": args.model,
                          "depth": args.depth, "batch": args.batch,
                          "image": image, "classes": classes,
                          "device": str(device),
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu")}),
              flush=True)
    hvd.shutdown()
    print(f"RESNET_PROBE_OK {r}", flush=True)
    return 0


def check(reading: dict):
    """Finite losses; every arm's first loss the same on rank 0."""
    arms = reading["resnet_probe"]
    for name, rd in arms.items():
        if not all(math.isfinite(x) for x in rd["losses"]):
            raise AssertionError(f"{name}: losses {rd['losses']}")
    firsts = {rd["losses"][0] for rd in arms.values()}
    if len(firsts) != 1:
        raise AssertionError(f"the arms' first losses differ: "
                             f"{ {k: v['losses'][0] for k, v in arms.items()} }")


def run_job(args, model: str, wire: str, root: str) -> dict:
    # the last --model wins: each job's worker trains one model
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(args.np), sys.executable, os.path.abspath(__file__)] + [
               a for a in sys.argv[1:]] + ["--model", model]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_COMPRESSION="" if wire == "off" else wire)
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
        raise AssertionError(f"resnet_probe: the {model} {wire} job timed "
                             "out")
    print(out, flush=True)
    if p.returncode != 0 or not all(f"RESNET_PROBE_OK {k}" in out
                                    for k in range(args.np)):
        raise AssertionError(f"resnet_probe: the {model} {wire} job failed")
    for line in out.splitlines():
        at = line.find('{"resnet_probe"')  # after the launcher's prefix
        if at >= 0:
            return json.loads(line[at:])
    raise AssertionError(f"resnet_probe: the {model} {wire} job printed no "
                         "reading")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=1)
    ap.add_argument("--model", default="resnet",
                    help=f"one or more of {MODELS}, comma-separated")
    ap.add_argument("--depth", choices=sorted(CONFIGS), default="50")
    ap.add_argument("--batch", type=int, default=64,
                    help="images a rank (the reference's 64 a GPU)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--image", type=int, default=None,
                    help="default: the model's published side")
    ap.add_argument("--wires", default=None,
                    help="off,bf16,int8 (default: off at one rank, off,bf16 "
                    "at more)")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="after the steps, one more step of each arm under "
                    "torch.profiler on every rank (rank 0's is reported)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None,
                    help="write every job's reading and the summary here")
    args = ap.parse_args()
    if set(args.arms.split(",")) - set(ARMS):
        raise SystemExit(f"--arms takes {ARMS}")
    models = args.model.split(",")
    if set(models) - set(MODELS):
        raise SystemExit(f"--model takes {MODELS}")
    root = os.path.dirname(os.path.abspath(__file__))
    if "HOROVOD_RANK" in os.environ:
        sys.path.insert(0, root)
        return worker(args)
    wires = (args.wires or ("off" if args.np == 1 else "off,bf16")).split(",")
    if set(wires) - set(WIRES):
        raise SystemExit(f"--wires takes {WIRES}")
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    readings = {}
    for model in models:
        for wire in wires:
            readings[f"{model}/{wire}"] = r = run_job(args, model, wire, root)
            check(r)
    summary = {}
    for key, reading in readings.items():
        arms = reading["resnet_probe"]
        if "bare" in arms:
            summary[key] = {f"{a}_minus_bare_ms": arms[a]["median_step_ms"]
                            - arms["bare"]["median_step_ms"]
                            for a in arms if a != "bare"}
    print(json.dumps({"resnet_probe_summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"readings": readings, "summary": summary,
                       "ranks": args.np}, f)
    print(f"resnet_probe: {models} (ResNet depth {args.depth}), {args.np} "
          f"ranks on {args.device or 'cuda'}, wires {wires}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
