"""Synthetic training throughput through the port (``horovod_tpu_torch``):
Horovod's ``examples/pytorch/pytorch_synthetic_benchmark.py`` shape —
synthetic batches, ``DistributedOptimizer``, img/sec per worker and in
total with a 95 % band — over the port's model zoo.

    python -m horovod_tpu_torch.runner -np 4 python \
        examples/torch_port/pytorch_synthetic_benchmark.py --model vgg16
    (``--device cpu`` runs the ranks over gloo on the CPU; ``--image`` and
    ``--num-classes`` shrink the model's input and head there)

Models: ``resnet50``, ``resnet101`` (224²), ``vgg16`` (224²),
``inception3`` (299²) and ``vit_b16`` (224²), at their published widths,
bf16 compute over fp32 weights on the GPU, fp32 on the CPU.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import models

# each constructor takes ``image`` (default: the model's published side)
MODELS = {"resnet50": models.ResNet50, "resnet101": models.ResNet101,
          "vgg16": models.VGG16, "inception3": models.InceptionV3,
          "vit_b16": models.ViT_B16}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODELS), default="resnet50")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image", type=int, default=None,
                   help="input side (default: the model's published one)")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=3)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--device", default=None,
                   help="cpu runs on the CPU; default: the rank's GPU")
    args = p.parse_args()

    hvd.init(device=args.device)
    device = hvd.device()
    cuda = device.type == "cuda"
    model = MODELS[args.model](
        num_classes=args.num_classes, image=args.image, device=device,
        dtype=torch.bfloat16 if cuda else torch.float32, seed=0)
    image = model.image
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size())
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    g = torch.Generator().manual_seed(1234 + hvd.rank())
    data = torch.randn(args.batch_size, 3, image, image, generator=g).to(
        device)
    target = torch.randint(0, args.num_classes, (args.batch_size,),
                           generator=g).to(device)

    def benchmark_step():
        optimizer.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()
        return loss

    for _ in range(args.num_warmup_batches):
        benchmark_step()
    if cuda:
        torch.cuda.synchronize(device)

    img_secs = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = benchmark_step()
        loss.item()  # waits for the iteration's device work
        img_secs.append(args.batch_size * args.num_batches_per_iter
                        / (time.perf_counter() - t0))

    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    if hvd.rank() == 0:
        n = hvd.size()
        print(f"Model: {args.model}, batch size {args.batch_size}, image "
              f"{image}, {n} worker(s) on {device.type}")
        print(f"Img/sec per worker: {mean:.1f} +- {conf:.1f}")
        print(f"Total img/sec on {n} worker(s): {n * mean:.1f} +- "
              f"{n * conf:.1f}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
