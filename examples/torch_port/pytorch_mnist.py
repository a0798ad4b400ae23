"""PyTorch MNIST through the port (``horovod_tpu_torch``): Horovod's
``examples/pytorch/pytorch_mnist.py`` shape (BASELINE.json config 1) with
synthetic data, as the network is out of reach.

``DistributedOptimizer`` with ``broadcast_parameters`` and
``broadcast_optimizer_state``; each rank reads its shard of the data
through ``ShardedLoader``, which prefetches the next batches to the rank's
GPU; ``MnistConvNet`` from the port's model zoo; rank 0 prints each
epoch's last loss.

    python -m horovod_tpu_torch.runner -np 2 python examples/torch_port/pytorch_mnist.py
    (add ``--device cpu`` to run the ranks over gloo on the CPU)
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import MnistConvNet
from horovod_tpu_torch.utils.data import ShardedLoader


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--use-adasum", action="store_true")
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--device", default=None,
                   help="cpu runs on the CPU; default: the rank's GPU")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args()

    hvd.init(device=args.device)
    device = hvd.device()

    rng = np.random.RandomState(0)
    x = rng.rand(args.samples, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, args.samples).astype(np.int64)
    loader = ShardedLoader((x, y), batch_size=args.batch_size, shuffle=True,
                           seed=args.seed, prefetch=2, device=device)

    model = MnistConvNet(device=device, seed=args.seed)
    # linear LR scaling by the number of gradient contributors, one a GPU
    lr_scaler = hvd.size() if not args.use_adasum else 1
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr * lr_scaler,
                                momentum=0.5)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        op=hvd.Adasum if args.use_adasum else hvd.Average)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    model.train()
    for epoch in range(args.epochs):
        loss = None
        for bx, by in loader.epoch(epoch):
            optimizer.zero_grad()
            loss = F.cross_entropy(model(bx), by)
            loss.backward()
            optimizer.step()
        if hvd.rank() == 0 and loss is not None:
            print(f"epoch {epoch}: loss={loss.item():.4f}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
