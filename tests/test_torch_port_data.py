"""The port's input pipeline (``horovod_tpu_torch/utils/data.py``) against
the JAX package's (``horovod_tpu/utils/data.py``), on the CPU.

The same host arrays go through both packages' ``ShardedLoader`` for two
shards (each package's world read as two ranks), with and without
shuffling, with prefetch 0 (host numpy) and 2 (JAX device arrays against
the port's CPU tensors), over two epochs: every batch bit for bit the JAX
loader's. The port shards by ``size()``/``rank()`` where the JAX package
reads ``cross_size()``/``cross_rank()``, so each side's pair is patched.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.utils import data as JD
from horovod_tpu_torch.utils import data as PD

N, BATCH = 37, 4


def _arrays():
    rs = np.random.RandomState(0)
    return (rs.randn(N, 3, 5).astype(np.float32),
            rs.randint(0, 10, N).astype(np.int64),
            (rs.rand(N, 2) > 0.5))


def _world(monkeypatch, shards: int, shard: int):
    """Both packages' sharding read as ``shard`` of ``shards``."""
    monkeypatch.setattr(JD.ctx_mod, "cross_size", lambda: shards)
    monkeypatch.setattr(JD.ctx_mod, "cross_rank", lambda: shard)
    monkeypatch.setattr(PD.ctx_mod, "size", lambda: shards)
    monkeypatch.setattr(PD.ctx_mod, "rank", lambda: shard)


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(a, b) -> bool:
    a, b = _host(a), _host(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_sharded_loader_batches_are_the_jax_loaders(monkeypatch, shard,
                                                    shuffle, prefetch):
    """Every leaf bit for bit the JAX loader's host batch; with prefetch,
    also the JAX loader's device batch (whose int64 labels JAX holds as
    int32, its x64 default) by value."""
    _world(monkeypatch, 2, shard)
    arrays = _arrays()
    kw = dict(batch_size=BATCH, shuffle=shuffle, seed=3)
    host = JD.ShardedLoader(arrays, prefetch=0, **kw)
    device = JD.ShardedLoader(arrays, prefetch=prefetch, **kw)
    got = PD.ShardedLoader(arrays, prefetch=prefetch, device="cpu", **kw)
    assert len(got) == len(host) == (N - shard + 1) // 2 // BATCH
    for epoch in range(2):
        batches = list(zip(host.epoch(epoch), device.epoch(epoch),
                           got.epoch(epoch), strict=True))
        assert len(batches) == len(host)
        for h, d, g in batches:
            assert len(h) == len(d) == len(g) == 3
            for a, b, c in zip(h, d, g):
                assert isinstance(c, torch.Tensor if prefetch else
                                  np.ndarray)
                assert _same_bits(a, c)
                dev = np.asarray(b)
                assert _same_bits(dev, _host(c).astype(dev.dtype))
    if shuffle:  # an epoch's order is its own
        e0, e1 = (np.concatenate([_host(b[1]) for b in got.epoch(e)])
                  for e in (0, 1))
        assert not np.array_equal(e0, e1)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_iterator_and_shards_match_the_jax_package(drop_remainder):
    arrays = _arrays()
    for shard in range(3):
        js = JD.shard_arrays(arrays, shard, 3)
        ps = PD.shard_arrays(arrays, shard, 3)
        assert all(_same_bits(a, b) for a, b in zip(js, ps))
        want = list(JD.batch_iterator(js, 5, True, 11, drop_remainder))
        got = list(PD.batch_iterator(ps, 5, True, 11, drop_remainder))
        assert len(got) == len(want)
        assert all(_same_bits(a, b) for w, g in zip(want, got)
                   for a, b in zip(w, g))


def test_shards_follow_the_port_world():
    """After ``init`` the port's world decides the shard: one rank here."""
    hvd.init(device="cpu")
    try:
        arrays = _arrays()
        loader = PD.ShardedLoader(arrays, batch_size=BATCH, device="cpu")
        assert all(_same_bits(a, b) for a, b in zip(loader.arrays, arrays))
        bx = next(iter(loader.epoch(0)))[0]
        assert bx.device == hvd.device()
    finally:
        hvd.shutdown()


def test_prefetch_keeps_size_batches_in_flight():
    """Before the first batch is handed out, ``size`` batches and the one
    behind it have been drawn, as in the JAX package; the batches are
    copies, not views of the host arrays."""
    for size in (1, 2, 3):
        drawn = []
        rows = [np.full((2,), i, np.float32) for i in range(6)]

        def source():
            for i, row in enumerate(rows):
                drawn.append(i)
                yield (row,)

        for i, (b,) in enumerate(PD.prefetch_to_device(source(), size,
                                                       device="cpu")):
            if i == 0:
                assert len(drawn) == min(size + 1, 6)
            assert torch.equal(b, torch.full((2,), float(i)))
            b.add_(1.0)
            assert rows[i][0] == i  # the host row is untouched
        assert len(drawn) == 6


def test_prefetch_maps_nested_batches_and_refuses_other_devices():
    batch = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
             "pair": [np.ones(2, np.int32), np.zeros(1, np.int64)]}
    (out,) = list(PD.prefetch_to_device(iter([batch]), 2, device="cpu"))
    assert torch.equal(out["x"], torch.arange(6.0).reshape(2, 3))
    assert isinstance(out["pair"], list)
    assert out["pair"][0].dtype == torch.int32
    with pytest.raises(ValueError, match="neither CUDA nor the CPU"):
        next(PD.prefetch_to_device(iter([batch]), 2, device="meta"))
