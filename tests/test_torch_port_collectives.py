"""The port's eager collectives and Horovod front end on gloo (CPU).

In-process, at size 1, each op × dtype × scaling goes through the port and
through the JAX package's eager ``allreduce`` on the same numpy input:
prescale, reduce, postscale; SUM keeps the caller's dtype; integer AVERAGE
raises; a zero-element tensor is still scaled. Then one 2-process gloo job
(``HOROVOD_RANK``/``HOROVOD_SIZE`` and ``MASTER_*`` env, as a launcher sets
them) checks that ``DistributedOptimizer``'s averaged gradients equal the
mean of the two ranks' local gradients.
"""

import os
import socket
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # tiny shapes: one intra-op thread is enough, and leaves the cores to
    # the suite's other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


OPS = [hvd.Sum, hvd.Average, hvd.Min, hvd.Max, hvd.Product]


CASES = [(op, dtype) for op in OPS
         for dtype in (torch.float32, torch.bfloat16, torch.int32)
         # integer AVERAGE raises: test_integer_average_raises
         if not (op == hvd.Average and dtype == torch.int32)]


@pytest.mark.parametrize("scale", [(1.0, 1.0), (2.0, 0.25)])
@pytest.mark.parametrize("op,dtype", CASES,
                         ids=[f"{o.name}-{str(d)[6:]}" for o, d in CASES])
def test_allreduce_matches_jax_at_size_one(op, dtype, scale):
    pre, post = scale
    x = (torch.arange(12, dtype=torch.float32).reshape(3, 4) - 5).to(dtype)
    out = hvd.allreduce(x, op=op, prescale_factor=pre,
                        postscale_factor=post)
    ref = np.asarray(jhvd.allreduce(_to_np(x), op=op, prescale_factor=pre,
                                    postscale_factor=post))
    # dtype contract: the caller's dtype, promoted only by the scale factors
    assert out.dtype == (x if scale == (1.0, 1.0) else x * pre * post).dtype
    if dtype != torch.bfloat16:
        assert str(out.dtype).split(".")[1] == ref.dtype.name
    np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                               rtol=1e-6)
    assert not torch.equal(out, x) or (pre, post) == (1.0, 1.0)


def test_sum_keeps_small_integer_dtype():
    x = torch.tensor([200, 100], dtype=torch.uint8)
    out = hvd.allreduce(x, op=hvd.Sum)
    ref = np.asarray(jhvd.allreduce(x.numpy(), op=hvd.Sum))
    assert out.dtype == torch.uint8 and ref.dtype == np.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_integer_average_raises():
    with pytest.raises(ValueError, match="AVERAGE"):
        hvd.allreduce(torch.arange(4, dtype=torch.int32), op=hvd.Average)
    with pytest.raises(ValueError, match="AVERAGE"):
        jhvd.allreduce(np.arange(4, dtype=np.int32), op=hvd.Average)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_zero_element_allreduce_still_scales(dtype):
    x = torch.zeros((0, 3), dtype=dtype)
    out = hvd.allreduce(x, op=hvd.Sum, prescale_factor=3.0)
    ref = np.asarray(jhvd.allreduce(x.numpy(), op=hvd.Sum,
                                    prescale_factor=3.0))
    assert tuple(out.shape) == ref.shape == (0, 3)
    assert str(out.dtype).split(".")[1] == ref.dtype.name == "float32"


def test_unported_paths_raise():
    # Adasum (item 13) is ported: at a world of one it is the JAX
    # package's identity
    x = torch.arange(4.0) - 1.5
    out = hvd.allreduce(x, op=hvd.Adasum)
    ref = np.asarray(jhvd.allreduce(x.numpy(), op=hvd.Adasum))
    assert torch.equal(out, x) and np.array_equal(out.numpy(), ref)
    # the sharded update (item 12) is ported: it builds the whole-leaf
    # ZeRO-1 wrapper
    p = torch.nn.Parameter(torch.ones(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                   sharded_update=True)
    assert type(opt).__name__ == "ShardedDistributedSGD"


def test_async_inplace_grouped_and_broadcast():
    x = torch.arange(4.0)
    h = hvd.allreduce_async(x, op=hvd.Sum, prescale_factor=2.0)
    out = hvd.synchronize(h)
    assert torch.equal(out, x * 2) and torch.equal(x, torch.arange(4.0))
    h = hvd.allreduce_async_(x, op=hvd.Sum, postscale_factor=3.0)
    assert hvd.synchronize(h) is not None
    assert torch.equal(x, torch.arange(4.0) * 3)
    outs = hvd.grouped_allreduce([torch.ones(2), torch.full((3,), 2.0)],
                                 op=hvd.Average)
    assert [o.tolist() for o in outs] == [[1.0, 1.0], [2.0, 2.0, 2.0]]
    b = hvd.broadcast(torch.tensor([5.0]), root_rank=0)
    assert b.tolist() == [5.0]
    h = hvd.broadcast_async_(torch.tensor([1.0]), root_rank=0)
    assert hvd.poll(h) in (True, False)
    assert hvd.synchronize(h).tolist() == [1.0]
    hvd.barrier()


def test_allreduce_is_differentiable():
    x = torch.ones(3, requires_grad=True)
    (hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0) * 3).sum().backward()
    assert x.grad.tolist() == [6.0, 6.0, 6.0]
    y = torch.ones(2, requires_grad=True)
    hvd.broadcast(y, root_rank=0).sum().backward()
    assert y.grad.tolist() == [1.0, 1.0]


def test_fp16_compression_roundtrip():
    x = torch.tensor([1.5, -2.25])
    out = hvd.allreduce(x, op=hvd.Sum, compression=hvd.Compression.fp16)
    assert out.dtype == torch.float32 and out.tolist() == [1.5, -2.25]


def test_distributed_optimizer_semantics_at_size_one():
    """Hooks that never fired are zero-filled at synchronize; the predivide
    factor splits AVERAGE into SUM with pre/postscale; skip_synchronize
    steps without reducing; re-wrapping raises."""
    a = torch.nn.Parameter(torch.ones(2))
    unused = torch.nn.Parameter(torch.ones(2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([a, unused], lr=0.5),
        named_parameters=[("a", a), ("unused", unused)],
        gradient_predivide_factor=4.0)
    assert opt._op == hvd.Sum and opt._prescale == 0.25
    assert opt._postscale == 4.0
    assert isinstance(opt, torch.optim.SGD)
    (a * 3).sum().backward()
    opt.step()
    assert a.tolist() == [-0.5, -0.5]
    assert unused.grad.tolist() == [0.0, 0.0]
    opt.zero_grad()
    (a * 2).sum().backward()
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    assert a.tolist() == [-1.5, -1.5]
    with pytest.raises(ValueError, match="already wrapped"):
        hvd.DistributedOptimizer(opt)
    with pytest.raises(ValueError, match="duplicate"):
        hvd.DistributedOptimizer(torch.optim.SGD([a], lr=0.1),
                                 named_parameters=[("a", a), ("a", a)])


def test_backward_passes_per_step_accumulates():
    a = torch.nn.Parameter(torch.zeros(1))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([a], lr=1.0),
                                   named_parameters=[("a", a)],
                                   backward_passes_per_step=2)
    (a * 1.0).sum().backward()
    assert not opt._handles  # first pass: no reduction yet
    (a * 2.0).sum().backward()
    assert len(opt._handles) == 1
    opt.step()
    assert a.tolist() == [-3.0]


_WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    assert n == 2 and hvd.local_size() == 2 and hvd.local_rank() == r
    cfg = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    # different weights on each rank until the broadcast
    model = PT.TransformerLM(cfg, seed=r)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    ref = PT.TransformerLM(cfg, seed=0)
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    tokens = torch.randint(0, 64, (2, 17),
                           generator=torch.Generator().manual_seed(100 + r))

    # this rank's local gradients, without hooks, then both ranks' mean
    PT.lm_loss(ref, tokens, attn_fn=ring_attention).backward()
    want = []
    for p in ref.parameters():
        parts = [torch.empty_like(p.grad) for _ in range(n)]
        dist.all_gather(parts, p.grad)
        want.append(torch.stack(parts).mean(0))
    assert not torch.equal(want[0], ref.embed.grad)

    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    PT.lm_loss(model, tokens, attn_fn=ring_attention).backward()
    opt.synchronize()
    for (name, p), w in zip(model.named_parameters(), want):
        torch.testing.assert_close(p.grad, w, rtol=1e-6, atol=1e-7)
    with opt.skip_synchronize():
        opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for p in model.parameters():  # the replicas stay identical
        assert torch.equal(hvd.allreduce(p.detach(), op=hvd.Max),
                           hvd.allreduce(p.detach(), op=hvd.Min))

    x = torch.tensor([1.0, 2.0]) * (r + 1)
    for op, out in ((hvd.Sum, [3.0, 6.0]), (hvd.Average, [1.5, 3.0]),
                    (hvd.Min, [1.0, 2.0]), (hvd.Max, [2.0, 4.0]),
                    (hvd.Product, [2.0, 8.0])):
        assert hvd.allreduce(x, op=op).tolist() == out, op
    assert hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                         postscale_factor=0.25).tolist() == [1.5, 3.0]
    xi = hvd.allreduce(torch.tensor([1, 2], dtype=torch.int32) * (r + 1),
                       op=hvd.Sum)
    assert xi.dtype == torch.int32 and xi.tolist() == [3, 6]
    assert hvd.broadcast(torch.tensor([float(r)]), 1).tolist() == [1.0]
    # a ring of two over the world: each rank holds half of one sequence
    g = torch.Generator().manual_seed(5)
    full = [torch.randn(1, 8, 2, 8, generator=g) for _ in range(3)]
    mine = [x[:, 4 * r:4 * (r + 1)] for x in full]
    torch.testing.assert_close(
        ring_attention(*mine, group=dist.group.WORLD),
        PT.causal_attention(*full)[:, 4 * r:4 * (r + 1)],
        rtol=1e-5, atol=1e-6)
    hvd.barrier()
    hvd.shutdown()
    print("RANK_OK", r)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_distributed_optimizer(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, out
