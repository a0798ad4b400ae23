"""The port stands alone: it imports neither JAX nor the JAX package (the
runtime, the controller, the launcher and K1 included), and it never falls
back silently to the CPU or to a plain path."""

import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")

_ISOLATED = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import importlib, pkgutil
    import torch
    import horovod_tpu_torch as hvd
    for m in pkgutil.walk_packages(hvd.__path__, "horovod_tpu_torch."):
        importlib.import_module(m.name)
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention

    cfg = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    if not torch.cuda.is_available():
        for entry in (hvd.init, lambda: PT.TransformerLM(cfg)):
            try:
                entry()
                raise AssertionError("an entry point without CUDA must raise")
            except RuntimeError as e:
                assert "device='cpu'" in str(e)
    hvd.init(device="cpu")
    # an entry point given no device takes the port's
    model = PT.TransformerLM(cfg)
    assert all(p.device == hvd.device() for p in model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    tokens = torch.randint(0, 64, (2, 17),
                           generator=torch.Generator().manual_seed(0))
    before = model.embed.detach().clone()
    loss = PT.lm_loss(model, tokens, attn_fn=ring_attention)
    loss.backward()
    opt.step()
    assert torch.isfinite(loss) and not torch.equal(before, model.embed)
    # the gradients went through the runtime's fused chunks
    from horovod_tpu_torch.common import context
    rt = context.runtime()
    assert rt.chunks > 0 and rt.collective_calls >= rt.chunks
    for name in ("runner.launch", "runner.http_server", "runner.hosts",
                 "runner.network", "runner.secret", "ops.queue",
                 "ops.controller", "ops.fused_pack", "ops.wire", "_native",
                 "utils.metrics", "utils.lockcheck", "utils.retry"):
        assert "horovod_tpu_torch." + name in sys.modules, name
    assert not any(n == "jax" or n.startswith(("jax.", "horovod_tpu."))
                   for n, m in sys.modules.items() if m is not None)
    hvd.shutdown()
    print("ISOLATED_OK")
""")


def test_port_imports_and_trains_without_jax():
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0 and "ISOLATED_OK" in out.stdout, (
        out.stdout + out.stderr)


_FORBIDDEN = re.compile(
    r"import jax|from jax|horovod_tpu[.]|from horovod_tpu |"
    r"import horovod_tpu$", re.M)


def test_no_source_names_jax_or_the_jax_package():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "flash_probe.py",
                                             "runtime_probe.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu"))]
    hits = []
    for f in files:
        with open(f) as fh:
            hits += [(f, m.group(0)) for m in _FORBIDDEN.finditer(fh.read())]
    assert len(files) > 10 and not hits, hits


def test_kernel_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on CUDA raises: the plain
    version serves only CPU tensors."""
    q = torch.empty((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        fa.attention_stats(q, q, q)


@pytest.mark.parametrize("s,match", [(64, "CUDA or the CPU"),
                                     (96, "divisible")])
def test_ring_attention_off_cpu_takes_the_kernel_or_raises(s, match):
    """Off the CPU, ring attention's default is the kernel's dispatch, and a
    length the blocks do not tile raises: it never gives way to the
    blockwise plain path, which would run a meta tensor without a word."""
    q = torch.empty((1, s, 2, 64), device="meta")
    with pytest.raises(ValueError, match=match):
        ring_attention(q, q, q, block_q=64, block_k=64)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_attention")


def test_kernel_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    a = _build._lib_path("flash_attention", "/x/nvcc")
    assert a.startswith(os.path.join(PKG, "_build", "flash_attention-"))
    assert a == _build._lib_path("flash_attention", "/x/nvcc")
    assert a != _build._lib_path("flash_attention", "/y/nvcc")
    src = tmp_path / "flash_attention.cu"
    shutil.copy(os.path.join(_build.CSRC, src.name), src)
    src.write_text(src.read_text() + "\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert a != _build._lib_path("flash_attention", "/x/nvcc")


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """Without a card, or alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    runs = [[sys.executable, os.path.join(REPO, "chip_smoke.py")]]
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    alone = [sys.executable, str(tmp_path / "chip_smoke.py")]
    if torch.cuda.is_available():
        runs = []
    runs.append(alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cmd in runs:
        out = subprocess.run(cmd, cwd=str(tmp_path), capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout, out.stdout
