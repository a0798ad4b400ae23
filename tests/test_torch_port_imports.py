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
from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import xent
from horovod_tpu_torch.parallel import (ring_attention,
                                        striped_ring_attention,
                                        ulysses_attention)

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
    from horovod_tpu_torch.models import resnet as PR
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention
    import resnet_probe

    cfg = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    if not torch.cuda.is_available():
        for entry in (hvd.init, lambda: PT.TransformerLM(cfg),
                      lambda: PR.ResNet50()):
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
    resnet = resnet_probe.build("tiny", torch.device("cpu"), 0)
    assert resnet_probe.CONFIGS["tiny"][0] == [1, 1, 1, 1]
    assert all(p.device == hvd.device() for p in PR.ResNet(
        [1, 1, 1, 1], num_filters=8, num_classes=10).parameters())
    images = torch.randn(2, 3, 32, 32)
    assert resnet(images).shape == (2, 10)
    # the gradients went through the runtime's fused chunks
    from horovod_tpu_torch.common import context
    rt = context.runtime()
    assert rt.chunks > 0 and rt.collective_calls >= rt.chunks
    assert rt._mp is None and hvd.megaplan_report() == {"enabled": False}
    for name in ("runner.launch", "runner.http_server", "runner.hosts",
                 "runner.network", "runner.secret", "ops.queue",
                 "ops.controller", "ops.fused_pack", "ops.wire",
                 "ops.megaplan", "_native",
                 "utils.metrics", "utils.lockcheck", "utils.retry",
                 "opt.sharded", "parallel.sharding_policy", "ops.adasum",
                 "torch.sync_batch_norm"):
        assert "horovod_tpu_torch." + name in sys.modules, name
    assert not any(n == "jax" or n.startswith(("jax.", "horovod_tpu."))
                   for n, m in sys.modules.items() if m is not None)
    hvd.shutdown()
    print("ISOLATED_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scripts this file runs in subprocesses, all started at once (each
    spends most of its time importing torch): name -> (exit code, stdout,
    stderr). chip_smoke.py runs from a directory that holds it alone, and,
    without a card, from the repository."""
    alone = tmp_path_factory.mktemp("alone")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    no_path = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    specs = {"isolated": ([sys.executable, "-c", _ISOLATED], REPO, env),
             "long_context": ([sys.executable, "-c", _LONG_CONTEXT], REPO,
                              env),
             "smoke_alone": ([sys.executable, str(alone / "chip_smoke.py")],
                             alone, no_path)}
    if not torch.cuda.is_available():
        specs["smoke_in_repo"] = ([sys.executable,
                                   os.path.join(REPO, "chip_smoke.py")],
                                  alone, no_path)
    procs = {name: subprocess.Popen(cmd, cwd=str(cwd), env=e, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, (cmd, cwd, e) in specs.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_port_imports_and_trains_without_jax(runs):
    rc, stdout, stderr = runs["isolated"]
    assert rc == 0 and "ISOLATED_OK" in stdout, stdout + stderr


_FORBIDDEN = re.compile(
    r"import jax|from jax|horovod_tpu[.]|from horovod_tpu |"
    r"import horovod_tpu$", re.M)


def test_no_source_names_jax_or_the_jax_package():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "adasum_probe.py",
                                             "collectives_probe.py",
                                             "flash_probe.py",
                                             "megaplan_probe.py",
                                             "runtime_probe.py",
                                             "sp_probe.py",
                                             "resnet_probe.py",
                                             "wire_probe.py",
                                             "zero_probe.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
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


_LONG_CONTEXT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import sp

    cfg = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32, remat=True, xent_chunk=16)
    model = PT.TransformerLM(cfg, device="cpu")
    tokens = torch.randint(0, 64, (1, 17),
                           generator=torch.Generator().manual_seed(0))
    for attn in (lambda q, k, v: sp._simulated_ring(q, k, v, 4, True),
                 lambda q, k, v: sp._simulated_ulysses(q, k, v, 2)):
        loss = PT.lm_loss(model, tokens, attn_fn=attn)
        loss.backward()
        assert torch.isfinite(loss) and model.embed.grad is not None
    for name in ("ops.xent", "parallel.sp"):
        assert "horovod_tpu_torch." + name in sys.modules, name
    assert not any(n == "jax" or n.startswith(("jax.", "horovod_tpu."))
                   for n, m in sys.modules.items() if m is not None)
    print("LONG_CONTEXT_OK")
""")


def test_long_context_modules_run_without_jax(runs):
    """The sequence-parallel module, the chunked loss and remat import and
    train without JAX or the JAX package."""
    rc, stdout, stderr = runs["long_context"]
    assert rc == 0 and "LONG_CONTEXT_OK" in stdout, stdout + stderr


@pytest.mark.parametrize("fn", [striped_ring_attention, ulysses_attention])
def test_sequence_parallel_attention_off_cpu_takes_the_kernel_or_raises(fn):
    """Off the CPU the striped ring and Ulysses' default core take the
    kernel's dispatch: a meta tensor raises, never runs a plain path."""
    q = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        fn(q, q, q)


def test_k5_raises_without_nvcc(monkeypatch, tmp_path):
    """K5 builds at first use on the card; without nvcc it raises, and a
    tensor on neither the CPU nor CUDA is refused before any build."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(xent, "_fns", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        xent._kernel("hvd_xent_fwd_chunk")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("xent")
    x = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        xent.chunked_softmax_xent(x, x, torch.zeros(2, dtype=torch.int64,
                                                    device="meta"), 4)


def test_k4_raises_without_nvcc(monkeypatch, tmp_path):
    """K4 builds at first use on the card; without nvcc it raises, and a
    tensor on neither the CPU nor CUDA is refused before any build."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(adasum, "_fns", {})
    for symbol in ("hvd_adasum_dot_norms", "hvd_adasum_scaled_add"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            adasum._kernel(symbol)
    x = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        adasum.adasum_combine(x, x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_attention_tf32")


def test_kernel_library_name_follows_source_and_flags(tmp_path, monkeypatch):
    """The library's name carries a digest of the compiler, the flags, the
    source and every header beside it: an edit to any of them builds
    anew."""
    name = "flash_attention_tf32"
    a = _build._lib_path(name, "/x/nvcc")
    assert a.startswith(os.path.join(PKG, "_build", name + "-"))
    assert a == _build._lib_path(name, "/x/nvcc")
    assert a != _build._lib_path(name, "/y/nvcc")
    headers = [f for f in os.listdir(_build.CSRC) if f.endswith(".cuh")]
    assert headers
    for f in [name + ".cu", *headers]:
        shutil.copy(os.path.join(_build.CSRC, f), tmp_path / f)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert a == _build._lib_path(name, "/x/nvcc")  # same files, same name
    for f in (name + ".cu", headers[0]):
        path = tmp_path / f
        text = path.read_text()
        path.write_text(text + "\n")
        assert a != _build._lib_path(name, "/x/nvcc"), f
        path.write_text(text)
    assert a == _build._lib_path(name, "/x/nvcc")


def test_chip_smoke_fails_without_cuda_or_repo(runs):
    """Without a card, or alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    smoke = [name for name in runs if name.startswith("smoke")]
    assert "smoke_alone" in smoke
    for name in smoke:
        rc, stdout, _ = runs[name]
        assert rc != 0, stdout
        assert '"ok"' not in stdout, stdout


def test_probe_ablations_patch_text_in_the_sources(monkeypatch):
    """Every ablation of ``flash_probe.py`` names text that is in the
    kernel's source or the shared header, so an edit that moves a patched
    line fails here and not on the card."""
    monkeypatch.syspath_prepend(REPO)
    import flash_probe

    for source, _, ablations in flash_probe.ABLATIONS.values():
        texts = []
        for name in (source + ".cu", flash_probe.HEADER):
            with open(os.path.join(_build.CSRC, name)) as f:
                texts.append(f.read())
        for name, patches in ablations:
            for old, _ in patches:
                assert any(old in t for t in texts), (source, name, old)
