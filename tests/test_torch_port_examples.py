"""The port's two PyTorch examples (``examples/torch_port/``) each finish
in a two-process gloo job through the port's launcher, on the CPU: the
MNIST example over ``ShardedLoader`` (one epoch of a small synthetic set)
and the synthetic benchmark on ResNet-50 at 32² (10 classes, two images a
rank). Both jobs start together."""

import math
import os
import re
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch_port")
JOBS = {
    "mnist": ["pytorch_mnist.py", "--device", "cpu", "--epochs", "2",
              "--samples", "512"],
    "synthetic": ["pytorch_synthetic_benchmark.py", "--device", "cpu",
                  "--model", "resnet50", "--image", "32", "--num-classes",
                  "10", "--batch-size", "2", "--num-iters", "2",
                  "--num-warmup-batches", "1", "--num-batches-per-iter",
                  "1"],
}


@pytest.fixture(scope="module")
def jobs():
    """name -> (exit code, output) of each example's two-rank job."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("HOROVOD_COMPRESSION", "HOROVOD_FUSION_THRESHOLD"):
        env.pop(k, None)
    # a session each, so a timeout ends the launcher and its workers
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, os.path.join(EXAMPLES, script), *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
        for name, (script, *args) in JOBS.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout = p.communicate(timeout=240)[0]
            out[name] = (p.returncode, stdout)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return out


def test_mnist_example_trains_over_the_sharded_loader(jobs):
    rc, out = jobs["mnist"]
    assert rc == 0, out
    losses = [float(x) for x in re.findall(r"epoch \d+: loss=([-\d.naif]+)",
                                           out)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses), out


def test_synthetic_benchmark_reports_throughput(jobs):
    rc, out = jobs["synthetic"]
    assert rc == 0, out
    assert "Model: resnet50, batch size 2, image 32, 2 worker(s) on cpu" \
        in out, out
    total = re.search(r"Total img/sec on 2 worker\(s\): ([\d.]+)", out)
    assert total and float(total.group(1)) > 0, out
