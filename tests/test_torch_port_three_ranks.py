"""A bf16 AVERAGE at three gloo ranks, pinned against the JAX package's
multi-rank rule (``_allreduce_body``: prescale, ``jnp.mean``, postscale).

At two ranks the port equals that rule bit for bit. At three the
collective adds the prescaled bf16 rows one at a time, rounding each sum
to bf16, where ``jnp.mean`` accumulates in fp32, and the port's unpack
multiplies by ``post / 3`` rounded to bf16 (K1's factor rule), so the two
differ in some elements. The test holds:

- every element of the port's result to one of the three orders in which
  the collective may add three rows, each sum rounded to bf16, then the
  unpack's factor: a change in how gloo (or NCCL) sums shows here;
- the distance to the JAX rule within the bound the roundings allow:
  two additions of at most half a bf16 ulp of a partial sum (with three
  rows of at most m, 2^-9 * 2m * 2 over the mean's divisor 3), the bf16
  factor (2^-9 relative), and the two results' own roundings:
  ``|port - rule| <= 2^-7 * post * m + 2^-9 * (|port| + |rule|)``,
  where m is the element's largest prescaled row;
- the three ranks' results bitwise equal.
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np

from horovod_tpu.ops import collectives as jcoll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (12, 1, 35, 129, 4000)
PRE, POST = 1.0 / 3, 0.7

WORKER = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
    assert hvd.size() == 3
    rs = np.random.RandomState(7 + r)
    ts = [torch.from_numpy(rs.uniform(-4, 4, n).astype(np.float32))
          .to(torch.bfloat16) for n in {sizes!r}]
    outs = hvd.grouped_allreduce(ts, name="bf16avg", op=hvd.Average,
                                 prescale_factor={pre!r},
                                 postscale_factor={post!r})
    np.save({out!r}.format(r), np.concatenate(
        [o.view(torch.int16).numpy() for o in outs]))
    hvd.shutdown()
    print("THREE_OK", r)
"""


def _bf16(x) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def test_bf16_average_at_three_ranks_is_pinned(tmp_path):
    out = str(tmp_path / "r{}.npy")
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER.format(
        sizes=SIZES, pre=PRE, post=POST, out=out)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "3",
         sys.executable, str(script)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log = p.communicate(timeout=180)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        raise AssertionError(p.communicate()[0])
    assert p.returncode == 0, log
    got = [np.load(out.format(r)) for r in range(3)]
    for r in (1, 2):
        np.testing.assert_array_equal(got[r], got[0])
    port = _f32(got[0].view(ml_dtypes.bfloat16))
    rows = []
    for r in range(3):
        rs = np.random.RandomState(7 + r)
        rows.append(np.concatenate([_bf16(rs.uniform(-4, 4, n).astype(
            np.float32)) for n in SIZES]))
    g = np.stack(rows)
    rule = _f32(jcoll._allreduce_body(None, jcoll.ReduceOp.AVERAGE, PRE,
                                      POST, False)(jnp.asarray(g)))
    # the port's chain: bf16 prescale (factor rounded to bf16), bf16 sums
    # in some order, the unpack's factor post / 3 rounded to bf16
    pre = _f32(_bf16(PRE))
    p_rows = [_f32(_bf16(_f32(row) * pre)) for row in rows]
    fac = _f32(_bf16(POST / 3))
    orders = []
    for a, b, c in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
        s = _f32(_bf16(_f32(_bf16(p_rows[a] + p_rows[b])) + p_rows[c]))
        orders.append(_f32(_bf16(s * fac)))
    assert np.all(np.any([port == o for o in orders], axis=0))
    m = np.max(np.abs(np.stack(p_rows)), axis=0)
    bound = 2.0 ** -7 * POST * m + 2.0 ** -9 * (np.abs(port) + np.abs(rule))
    assert np.all(np.abs(port - rule) <= bound)
    # the two differ: the pin is of a departure, not of an equality
    assert np.any(port != rule)
