"""Shared pieces of the in-step optimizer's parity tests
(``test_torch_port_spmd.py``, ``test_torch_port_spmd_jobs.py``): the
JAX package's mesh over the session's virtual CPU devices, bf16 values
held in fp32 arrays, and an n-rank simulation of the EQuARX schedule in
one process.

``simulate_equarx`` runs ``horovod_tpu_torch.ops.collectives``'s
phases for every virtual rank, with the exchanges as list operations:
each rank's ``equarx_phase1`` rows, row j of every rank to rank j (the
``all_to_all_single``), each rank's ``equarx_reduce`` and
``equarx_requantize``, every rank's requantized row to all (the
``all_gather``), one ``equarx_unpack``.
"""

import jax
import ml_dtypes
import numpy as np
import torch
from jax.sharding import Mesh

from horovod_tpu_torch.ops import collectives as PC


def mesh(n: int, name: str = "hvd") -> Mesh:
    """n of the session's virtual CPU devices as a one-axis mesh."""
    return Mesh(np.array(jax.devices()[:n]), (name,))


def bf16_exact(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, kept as fp32 (numpy has no bf16 to save)."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)


def simulate_equarx(rank_tensors, spec, average: bool, pre: float = 1.0,
                    post: float = 1.0, residuals=None) -> tuple:
    """EQuARX over ``len(rank_tensors)`` virtual ranks, each a list of
    tensors of one float dtype; ``residuals`` one flat fp32 tensor (or
    None) a rank. Returns (each rank's outputs, each rank's new residual
    trimmed to the flat's size)."""
    n = len(rank_tensors)
    size = sum(t.numel() for t in rank_tensors[0])
    csz, rb = PC.equarx_layout(size, n, spec)
    ef = spec.error_feedback
    phase1 = [PC.equarx_phase1(ts, spec, n, pre,
                               None if residuals is None else residuals[r],
                               ef)
              for r, ts in enumerate(rank_tensors)]
    rows = []
    for j in range(n):
        received = torch.stack([phase1[r][0][j] for r in range(n)])
        chunk = PC.equarx_reduce(received, spec, n, csz, average)
        rows.append(PC.equarx_requantize(chunk, spec))
    gathered = torch.cat(rows)
    outs = []
    for ts in rank_tensors:
        o = [torch.empty_like(t) for t in ts]
        PC.equarx_unpack(gathered, o, spec, n, post)
        outs.append(o)
    errs = [None if e is None else e[:size] for _, e in phase1]
    return outs, errs
