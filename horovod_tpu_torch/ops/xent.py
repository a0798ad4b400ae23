"""Chunked softmax cross-entropy: the LM loss without the logits tensor —
counterpart of ``horovod_tpu/ops/xent.py``.

``chunked_softmax_xent(x, w, targets, chunk)`` streams the classifier over
vocabulary chunks of ``chunk`` classes, so at most one fp32 ``[N, chunk]``
logits block exists at a time:

- forward: per chunk, ``logits = x @ w_c.T`` (``torch.matmul`` in fp32), then
  K5's forward pass updates each row's running (max, rescaled exp-sum,
  target logit): the online logsumexp (JAX ``_forward`` :52-86);
- backward: per chunk, the logits are recomputed, K5's backward pass turns
  them in place into ``dlogits = (exp(logits - lse) - onehot) * ct / N``,
  then ``dx += dlogits @ w_c`` and ``dW_c = dlogits.T @ x`` (JAX ``_bwd``
  :94-124).

Only ``lse`` ``[N]`` is saved between the passes (with the inputs), never a
``[N, V]`` tensor. The products stay ``torch.matmul`` in fp32: XLA computes
them outside any kernel, and the port leaves fp32 products in full fp32
(TF32 off, PyTorch's default), as on the dense logits path.

K5 is ``csrc/xent.cu`` (two kernels, ``xent_fwd_chunk`` and
``xent_bwd_chunk``); beside each wrapper is its plain PyTorch version, the
JAX scan body op for op. Dispatch: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``kernel_launches`` counts the
launches by kernel.

Contracts kept from the JAX package: targets are clipped to ``[0, V - 1]``
(``:58-61``: JAX's ``take_along_axis`` clamps, so a ``-1`` pad hits class
0 as on the dense path); a chunk that does not divide V raises
``ValueError``; the loss is the mean over N; ``dx`` has x's dtype and
``dW`` has w's dtype.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
SOURCE = "xent"

# launches made by the wrappers, by kernel (read and reset by chip_smoke.py)
kernel_launches = {"xent_fwd_chunk": 0, "xent_bwd_chunk": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "hvd_xent_fwd_chunk": [_P, _P, _L, _I, _I, _P, _P, _P, _I, _P],
    "hvd_xent_bwd_chunk": [_P, _P, _L, _I, _I, _P, _P, _I, _P],
}
_fns: dict = {}


def _kernel(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(SOURCE), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _chunks(V: int, chunk: int) -> int:
    chunk = min(chunk, V)
    if V % chunk:
        raise ValueError(
            f"vocab size {V} must be divisible by xent chunk {chunk}")
    return V // chunk


def _check(logits, targets, rows: list):
    """The kernels' contract: fp32 [N, C] logits, int64 [N] targets and
    fp32 [N] row vectors, contiguous, on one device."""
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be fp32 [N, C], got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    N = logits.shape[0]
    if targets.shape != (N,) or targets.dtype != torch.int64:
        raise ValueError(f"targets must be int64 [{N}], got {targets.dtype} "
                         f"{tuple(targets.shape)}")
    for t in rows:
        if t.shape != (N,) or t.dtype != torch.float32:
            raise ValueError(f"row vectors must be fp32 [{N}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (logits, targets, *rows):
        if t.device != logits.device:
            raise ValueError("K5's tensors must lie on one device")
        if not t.is_contiguous():
            raise ValueError("K5's tensors must be contiguous")
    if logits.device.type not in ("cuda", "cpu"):
        raise ValueError(f"K5 runs on CUDA or the CPU, not {logits.device}")


def _launch(symbol: str, logits, *args):
    dev = logits.device
    err = _kernel(symbol)(*args, dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 {symbol} launch failed: error {err} (a "
                           "cudaError_t)")
    kernel_launches[symbol[4:]] += 1


def fwd_chunk_plain(logits, targets, base: int, m, l, tgt):
    """The plain version of ``xent_fwd_chunk`` (JAX ``_forward``'s body
    :65-78): updates (m, l, tgt) in place."""
    C = logits.shape[1]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    l_new = l * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(dim=-1)
    local = targets - base
    in_chunk = (local >= 0) & (local < C)
    picked = logits.gather(1, local.clamp(0, C - 1)[:, None])[:, 0]
    tgt.copy_(torch.where(in_chunk, picked, tgt))
    m.copy_(m_new)
    l.copy_(l_new)


def bwd_chunk_plain(logits, targets, base: int, lse, scale):
    """The plain version of ``xent_bwd_chunk`` (JAX ``_bwd``'s body
    :106-113): the chunk's logits become its dlogits in place."""
    C = logits.shape[1]
    p = torch.exp(logits - lse[:, None])
    local = targets - base
    in_chunk = (local >= 0) & (local < C)
    onehot = (torch.where(in_chunk, local, -1)[:, None]
              == torch.arange(C, device=logits.device)[None, :])
    logits.copy_((p - onehot.float()) * scale)


def xent_fwd_chunk(logits, targets, base: int, m, l, tgt):
    """K5's forward pass over one chunk: the online logsumexp and the
    target's pick, (m, l, tgt) updated in place."""
    _check(logits, targets, [m, l, tgt])
    if logits.device.type == "cpu":
        return fwd_chunk_plain(logits, targets, base, m, l, tgt)
    N, C = logits.shape
    _launch("hvd_xent_fwd_chunk", logits, logits.data_ptr(),
            targets.data_ptr(), base, N, C, m.data_ptr(), l.data_ptr(),
            tgt.data_ptr())


def xent_bwd_chunk(logits, targets, base: int, lse, scale):
    """K5's backward pass over one chunk: logits -> dlogits in place.
    ``scale`` is a one-element fp32 tensor on the logits' device (ct / N)."""
    _check(logits, targets, [lse])
    if scale.numel() != 1 or scale.dtype != torch.float32 or (
            scale.device != logits.device):
        raise ValueError("scale must be one fp32 element on the logits' "
                         "device")
    if logits.device.type == "cpu":
        return bwd_chunk_plain(logits, targets, base, lse, scale)
    N, C = logits.shape
    _launch("hvd_xent_bwd_chunk", logits, logits.data_ptr(),
            targets.data_ptr(), base, N, C, lse.data_ptr(),
            scale.data_ptr())


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        N = x.shape[0]
        V = w.shape[0]
        targets = targets.reshape(-1).long().clamp(0, V - 1).contiguous()
        n_chunks = _chunks(V, chunk)
        C = V // n_chunks
        xf = x.float()
        m = torch.full((N,), NEG_INF, dtype=torch.float32, device=x.device)
        l = torch.zeros((N,), dtype=torch.float32, device=x.device)
        tgt = torch.full((N,), NEG_INF, dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            logits = xf @ w[c * C:(c + 1) * C].float().T      # [N, C]
            xent_fwd_chunk(logits, targets, c * C, m, l, tgt)
            del logits
        lse = m + torch.log(l)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return torch.mean(lse - tgt)

    @staticmethod
    def backward(ctx, ct):
        x, w, targets, lse = ctx.saved_tensors
        N, d = x.shape
        V = w.shape[0]
        n_chunks = _chunks(V, ctx.chunk)
        C = V // n_chunks
        xf = x.float()
        # d(mean)/d(per-token): one fp32 element, read by K5 on the device
        scale = (ct.float() / N).reshape(1)
        dx = torch.zeros((N, d), dtype=torch.float32, device=x.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        for c in range(n_chunks):
            wif = w[c * C:(c + 1) * C].float()
            dlogits = xf @ wif.T                             # [N, C]
            xent_bwd_chunk(dlogits, targets, c * C, lse, scale)
            dx += dlogits @ wif                              # [N, d]
            dw[c * C:(c + 1) * C] = dlogits.T @ xf           # [C, d]
            del dlogits
        return dx.to(x.dtype), dw, None, None


def chunked_softmax_xent(x, w, targets, chunk: int = 8192):
    """Mean cross-entropy of ``softmax(x @ w.T)`` against ``targets``.

    x: [N, d] activations; w: [V, d] classifier (embedding) matrix;
    targets: [N] int ids. Returns the scalar mean loss (fp32).
    Differentiable in x and w; logits are never materialized beyond
    [N, chunk]."""
    _chunks(w.shape[0], chunk)  # raises before any work
    return _ChunkedXent.apply(x, w, targets, chunk)
