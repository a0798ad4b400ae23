"""Gradient compression — counterpart of ``horovod_tpu/ops/compression.py``.

- The cast compressors (``NoneCompressor``, ``FP16Compressor``,
  ``BF16Compressor``, :75-123), applied around a collective by the caller.
- The compressed wire of the runtime's fused chunks (:126-343): the bf16
  cast wire (``make_cast_spec``, ``bits=16``) and the blockwise int8/int4
  formats (``make_quant_spec``): per-block absmax scales rounded to bf16,
  int4 packed two values a byte (low nibble first, two's complement), and
  error-feedback residuals that carry each step's quantization error into
  the next. ``QuantSpec`` is the static signature folded into the plan
  keys; ``resolve_quant_spec`` reads ``HOROVOD_COMPRESSION`` and raises on
  a value outside ``WIRE_MODES``.
- The guardrails that keep a tensor off the wire (``quant_fallback_reason``:
  non-float dtypes, leaves under ``HOROVOD_QUANT_MIN_ELEMS``, names that
  match ``DEFAULT_OPTOUT_PATTERNS`` or ``HOROVOD_QUANT_OPTOUT``).
- ``quantize_blockwise`` and ``dequantize_blockwise``: the plain PyTorch
  version of the format, bit for bit the JAX package's; the kernels that
  run it on the card, fused with the pack and the reduction, are in
  ``ops/quant_wire.py``.
- The metrics ``hvd_quant_wire_bytes_total{bits}``,
  ``hvd_quant_blocks_total`` and ``hvd_quant_fallback_total{reason}``,
  registered lazily: no such series exists until a tensor goes to, or is
  kept off, the compressed wire. The cast wire counts under ``bits="16"``
  (the JAX package counts it under ``bits="4"``, ROADMAP.md queue 3).
- ``ResidualStore``: the runtime's error-feedback residuals, committed only
  after a dispatch succeeded, reset on an elastic-generation change and
  dropped on a shape change.
- The ``Compression.int8``/``int4`` markers (``QuantCompressor``): their
  ``compress``/``decompress`` are the identity; the runtime reads their
  ``quant_spec`` and runs the format inside the collective.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..common import env as env_schema
from ..utils import metrics as metrics_mod

_m_pre = None
_m_post = None


def _record_wire_bytes(pre_bytes: int, wire_bytes: int):
    """The pre- and post-compression byte counters
    (``hvd_compression_bytes_total{stage}``)."""
    global _m_pre, _m_post
    if _m_pre is None:
        reg = metrics_mod.get_registry()
        _m_pre = reg.counter("hvd_compression_bytes_total",
                             "payload bytes around compression", stage="pre")
        _m_post = reg.counter("hvd_compression_bytes_total",
                              "payload bytes around compression",
                              stage="post")
    _m_pre.inc(int(pre_bytes))
    _m_post.inc(int(wire_bytes))


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and dtype != cls.wire_dtype:
            wire = tensor.to(cls.wire_dtype)
            _record_wire_bytes(tensor.numel() * tensor.element_size(),
                               wire.numel() * wire.element_size())
            return wire, dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


# --- the blockwise int8/int4 wire -----------------------------------------

# scale words ride the wire in bf16, two bytes a block
SCALE_BYTES = 2
# below this many elements a tensor stays on the uncompressed wire
DEFAULT_QUANT_MIN_ELEMS = 4096
# name substrings (case-insensitive) kept off the wire: normalization
# scales and offsets, and biases; HOROVOD_QUANT_OPTOUT extends the list
DEFAULT_OPTOUT_PATTERNS = ("bias", "norm", "bn", "gamma", "beta",
                           "embedding_scale")


class QuantSpec(NamedTuple):
    """The wire's static signature, folded into fused-plan keys. ``bits``
    16 is the bf16 cast wire (no blocks, no scales, no error feedback); 8
    and 4 are the blockwise absmax formats."""

    bits: int
    block: int
    error_feedback: bool

    @property
    def qmax(self) -> float:
        return 127.0 if self.bits == 8 else 7.0

    def signature(self) -> tuple:
        return ("quant", self.bits, self.block, self.error_feedback)


# the accepted HOROVOD_COMPRESSION values (plus ""/"0"/"off" for "none")
WIRE_MODES = ("none", "bf16", "int8", "int4")


def make_cast_spec() -> QuantSpec:
    """The bf16 cast wire's spec."""
    return QuantSpec(16, 1, False)


def spec_for_mode(mode: str, block: Optional[int] = None,
                  error_feedback: Optional[bool] = None
                  ) -> Optional[QuantSpec]:
    """The spec of one of ``WIRE_MODES``: None for the uncompressed wire,
    ValueError outside the closed set."""
    mode = (mode or "").strip().lower()
    if mode in ("", "none", "0", "off"):
        return None
    if mode == "bf16":
        return make_cast_spec()
    if mode == "int8":
        return make_quant_spec(8, block, error_feedback)
    if mode == "int4":
        return make_quant_spec(4, block, error_feedback)
    raise ValueError(f"unknown compression mode {mode!r}: supported values "
                     f"are {'|'.join(WIRE_MODES)}")


def mode_of_spec(spec: Optional[QuantSpec]) -> str:
    """The inverse of ``spec_for_mode``."""
    if spec is None:
        return "none"
    return {16: "bf16", 8: "int8", 4: "int4"}[spec.bits]


def _positive_block(block: int, bits: int) -> int:
    block = max(int(block), 8)
    if bits == 4 and block % 2:
        block += 1  # int4 packs value pairs: blocks are even
    return block


def make_quant_spec(bits: int, block: Optional[int] = None,
                    error_feedback: Optional[bool] = None) -> QuantSpec:
    """A blockwise spec; unset fields come from the knobs."""
    if bits not in (8, 4):
        raise ValueError(f"quantized wire supports 8 or 4 bits, got {bits}")
    if block is None:
        block = env_schema.get_int(env_schema.HOROVOD_QUANT_BLOCK, 256)
    if error_feedback is None:
        error_feedback = env_schema.get_bool(env_schema.HOROVOD_QUANT_EF,
                                             True)
    return QuantSpec(int(bits), _positive_block(block, bits),
                     bool(error_feedback))


def resolve_quant_spec(config=None) -> Optional[QuantSpec]:
    """The runtime's wire from ``HOROVOD_COMPRESSION`` (or a parsed
    ``RuntimeConfig``); None keeps the wire uncompressed."""
    block = ef = None
    if config is not None:
        mode = (getattr(config, "compression", "") or "").strip().lower()
        block = getattr(config, "quant_block", None)
        ef = getattr(config, "quant_error_feedback", None)
    else:
        mode = env_schema.get_str(env_schema.HOROVOD_COMPRESSION) \
            .strip().lower()
    try:
        return spec_for_mode(mode, block, ef)
    except ValueError as e:
        raise ValueError(f"{env_schema.HOROVOD_COMPRESSION}: {e}") from None


def quant_optout_patterns(extra: Optional[str] = None) -> Tuple[str, ...]:
    """The default and the user's opt-out substrings, lowercased;
    ``extra`` is the comma-separated list (``HOROVOD_QUANT_OPTOUT`` when
    None)."""
    if extra is None:
        extra = env_schema.get_str(env_schema.HOROVOD_QUANT_OPTOUT)
    pats = list(DEFAULT_OPTOUT_PATTERNS)
    for p in extra.split(","):
        p = p.strip().lower()
        if p and p not in pats:
            pats.append(p)
    return tuple(pats)


def quant_min_elems() -> int:
    return env_schema.get_int(env_schema.HOROVOD_QUANT_MIN_ELEMS,
                              DEFAULT_QUANT_MIN_ELEMS)


def quant_fallback_reason(name: str, size: int, dtype: torch.dtype,
                          patterns: Tuple[str, ...],
                          min_elems: int) -> Optional[str]:
    """Why a tensor stays off the compressed wire, or None. The reasons
    are the label set of ``hvd_quant_fallback_total{reason}``."""
    if not dtype.is_floating_point:
        return "non_float"
    if int(size) < int(min_elems):
        return "small_leaf"
    low = (name or "").lower()
    for p in patterns:
        if p in low:
            return "optout_match"
    return None


def quant_wire_layout(n_elems: int, spec: QuantSpec
                      ) -> Tuple[int, int, int, int]:
    """(padded elements, blocks, payload bytes, scale bytes) of a flat
    buffer of ``n_elems``: int4 packs two values a byte, and every block
    adds ``SCALE_BYTES``."""
    n = int(n_elems)
    block = spec.block
    padded = -(-n // block) * block
    nblocks = padded // block
    payload = padded if spec.bits == 8 else padded // 2
    return padded, nblocks, payload, nblocks * SCALE_BYTES


def quantize_blockwise(flat: torch.Tensor, spec: QuantSpec):
    """``flat[n]`` -> (payload, bf16 scales), the plain version of the
    format as the JAX package runs it under ``jit``: per block, scale =
    max|x| * fp32(1/qmax) (XLA rewrites the division by the constant qmax
    into that product; 1 for an all-zero block), rounded to bf16;
    q = round-half-even(x / scale) by IEEE division, clipped to +-qmax.
    int8 keeps one int8 an element; int4 packs consecutive pairs into one
    uint8, low nibble first."""
    block, qmax = spec.block, spec.qmax
    n = flat.shape[0]
    x = flat.float()
    pad = (-n) % block
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xb = x.view(-1, block)
    absmax = xb.abs().amax(dim=1)
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scales = torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))
    wire_scales = scales.to(torch.bfloat16)
    eff = wire_scales.float()
    q = torch.clamp(torch.round(xb / eff[:, None]), -qmax, qmax) \
        .to(torch.int8).view(-1)
    if spec.bits == 8:
        return q, wire_scales
    u = q.view(torch.uint8) & 0xF  # two's-complement nibbles
    return u[0::2] | (u[1::2] << 4), wire_scales


def dequantize_blockwise(packed: torch.Tensor, scales: torch.Tensor,
                         spec: QuantSpec, n_elems: int) -> torch.Tensor:
    """The inverse of ``quantize_blockwise``: ``float32[n_elems]``."""
    if spec.bits == 8:
        q = packed.view(torch.int8)
    else:
        p = packed.view(torch.uint8)
        lo = (p & 0xF).to(torch.int8)
        hi = (p >> 4).to(torch.int8)
        # sign-extend the 4-bit two's-complement nibble
        q = torch.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], dim=-1).view(-1)
    xb = q.view(-1, spec.block).float()
    return (xb * scales.float()[:, None]).view(-1)[:n_elems]


# --- metrics, registered at first use (the zero-cost contract) ------------

_wire_handles: dict = {}
_blocks_handle = None
_fallback_handles: dict = {}


def quant_fallback_counter(reason: str):
    h = _fallback_handles.get(reason)
    if h is None:
        h = metrics_mod.get_registry().counter(
            "hvd_quant_fallback_total", "tensors kept off the quantized wire",
            reason=reason)
        _fallback_handles[reason] = h
    return h


def record_quant_chunk(pre_bytes: int, wire_bytes: int, bits: int,
                       n_blocks: int) -> None:
    """One compressed chunk's accounting: the compression counters, the
    wire bytes by format (payload and scales) and the blocks."""
    global _blocks_handle
    _record_wire_bytes(pre_bytes, wire_bytes)
    h = _wire_handles.get(bits)
    if h is None:
        reg = metrics_mod.get_registry()
        h = _wire_handles[bits] = reg.counter(
            "hvd_quant_wire_bytes_total",
            "quantized wire bytes (packed payload + scales)", bits=str(bits))
        if _blocks_handle is None:
            _blocks_handle = reg.counter("hvd_quant_blocks_total",
                                         "absmax blocks quantized")
    h.inc(int(wire_bytes))
    _blocks_handle.inc(int(n_blocks))


# --- the runtime's error-feedback residuals -------------------------------


class ResidualStore:
    """Error-feedback residuals, one a tensor: the fp32 error of the
    tensor's last quantized dispatch, keyed by its name and the wire's
    signature. Only the cycle thread touches the store.

    ``get`` gives a chunk's residuals before its dispatch and ``commit``
    stores the dispatch's flat new residual, as one view a tensor, only
    after the dispatch succeeded, so a failed dispatch leaves the previous
    ones in place. An elastic-generation change resets the store (the peers
    changed); a residual whose length no longer fits its tensor is dropped.
    The runtime's chunks follow the cycle's timing, so the same tensors may
    fuse otherwise from step to step; a residual follows its tensor into
    whatever chunk it lands in (K3 reads each tensor's residual through a
    pointer table). The JAX package keys a residual by the chunk's ordered
    names instead, which gives the same values while the chunks recur and
    drops a tensor's error when they do not. ``hits`` and ``misses`` count
    the tensors that ``get`` found a residual for and those it did not."""

    def __init__(self):
        self._res: dict = {}
        self._epoch = self._gen()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _gen() -> int:
        return env_schema.get_int(env_schema.HOROVOD_ELASTIC_GEN, 0)

    def _check_epoch(self) -> None:
        gen = self._gen()
        if gen != self._epoch:
            self._res.clear()
            self._epoch = gen

    def get(self, names, sizes, sig: tuple):
        """The residuals to fold into a chunk's dispatch, one a tensor
        (None where there is none: a first step, a reset or a stale
        shape), or None when no tensor of the chunk has one."""
        self._check_epoch()
        out = []
        for name, n in zip(names, sizes):
            key = (name, sig)
            r = self._res.get(key)
            if r is not None and int(r.numel()) != int(n):
                del self._res[key]
                r = None
            out.append(r)
        found = sum(r is not None for r in out)
        self.hits += found
        self.misses += len(out) - found
        return out if found else None

    def residual(self, name: str, sig: tuple):
        """A tensor's residual, or None (counts nothing)."""
        return self._res.get((name, sig))

    def commit(self, names, sizes, sig: tuple, flat) -> None:
        """Store the chunk's new residual ``flat`` (chunk order) as one
        view a tensor."""
        self._check_epoch()
        for name, part in zip(names, torch.split(flat, list(sizes))):
            self._res[(name, sig)] = part

    def reset(self) -> None:
        self._res.clear()
        self._epoch = self._gen()

    def __len__(self) -> int:
        return len(self._res)

    def nbytes(self) -> int:
        return sum(int(r.numel() * r.element_size())
                   for r in self._res.values())


# --- the API's markers ------------------------------------------------------


class QuantCompressor(Compressor):
    """``Compression.int8``/``int4``: a marker. Summing packed integers is
    not summing the values, so the format lives inside the collective:
    ``compress``/``decompress`` are the identity and the runtime reads
    ``quant_spec``."""

    def __init__(self, bits: int, block: Optional[int] = None,
                 error_feedback: Optional[bool] = None):
        self._bits = bits
        self._block = block
        self._error_feedback = error_feedback

    @property
    def quant_spec(self) -> QuantSpec:
        """Resolved at use, so the knobs' defaults are read then."""
        return make_quant_spec(self._bits, self._block,
                               self._error_feedback)

    def with_options(self, block: Optional[int] = None,
                     error_feedback: Optional[bool] = None
                     ) -> "QuantCompressor":
        """A customized copy, e.g.
        ``Compression.int4.with_options(error_feedback=False)``."""
        return QuantCompressor(
            self._bits, self._block if block is None else block,
            self._error_feedback if error_feedback is None
            else error_feedback)

    def compress(self, tensor):
        return tensor, None

    def decompress(self, tensor, ctx):
        return tensor


class Compression:
    """The compression choices of an allreduce (reference
    compression.py:66-75); ``int8``/``int4`` select the blockwise wire."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = QuantCompressor(8)
    int4 = QuantCompressor(4)
