"""Negotiation wire formats: the v1 JSON payloads with the 1-byte
SAME_AS_LAST marker, and v2, versioned, length-delimited binary frames
(ported whole from the JAX package), which ``ops/controller.py`` speaks
under ``HOROVOD_HIER_NEGOTIATION`` once every rank advertised them.

v1, byte for byte the JAX controller's (its ``KVController``/
``_Coordinator`` write these payloads inline):

    submission := JSON {"e": [[name, sig], ...], "j": joined,
                        "sd": shutting down[, "wv": 2]}
                  -- "wv" only in round 0 under HOROVOD_HIER_NEGOTIATION
                | SAME_AS_LAST  -- the rank's last submission again
    response   := JSON {"ready", "sigs", "errors", "join_done",
                        ["shutdown_done"], ["invalidate"], ["abort"],
                        ["wv"], ["mp"]}
                  -- "wv" confirms v2 in round 0, "mp" grants the
                     megaplan lease

Reference: Horovod's common/wire/message.fbs — the
reference serializes controller messages with FlatBuffers precisely
because the per-round control traffic is hot enough that a text codec
shows up at scale. The v1 wire is JSON (above); at pod scale the
per-round JSON bytes and parse cost grow with world size, so v2
replaces the payloads with a compact binary encoding while keeping the *protocol* (rounds, scopes,
SAME_AS_LAST marker, traced ``"t"`` suffix) bit-compatible.

Frame grammar (all integers LEB128 varints unless sized):

    frame     := MAGIC_V2 kind body
    kind      := SUBMIT(0x01) | AGG(0x02) | RESP(0x03)

    SUBMIT    := flags [f64 t] n_entries { str(name) sigref(sig) }
                 -- flags: 1 joined, 2 shutting_down, 4 has_t
    AGG       := flags group size bitmap(covered) bitmap(joined)
                 bitmap(sd) n_entries { str(name) sigref(sig)
                 bitmap(ranks) } [tmap]
                 -- flags: 1 has_tmap; tmap := n { rank f64 t }
    RESP      := flags n_ready { str(name) sigref(sig) }
                 n_errors { str(name) str(msg) } [join_done]
                 [n_strag { str(name) rank f64 wait }] [wv]
                 [len json(params)]
                 -- flags: 1 join_done, 2 shutdown_done, 4 invalidate,
                    8 has_params, 16 has_strag, 32 has_wv

Strings are interned: the first occurrence in a frame (SUBMIT/AGG) or on
a channel (RESP) carries the bytes and binds the next id; later
occurrences are a 1-2 byte reference. SUBMIT/AGG frames are
self-contained — a leader fail-over or flat fallback mid-stream must
never leave a decoder holding bindings the encoder has forgotten — while
the RESP channel interns across rounds (single writer, and the lockstep
guarantees every rank decodes every response in order), which is where
the repetition actually lives: ``allreduce``/``float32``/``global``
style signature atoms recur every round under fresh tensor names.

Whole signatures intern the same way (``sigref``): gradients in one
model overwhelmingly share a handful of (shape, dtype, op, scale)
tuples, so the first occurrence carries the tagged value and later
entries — and on the RESP channel, later *rounds* — are a 1-2 byte
reference. Decoders hand back the one decoded object per binding;
callers treat signatures as immutable (the controller only ever
compares and re-serializes them).

The first byte ``MAGIC_V2`` (0x02) collides with neither JSON payloads
(``{``/``[``) nor the 1-byte SAME_AS_LAST marker (``=``, 0x3D), so
decoders sniff the format per value and mixed-version worlds degrade to
v1 without flag-day coordination (docs/scaling.md covers the
handshake).
"""

from __future__ import annotations

import json
import struct
from typing import Optional

MAGIC_V2 = 0x02
WIRE_V1 = 1
WIRE_V2 = 2

# "my submission is identical to last round's" (the role of the reference
# response cache's bit vector)
SAME_AS_LAST = b"="

KIND_SUBMIT = 0x01
KIND_AGG = 0x02
KIND_RESP = 0x03

# value codec tags (signature lists are heterogenous: strings, ints,
# floats, nested lists, None for absent root ranks)
_T_NULL, _T_FALSE, _T_TRUE, _T_INT, _T_FLOAT, _T_STR, _T_LIST = range(7)


class WireDecodeError(ValueError):
    """A v2 frame failed to parse (truncation, bad tag, dangling intern
    reference). Decoders raise this instead of struct/index errors so
    the controller can attribute the failure to the wire layer."""


# -- v1: JSON payloads -------------------------------------------------------

def encode_submission_v1(entries, joined: bool, shutting_down: bool,
                         wv: Optional[int] = None) -> bytes:
    """One rank's v1 round submission; ``entries`` is an iterable of
    ``(name, sig)``, ``wv`` the round-0 advert of wire v2."""
    msg = {"e": [[n, sig] for n, sig in entries], "j": bool(joined),
           "sd": bool(shutting_down)}
    if wv is not None:
        msg["wv"] = wv
    return json.dumps(msg).encode()


def decode_submission_v1(raw: bytes, last: Optional[dict]) -> dict:
    """A v1 submission as ``{"e", "j", "sd"}``; the SAME_AS_LAST marker
    repeats ``last``, the sender's previous submission (an empty one when
    there is none)."""
    if raw[:1] == SAME_AS_LAST:
        return last if last is not None else {"e": [], "j": False,
                                              "sd": False}
    return json.loads(raw)


def encode_response_v1(resp: dict) -> bytes:
    return json.dumps(resp).encode()


def decode_response_v1(raw: bytes) -> dict:
    return json.loads(raw)


# -- varints ---------------------------------------------------------------

def _enc_uvarint(out: bytearray, v: int) -> None:
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _enc_svarint(out: bytearray, v: int) -> None:
    _enc_uvarint(out, (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        try:
            b = self.buf[self.pos]
        except IndexError:
            raise WireDecodeError("truncated frame") from None
        self.pos += 1
        return b

    def uvarint(self) -> int:
        shift = v = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise WireDecodeError("varint overflow")

    def svarint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def f64(self) -> float:
        end = self.pos + 8
        if end > len(self.buf):
            raise WireDecodeError("truncated f64")
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos = end
        return v

    def raw(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise WireDecodeError("truncated bytes")
        v = self.buf[self.pos:end]
        self.pos = end
        return v


# -- string interning ------------------------------------------------------

class Interner:
    """Encoder half of the string table: first sight writes the bytes
    and binds the next id, repeats write a reference (id<<1|0 vs the
    new-binding marker id<<1|1 — one bit, not a separate tag byte)."""

    __slots__ = ("_ids",)

    def __init__(self):
        self._ids: dict[str, int] = {}

    def encode(self, out: bytearray, s: str) -> None:
        i = self._ids.get(s)
        if i is not None:
            _enc_uvarint(out, i << 1)
            return
        self._ids[s] = len(self._ids)
        raw = s.encode("utf-8")
        _enc_uvarint(out, (len(self._ids) - 1) << 1 | 1)
        _enc_uvarint(out, len(raw))
        out += raw


class StringTable:
    """Decoder half: ids resolve in binding order. Monotone — nothing
    ever unbinds, so a decoder that has seen every prior frame on the
    channel (the lockstep guarantee) can never dangle."""

    __slots__ = ("_strs",)

    def __init__(self):
        self._strs: list[str] = []

    def decode(self, r: _Reader) -> str:
        ref = r.uvarint()
        if ref & 1:
            n = r.uvarint()
            try:
                s = r.raw(n).decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireDecodeError(f"bad utf-8 in interned string: {e}")
            if ref >> 1 != len(self._strs):
                raise WireDecodeError("out-of-order intern binding")
            self._strs.append(s)
            return s
        i = ref >> 1
        if i >= len(self._strs):
            raise WireDecodeError(f"dangling intern reference {i}")
        return self._strs[i]


# -- tagged values (signatures) -------------------------------------------

def _enc_value(out: bytearray, v, intern: Interner) -> None:
    if v is None:
        out.append(_T_NULL)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        _enc_svarint(out, v)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += struct.pack("<d", v)
    elif isinstance(v, str):
        out.append(_T_STR)
        intern.encode(out, v)
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        _enc_uvarint(out, len(v))
        for item in v:
            _enc_value(out, item, intern)
    else:
        raise TypeError(f"unencodable signature element: {type(v)!r}")


def _dec_value(r: _Reader, table: StringTable):
    tag = r.u8()
    if tag == _T_NULL:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return r.svarint()
    if tag == _T_FLOAT:
        return r.f64()
    if tag == _T_STR:
        return table.decode(r)
    if tag == _T_LIST:
        return [_dec_value(r, table) for _ in range(r.uvarint())]
    raise WireDecodeError(f"unknown value tag {tag}")


# -- signature interning ---------------------------------------------------

class _SigEncoder:
    """Whole-signature interning over a value codec: repeats of an
    identical signature write a 1-2 byte reference instead of the full
    tagged value (same id<<1|new-bit scheme as :class:`Interner`).
    Keyed by the canonical JSON of the signature — deterministic for
    equal inputs, so SAME_AS_LAST byte comparison still holds."""

    __slots__ = ("_intern", "_ids")

    def __init__(self, intern: Interner):
        self._intern = intern
        self._ids: dict[str, int] = {}

    def encode(self, out: bytearray, sig) -> None:
        key = json.dumps(sig)
        i = self._ids.get(key)
        if i is not None:
            _enc_uvarint(out, i << 1)
            return
        self._ids[key] = len(self._ids)
        _enc_uvarint(out, (len(self._ids) - 1) << 1 | 1)
        _enc_value(out, sig, self._intern)


class _SigDecoder:
    """Decoder half: bindings resolve in order, the decoded object is
    shared between references (callers never mutate signatures)."""

    __slots__ = ("_table", "_sigs")

    def __init__(self, table: StringTable):
        self._table = table
        self._sigs: list = []

    def decode(self, r: _Reader):
        ref = r.uvarint()
        if ref & 1:
            if ref >> 1 != len(self._sigs):
                raise WireDecodeError("out-of-order sig binding")
            v = _dec_value(r, self._table)
            self._sigs.append(v)
            return v
        i = ref >> 1
        if i >= len(self._sigs):
            raise WireDecodeError(f"dangling sig reference {i}")
        return self._sigs[i]


# -- rank bitmaps ----------------------------------------------------------

def _enc_bitmap(out: bytearray, ranks, size: int) -> None:
    bits = bytearray((size + 7) // 8)
    for k in ranks:
        if not 0 <= k < size:
            raise ValueError(f"rank {k} outside world of {size}")
        bits[k >> 3] |= 1 << (k & 7)
    out += bits


def _dec_bitmap(r: _Reader, size: int) -> set:
    raw = r.raw((size + 7) // 8)
    out = set()
    for byte_i, b in enumerate(raw):
        while b:
            low = b & -b
            out.add((byte_i << 3) + low.bit_length() - 1)
            b ^= low
    return out


# -- SUBMIT frames ---------------------------------------------------------

def encode_submission(entries, joined: bool, shutting_down: bool,
                      t: Optional[float] = None) -> bytes:
    """One worker's (or group member's) round submission.

    ``entries`` is the negotiate() pending view: an iterable of
    ``(name, sig)``. ``t`` is the traced clock-aligned submit time —
    deliberately OUTSIDE the SAME_AS_LAST comparison, so callers encode
    the comparable payload with ``t=None`` and re-encode with the
    timestamp only for the wire (mirrors the v1 JSON split)."""
    out = bytearray((MAGIC_V2, KIND_SUBMIT))
    flags = (1 if joined else 0) | (2 if shutting_down else 0)
    if t is not None:
        flags |= 4
    out.append(flags)
    if t is not None:
        out += struct.pack("<d", t)
    items = list(entries)
    _enc_uvarint(out, len(items))
    intern = Interner()
    sig_enc = _SigEncoder(intern)
    for name, sig in items:
        intern.encode(out, name)
        sig_enc.encode(out, sig)
    return bytes(out)


def decode_submission(raw: bytes) -> dict:
    """Returns the v1-shaped message dict ``{"e": [[name, sig], ...],
    "j": bool, "sd": bool}`` plus ``"t"`` when the frame carries a
    traced submit time — drop-in for ``json.loads`` of a v1 payload."""
    r = _Reader(raw)
    if r.u8() != MAGIC_V2 or r.u8() != KIND_SUBMIT:
        raise WireDecodeError("not a v2 SUBMIT frame")
    flags = r.u8()
    msg: dict = {"j": bool(flags & 1), "sd": bool(flags & 2)}
    if flags & 4:
        msg["t"] = r.f64()
    table = StringTable()
    sig_dec = _SigDecoder(table)
    msg["e"] = [[table.decode(r), sig_dec.decode(r)]
                for _ in range(r.uvarint())]
    return msg


# -- AGG frames (leader -> coordinator) ------------------------------------

def encode_aggregate(group: int, size: int, entries, covered, joined,
                     shutting_down, t_map: Optional[dict] = None) -> bytes:
    """A node leader's merged round: ``entries`` is ``[(name, sig,
    ranks)]`` (duplicate names with different sigs are legal — the
    coordinator's mismatch validation wants to see both sides),
    ``covered`` the ranks this aggregate answers for, ``joined``/
    ``shutting_down`` the subsets that set those flags, ``t_map`` the
    traced per-rank submit times. Like SUBMIT, callers build the
    SAME_AS_LAST-comparable encoding with ``t_map=None``."""
    out = bytearray((MAGIC_V2, KIND_AGG))
    out.append(1 if t_map else 0)
    _enc_uvarint(out, group)
    _enc_uvarint(out, size)
    _enc_bitmap(out, covered, size)
    _enc_bitmap(out, joined, size)
    _enc_bitmap(out, shutting_down, size)
    items = list(entries)
    _enc_uvarint(out, len(items))
    intern = Interner()
    sig_enc = _SigEncoder(intern)
    for name, sig, ranks in items:
        intern.encode(out, name)
        sig_enc.encode(out, sig)
        _enc_bitmap(out, ranks, size)
    if t_map:
        _enc_uvarint(out, len(t_map))
        for k in sorted(t_map):
            _enc_uvarint(out, k)
            out += struct.pack("<d", float(t_map[k]))
    return bytes(out)


def decode_aggregate(raw: bytes) -> dict:
    """Returns ``{"g": group, "e": [[name, sig, set(ranks)], ...],
    "covered": set, "j": set, "sd": set}`` plus ``"t"`` (rank -> time)
    when traced."""
    r = _Reader(raw)
    if r.u8() != MAGIC_V2 or r.u8() != KIND_AGG:
        raise WireDecodeError("not a v2 AGG frame")
    flags = r.u8()
    group = r.uvarint()
    size = r.uvarint()
    msg: dict = {"g": group,
                 "covered": _dec_bitmap(r, size),
                 "j": _dec_bitmap(r, size),
                 "sd": _dec_bitmap(r, size)}
    table = StringTable()
    sig_dec = _SigDecoder(table)
    msg["e"] = [[table.decode(r), sig_dec.decode(r),
                 _dec_bitmap(r, size)]
                for _ in range(r.uvarint())]
    if flags & 1:
        msg["t"] = {r.uvarint(): r.f64() for _ in range(r.uvarint())}
    return msg


def is_aggregate(raw: bytes) -> bool:
    return len(raw) >= 2 and raw[0] == MAGIC_V2 and raw[1] == KIND_AGG


# -- RESP frames (coordinator -> everyone) ---------------------------------

_F_JOIN_DONE = 1
_F_SHUTDOWN = 2
_F_INVALIDATE = 4
_F_PARAMS = 8
_F_STRAG = 16
_F_WV = 32


class ResponseEncoder:
    """Coordinator-held encoder for the response channel. Interns
    strings ACROSS rounds — safe because the coordinator is the only
    writer and the lockstep makes every rank decode every response in
    publication order (a rank that misses one is broken and
    re-initializes with a fresh table)."""

    def __init__(self):
        self._intern = Interner()
        self._sig_enc = _SigEncoder(self._intern)

    def encode(self, resp: dict) -> bytes:
        out = bytearray((MAGIC_V2, KIND_RESP))
        flags = 0
        if resp.get("join_done") is not None:
            flags |= _F_JOIN_DONE
        if resp.get("shutdown_done"):
            flags |= _F_SHUTDOWN
        if resp.get("invalidate"):
            flags |= _F_INVALIDATE
        if resp.get("params") is not None:
            flags |= _F_PARAMS
        if resp.get("strag"):
            flags |= _F_STRAG
        if resp.get("wv") is not None:
            flags |= _F_WV
        out.append(flags)
        ready = resp.get("ready", [])
        sigs = resp.get("sigs", {})
        _enc_uvarint(out, len(ready))
        for name in ready:
            self._intern.encode(out, name)
            self._sig_enc.encode(out, sigs[name])
        errors = resp.get("errors", {})
        _enc_uvarint(out, len(errors))
        for name, emsg in errors.items():
            self._intern.encode(out, name)
            self._intern.encode(out, emsg)
        if flags & _F_JOIN_DONE:
            _enc_uvarint(out, int(resp["join_done"]))
        if flags & _F_STRAG:
            strag = resp["strag"]
            _enc_uvarint(out, len(strag))
            for name, (last, wait) in strag.items():
                self._intern.encode(out, name)
                _enc_uvarint(out, int(last))
                out += struct.pack("<d", float(wait))
        if flags & _F_WV:
            _enc_uvarint(out, int(resp["wv"]))
        if flags & _F_PARAMS:
            blob = json.dumps(resp["params"]).encode()
            _enc_uvarint(out, len(blob))
            out += blob
        return bytes(out)


class ResponseDecoder:
    """Worker-held decoder for the response channel (one per
    controller, tables advance with the lockstep). Returns the same
    dict shape ``json.loads`` yields for a v1 response."""

    def __init__(self):
        self._table = StringTable()
        self._sig_dec = _SigDecoder(self._table)

    def decode(self, raw: bytes) -> dict:
        r = _Reader(raw)
        if r.u8() != MAGIC_V2 or r.u8() != KIND_RESP:
            raise WireDecodeError("not a v2 RESP frame")
        flags = r.u8()
        ready = []
        sigs = {}
        for _ in range(r.uvarint()):
            name = self._table.decode(r)
            ready.append(name)
            sigs[name] = self._sig_dec.decode(r)
        errors = {}
        for _ in range(r.uvarint()):
            name = self._table.decode(r)
            errors[name] = self._table.decode(r)
        resp: dict = {"ready": ready, "sigs": sigs, "errors": errors,
                      "join_done": None}
        if flags & _F_JOIN_DONE:
            resp["join_done"] = r.uvarint()
        if flags & _F_STRAG:
            resp["strag"] = {
                self._table.decode(r): [r.uvarint(), r.f64()]
                for _ in range(r.uvarint())}
        if flags & _F_WV:
            resp["wv"] = r.uvarint()
        if flags & _F_PARAMS:
            try:
                resp["params"] = json.loads(r.raw(r.uvarint()))
            except ValueError as e:
                raise WireDecodeError(f"bad params blob: {e}")
        if flags & _F_SHUTDOWN:
            resp["shutdown_done"] = True
        if flags & _F_INVALIDATE:
            resp["invalidate"] = True
        return resp
