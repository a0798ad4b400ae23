"""The rendezvous key-value store over HTTP and its binary shards — the
port of ``horovod_tpu/runner/http_server.py`` (``_Store`` :569, the
handler :122-566, the shard protocol :647-866, ``_KVServer`` :868,
``RendezvousServer`` :900, ``KVStoreClient`` :972).

The launcher starts one ``RendezvousServer``; workers reach it with
``KVStoreClient``, and the controller's negotiation rounds ride it
(``ops/controller.py``). Values are opaque bytes under ``scope/key``; a GET
blocks until its key exists. When a job secret is present
(``HOROVOD_SECRET_KEY``, minted by the launcher: ``runner/secret.py``),
every request carries an HMAC digest the store checks before acting (403
otherwise), and every read's response carries a digest the client checks.

**Shards** (``HOROVOD_KV_SHARDS`` > 1): the keyspace is split over that
many stores, each behind a listener of its own that speaks a
length-prefixed binary framing (``_ShardListener``); a client routes a
scope to ``crc32(scope) % len(ports)`` of the table ``GET /shards``
returns. ``put_get`` is one ``PUTGET`` exchange there (store a key, block
on another of the same scope), where the HTTP path needs a PUT and a
GET. The HTTP server stays up for the bootstrap, the telemetry and an
unsharded client, on the first store. The wire and the signing are the
JAX package's, byte for byte, so either package's client talks to either
package's server, sharded or not.

The telemetry endpoints (JAX :168-521), read-only and exempt from the HMAC
(a scraper cannot sign; a bare path has no slash, so it never collides
with a ``scope/key``); each merges what the ranks pushed under its scope,
from every shard:

- ``GET /metrics``: the Prometheus exposition of this process's registry
  and of every snapshot the ranks pushed under ``metrics/``, labelled
  ``rank="k"`` (only the newest elastic generation's; a rank whose push
  lags is labelled ``stale="1"``);
- ``GET /clock``: this server's wall clock, the tracer's common timebase;
- ``GET /timeline``: one clock-aligned Chrome trace of the ranks' pushed
  spans (pid = rank) with their anatomy lanes;
- ``GET /perf``, ``/anatomy``, ``/memory`` and ``/checkpoint``: the ranks'
  perf-ledger, anatomy, memory-ledger and checkpointer snapshots by rank,
  each marked ``stale`` when its push lags the newest by more than
  ``STALE_INTERVALS`` intervals (``_merged_snapshots``); ``/checkpoint``
  adds the newest consistent manifest when its directory is visible here;
- ``GET /debug``: the ranks' diagnostic bundles merged into one
  attribution that names the wedged rank (``utils/diag.py``);
- ``GET /history?series=a,b&since=<unix time>`` and ``GET /health``: the
  health engines' series by rank, and the fleet's verdict with its
  suspects ranked (``utils/health.py``);
- ``GET /shards``: the shard listeners' ports (empty unsharded).
"""

from __future__ import annotations

import base64
import hmac
import http.client
import json
import socket
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.error import HTTPError
from urllib.parse import unquote

from ..utils import faults as _faults
from ..utils import retry as _retry
from . import secret as _secret


#: A pushed snapshot whose push time lags the newest push by more than this
#: many publisher intervals is marked stale (the floor absorbs the dumper
#: threads' jitter between healthy ranks).
STALE_INTERVALS = 3
STALE_FLOOR_S = 15.0


def _stale_ranks(entries) -> set:
    """Which of ``[(rank, snapshot), ...]`` are old news: their
    ``push_ts`` lags the newest push by more than ``STALE_INTERVALS``
    publisher intervals. A snapshot without a stamp is never marked."""
    stamped = [(r, s) for r, s in entries
               if isinstance(s.get("push_ts"), (int, float))]
    if len(stamped) < 2:
        return set()
    newest = max(s["push_ts"] for _, s in stamped)
    out = set()
    for r, s in stamped:
        interval = s.get("push_interval_s")
        if not isinstance(interval, (int, float)) or interval <= 0:
            interval = 30.0
        if newest - s["push_ts"] > max(STALE_INTERVALS * interval,
                                       STALE_FLOOR_S):
            out.add(r)
    return out


def _pushed(server, kv_scope: str) -> list:
    """``[(rank string, snapshot)]`` of every ``{kv_scope}/rank{k}`` push,
    half-written ones skipped (the next poll catches up)."""
    prefix = kv_scope + "/"
    out = []
    for k, v in sorted(server.scan_prefix(prefix).items()):
        suffix = k[len(prefix):]  # "rank1"
        try:
            out.append((suffix[4:] if suffix.startswith("rank") else suffix,
                        json.loads(v)))
        except (ValueError, UnicodeDecodeError):
            continue
    return out


def _merged_snapshots(server, kv_scope: str, local=None) -> dict:
    """The per-rank merge ``/perf`` and ``/anatomy`` serve: every pushed
    snapshot by rank string, each marked ``stale`` by :func:`_stale_ranks`
    (marked, never dropped), and this process's own snapshot when it has
    one (``local``: ``(rank, snapshot_fn)``) and no push shadows it."""
    entries = _pushed(server, kv_scope)
    stale = _stale_ranks(entries)
    ranks = {}
    for rank, snap in entries:
        snap["stale"] = rank in stale
        ranks[rank] = snap
    if local is not None:
        local_rank, snapshot_fn = local
        if str(local_rank) not in ranks:
            snap = snapshot_fn()
            snap["stale"] = False
            ranks[str(local_rank)] = snap
    return ranks


class KVAuthError(RuntimeError):
    """A KV exchange failed authentication: the store refused our digest
    (key mismatch, tampered request, clock outside the replay window) or a
    GET response's digest did not verify."""


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Nagle + delayed ACK on persistent connections costs 40 ms per
    # response; negotiation rounds are latency-bound
    disable_nagle_algorithm = True

    def log_message(self, *a):  # quiet
        pass

    def _key(self):
        return unquote(self.path.lstrip("/"))

    def _authorized(self, body: bytes = b"") -> bool:
        key = self.server.secret_key  # type: ignore[attr-defined]
        if not key:
            return True
        ts = self.headers.get(_secret.TS_HEADER) or ""
        try:
            skew = abs(time.time() - float(ts))
        except ValueError:
            return False
        if skew > _secret.MAX_SKEW_SECONDS:
            return False  # stale (or far-future) signed request: replay
        mode = ""
        if self.headers.get("X-Prefix-Read"):
            mode = f"prefix:{self.headers.get('X-Min-Count', '1')}"
        return _secret.check_digest(
            key, self.headers.get(_secret.DIGEST_HEADER),
            self.command.encode(), self._key().encode(),
            (self.headers.get("X-Exclude-Prefix") or "").encode(),
            ts.encode(), mode.encode(), body)

    def _reply(self, status: int, body: bytes = b"", digest_path=None):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        skey = self.server.secret_key  # type: ignore[attr-defined]
        if skey and digest_path is not None:
            self.send_header(_secret.DIGEST_HEADER,
                             _secret.response_digest(skey, digest_path, body))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if not self._authorized(body):
            return self._reply(403)
        self.server.store.put(self._key(), body)  # type: ignore[attr-defined]
        self._reply(200)

    def _send(self, body: bytes, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj):
        self._send(json.dumps(obj).encode(), "application/json")

    def _do_metrics(self):
        """``GET /metrics``: this process's registry and every rank's pushed
        snapshot in one exposition. After a resize the ranks of an older
        elastic generation keep their last push in the store, so only the
        newest (epoch, generation) present is rendered."""
        from ..utils import metrics as metrics_mod

        worker = _pushed(self.server, metrics_mod.KV_SCOPE)

        def gen(snap):
            try:
                return (int(snap.get("elastic_epoch", 0)),
                        int(snap.get("elastic_gen", 0)))
            except (TypeError, ValueError):
                return (0, 0)

        if worker:
            newest = max(gen(s) for _, s in worker)
            worker = [(r, s) for r, s in worker if gen(s) == newest]
        stale = _stale_ranks(worker)
        snaps = [({}, metrics_mod.get_registry().snapshot())]
        snaps.extend(
            ({"rank": r, "stale": "1"} if r in stale else {"rank": r}, s)
            for r, s in worker)
        self._send(metrics_mod.render_snapshots(snaps).encode(),
                   "text/plain; version=0.0.4; charset=utf-8")

    def _do_clock(self):
        """``GET /clock``: this server's wall clock (utils/tracing.py probes
        it, NTP-style)."""
        self._send_json({"t": time.time()})

    def _do_timeline(self):
        """``GET /timeline``: the ranks' pushed span buffers (and this
        process's tracer) merged into one clock-aligned Chrome trace, with
        the anatomy's lanes and critical-path summary."""
        from ..utils import anatomy as anatomy_mod
        from ..utils import tracing as tracing_mod

        def merged(scope, local):
            bufs = [] if local is None else [local.snapshot()]
            for _, buf in _pushed(self.server, scope):
                # this process's own view is the fresher one
                if local is None or buf.get("rank") != local.rank:
                    bufs.append(buf)
            return bufs

        anatomy = merged(anatomy_mod.KV_SCOPE, anatomy_mod.get_profiler())
        self._send_json(tracing_mod.merge_chrome_trace(
            merged(tracing_mod.KV_SCOPE, tracing_mod.get_tracer()),
            anatomy=anatomy or None))

    def _do_perf(self):
        """``GET /perf``: the ranks' perf-ledger snapshots by rank."""
        from ..utils import perfledger as perfledger_mod

        local = perfledger_mod.get_ledger()
        self._send_json({"ranks": _merged_snapshots(
            self.server, perfledger_mod.KV_SCOPE,
            (local.rank, local.snapshot) if local is not None else None)})

    def _do_anatomy(self):
        """``GET /anatomy``: the ranks' anatomy snapshots by rank."""
        from ..utils import anatomy as anatomy_mod

        local = anatomy_mod.get_profiler()
        self._send_json({"ranks": _merged_snapshots(
            self.server, anatomy_mod.KV_SCOPE,
            (local.rank, local.snapshot) if local is not None else None)})

    def _do_memory(self):
        """``GET /memory``: the ranks' memory-ledger snapshots by rank."""
        from ..utils import memledger as memledger_mod

        local = memledger_mod.get_ledger()
        self._send_json({"ranks": _merged_snapshots(
            self.server, memledger_mod.KV_SCOPE,
            (local.rank, local.snapshot) if local is not None else None)})

    def _do_checkpoint(self):
        """``GET /checkpoint``: the ranks' checkpointer statuses by rank,
        and the newest consistent manifest when the checkpoint directory
        is visible from this host."""
        from ..common import env as env_schema
        from ..utils import async_ckpt as async_ckpt_mod

        local = async_ckpt_mod.get_checkpointer()
        ranks = _merged_snapshots(
            self.server, async_ckpt_mod.KV_SCOPE,
            (local.rank, local.snapshot_status)
            if local is not None else None)
        manifest = None
        ckpt_dir = (env_schema.get_str(env_schema.HOROVOD_ASYNC_CKPT_DIR)
                    or (local.directory if local is not None else ""))
        if ckpt_dir:
            m = async_ckpt_mod.read_manifest(ckpt_dir)
            if m is not None:
                manifest = {k: v for k, v in m.items() if k != "ranks"}
        self._send_json({"ranks": ranks, "manifest": manifest})

    def _do_debug(self):
        """``GET /debug``: the ranks' diagnostic bundles (``diag/``)
        merged into one attribution that names the wedged rank — the
        endpoint to read when the job is too wedged to sign anything."""
        from ..utils import diag as diag_mod

        bundles = {}
        for rank, b in _pushed(self.server, diag_mod.KV_SCOPE):
            try:
                bundles[int(rank)] = b
            except ValueError:
                continue
        self._send_json(diag_mod.merge_bundles(bundles))

    def _health_ranks(self) -> dict:
        from ..utils import health as health_mod

        local = health_mod.get_engine()
        return _merged_snapshots(
            self.server, health_mod.KV_SCOPE,
            (local.rank, local.snapshot) if local is not None else None)

    def _do_history(self, query: str = ""):
        """``GET /history``: the health engines' series by rank (raw and
        downsampled), their anomalies and baselines; ``?series=a,b``
        keeps those series and ``since=<unix time>`` drops older
        points."""
        from urllib.parse import parse_qs

        params = parse_qs(query)
        wanted = {s for v in params.get("series", [])
                  for s in v.split(",") if s}
        try:
            since = float(params.get("since", ["0"])[-1])
        except ValueError:
            since = 0.0
        ranks = self._health_ranks()
        if wanted or since > 0:
            for snap in ranks.values():
                series = snap.get("series")
                if not isinstance(series, dict):
                    continue
                out = {}
                for name, body in series.items():
                    if wanted and name not in wanted:
                        continue
                    if since > 0 and isinstance(body, dict):
                        body = dict(body)
                        for tier in ("samples", "downsampled"):
                            pts = body.get(tier)
                            if isinstance(pts, list):
                                body[tier] = [
                                    p for p in pts
                                    if isinstance(p, (list, tuple))
                                    and len(p) == 2 and p[0] >= since]
                    out[name] = body
                snap["series"] = out
        self._send_json({"ranks": ranks})

    def _do_health(self, query: str = ""):
        """``GET /health``: one verdict for the fleet (healthy, degraded,
        critical), the suspects ranked, the anomalies by rank."""
        from ..utils import health as health_mod

        self._send_json(health_mod.fleet_view(self._health_ranks()))

    def _do_shards(self):
        """``GET /shards``: the shard listeners' ports, in the order a
        client's ``crc32(scope) % len`` indexes; empty unsharded."""
        self._send_json({"shards": list(self.server.shard_ports)})

    _TELEMETRY = {"metrics": _do_metrics, "clock": _do_clock,
                  "timeline": _do_timeline, "perf": _do_perf,
                  "anatomy": _do_anatomy, "memory": _do_memory,
                  "checkpoint": _do_checkpoint, "debug": _do_debug,
                  "shards": _do_shards}
    # the endpoints that take a query string
    _QUERIED = {"history": _do_history, "health": _do_health}

    def do_GET(self):
        key = self._key()
        endpoint = self._TELEMETRY.get(key)
        if endpoint is not None:
            return endpoint(self)
        base, _, query = key.partition("?")
        endpoint = self._QUERIED.get(base)
        if endpoint is not None:
            return endpoint(self, query)
        if not self._authorized():
            return self._reply(403)
        key = self._key()
        store = self.server.store  # type: ignore[attr-defined]
        deadline = time.monotonic() + float(
            self.headers.get("X-Timeout", "30"))
        if self.headers.get("X-Prefix-Read"):
            # bulk read: every key under the prefix once X-Min-Count exist,
            # or whatever is there at the deadline (stall attribution)
            min_count = int(self.headers.get("X-Min-Count", "1"))
            matches = store.wait_prefix(key, min_count, deadline)
            body = json.dumps(
                {k[len(key):]: base64.b64encode(v).decode()
                 for k, v in matches.items()}).encode()
            return self._reply(200, body, digest_path=key)
        body = store.wait_key(key, deadline)
        if body is None:
            return self._reply(404)
        self._reply(200, body, digest_path=key)

    def do_DELETE(self):
        if not self._authorized():
            return self._reply(403)
        # a prefix sweep spans the shards (a GC of ``ctl/`` must reach
        # every store, wherever its scopes hashed); it is idempotent
        prefix, exclude = self._key(), self.headers.get("X-Exclude-Prefix")
        for st in self.server.all_stores:  # type: ignore[attr-defined]
            st.delete_prefix(prefix, exclude)
        self._reply(200)


class _Store:
    """The key-value table with targeted wakeups: a blocking reader parks
    on its exact key or on its prefix, and a PUT wakes only the readers it
    can satisfy. The events are hints: a woken reader re-checks the data
    under the lock."""

    def __init__(self, waiter_gauge=None):
        self.lock = threading.Lock()
        self.data: dict[str, bytes] = {}  # guarded-by: lock
        # key -> [Event, ...] parked exact-key readers
        self._key_waiters: dict[str, list] = {}  # guarded-by: lock
        # [prefix, still_missing_count, Event] parked prefix readers
        self._prefix_waiters: list = []  # guarded-by: lock
        # the hvd_kv_waiters gauge, made only for a sharded or
        # hierarchical job (None: no series)
        self._m_waiters = waiter_gauge

    def put(self, key: str, value: bytes) -> None:
        fire = []
        with self.lock:
            fresh = key not in self.data
            self.data[key] = value
            fire.extend(self._key_waiters.pop(key, ()))
            if fresh:
                for w in self._prefix_waiters:
                    if key.startswith(w[0]):
                        w[1] -= 1
                        if w[1] <= 0:
                            fire.append(w[2])
        for ev in fire:
            ev.set()

    def wait_key(self, key: str, deadline: float) -> Optional[bytes]:
        """Value of ``key``, blocking until it exists or ``deadline``
        (time.monotonic) passes — then None (the handler's 404)."""
        with self.lock:
            v = self.data.get(key)
            if v is not None:
                return v
            ev = threading.Event()
            self._key_waiters.setdefault(key, []).append(ev)
        g = self._m_waiters
        if g is not None:
            g.inc()
        try:
            while True:
                remaining = deadline - time.monotonic()
                fired = remaining > 0 and ev.wait(remaining)
                with self.lock:
                    v = self.data.get(key)
                    if v is not None or not fired:
                        lst = self._key_waiters.get(key)
                        if lst is not None:
                            if ev in lst:
                                lst.remove(ev)
                            if not lst:
                                del self._key_waiters[key]
                        return v
                    # woken but the key vanished again (racing DELETE)
                    ev.clear()
                    self._key_waiters.setdefault(key, []).append(ev)
        finally:
            if g is not None:
                g.dec()

    def wait_prefix(self, prefix: str, min_count: int,
                    deadline: float) -> dict:
        """Every key under ``prefix`` once at least ``min_count`` exist,
        or whatever is present at ``deadline``."""
        while True:
            with self.lock:
                matches = {k: v for k, v in self.data.items()
                           if k.startswith(prefix)}
                remaining = deadline - time.monotonic()
                if len(matches) >= min_count or remaining <= 0:
                    return matches
                ev = threading.Event()
                w = [prefix, min_count - len(matches), ev]
                self._prefix_waiters.append(w)
            g = self._m_waiters
            if g is not None:
                g.inc()
            try:
                ev.wait(remaining)
            finally:
                if g is not None:
                    g.dec()
                with self.lock:
                    if w in self._prefix_waiters:
                        self._prefix_waiters.remove(w)

    def delete_prefix(self, prefix: str,
                      exclude: Optional[str] = None) -> None:
        with self.lock:
            for k in [k for k in self.data if k.startswith(prefix)]:
                if exclude and k.startswith(exclude):
                    continue  # live namespace: a GC sweep must not race it
                del self.data[k]


# -- the binary shard protocol (JAX :647-720) ---------------------------------
#
# A shard's listener speaks a length-prefixed framing instead of HTTP, an
# order of magnitude less Python an exchange. The HMAC material is the HTTP
# path's: a request signs (verb, path, exclude, ts, mode, body), a read's
# response signs (path, payload).
#
#   request  := 0x4B verb:u8 len:u32 body
#   body     := path:str16 ts:str16 digest:str16 exclude:str16
#               timeout:f64 min_count:u32 value:bytes
#   response := status:u8 len:u32 payload digest:str16
#   status   := 0 ok | 1 not found (the blocking GET's 404) | 3 forbidden
#
# PUTGET stores ``path`` = ``value``, then blocks on the key named by the
# ``exclude`` field (both are under the request's digest) until it exists
# or ``timeout`` passes: one exchange for a member's submit and wait.

BIN_MAGIC = 0x4B  # "K"
_BV_PUT, _BV_GET, _BV_PREFIX, _BV_DELETE, _BV_PUTGET = 1, 2, 3, 4, 5
_BIN_VERB_NAMES = {_BV_PUT: "BINPUT", _BV_GET: "BINGET",
                   _BV_PREFIX: "BINPREFIX", _BV_DELETE: "BINDELETE",
                   _BV_PUTGET: "BINPUTGET"}
_BIN_MAX_FRAME = 64 << 20


def _recv_exact(sock, n: int) -> bytes:
    parts = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionResetError("KV shard peer closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def _pack_str16(s: bytes) -> bytes:
    return struct.pack("<H", len(s)) + s


def shard_index(scope: str, n: int) -> int:
    """The shard of ``scope`` among ``n``: ``crc32``, never ``hash()``,
    which is salted a process, while every client must agree."""
    return zlib.crc32(scope.encode()) % n


class _ShardListener(threading.Thread):
    """One binary listener socket over one shard's store, a thread a
    connection (a client keeps one persistent socket a thread); a blocking
    read parks on the store's waiters as the HTTP handler's does."""

    def __init__(self, store: _Store, secret_key: Optional[str]):
        super().__init__(daemon=True, name="hvd-kv-shard")
        self._store = store
        self._secret_key = secret_key
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(1024)
        self.port = self._sock.getsockname()[1]
        self._stopped = False

    def run(self):
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed by stop()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="hvd-kv-shard-conn").start()

    def stop(self):
        self._stopped = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _serve_conn(self, conn):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                hdr = _recv_exact(conn, 6)
                verb = hdr[1]
                (blen,) = struct.unpack_from("<I", hdr, 2)
                if hdr[0] != BIN_MAGIC or blen > _BIN_MAX_FRAME:
                    return  # not the protocol: drop the connection
                status, payload, path = self._handle(
                    verb, _recv_exact(conn, blen))
                dig = b""
                if (self._secret_key and status == 0
                        and verb in (_BV_GET, _BV_PREFIX, _BV_PUTGET)):
                    dig = _secret.response_digest(
                        self._secret_key, path, payload).encode()
                conn.sendall(struct.pack("<BI", status, len(payload))
                             + payload + _pack_str16(dig))
        except (OSError, struct.error):
            pass  # the peer closed, or teardown
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, verb: int, body: bytes):
        pos = 0

        def s16():
            nonlocal pos
            (n,) = struct.unpack_from("<H", body, pos)
            pos += 2 + n
            return body[pos - n:pos]

        path_b, ts, dig, excl = s16(), s16(), s16(), s16()
        timeout, min_count = struct.unpack_from("<dI", body, pos)
        pos += 12
        value = body[pos:]
        path = path_b.decode("utf-8", "replace")
        if not self._authorized(verb, path, value, excl, ts, min_count,
                                dig):
            return 3, b"", path
        store = self._store
        if verb == _BV_PUT:
            store.put(path, value)
            return 0, b"", path
        if verb == _BV_GET:
            v = store.wait_key(path, time.monotonic() + timeout)
            return (1, b"", path) if v is None else (0, v, path)
        if verb == _BV_PUTGET:
            # both keys are of one scope, so of this shard; the response's
            # digest binds the payload to the request's path, as a GET's
            store.put(path, value)
            v = store.wait_key(excl.decode("utf-8", "replace"),
                               time.monotonic() + timeout)
            return (1, b"", path) if v is None else (0, v, path)
        if verb == _BV_PREFIX:
            matches = store.wait_prefix(path, max(1, min_count),
                                        time.monotonic() + timeout)
            out = bytearray()
            for k in sorted(matches):
                out += _pack_str16(k[len(path):].encode())
                v = matches[k]
                out += struct.pack("<I", len(v)) + v
            return 0, bytes(out), path
        if verb == _BV_DELETE:
            store.delete_prefix(path, excl.decode("utf-8", "replace")
                                or None)
            return 0, b"", path
        return 3, b"", path  # an unknown verb

    def _authorized(self, verb, path, value, excl, ts, min_count,
                    dig) -> bool:
        key = self._secret_key
        if not key:
            return True
        ts_s = ts.decode("ascii", "replace")
        try:
            skew = abs(time.time() - float(ts_s))
        except ValueError:
            return False
        if skew > _secret.MAX_SKEW_SECONDS:
            return False  # stale (or far-future) signed request: replay
        want = _secret.request_digest(
            key, _BIN_VERB_NAMES.get(verb, "?"), path, value,
            excl.decode("utf-8", "replace"), ts=ts_s,
            mode=f"bin:{min_count}")
        return hmac.compare_digest(want.encode(), dig)


class _KVServer(ThreadingHTTPServer):
    # every rank of a negotiation round connects at once: a deep listen
    # backlog keeps accept cheap
    request_queue_size = 1024
    daemon_threads = True

    def scan_prefix(self, prefix: str) -> dict:
        """Every key under ``prefix`` and its value, from every shard (the
        telemetry endpoints' read)."""
        out: dict = {}
        for st in self.all_stores:
            with st.lock:
                out.update((k, v) for k, v in st.data.items()
                           if k.startswith(prefix))
        return out

    def handle_error(self, request, client_address):
        import sys

        if isinstance(sys.exc_info()[1], (ConnectionResetError,
                                          BrokenPipeError, TimeoutError)):
            return  # peer closed its keep-alive connection (job teardown)
        super().handle_error(request, client_address)


def _kv_instrumented(shards: int) -> bool:
    """Whether the KV layer's series exist: a sharded or a hierarchical
    job (JAX's rule: a flat, unsharded job registers none)."""
    from ..common import env as env_schema

    return shards > 1 or env_schema.get_bool(
        env_schema.HOROVOD_HIER_NEGOTIATION)


class RendezvousServer:
    """Blocking-GET KV store over HTTP. ``secret_key=None`` takes the job
    secret from ``HOROVOD_SECRET_KEY``; without one the store is open.

    ``shards`` (default ``HOROVOD_KV_SHARDS``, 1) splits the keyspace over
    that many stores, each behind a binary listener (shard 0 too, so a
    scope that hashes there is not served by the slow HTTP path); with 1
    the server is the HTTP server alone and no listener exists."""

    def __init__(self, port: int = 0, secret_key: Optional[str] = None,
                 shards: Optional[int] = None):
        from ..common import env as env_schema

        if shards is None:
            shards = env_schema.get_int(env_schema.HOROVOD_KV_SHARDS, 1)
        shards = max(1, int(shards))
        key = (secret_key if secret_key is not None
               else _secret.env_secret())
        gauge = None
        if _kv_instrumented(shards):
            from ..utils import metrics as metrics_mod

            gauge = metrics_mod.get_registry().gauge(
                "hvd_kv_waiters",
                "KV requests currently parked on a blocking read")
        self._stores = [_Store(gauge) for _ in range(shards)]
        self._server = _KVServer(("0.0.0.0", port), _KVHandler)
        self._server.store = self._stores[0]  # type: ignore[attr-defined]
        self._server.all_stores = self._stores  # type: ignore[attr-defined]
        self._server.secret_key = key  # type: ignore[attr-defined]
        self._listeners = ([_ShardListener(st, key) for st in self._stores]
                           if shards > 1 else [])
        self._server.shard_ports = [  # type: ignore[attr-defined]
            ln.port for ln in self._listeners]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def shard_ports(self) -> list:
        return [ln.port for ln in self._listeners]

    def start(self) -> int:
        for ln in self._listeners:
            ln.start()
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="hvd-rendezvous")
        self._thread.start()
        return self.port

    def stop(self):
        for ln in self._listeners:
            ln.stop()
        if self._thread:  # shutdown() waits for a serve_forever that runs
            self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


class KVStoreClient:
    """Client of ``RendezvousServer``: signs requests and checks read
    responses when a job secret is available (the server's rule). Each
    thread keeps one persistent connection; a stale socket is retried once
    on a fresh one (idempotent verbs only: every KV operation is
    last-write-wins).

    With ``HOROVOD_KV_SHARDS`` > 1 the client reads the server's shard
    table (``GET /shards``) at its first request and routes each scope to
    its shard's binary listener; a server with no shards returns an empty
    table, and the client stays on HTTP. In a sharded or hierarchical job
    it times its requests (``hvd_kv_request_seconds{verb}``) and counts
    its redials (``hvd_kv_reconnects_total``)."""

    IDEMPOTENT_VERBS = frozenset({"GET", "PUT", "DELETE"})

    def __init__(self, addr: str, port: int,
                 secret_key: Optional[str] = None):
        from ..common import env as env_schema

        self.addr = addr
        self.port = port
        self.base = f"http://{addr}:{port}"
        self._secret = (secret_key if secret_key is not None
                        else _secret.env_secret())
        self._local = threading.local()
        # the knob opts in; the server's table decides
        self._want_shards = env_schema.get_int(
            env_schema.HOROVOD_KV_SHARDS, 1)
        self._shard_ports: Optional[list] = None
        self._instrument = _kv_instrumented(self._want_shards)
        self._m_lat: dict = {}
        self._m_reconnects = None

    def _observe(self, verb: str, t0: float):
        if not self._instrument:
            return
        h = self._m_lat.get(verb)
        if h is None:
            from ..utils import metrics as metrics_mod

            h = self._m_lat[verb] = metrics_mod.get_registry().histogram(
                "hvd_kv_request_seconds",
                "KV client request latency by verb "
                "(retries and reconnects included)", verb=verb)
        h.observe(time.monotonic() - t0)

    def _note_reconnect(self):
        if not self._instrument:
            return
        m = self._m_reconnects
        if m is None:
            from ..utils import metrics as metrics_mod

            m = self._m_reconnects = metrics_mod.get_registry().counter(
                "hvd_kv_reconnects_total",
                "KV client connections dropped mid-exchange and redialed")
        m.inc()

    # -- routing ------------------------------------------------------------

    def shard_ports(self) -> list:
        """The server's shard table (empty: unsharded), read once."""
        ports = self._shard_ports
        if ports is None:
            ports = self._shard_ports = self._fetch_shards()
        return ports

    def _shard_port(self, scope: str) -> Optional[int]:
        """The port of ``scope``'s shard, or None for the HTTP server."""
        if self._want_shards <= 1:
            return None
        ports = self.shard_ports()
        if not ports:
            return None
        return ports[shard_index(scope, len(ports))]

    def _fetch_shards(self) -> list:
        def attempt():
            status, _, body = self._attempt("GET", "shards", None, {}, 10.0)
            if status != 200:
                raise HTTPError(f"{self.base}/shards", status,
                                "shard table", None, None)
            return list(json.loads(body).get("shards", []))

        policy = _retry.RetryPolicy.from_env(max_attempts=3,
                                             base_delay_s=0.05,
                                             max_delay_s=1.0)
        return _retry.Retrier("kv.get", policy).call(attempt)

    # -- the binary shard path ----------------------------------------------

    def _bin_conn(self, port: int):
        conns = getattr(self._local, "bins", None)
        if conns is None:
            conns = self._local.bins = {}
        sock = conns.get(port)
        if sock is None:
            sock = socket.create_connection((self.addr, port), timeout=10.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conns[port] = sock
        return sock

    def _bin_attempt(self, port: int, verb: int, path: str, value: bytes,
                     excl: str, timeout: float, min_count: int):
        sock = self._bin_conn(port)
        try:
            ts = f"{time.time():.6f}" if self._secret else ""
            dig = b""
            if self._secret:
                dig = _secret.request_digest(
                    self._secret, _BIN_VERB_NAMES[verb], path, value,
                    excl, ts=ts, mode=f"bin:{min_count}").encode()
            body = (_pack_str16(path.encode()) + _pack_str16(ts.encode())
                    + _pack_str16(dig) + _pack_str16(excl.encode())
                    + struct.pack("<dI", float(timeout), int(min_count))
                    + value)
            sock.settimeout(timeout + 10.0)
            sock.sendall(struct.pack("<BBI", BIN_MAGIC, verb, len(body))
                         + body)
            hdr = _recv_exact(sock, 5)
            (n,) = struct.unpack_from("<I", hdr, 1)
            payload = _recv_exact(sock, n)
            (dn,) = struct.unpack_from("<H", _recv_exact(sock, 2), 0)
            rdig = (_recv_exact(sock, dn).decode("ascii", "replace")
                    if dn else "")
            return hdr[0], payload, rdig
        except OSError:
            # a stale shard socket: drop it so a retry dials fresh
            try:
                sock.close()
            except OSError:
                pass
            getattr(self._local, "bins", {}).pop(port, None)
            self._note_reconnect()
            raise

    def _bin_request(self, port: int, verb: int, path: str,
                     value: bytes = b"", excl: str = "",
                     timeout: float = 30.0, min_count: int = 0,
                     site: str = "") -> bytes:
        policy = _retry.RetryPolicy.from_env(max_attempts=2,
                                             base_delay_s=0.05,
                                             max_delay_s=1.0)

        def attempt():
            _faults.fault_point(site)
            return self._bin_attempt(port, verb, path, value, excl,
                                     timeout, min_count)

        status, payload, rdig = _retry.Retrier(site, policy).call(attempt)
        what = f"{_BIN_VERB_NAMES[verb]} {path}"
        if status == 3:
            raise KVAuthError(
                f"KV shard refused {what}: HMAC digest rejected — either "
                "the secret key differs or this host's clock is outside "
                "the replay window")
        if status == 1:
            # the HTTP blocking GET's deadline: callers tell it by the 404
            raise HTTPError(f"{self.base}/{path}", 404, what, None, None)
        if status != 0:
            raise HTTPError(f"{self.base}/{path}", 500, what, None, None)
        if (self._secret and verb in (_BV_GET, _BV_PREFIX, _BV_PUTGET)
                and not _secret.check_digest(
                    self._secret, rdig, b"RESP", path.encode(), payload)):
            raise KVAuthError(
                f"{what}: response digest missing or invalid — the value "
                "was tampered with in transit or the shard does not hold "
                "the job secret")
        return payload

    # -- the HTTP path ------------------------------------------------------

    def _attempt(self, method: str, path: str, body: Optional[bytes],
                 headers: dict, timeout: float):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.addr, self.port,
                                              timeout=timeout)
            try:
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            except OSError:
                pass  # connect() is retried by conn.request below
            self._local.conn = conn
        try:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            conn.request(method, "/" + path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.headers, resp.read()
        except (OSError, http.client.HTTPException):
            # stale keep-alive socket: drop it so a retry dials fresh
            conn.close()
            self._local.conn = None
            self._note_reconnect()
            raise

    def _request(self, method: str, path: str, body: Optional[bytes],
                 headers: dict, timeout: float, site: str = ""):
        policy = (_retry.RetryPolicy.from_env(max_attempts=2,
                                              base_delay_s=0.05,
                                              max_delay_s=1.0)
                  if method in self.IDEMPOTENT_VERBS
                  else _retry.RetryPolicy(max_attempts=1))
        site = site or f"kv.{method.lower()}"

        def attempt():
            _faults.fault_point(site)
            return self._attempt(method, path, body, headers, timeout)

        return _retry.Retrier(site, policy).call(attempt)

    def _headers(self, method: str, path: str, body: bytes = b"",
                 exclude: str = "", mode: str = "") -> dict:
        if not self._secret:
            return {}
        ts = f"{time.time():.6f}"
        return {
            _secret.TS_HEADER: ts,
            _secret.DIGEST_HEADER: _secret.request_digest(
                self._secret, method, path, body, exclude, ts=ts,
                mode=mode),
        }

    def _check_status(self, status: int, path: str, what: str):
        if status == 200:
            return
        if status == 403:
            raise KVAuthError(
                f"KV store refused {what}: HMAC digest rejected — either "
                "the secret key differs (is HOROVOD_SECRET_KEY consistent "
                "across the job?) or this host's clock is more than "
                f"{_secret.MAX_SKEW_SECONDS:.0f}s off the store's")
        # HTTPError for the rest: callers tell the blocking-GET timeout
        # (404) by its code
        raise HTTPError(f"{self.base}/{path}", status, what, None, None)

    def _check_response(self, rhdrs, path: str, body: bytes, what: str):
        if self._secret and not _secret.check_digest(
                self._secret, rhdrs.get(_secret.DIGEST_HEADER),
                b"RESP", path.encode(), body):
            raise KVAuthError(
                f"{what}: response digest missing or invalid — the value "
                "was tampered with in transit or the store does not hold "
                "the job secret")

    # -- the verbs ----------------------------------------------------------

    def put(self, scope: str, key: str, value: bytes):
        t0 = time.monotonic()
        try:
            path = f"{scope}/{key}"
            # a torn value is stored "successfully", as a writer that
            # crashed mid-value would leave it for the readers
            value = _faults.corrupt("kv.put", value)
            port = self._shard_port(scope)
            if port is not None:
                self._bin_request(port, _BV_PUT, path, value=value,
                                  site="kv.put")
                return
            status, _, _ = self._request(
                "PUT", path, value, self._headers("PUT", path, value), 30.0)
            self._check_status(status, path, f"PUT {path}")
        finally:
            self._observe("put", t0)

    def get(self, scope: str, key: str, timeout: float = 30.0) -> bytes:
        t0 = time.monotonic()
        try:
            path = f"{scope}/{key}"
            port = self._shard_port(scope)
            if port is not None:
                return self._bin_request(port, _BV_GET, path,
                                         timeout=timeout, site="kv.get")
            headers = {"X-Timeout": str(timeout)}
            headers.update(self._headers("GET", path))
            status, rhdrs, body = self._request("GET", path, None, headers,
                                                timeout + 10)
            self._check_status(status, path, f"GET {path}")
            self._check_response(rhdrs, path, body, f"GET {path}")
            return body
        finally:
            self._observe("get", t0)

    def put_get(self, scope: str, put_key: str, value: bytes,
                get_key: str, timeout: float = 30.0) -> bytes:
        """Store ``scope/put_key``, then block on ``scope/get_key`` (or
        raise the blocking GET's 404 at the deadline): one ``PUTGET``
        exchange on a shard, a PUT and a GET over HTTP."""
        port = self._shard_port(scope)
        if port is None:
            self.put(scope, put_key, value)
            return self.get(scope, get_key, timeout=timeout)
        t0 = time.monotonic()
        try:
            value = _faults.corrupt("kv.put", value)
            return self._bin_request(
                port, _BV_PUTGET, f"{scope}/{put_key}", value=value,
                excl=f"{scope}/{get_key}", timeout=timeout, site="kv.get")
        finally:
            self._observe("put_get", t0)

    def get_prefix(self, scope: str, prefix: str = "", min_count: int = 1,
                   timeout: float = 30.0) -> dict:
        """Every key under ``scope/prefix`` in one request, blocking on the
        server until ``min_count`` keys exist or the timeout passes
        (partial results return then). Returns {key_suffix: bytes}."""
        t0 = time.monotonic()
        try:
            path = f"{scope}/{prefix}"
            port = self._shard_port(scope)
            if port is not None:
                payload = self._bin_request(
                    port, _BV_PREFIX, path, timeout=timeout,
                    min_count=min_count, site="kv.wait")
                out, pos = {}, 0
                while pos < len(payload):
                    (kl,) = struct.unpack_from("<H", payload, pos)
                    pos += 2
                    k = payload[pos:pos + kl].decode("utf-8", "replace")
                    pos += kl
                    (vl,) = struct.unpack_from("<I", payload, pos)
                    pos += 4
                    out[k] = payload[pos:pos + vl]
                    pos += vl
                return out
            mode = f"prefix:{min_count}"
            headers = {"X-Prefix-Read": "1", "X-Min-Count": str(min_count),
                       "X-Timeout": str(timeout)}
            headers.update(self._headers("GET", path, mode=mode))
            status, rhdrs, body = self._request("GET", path, None, headers,
                                                timeout + 10,
                                                site="kv.wait")
            self._check_status(status, path, f"GET(prefix) {path}")
            self._check_response(rhdrs, path, body, f"GET(prefix) {path}")
            return {k: base64.b64decode(v)
                    for k, v in json.loads(body).items()}
        finally:
            self._observe("wait", t0)

    def delete_scope(self, scope: str):
        t0 = time.monotonic()
        try:
            path = f"{scope}/"
            port = self._shard_port(scope)
            if port is not None:
                # a scope's keys are all on one shard
                self._bin_request(port, _BV_DELETE, path, site="kv.delete")
                return
            status, _, _ = self._request(
                "DELETE", path, None, self._headers("DELETE", path), 30.0)
            self._check_status(status, path, f"DELETE {path}")
        finally:
            self._observe("delete", t0)

    def delete_prefix(self, prefix: str, exclude: Optional[str] = None):
        """Delete every key under ``prefix`` except those under
        ``exclude``; a bare prefix spans scopes, so a sharded client sweeps
        every shard."""
        t0 = time.monotonic()
        try:
            if self._want_shards > 1:
                ports = self.shard_ports()
                if ports:
                    for port in ports:
                        self._bin_request(port, _BV_DELETE, prefix,
                                          excl=exclude or "",
                                          site="kv.delete")
                    return
            headers = self._headers("DELETE", prefix, exclude=exclude or "")
            if exclude:
                headers["X-Exclude-Prefix"] = exclude
            status, _, _ = self._request("DELETE", prefix, None, headers,
                                         30.0)
            self._check_status(status, prefix, f"DELETE {prefix}")
        finally:
            self._observe("delete", t0)
