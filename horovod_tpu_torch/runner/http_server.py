"""The rendezvous key-value store over HTTP — the KV subset of
``horovod_tpu/runner/http_server.py`` (``_Store`` :569, the KV verbs of
``_KVHandler`` :122-168 and :528-566, ``_KVServer`` :868,
``RendezvousServer`` :900, ``KVStoreClient`` :972).

The launcher starts one ``RendezvousServer``; workers reach it with
``KVStoreClient``, and the controller's negotiation rounds ride it
(``ops/controller.py``). Values are opaque bytes under ``scope/key``; a GET
blocks until its key exists. When a job secret is present
(``HOROVOD_SECRET_KEY``, minted by the launcher: ``runner/secret.py``),
every request carries an HMAC digest the store checks before acting (403
otherwise), and every GET response carries a digest the client checks.

The wire is the JAX package's, so either package's client talks to either
package's server. Left out: the ``/memory``, ``/checkpoint``, ``/history``,
``/health``, ``/debug`` and ``/shards`` endpoints, the binary KV shards and
``put_get``'s one-exchange shard verb (ROADMAP.md queue 1 items 16–17);
``put_get`` here is a PUT followed by a blocking GET, as the JAX client
does without shards.

The telemetry endpoints (JAX :217-338, :368-400), read-only and exempt
from the HMAC (a scraper cannot sign; a bare path has no slash, so it
never collides with a ``scope/key``):

- ``GET /metrics``: the Prometheus exposition of this process's registry
  and of every snapshot the ranks pushed under ``metrics/``, labelled
  ``rank="k"`` (only the newest elastic generation's; a rank whose push
  lags is labelled ``stale="1"``);
- ``GET /clock``: this server's wall clock, the tracer's common timebase;
- ``GET /timeline``: one clock-aligned Chrome trace of the ranks' pushed
  spans (pid = rank) with their anatomy lanes;
- ``GET /perf`` and ``GET /anatomy``: the ranks' pushed perf-ledger and
  anatomy snapshots by rank, each marked ``stale`` when its push lags the
  newest by more than ``STALE_INTERVALS`` intervals (``_merged_snapshots``).
"""

from __future__ import annotations

import base64
import http.client
import json
import socket
import threading
import time
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

    _TELEMETRY = {"metrics": _do_metrics, "clock": _do_clock,
                  "timeline": _do_timeline, "perf": _do_perf,
                  "anatomy": _do_anatomy}

    def do_GET(self):
        endpoint = self._TELEMETRY.get(self._key())
        if endpoint is not None:
            return endpoint(self)
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
        self.server.store.delete_prefix(  # type: ignore[attr-defined]
            self._key(), self.headers.get("X-Exclude-Prefix"))
        self._reply(200)


class _Store:
    """The key-value table with targeted wakeups: a blocking reader parks
    on its exact key or on its prefix, and a PUT wakes only the readers it
    can satisfy. The events are hints: a woken reader re-checks the data
    under the lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.data: dict[str, bytes] = {}  # guarded-by: lock
        # key -> [Event, ...] parked exact-key readers
        self._key_waiters: dict[str, list] = {}  # guarded-by: lock
        # [prefix, still_missing_count, Event] parked prefix readers
        self._prefix_waiters: list = []  # guarded-by: lock

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
            try:
                ev.wait(remaining)
            finally:
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


class _KVServer(ThreadingHTTPServer):
    # every rank of a negotiation round connects at once: a deep listen
    # backlog keeps accept cheap
    request_queue_size = 1024
    daemon_threads = True

    def scan_prefix(self, prefix: str) -> dict:
        """Every key under ``prefix`` and its value (the telemetry
        endpoints' read)."""
        st = self.store
        with st.lock:
            return {k: v for k, v in st.data.items() if k.startswith(prefix)}

    def handle_error(self, request, client_address):
        import sys

        if isinstance(sys.exc_info()[1], (ConnectionResetError,
                                          BrokenPipeError, TimeoutError)):
            return  # peer closed its keep-alive connection (job teardown)
        super().handle_error(request, client_address)


class RendezvousServer:
    """Blocking-GET KV store over HTTP. ``secret_key=None`` takes the job
    secret from ``HOROVOD_SECRET_KEY``; without one the store is open."""

    def __init__(self, port: int = 0, secret_key: Optional[str] = None):
        key = (secret_key if secret_key is not None
               else _secret.env_secret())
        self._server = _KVServer(("0.0.0.0", port), _KVHandler)
        self._server.store = _Store()  # type: ignore[attr-defined]
        self._server.secret_key = key  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="hvd-rendezvous")
        self._thread.start()
        return self.port

    def stop(self):
        if self._thread:  # shutdown() waits for a serve_forever that runs
            self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


class KVStoreClient:
    """Client of ``RendezvousServer``: signs requests and checks GET
    responses when a job secret is available (the server's rule). Each
    thread keeps one persistent connection; a stale socket is retried once
    on a fresh one (idempotent verbs only: every KV operation is
    last-write-wins)."""

    IDEMPOTENT_VERBS = frozenset({"GET", "PUT", "DELETE"})

    def __init__(self, addr: str, port: int,
                 secret_key: Optional[str] = None):
        self.addr = addr
        self.port = port
        self.base = f"http://{addr}:{port}"
        self._secret = (secret_key if secret_key is not None
                        else _secret.env_secret())
        self._local = threading.local()

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

    def put(self, scope: str, key: str, value: bytes):
        path = f"{scope}/{key}"
        # a torn value is stored "successfully", as a writer that crashed
        # mid-value would leave it for the readers
        value = _faults.corrupt("kv.put", value)
        status, _, _ = self._request(
            "PUT", path, value, self._headers("PUT", path, value), 30.0)
        self._check_status(status, path, f"PUT {path}")

    def get(self, scope: str, key: str, timeout: float = 30.0) -> bytes:
        path = f"{scope}/{key}"
        headers = {"X-Timeout": str(timeout)}
        headers.update(self._headers("GET", path))
        status, rhdrs, body = self._request("GET", path, None, headers,
                                            timeout + 10)
        self._check_status(status, path, f"GET {path}")
        self._check_response(rhdrs, path, body, f"GET {path}")
        return body

    def put_get(self, scope: str, put_key: str, value: bytes,
                get_key: str, timeout: float = 30.0) -> bytes:
        """Store ``scope/put_key``, then block on ``scope/get_key``."""
        self.put(scope, put_key, value)
        return self.get(scope, get_key, timeout=timeout)

    def get_prefix(self, scope: str, prefix: str = "", min_count: int = 1,
                   timeout: float = 30.0) -> dict:
        """Every key under ``scope/prefix`` in one request, blocking on the
        server until ``min_count`` keys exist or the timeout passes
        (partial results return then). Returns {key_suffix: bytes}."""
        path = f"{scope}/{prefix}"
        mode = f"prefix:{min_count}"
        headers = {"X-Prefix-Read": "1", "X-Min-Count": str(min_count),
                   "X-Timeout": str(timeout)}
        headers.update(self._headers("GET", path, mode=mode))
        status, rhdrs, body = self._request("GET", path, None, headers,
                                            timeout + 10, site="kv.wait")
        self._check_status(status, path, f"GET(prefix) {path}")
        self._check_response(rhdrs, path, body, f"GET(prefix) {path}")
        return {k: base64.b64decode(v) for k, v in json.loads(body).items()}

    def delete_scope(self, scope: str):
        self.delete_prefix(f"{scope}/")

    def delete_prefix(self, prefix: str, exclude: Optional[str] = None):
        """Delete every key under ``prefix`` except those under
        ``exclude``."""
        headers = self._headers("DELETE", prefix, exclude=exclude or "")
        if exclude:
            headers["X-Exclude-Prefix"] = exclude
        status, _, _ = self._request("DELETE", prefix, None, headers, 30.0)
        self._check_status(status, prefix, f"DELETE {prefix}")
