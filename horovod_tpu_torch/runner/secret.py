"""Control-plane message authentication.

Reference: Horovod's runner/common/util/secret.py (the
launcher mints a random key per job) and network.py:60-100 (every
driver/task message carries an HMAC digest the receiver verifies, and
responses are signed back). There the wire is pickled TCP messages; here
the control plane is the HTTP KV store, so the digest rides an
``X-HVD-Digest`` header computed over the request's semantic content
(method, path, mutating headers, signed timestamp, body) and, on reads,
over the response body — a rogue process that can reach the store's
port can neither poison a negotiation round nor impersonate the store
without the launcher-injected key. Against an attacker who can also
*sniff* the wire, the signed ``X-HVD-TS`` timestamp bounds replay of a
captured request to MAX_SKEW_SECONDS (full replay immunity would need a
per-request server nonce round-trip, judged not worth doubling every KV
exchange for a control plane that normally rides a private cluster
network).

The key travels to workers the same way the reference delivers it: as
per-slot environment (``HOROVOD_SECRET_KEY``, reference
gloo_run.py:65-style injection), so it never appears on a command line.
"""

from __future__ import annotations

import hmac
import os
import secrets as _secrets

from ..common import env as env_schema

DIGEST_HEADER = "X-HVD-Digest"
TS_HEADER = "X-HVD-TS"

# Requests older (or newer) than this are refused even with a valid
# digest: it bounds the replay window for an attacker who can *sniff*
# the wire, not just connect (a captured delete sweep or PUT can only
# be replayed for this long). NTP-synced cluster hosts sit well inside
# it.
MAX_SKEW_SECONDS = 300.0


def make_secret_key() -> str:
    """A fresh per-job key (reference secret.py make_secret_key)."""
    return _secrets.token_hex(32)


def get_or_mint_env_secret() -> str:
    """The launcher's entry point: reuse an operator-provided key or mint
    one, publishing it in this process's env so per-slot env snapshots
    (and re-execs of the elastic launcher) inherit it."""
    key = os.environ.get(env_schema.HOROVOD_SECRET_KEY)
    if not key:
        key = make_secret_key()
        os.environ[env_schema.HOROVOD_SECRET_KEY] = key
    return key


def env_secret() -> str | None:
    return os.environ.get(env_schema.HOROVOD_SECRET_KEY) or None


def compute_digest(key: str, *parts: bytes) -> str:
    """HMAC-SHA256 over length-prefixed parts.

    Length prefixes make the digest injective in its parts — without
    them ``("a", "bc")`` and ``("ab", "c")`` would collide, letting an
    attacker move bytes between path and body of a captured request."""
    mac = hmac.new(key.encode(), digestmod="sha256")
    for p in parts:
        mac.update(len(p).to_bytes(8, "big"))
        mac.update(p)
    return mac.hexdigest()


def check_digest(key: str, digest: str | None, *parts: bytes) -> bool:
    if not digest:
        return False
    return hmac.compare_digest(compute_digest(key, *parts), digest)


def request_digest(key: str, method: str, path: str, body: bytes = b"",
                   exclude: str = "", ts: str = "", mode: str = "") -> str:
    """Digest for a KV request. ``exclude`` is the DELETE sweep's
    X-Exclude-Prefix header and ``mode`` the GET prefix-read marker
    (``prefix:<min_count>``) — they change what the request does, so
    they are part of the signed material. ``ts`` is the sender's clock
    (X-HVD-TS): signing it gives requests freshness, so a sniffed
    request replays for at most MAX_SKEW_SECONDS (the reference's
    pickled-TCP HMAC scheme has no freshness at all)."""
    return compute_digest(key, method.encode(), path.encode(),
                          exclude.encode(), ts.encode(), mode.encode(),
                          body)


def response_digest(key: str, path: str, body: bytes) -> str:
    """Digest for a GET response: bound to the path so a signed value
    for one key cannot be replayed as the value of another."""
    return compute_digest(key, b"RESP", path.encode(), body)
