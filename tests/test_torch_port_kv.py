"""The port's rendezvous KV store against the JAX package's, both ways: the
JAX ``KVStoreClient`` on the port's ``RendezvousServer`` and the port's
client on the JAX server, with the job's HMAC secret, through put, get,
``put_get``, ``get_prefix`` and the deletes; a client holding the wrong
key is refused in every pairing, as is an unsigned or stale request.
Mirrors ``tests/test_secret.py``."""

import threading
import time
import urllib.error
import urllib.request

import pytest

from horovod_tpu.runner import http_server as jkv
from horovod_tpu.runner import secret as jsecret
from horovod_tpu_torch.runner import http_server as pkv
from horovod_tpu_torch.runner import secret as psecret

PAIRS = [(pkv, jkv), (jkv, pkv), (pkv, pkv)]
PAIR_IDS = ["port-server-jax-client", "jax-server-port-client", "port-both"]


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def store(request):
    server_mod, client_mod = request.param
    key = psecret.make_secret_key()
    srv = server_mod.RendezvousServer(secret_key=key)
    port = srv.start()
    yield server_mod, client_mod, key, port
    srv.stop()


def test_verbs_interoperate(store):
    _, client_mod, key, port = store
    cli = client_mod.KVStoreClient("127.0.0.1", port, secret_key=key)
    cli.put("s", "ready/0", b"a")
    cli.put("s", "ready/1", b"bb")
    cli.put("s", "other", b"zz")
    assert cli.get("s", "ready/1", timeout=2) == b"bb"
    cli.put("g", "resp", b"fan-down")
    assert cli.put_get("g", "ready/3", b"mine", "resp", timeout=2) == \
        b"fan-down"
    assert cli.get("g", "ready/3", timeout=2) == b"mine"
    assert cli.get_prefix("s", "ready/", min_count=2, timeout=5) == {
        "0": b"a", "1": b"bb"}

    # a prefix read blocks until its count is met
    res = {}

    def read3():
        res["got"] = cli.get_prefix("s", "ready/", min_count=3, timeout=10)

    t = threading.Thread(target=read3)
    t.start()
    time.sleep(0.2)
    cli.put("s", "ready/2", b"ccc")
    t.join(timeout=10)
    assert not t.is_alive() and set(res["got"]) == {"0", "1", "2"}
    # a blocking get past its deadline is the 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        cli.get("s", "missing", timeout=0.3)
    assert ei.value.code == 404

    cli.put("ctl/e0g0/r0", "ready/0", b"live")
    cli.put("ctl/e1g0/r0", "ready/0", b"dead")
    cli.delete_prefix("ctl/", exclude="ctl/e0g0/")
    assert cli.get("ctl/e0g0/r0", "ready/0", timeout=2) == b"live"
    assert cli.get_prefix("ctl/e1g0/r0", "", min_count=1, timeout=0.3) == {}
    cli.delete_scope("s")
    assert cli.get_prefix("s", "", min_count=1, timeout=0.3) == {}


def test_wrong_key_refused(store):
    _, client_mod, _, port = store
    wrong = client_mod.KVStoreClient("127.0.0.1", port,
                                     secret_key=psecret.make_secret_key())
    for call in (lambda: wrong.put("s", "k", b"v"),
                 lambda: wrong.get("s", "k", timeout=1),
                 lambda: wrong.get_prefix("s", "", timeout=1),
                 lambda: wrong.delete_scope("s")):
        with pytest.raises(client_mod.KVAuthError):
            call()


def test_unsigned_and_stale_requests_refused(store):
    server_mod, client_mod, key, port = store
    with pytest.raises(client_mod.KVAuthError):
        client_mod.KVStoreClient("127.0.0.1", port,
                                 secret_key="").put("s", "k", b"poison")
    ts = f"{time.time() - 2 * psecret.MAX_SKEW_SECONDS:.6f}"
    hdrs = {psecret.TS_HEADER: ts,
            psecret.DIGEST_HEADER: psecret.request_digest(
                key, "PUT", "s/k", b"v", ts=ts)}
    req = urllib.request.Request(f"http://127.0.0.1:{port}/s/k", data=b"v",
                                 method="PUT", headers=hdrs)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 403


def test_keyed_client_refuses_an_unkeyed_store():
    """A store that does not hold the secret cannot answer a keyed GET."""
    srv = pkv.RendezvousServer(secret_key="")
    port = srv.start()
    try:
        pkv.KVStoreClient("127.0.0.1", port, secret_key="").put(
            "negotiate", "resp", b"forged")
        victim = pkv.KVStoreClient("127.0.0.1", port,
                                   secret_key=psecret.make_secret_key())
        with pytest.raises(pkv.KVAuthError, match="digest missing"):
            victim.get("negotiate", "resp", timeout=2)
    finally:
        srv.stop()


def test_secret_module_is_the_jax_packages():
    key = psecret.make_secret_key()
    parts = (b"PUT", b"s/k", b"", b"1.0", b"", b"v")
    assert psecret.compute_digest(key, *parts) == \
        jsecret.compute_digest(key, *parts)
    assert psecret.compute_digest(key, b"a", b"bc") != \
        psecret.compute_digest(key, b"ab", b"c")
    assert psecret.response_digest(key, "s/a", b"v") == \
        jsecret.response_digest(key, "s/a", b"v")
