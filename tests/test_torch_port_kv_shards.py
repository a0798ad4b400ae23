"""The port's sharded rendezvous store (``horovod_tpu_torch/runner/
http_server.py``) against the JAX package's (``horovod_tpu/runner/
http_server.py``): the scope routing gives the same shard for every scope,
and the wire works both ways — the port's client against the JAX server
and the JAX client against the port's server, unsharded and sharded, with
a job secret, ``put_get`` as one ``PUTGET`` exchange on a shard; the
telemetry endpoints the slice adds; and ``--config-file``, whose options
equal the JAX launcher's ``_apply_config_file`` for a JSON file and for
the flat YAML subset (the JAX launcher reads both with PyYAML)."""

import json
import threading
import urllib.request
import zlib
from urllib.error import HTTPError

import pytest

import horovod_tpu.runner.http_server as JS
import horovod_tpu.runner.launch as JL
import horovod_tpu_torch.runner.http_server as PS
import horovod_tpu_torch.runner.launch as PL

SECRET = "c2VjcmV0LWtleS1mb3ItdGhlLXRlc3Q="
PACKAGES = {"port": PS, "jax": JS}


def _serve(mod, shards):
    srv = mod.RendezvousServer(secret_key=SECRET, shards=shards)
    srv.start()
    return srv


def _verbs(srv):
    """Record the verbs each shard listener handles."""
    seen = []
    for ln in srv._listeners:
        handle = ln._handle

        def counted(verb, body, _h=handle):
            seen.append(verb)
            return _h(verb, body)

        ln._handle = counted
    return seen


def _http_calls(cli):
    """Record the HTTP requests a client makes."""
    seen = []
    attempt = cli._attempt

    def counted(method, path, *a, **kw):
        seen.append((method, path))
        return attempt(method, path, *a, **kw)

    cli._attempt = counted
    return seen


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_shard_routing_equals_jax(monkeypatch, n):
    monkeypatch.setenv("HOROVOD_KV_SHARDS", str(n))
    ports = [40000 + 7 * i for i in range(n)]
    pc = PS.KVStoreClient("127.0.0.1", 1)
    jc = JS.KVStoreClient("127.0.0.1", 1)
    pc._shard_ports = list(ports)
    jc._shard_ports = list(ports)
    scopes = ([f"ctl/e0g{g}/r{r}" for g in range(2) for r in range(40)]
              + ["metrics", "diag", "mem", "health", "ckpt", "perf",
                 "horovod_tpu_torch", "ctl/e0g0/r3/g1"])
    for scope in scopes:
        got = pc._shard_port(scope)
        assert got == jc._shard_port(scope), scope
        if n > 1:
            assert got == ports[zlib.crc32(scope.encode()) % n]
            assert PS.shard_index(scope, n) == ports.index(got)
        else:
            assert got is None


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_wire_both_ways(monkeypatch, server, client, shards):
    monkeypatch.setenv("HOROVOD_KV_SHARDS", str(shards))
    srv = _serve(PACKAGES[server], shards)
    try:
        verbs = _verbs(srv)
        mk = PACKAGES[client].KVStoreClient
        a = mk("127.0.0.1", srv.port, secret_key=SECRET)
        b = mk("127.0.0.1", srv.port, secret_key=SECRET)
        assert (a.shard_ports() if client == "port"
                else a._fetch_shards()) == srv.shard_ports
        for i in range(8):
            a.put(f"s{i}", "k", bytes([i]) * 3)
        assert [b.get(f"s{i}", "k") for i in range(8)] == [
            bytes([i]) * 3 for i in range(8)]
        with pytest.raises(HTTPError) as e:
            b.get("s0", "missing", timeout=0.1)
        assert e.value.code == 404
        # a member submits and waits in one call; the leader answers
        threading.Timer(0.2, lambda: b.put("ctl/r7/g0", "resp",
                                           b"fan-down")).start()
        http = _http_calls(a)
        del verbs[:]
        assert a.put_get("ctl/r7/g0", "ready/3", b"sub", "resp",
                         timeout=5) == b"fan-down"
        if shards > 1:
            # the member's one exchange, and the leader's put
            assert sorted(verbs) == [PS._BV_PUT, PS._BV_PUTGET]
            assert http == []
        else:
            assert [m for m, _ in http] == ["PUT", "GET"]
        got = b.get_prefix("ctl/r7/g0", "", min_count=2, timeout=5)
        assert got == {"ready/3": b"sub", "resp": b"fan-down"}
        b.delete_prefix("ctl/", exclude="ctl/r7/g0/resp")
        assert a.get_prefix("ctl/r7/g0", "", min_count=0,
                            timeout=0.1) == {"resp": b"fan-down"}
        a.delete_scope("s1")
        with pytest.raises(HTTPError):
            a.get("s1", "k", timeout=0.1)
    finally:
        srv.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_shard_refuses_another_secret(monkeypatch, server):
    monkeypatch.setenv("HOROVOD_KV_SHARDS", "2")
    srv = _serve(PACKAGES[server], 2)
    try:
        bad = PS.KVStoreClient("127.0.0.1", srv.port,
                               secret_key="another-key")
        with pytest.raises(PS.KVAuthError):
            bad.put("s", "k", b"v")
    finally:
        srv.stop()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def test_telemetry_endpoints_merge_every_shard(monkeypatch):
    monkeypatch.setenv("HOROVOD_KV_SHARDS", "3")
    srv = _serve(PS, 3)
    try:
        cli = PS.KVStoreClient("127.0.0.1", srv.port, secret_key=SECRET)
        assert _get(srv.port, "shards") == {"shards": srv.shard_ports}
        for r in range(2):
            cli.put("mem", f"rank{r}", json.dumps(
                {"rank": r, "components": {"fusion_buffer": 128}}).encode())
            cli.put("ckpt", f"rank{r}", json.dumps(
                {"rank": r, "last_step": 5 + r}).encode())
            cli.put("health", f"rank{r}", json.dumps(
                {"rank": r, "verdict": "healthy", "active": [],
                 "series": {"step_time_ms": {
                     "n": 2, "samples": [[1.0, 10.0], [5.0, 11.0 + r]],
                     "downsampled": []}}}).encode())
            cli.put("diag", f"rank{r}", json.dumps(
                {"reason": "watchdog", "stall": {"age_s": 1.0 + r},
                 "probes": {"coordinator": {"missing_ranks": [1]}
                            if r == 0 else {}}}).encode())
        mem = _get(srv.port, "memory")["ranks"]
        assert sorted(mem) == ["0", "1"] and not mem["1"]["stale"]
        ck = _get(srv.port, "checkpoint")
        assert ck["ranks"]["1"]["last_step"] == 6 and ck["manifest"] is None
        hist = _get(srv.port, "history?series=step_time_ms&since=2")
        assert hist["ranks"]["1"]["series"]["step_time_ms"]["samples"] == [
            [5.0, 12.0]]
        assert _get(srv.port, "health")["verdict"] == "healthy"
        dbg = _get(srv.port, "debug")
        assert dbg["suspects"] == [1] and sorted(dbg["ranks"]) == ["0", "1"]
    finally:
        srv.stop()


CONFIGS = {
    "json": json.dumps({"num-proc": 4, "hosts": "a:2,b:2",
                        "cycle_time_ms": 2.5, "fusion-threshold-mb": 64,
                        "env": ["A=1", "B=two"], "output_filename": "logs",
                        "network-interface": None}),
    "yaml": """# a launcher config
num-proc: 4
hosts: "a:2,b:2"     # two hosts of two
cycle_time_ms: 2.5
fusion-threshold-mb: 0x40
env: [A=1, 'B=two']
output_filename: logs
network-interface: ~
stall-check-warning-time-seconds: 30
slots-per-host: 1
""",
}


@pytest.mark.parametrize("fmt", sorted(CONFIGS))
@pytest.mark.parametrize("cli", [[], ["-np", "2", "--env", "C=3"]])
def test_config_file_equals_jax(tmp_path, fmt, cli):
    path = tmp_path / f"launch.{fmt}"
    path.write_text(CONFIGS[fmt])
    argv = ["--config-file", str(path)] + cli + ["python", "train.py"]
    pa = PL.make_parser().parse_args(argv)
    ja = JL.make_parser().parse_args(argv)
    PL._apply_config_file(pa)
    JL._apply_config_file(ja)
    keys = {k.replace("-", "_") for k in PL.parse_config_text(
        CONFIGS[fmt])} | {"num_proc", "env", "command"}
    assert {k: getattr(pa, k) for k in keys} == {
        k: getattr(ja, k) for k in keys}
    assert pa.num_proc == (2 if cli else 4)
    assert pa.hosts == "a:2,b:2" and pa.fusion_threshold_mb == 64


@pytest.mark.parametrize("text,line", [
    ("num-proc: 2\nhosts:\n  - a\n", 3),
    ("num-proc: 2\n- a\n", 2),
    ("a: &anchor 1\n", 1),
    ("a: {b: 1}\n", 1),
    ("a: 1:30\n", 1),
    ("a: 1\na: 2\n", 2),
    ("---\na: 1\n", 1),
])
def test_config_file_refuses_outside_the_subset(tmp_path, text, line):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(PL.ConfigFileError, match=f"bad.yaml:{line}:"):
        PL.parse_config_text(text, str(path).rsplit("/", 1)[1])
    rc = PL.run_commandline(["--config-file", str(path), "true"])
    assert rc == 2
