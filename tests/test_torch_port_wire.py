"""Wire parity of the port's negotiation with the JAX package's: frames the
port encodes decode under ``horovod_tpu.ops.wire`` and the other way round,
byte for byte, for the v2 submission, aggregate and response frames, and
the port controller's v1 round (full JSON payload, then the 1-byte
SAME_AS_LAST marker) is the JAX controller's, so a port worker and a JAX
coordinator negotiate one round together. Mirrors ``tests/test_wire.py``."""

import json
import threading

import pytest

from horovod_tpu.ops import controller as jctl
from horovod_tpu.ops import wire as jwire
from horovod_tpu.runner.http_server import KVStoreClient as JClient
from horovod_tpu.runner.http_server import RendezvousServer as JServer
from horovod_tpu_torch.ops import controller as pctl
from horovod_tpu_torch.ops import wire as pwire
from horovod_tpu_torch.runner.http_server import KVStoreClient as PClient

SIG = ["allreduce", "float32", [1024], 0, -1, 1.0, 1.0, "global", "cpu"]
SIG2 = ["allgather", "int32", [8, 4], 2, None, 1.0, 1.0, "global", "cpu"]

SUBMISSIONS = [([("t0", SIG), ("t1", SIG2)], True, False),
               ([], False, True),
               ([(f"g{i}", SIG) for i in range(16)], False, False)]
DIRECTIONS = [(pwire, jwire), (jwire, pwire)]
DIR_IDS = ["port-to-jax", "jax-to-port"]


@pytest.mark.parametrize("enc,dec", DIRECTIONS, ids=DIR_IDS)
@pytest.mark.parametrize("case", range(len(SUBMISSIONS)))
def test_submission_frames_cross_decode(enc, dec, case):
    entries, joined, sd = SUBMISSIONS[case]
    raw = enc.encode_submission(entries, joined, sd)
    assert raw == dec.encode_submission(entries, joined, sd)
    assert dec.decode_submission(raw) == {
        "e": [list(e) for e in entries], "j": joined, "sd": sd}
    traced = enc.encode_submission(entries, joined, sd, t=12.5)
    assert dec.decode_submission(traced)["t"] == 12.5


@pytest.mark.parametrize("enc,dec", DIRECTIONS, ids=DIR_IDS)
def test_aggregate_frames_cross_decode(enc, dec):
    kw = dict(group=3, size=64,
              entries=[("t0", SIG, {24, 25, 31}), ("t1", SIG2, {24})],
              covered={24, 25, 31}, joined={25}, shutting_down=set(),
              t_map={24: 1.5, 31: 2.25})
    raw = enc.encode_aggregate(**kw)
    assert raw == dec.encode_aggregate(**kw)
    assert dec.is_aggregate(raw)
    msg = dec.decode_aggregate(raw)
    assert (msg["g"], msg["covered"], msg["j"], msg["t"]) == (
        3, {24, 25, 31}, {25}, {24: 1.5, 31: 2.25})
    assert msg["e"] == [["t0", SIG, {24, 25, 31}], ["t1", SIG2, {24}]]


@pytest.mark.parametrize("enc,dec", DIRECTIONS, ids=DIR_IDS)
def test_response_channel_cross_decodes_across_rounds(enc, dec):
    """The response channel interns across rounds: an encoder of one
    package and a decoder of the other stay in step."""
    e, d = enc.ResponseEncoder(), dec.ResponseDecoder()
    resp = {"ready": [f"g{i}" for i in range(8)],
            "sigs": {f"g{i}": SIG for i in range(8)},
            "errors": {"bad": "Mismatched"}, "join_done": 1,
            "shutdown_done": True}
    for _ in range(3):
        out = d.decode(e.encode(resp))
        assert out["ready"] == resp["ready"]
        assert out["sigs"] == resp["sigs"]
        assert out["errors"] == resp["errors"]
        assert out["join_done"] == 1 and out["shutdown_done"] is True


def test_wire_constants_agree():
    for name in ("MAGIC_V2", "WIRE_V1", "WIRE_V2", "KIND_SUBMIT",
                 "KIND_AGG", "KIND_RESP"):
        assert getattr(pwire, name) == getattr(jwire, name), name
    assert pctl.KVController.SAME_AS_LAST == jctl.KVController.SAME_AS_LAST
    assert pwire.SAME_AS_LAST == jctl.KVController.SAME_AS_LAST


@pytest.mark.parametrize("case", range(len(SUBMISSIONS)))
def test_v1_submission_codec_is_the_jax_controllers(case):
    """``wire.encode_submission_v1`` writes the bytes the JAX controller
    writes inline, and the decoder reads them back; the marker repeats the
    sender's last submission."""
    entries, joined, sd = SUBMISSIONS[case]
    raw = pwire.encode_submission_v1(entries, joined, sd)
    assert raw == json.dumps({"e": [list(e) for e in entries], "j": joined,
                              "sd": sd}).encode()
    msg = pwire.decode_submission_v1(raw, None)
    assert msg == {"e": [list(e) for e in entries], "j": joined, "sd": sd}
    assert pwire.decode_submission_v1(pwire.SAME_AS_LAST, msg) is msg
    assert pwire.decode_submission_v1(pwire.SAME_AS_LAST, None) == {
        "e": [], "j": False, "sd": False}


class _Recorder:
    """A KV client that records the controller's PUTs and answers every
    response poll with an empty round."""

    def __init__(self):
        self.puts = []

    def put(self, scope, key, value):
        self.puts.append((scope, key, value))

    def get(self, scope, key, timeout=30.0):
        return json.dumps({"ready": [], "errors": {}, "sigs": {},
                           "join_done": None}).encode()


def test_v1_rounds_put_the_same_bytes_as_the_jax_controller():
    """Round 0 carries the JSON payload, round 1 (same set) the 1-byte
    SAME_AS_LAST marker, round 2 (a new set) JSON again — the same bytes
    under the same keys from both controllers."""
    rounds = [{"a": SIG}, {"a": SIG}, {"a": SIG, "b": SIG2}]
    puts = []
    for mod in (pctl, jctl):
        client = _Recorder()
        ctl = mod.KVController(client, rank=1, size=2, poll_timeout=5.0)
        for pending in rounds:
            ctl.negotiate(dict(pending))
        puts.append(client.puts)
        assert ctl.fast_rounds == 1
    assert puts[0] == puts[1]
    assert puts[0][1][2] == b"="
    assert json.loads(puts[0][0][2]) == {"e": [["a", SIG]], "j": False,
                                         "sd": False}


def test_port_worker_negotiates_with_a_jax_coordinator():
    """A JAX rank 0 (with its coordinator) and a port rank 1 share a round
    on the JAX store: one name both submit is ready on both, one only rank
    0 submits is not, and a mismatched one fails on both."""
    server = JServer(secret_key="k" * 64)
    server.start()
    try:
        j = jctl.KVController(JClient("127.0.0.1", server.port,
                                      secret_key="k" * 64),
                              rank=0, size=2, poll_timeout=20.0)
        p = pctl.KVController(PClient("127.0.0.1", server.port,
                                      secret_key="k" * 64),
                              rank=1, size=2, poll_timeout=20.0)
        out = {}

        def run(name, ctl, pending):
            out[name] = ctl.negotiate(pending)

        bad = SIG[:2] + [[5]] + SIG[3:]
        ts = [threading.Thread(target=run, args=(
                  "jax", j, {"both": SIG, "only0": SIG, "bad": SIG})),
              threading.Thread(target=run, args=(
                  "port", p, {"both": SIG, "bad": bad}))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        for resp in out.values():
            assert resp["ready"] == ["both"]
            assert resp["sigs"] == {"both": SIG}
            assert set(resp["errors"]) == {"bad"}
            assert "Mismatched" in resp["errors"]["bad"]
        j.stop()
        p.stop()
    finally:
        server.stop()
