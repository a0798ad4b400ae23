"""Process sets and join in the port's runtime, in one process on the CPU
(gloo), and the negotiation rules they need, held against the JAX
package's where it has them:

- a name on a set is ready once the set's members submitted it, while a
  non-member never does (``_required``, JAX ``controller.py`` :1220);
- two sets may each have a tensor ``x``: the negotiation key is scoped by
  the set (``_wire_name``, JAX ``queue.py`` :1069);
- a fused allreduce on a set runs on that set's runtime group, and so
  does every op alone;
- a joined rank contributes zeros built from the coordinator's signature
  (no rows to allgather and alltoall), never to a set it is not in
  (``_zero_entry_from_sig``, JAX ``queue.py`` :1080), and
  ``join_done`` ends the join;
- ``add_process_set`` is keyed by name and idempotent, the global set
  cannot be removed, a non-member cannot enqueue on a set, and a set's
  topology equals the JAX package's.

The sets here have one member (a world of one); the 2-process jobs of
``tests/test_torch_port_surface.py`` run sets of other ranks and of both.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.ops import controller as jctl
from horovod_tpu.ops import queue as jqueue
from horovod_tpu_torch.common import context
from horovod_tpu_torch.common.env import RuntimeConfig
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.ops import collectives as pcoll
from horovod_tpu_torch.ops import controller as pctl
from horovod_tpu_torch.ops import queue as pqueue


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _sig(op="allreduce", members=None, ps="global"):
    sig = [op, "float32", [4], 1, 0, 1.0, 1.0, ps, "cpu"]
    if members is not None:
        sig.append(members)
    return sig


def _respond(coord, subs):
    if isinstance(coord, pctl._Coordinator):
        return coord._respond(subs)
    # the JAX coordinator folds submissions inside its run loop: replay
    # that fold and its readiness rule
    for k in sorted(subs):
        for name, sig in subs[k].get("e", []):
            coord._increment(name, sig, k)
    return [n for n in coord.order
            if not (coord._required(n) - coord.table[n][1] - coord._joined)]


def _ready(resp):
    return resp["ready"] if isinstance(resp, dict) else resp


@pytest.mark.parametrize("which", ["port", "jax"])
def test_set_scoped_name_is_ready_once_its_members_submit(which):
    """A set of ranks {1, 2} in a world of 3: rank 0, not a member, never
    submits the set's name, which is ready once 1 and 2 have."""
    # a coordinator that is never started
    coord = (jctl if which == "jax" else pctl)._Coordinator(None, 3)
    name = "ps:pair:x"
    sig = _sig(members=[1, 2], ps="pair")
    assert _ready(_respond(coord, {0: {"e": []}, 1: {"e": [[name, sig]]},
                                   2: {"e": []}})) == []
    assert name in _ready(_respond(coord, {0: {"e": []}, 1: {"e": []},
                                           2: {"e": [[name, sig]]}}))


def test_global_name_still_waits_for_the_world():
    coord = pctl._Coordinator(None, 3)
    resp = coord._respond({0: {"e": [["x", _sig()]]},
                           1: {"e": [["x", _sig()]]}, 2: {"e": []}})
    assert resp["ready"] == [] and resp["errors"] == {}
    assert coord._respond({2: {"e": [["x", _sig()]]}})["ready"] == ["x"]


def test_two_sets_with_a_tensor_named_x_are_both_ready():
    """Set {0} and set {1} each submit ``x`` in the same round: scoped by
    the set, neither fails as a mismatch."""
    entries = [pqueue.TensorEntry(name="x", op="allreduce",
                                  tensor=torch.ones(4),
                                  process_set=types.SimpleNamespace(
                                      name=nm, ranks=[k]))
               for k, nm in enumerate(("zero", "one"))]
    keys = [pqueue.BackgroundRuntime._wire_name(e) for e in entries]
    assert keys == ["ps:zero:x", "ps:one:x"]
    assert keys == [jqueue.BackgroundRuntime._wire_name(
        types.SimpleNamespace(name="x", process_set=e.process_set))
        for e in entries]
    coord = pctl._Coordinator(None, 2)
    resp = coord._respond({k: {"e": [[keys[k], pctl.entry_signature(e)]]}
                           for k, e in enumerate(entries)})
    assert sorted(resp["ready"]) == sorted(keys) and resp["errors"] == {}
    plain = pqueue.TensorEntry(name="x", op="allreduce", tensor=torch.ones(4))
    assert pqueue.BackgroundRuntime._wire_name(plain) == "x"


def _private_runtime():
    ps = context.global_process_set()
    return pqueue.BackgroundRuntime(ps, RuntimeConfig(), torch.device("cpu"),
                                    ps.runtime_group)


def test_fused_allreduce_on_a_set_runs_on_the_sets_group(port):
    ps = hvd.add_process_set([0], name="solo")
    try:
        rt = _private_runtime()
        pcoll.invalidate_fused_plans()
        xs = [torch.full((3,), 1.0), torch.full((5,), 2.0)]
        hs = [rt.enqueue(pqueue.TensorEntry(
            name=f"s{i}", op="allreduce", tensor=x, output=x,
            reduce_op=pcoll.ReduceOp.AVERAGE, process_set=ps))
            for i, x in enumerate(xs)]
        rt.run_cycle()
        for h, x in zip(hs, (1.0, 2.0)):
            assert rt.handles.wait(h).tolist() == [x] * (3 if x == 1 else 5)
        plans = [(k, p) for k, p in pcoll._PLANS.items() if k[2] == "solo"]
        assert len(plans) == 1 and rt.chunks == 1
        assert plans[0][1].group is ps.runtime_group
        assert ps.runtime_group is not rt.group
        # an op alone takes the set's group too
        assert rt._group_of(ps) is ps.runtime_group
        assert rt._group_of(None) is rt.group
    finally:
        hvd.remove_process_set(ps)


class _StubController:
    def __init__(self, resp):
        self.resp = resp
        self.joined = []

    def negotiate(self, sigs, joined=False, shutting_down=False):
        self.joined.append(joined)
        return dict(self.resp)


def test_joined_rank_contributes_zeros_only_to_sets_it_is_in(port):
    """Rank 0, joined, is told of four ready names: a global allreduce, a
    global allgather, one on a set it is in, one on a set of rank 1 only.
    It builds zeros for the first three (no rows for the allgather) and
    nothing for the last; ``join_done`` ends its join."""
    mine = hvd.add_process_set([0], name="mine")
    try:
        rt = _private_runtime()
        sigs = {"ar": _sig(),
                "ag": ["allgather", "bfloat16", ["*", 3], 0, 0, 1.0, 1.0,
                       "global", "cpu"],
                "ps:mine:x": _sig(members=[0], ps="mine"),
                "ps:theirs:x": _sig(members=[1], ps="theirs")}
        rt.controller = _StubController(
            {"ready": list(sigs), "sigs": sigs, "errors": {},
             "join_done": None})
        rt.joined = True
        out = rt._negotiate([])
        assert rt.controller.joined == [True]
        assert [(e.name, e.op, tuple(e.tensor.shape), e.tensor.dtype,
                 getattr(e.process_set, "name", None)) for e in out] == [
            ("ar", "allreduce", (4,), torch.float32, None),
            ("ag", "allgather", (0, 3), torch.bfloat16, None),
            ("x", "allreduce", (4,), torch.float32, "mine")]
        assert all(e.handle == -1 and not e.tensor.any() for e in out)
        # the zero contributions run and release no caller's handle
        rt._dispatch_batch(out)
        rt.controller.resp["join_done"] = 0
        rt.controller.resp["ready"] = []
        assert rt._negotiate([]) == []
        assert not rt.joined and rt._join_done.is_set()
    finally:
        hvd.remove_process_set(mine)


def test_not_joined_rank_builds_no_zeros(port):
    rt = _private_runtime()
    rt.controller = _StubController({"ready": ["ar"], "sigs": {"ar": _sig()},
                                     "errors": {}, "join_done": None})
    assert rt._negotiate([]) == []


def test_join_waits_for_join_done(port):
    rt = _private_runtime()
    rt.controller = _StubController({})
    got = {}
    t = threading.Thread(target=lambda: got.update(last=rt.join(timeout=10)))
    t.start()
    deadline = time.monotonic() + 10
    while not rt.joined and time.monotonic() < deadline:
        time.sleep(0.001)
    assert rt.joined
    rt._join_last_rank = 1
    rt.joined = False
    rt._join_done.set()
    t.join(10)
    assert got == {"last": 1}
    rt.controller = None
    assert rt.join() == 0  # no controller: nobody to wait for


def test_zero_entry_matches_the_jax_package(port):
    """The same op, shape (no rows for allgather and alltoall), dtype,
    factors and plain name as the JAX package's zero contribution."""
    hvd.add_process_set([0], name="z")
    try:
        rt = _private_runtime()
        cases = [("ag", ["allgather", "float32", ["*", 2], 0, 0, 1.0, 1.0,
                         "global", "cpu"]),
                 ("ps:z:a2a", ["alltoall", "int32", ["*"], 0, 0, 1.0, 1.0,
                               "z", "cpu", [0]]),
                 ("rs", ["reducescatter", "float32", [4, 2], 0, 0, 1.0,
                         1.0, "global", "cpu"]),
                 ("bc", ["broadcast", "float32", [3], 1, 0, 1.0, 1.0,
                         "global", "cpu"]),
                 ("ar", ["allreduce", "float32", [2], 1, 0, 0.5, 4.0,
                         "global", "cpu"])]
        for name, sig in cases:
            p = rt._zero_entry_from_sig(name, sig)
            j = jqueue.BackgroundRuntime._zero_entry_from_sig(
                name, sig[:7] + ["global"] + sig[8:])
            assert (p.name, p.op, int(p.reduce_op), p.root_rank,
                    p.prescale_factor, p.postscale_factor) == (
                j.name if sig[7] == "global" else name.split(":")[-1],
                j.op, int(j.reduce_op), j.root_rank, j.prescale_factor,
                j.postscale_factor)
            assert tuple(p.tensor.shape) == np.shape(j.tensor)
            assert str(p.tensor.dtype)[6:] == np.asarray(j.tensor).dtype.name
            assert p.output is p.tensor
            assert getattr(p.process_set, "name", "global") == sig[7]
    finally:
        hvd.remove_process_set("z")


def test_add_process_set_is_keyed_by_name(port):
    a = hvd.add_process_set([0])
    try:
        assert a.name == "set_0" and a.ranks == [0]
        assert hvd.add_process_set([0]) is a
        assert context.process_set_by_name("set_0") is a
        with pytest.raises(ValueError, match="global"):
            hvd.remove_process_set("global")
        with pytest.raises(ValueError, match="subset"):
            hvd.add_process_set([1])
        with pytest.raises(ValueError, match="subset"):
            hvd.add_process_set([])
    finally:
        hvd.remove_process_set(a)
    assert context.process_set_by_name("set_0") is None
    hvd.remove_process_set("set_0")  # a second removal is a no-op


def test_remove_process_set_drops_its_plans(port):
    ps = hvd.add_process_set([0], name="gone")
    hvd.grouped_allreduce([torch.ones(2), torch.ones(3)], name="gone.g",
                          op=hvd.Sum, process_set=ps)
    assert any(k[2] == "gone" for k in pcoll._PLANS)
    hvd.remove_process_set(ps)
    assert not any(k[2] == "gone" for k in pcoll._PLANS)


def test_non_member_cannot_enqueue_on_a_set(port):
    other = context.ProcessSet("other", [1], None, None)
    assert not other.included()
    with pytest.raises(ValueError, match="not a member"):
        hvd.allreduce(torch.ones(2), name="nm", process_set=other)
    with pytest.raises(HorovodInternalError, match="not a member"):
        other.rank  # noqa: B018 (the property raises)


def test_set_topology_matches_jax_package(port):
    """A set of one member: the port counts ranks (processes), the JAX
    package chips; in this one-process JAX world of 8 chips the set of
    chip 0 is the port's set of rank 0."""
    p = hvd.add_process_set([0], name="topo")
    j = jhvd.add_process_set([0], name="topo")
    try:
        assert (p.rank, p.size, p.cross_rank, p.cross_size) == (
            j.rank, j.size, j.cross_rank, j.cross_size) == (0, 1, 0, 1)
        g, jg = hvd.global_process_set(), jhvd.global_process_set()
        assert (g.rank, g.cross_rank, g.cross_size) == (
            jg.rank, jg.cross_rank, jg.cross_size)
    finally:
        hvd.remove_process_set(p)
        jhvd.remove_process_set("topo")


def test_ops_on_a_set_of_one(port):
    """Every op on a set goes through the set's group and gives the
    world-of-one result."""
    ps = hvd.add_process_set([0], name="one.ops")
    try:
        x = torch.arange(6.0).view(3, 2)
        assert torch.equal(hvd.allgather(x, name="o.ag", process_set=ps), x)
        out, recv = hvd.alltoall(x, name="o.a2a", process_set=ps)
        assert torch.equal(out, x) and recv.tolist() == [3]
        assert torch.equal(hvd.reducescatter(x, name="o.rs",
                                             process_set=ps), x)
        assert torch.equal(hvd.broadcast(x, 0, name="o.bc",
                                         process_set=ps), x)
        assert torch.equal(hvd.allreduce(x, name="o.ar", op=hvd.Max,
                                         process_set=ps), x)
        hvd.barrier(process_set=ps)
        assert hvd.allgather_object(7, process_set=ps) == [7]
    finally:
        hvd.remove_process_set(ps)
