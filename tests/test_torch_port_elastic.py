"""The port's elastic layer against the JAX package's, on the CPU:

- fault injection: for one ``HOROVOD_FAULT_SPEC``, seed and rank, both
  packages fire the same hits at every site over 1000 hits, and both
  refuse the same malformed specs;
- the driver: ``compute_assignments`` gives the same slots for a scripted
  sequence of discovery results (hosts added and removed, ``max_np`` and
  ``min_np``), and respawn-before-blacklist over thread-free worker
  doubles gives the same rounds, strikes, blacklist and exit code;
- ``run``: the same sequence of ``restore``, ``on_reset``, ``sync`` and
  re-initializations for a scripted sequence of ``HorovodInternalError``
  and ``HostsUpdatedInterrupt``;
- ``ElasticSampler``: the port's indices at a world of W equal the JAX
  sampler's at ``cross_size() == W``, over epochs and processed sets;
- checkpoint files: either package loads the other's pickle file, keeps
  the committed file after a torn write and falls back to ``.old``;
- ``TorchState`` in one process: commit and restore, and the departure
  from the JAX shim (a relaunched port state comes back with the
  committed weights, the JAX shim's with fresh ones);
- the ``TCPStore`` port key: a relaunched incarnation reads only its own;
- the knobs: an elastic job configured for the JAX package warns of
  nothing under the port.

The two-process jobs are in ``tests/test_torch_port_elastic_jobs.py``,
the async checkpointer in ``tests/test_torch_port_async_ckpt.py``.
"""

import dataclasses
import os
import pickle
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from horovod_tpu import elastic as jelastic
from horovod_tpu.elastic import driver as jdriver
from horovod_tpu.utils import checkpoint as jckpt
from horovod_tpu.utils import faults as jfaults
from horovod_tpu.utils import metrics as jmetrics
from horovod_tpu_torch import elastic as pelastic
from horovod_tpu_torch.common import context
from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.common.exceptions import (FaultInjectedError,
                                                 HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.elastic import driver as pdriver
from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                  RendezvousServer)
from horovod_tpu_torch.utils import checkpoint as pckpt
from horovod_tpu_torch.utils import faults as pfaults


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("HOROVOD_FAULT_SPEC", "HOROVOD_FAULT_SEED", "HOROVOD_RANK",
              "HOROVOD_ELASTIC_STORE", "HOROVOD_ELASTIC_EPOCH",
              "HOROVOD_ELASTIC_GEN", "HOROVOD_GLOO_RENDEZVOUS_ADDR",
              "HOROVOD_GLOO_RENDEZVOUS_PORT", "MASTER_PORT",
              "HOROVOD_ELASTIC_RESPAWN_ATTEMPTS",
              "HOROVOD_ELASTIC_RESPAWN_BACKOFF"):
        monkeypatch.delenv(k, raising=False)
    jfaults.reset()
    pfaults.reset()
    # a firing of a JAX fault point registers its series in the JAX
    # package's process-wide registry; the ones a test adds go with it, so
    # the JAX package's own tests that follow in this process find none
    reg = jmetrics.get_registry()
    with reg._lock:
        before = set(reg._metrics)
    yield
    jfaults.reset()
    pfaults.reset()
    with reg._lock:
        for key in [k for k in reg._metrics
                    if k[0] == "hvd_fault_injected_total"
                    and k not in before]:
            del reg._metrics[key]


# --- fault injection ---------------------------------------------------------

SPEC = ",".join([
    "kv.get:error@0.3#200", "kv.put:drop@7", "kv.wait:fail=boom@0.5",
    "kv.delete:error#3", "controller.poll:drop@0.05",
    "controller.submit:error@13#40", "leader.merge:fail@0.9#500",
    "elastic.spawn:error#1", "elastic.heartbeat:drop@0.2",
    "metrics.push:error@3", "autotune.propose:error@0.5",
    "plan.dispatch:fail@0.01", "ckpt.write:torn@0.25#60",
    "ckpt.flush:error@2", "megaplan.capture:error@0.7",
    "megaplan.replay:drop@4#9", "health.sample:error@0.33",
    "ckpt.write:error@5"])


def _firings(faults, site: str, hits: int = 1000) -> list:
    out = []
    for _ in range(hits):
        got = []
        if faults.corrupt(site, b"abcdef") != b"abcdef":
            got.append("torn")
        try:
            faults.fault_point(site)
        except ConnectionError:
            got.append("drop")
        except Exception as e:
            assert type(e).__name__ == "FaultInjectedError", e
            got.append(f"error:{e}")
        out.append(tuple(got))
    return out


@pytest.mark.parametrize("rank,seed", [("0", "0"), ("1", "7"), ("3", "")])
def test_fault_firings_match_jax(monkeypatch, rank, seed):
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", SPEC)
    monkeypatch.setenv("HOROVOD_RANK", rank)
    monkeypatch.setenv("HOROVOD_FAULT_SEED", seed)
    assert set(pfaults.SITES) == set(jfaults.SITES)
    fired = 0
    for site in pfaults.SITES:
        got, want = _firings(pfaults, site), _firings(jfaults, site)
        assert got == want, site
        fired += sum(1 for g in got if g)
    assert fired > 1000


@pytest.mark.parametrize("spec", [
    "kv.get", "kv.get:explode", "kv.get:error#x", "kv.get:error@abc",
    "kv.get:delay=soon"])
def test_both_refuse_the_same_bad_specs(monkeypatch, spec):
    for faults in (pfaults, jfaults):
        with pytest.raises(ValueError):
            faults._FaultState(spec, 0)
        monkeypatch.setenv("HOROVOD_FAULT_SPEC", spec)
        faults.reset()
        assert faults._active().rules == {}  # logged, then ignored
        faults.fault_point("kv.get")


def test_unset_spec_is_inert_and_registers_nothing(monkeypatch):
    from horovod_tpu_torch.utils import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "get_registry", lambda: reg)
    pfaults.fault_point("plan.dispatch")
    assert pfaults._active() is None and not reg.names()
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "plan.dispatch:error#1")
    with pytest.raises(FaultInjectedError):
        pfaults.fault_point("plan.dispatch")
    pfaults.fault_point("plan.dispatch")  # its one trigger is spent
    assert reg.counter_value("hvd_fault_injected_total",
                             site="plan.dispatch", mode="error") == 1


# --- the driver ---------------------------------------------------------------

ROUNDS = [
    ({"a": 2}, None, 1),
    ({"a": 2, "b": 2}, None, 1),            # a host added
    ({"b": 2, "a": 2, "c": 1}, 4, 1),       # max_np cuts the tail
    ({"c": 1, "a": 2}, None, 1),            # b removed: a keeps rank 0
    ({"c": 1, "a": 2, "d": 3}, 5, 2),
    ({"d": 3}, None, 2),                    # the last survivors go
    ({"e": 4}, None, 1),                    # none survives: refused
]


def _assignments(mod, fixed_hosts):
    disc = fixed_hosts({})
    out = []
    drv = None
    for hosts, max_np, min_np in ROUNDS:
        if drv is None:
            drv = mod.ElasticDriver(disc, min_np=min_np, max_np=max_np)
            drv.rendezvous.start()  # the JAX server's stop needs it
        drv.max_np, drv.min_np = max_np, min_np
        disc.set(hosts)
        drv.host_manager.update_available_hosts()
        try:
            out.append([dataclasses.asdict(s)
                        for s in drv.compute_assignments()])
        except RuntimeError as e:
            out.append(("refused", str(e).split(";")[0]))
    drv.stop()
    return out


def test_compute_assignments_match_jax():
    got = _assignments(pdriver, pelastic.FixedHosts)
    want = _assignments(jdriver, jelastic.FixedHosts)
    assert got == want
    assert got[-1][0] == "refused" and got[3][0]["hostname"] == "a"
    # min_np above what discovery offers
    for mod, fixed in ((pdriver, pelastic.FixedHosts),
                       (jdriver, jelastic.FixedHosts)):
        d = mod.ElasticDriver(fixed({"a": 1}), min_np=3)
        d.rendezvous.start()
        d.host_manager.update_available_hosts()
        with pytest.raises(RuntimeError, match="min_np"):
            d.compute_assignments()
        d.stop()


class _Worker:
    """A thread-free worker double: its exit code comes from the script
    at once."""

    def __init__(self, rc):
        self._rc = rc
        self.terminated = False

    def poll(self):
        return self._rc

    def terminate(self):
        self.terminated = True
        self._rc = -15

    def kill(self):
        self.terminate()


# (round, host) -> exit code; everything else exits 0
SCRIPTS = {
    "respawn_then_blacklist": ({"a": 1, "b": 1}, 1,
                               {(1, "b"): 1, (2, "b"): 1}),
    "no_respawns": ({"a": 2, "b": 1}, 0, {(1, "a"): 3}),
    "below_min_np": ({"a": 1}, 0, {(1, "a"): 2}),
    "clean_exit_clears_strikes": ({"a": 1, "b": 1}, 1,
                                  {(1, "b"): 1, (3, "b"): 1}),
}


def _rounds(mod, fixed_hosts, name, monkeypatch):
    hosts, retries, fails = SCRIPTS[name]
    drv = mod.ElasticDriver(fixed_hosts(hosts), min_np=1,
                            respawn_retries=retries,
                            respawn_backoff_s=0.001)
    launched = []
    nround = {"n": 0, "epoch": None}
    rerun = {"left": 1}

    def create(slot, env):
        ep = env["HOROVOD_ELASTIC_EPOCH"]
        if ep != nround["epoch"]:
            nround["n"] += 1
            nround["epoch"] = ep
        launched.append((nround["n"], slot.hostname, slot.rank, slot.size,
                         ep, env["HOROVOD_ELASTIC"]))
        return _Worker(fails.get((nround["n"], slot.hostname), 0))

    if name == "clean_exit_clears_strikes":
        # round 2 exits 0 everywhere; run the driver again for round 3
        rc = drv.run(create, lambda s: {})
        nround["epoch"] = None
        drv._stop.clear()
        drv.rendezvous.stop()
        drv.rendezvous = type(drv.rendezvous)()
        rc = (rc, drv.run(create, lambda s: {}))
    else:
        rc = drv.run(create, lambda s: {})
    out = {"launched": launched, "rc": rc,
           "strikes": dict(drv._host_strikes),
           "blacklisted": sorted(h for h in ("a", "b")
                                 if drv.host_manager.is_blacklisted(h)),
           "epoch": drv._epoch}
    drv.stop()
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_respawn_before_blacklist_matches_jax(name, monkeypatch):
    monkeypatch.setenv("HOROVOD_PREEMPT_GRACE_S", "1")
    got = _rounds(pdriver, pelastic.FixedHosts, name, monkeypatch)
    want = _rounds(jdriver, jelastic.FixedHosts, name, monkeypatch)
    assert got == want
    if name == "respawn_then_blacklist":
        assert got["blacklisted"] == ["b"] and got["rc"] == 0
        assert [r for r, *_ in got["launched"]] == [1, 1, 2, 2, 3]
    if name == "below_min_np":
        assert got["rc"] == 1


def test_terminate_escalates_after_the_grace_window(monkeypatch):
    monkeypatch.setenv("HOROVOD_PREEMPT_GRACE_S", "0.2")

    class Stubborn(_Worker):
        def terminate(self):
            self.terminated = True  # ignores SIGTERM

        def kill(self):
            self._rc = -9

    drv = pdriver.ElasticDriver(pelastic.FixedHosts({"a": 1}), min_np=1)
    slot = types.SimpleNamespace(rank=0)
    w = Stubborn(None)
    t0 = time.monotonic()
    drv._terminate({0: (slot, w)})
    assert w.terminated and w.poll() == -9
    assert 0.2 <= time.monotonic() - t0 < 5
    drv.stop()


def test_elastic_flags_dispatch_to_run_elastic(monkeypatch):
    from horovod_tpu_torch.runner import launch

    seen = {}

    def fake(command, args):
        seen.update(command=command, min_np=args.min_np, max_np=args.max_np,
                    script=args.host_discovery_script,
                    slots=args.slots_per_host)
        return 7

    monkeypatch.setattr(pdriver, "run_elastic", fake)
    rc = launch.run_commandline(["--min-np", "1", "--max-np", "3",
                                 "--host-discovery-script", "/bin/true",
                                 "--slots-per-host", "2", "python", "x.py"])
    assert rc == 7
    assert seen == {"command": ["python", "x.py"], "min_np": 1, "max_np": 3,
                    "script": "/bin/true", "slots": 2}


# --- run ---------------------------------------------------------------------

class _RecState:
    def __init__(self, log):
        self.log = log

    def sync(self):
        self.log.append("sync")

    def restore(self):
        self.log.append("restore")

    def on_reset(self):
        self.log.append("on_reset")


SEQUENCES = [
    [],
    ["internal"],
    ["hosts"],
    ["hosts_skip"],
    ["internal", "internal", "hosts", "internal"],
    ["hosts_skip", "internal", "hosts_skip", "hosts"],
]


def _run_log(mod, errors, internal, hosts, monkeypatch):
    log = []
    monkeypatch.setattr(mod, "_reinitialize", lambda: log.append("reinit"))
    left = list(errors)

    @mod.run
    def train(state, x):
        log.append(f"train:{x}")
        if left:
            kind = left.pop(0)
            if kind == "internal":
                raise internal("collective failed")
            raise hosts(skip_sync=(kind == "hosts_skip"))
        return "done"

    assert train(_RecState(log), 5) == "done"
    return log


@pytest.mark.parametrize("errors", SEQUENCES)
def test_run_call_sequence_matches_jax(errors, monkeypatch):
    from horovod_tpu.common import exceptions as jexc

    got = _run_log(pelastic, errors, HorovodInternalError,
                   HostsUpdatedInterrupt, monkeypatch)
    want = _run_log(jelastic, errors, jexc.HorovodInternalError,
                    jexc.HostsUpdatedInterrupt, monkeypatch)
    assert got == want
    assert got.count("reinit") == len(errors)


# --- the sampler ---------------------------------------------------------------

def test_sampler_indices_match_jax_cross_size(monkeypatch):
    from horovod_tpu.torch import elastic_sampler as jsampler
    from horovod_tpu_torch.torch import elastic_sampler as psampler

    world = {"size": 1, "rank": 0}
    monkeypatch.setattr(jsampler, "_core", types.SimpleNamespace(
        cross_size=lambda: world["size"], cross_rank=lambda: world["rank"]))
    monkeypatch.setattr(context, "is_initialized", lambda: True)
    monkeypatch.setattr(context, "size", lambda: world["size"])
    monkeypatch.setattr(context, "rank", lambda: world["rank"])
    rs = np.random.RandomState(3)
    for n, shuffle, seed in ((37, True, 0), (64, False, 5), (5, True, 11)):
        data = list(range(n))
        for epoch in range(3):
            processed = sorted(set(rs.randint(0, n, size=rs.randint(0, n))))
            for w in (1, 2, 3, 4, 7):
                for r in range(w):
                    world.update(size=w, rank=r)
                    pair = []
                    for mod in (psampler, jsampler):
                        s = mod.ElasticSampler(data, shuffle=shuffle,
                                               seed=seed)
                        s.set_epoch(epoch)
                        s.load_state_dict({"epoch": epoch,
                                           "processed_indices": processed})
                        s.record_batch(0, 2)
                        s.reset()
                        pair.append((list(s), len(s), s.state_dict()))
                    assert pair[0] == pair[1], (n, epoch, w, r)


# --- checkpoint files --------------------------------------------------------

def _tree():
    r = np.random.RandomState(1)
    return {"w": r.randn(5, 3).astype(np.float32), "step": 4,
            "nested": [r.randint(0, 9, 6), ("x", 2.5)]}


def _same_tree(a, b):
    assert pickle.dumps(a) == pickle.dumps(b)


@pytest.mark.parametrize("writer,reader", [(pckpt, jckpt), (jckpt, pckpt),
                                           (pckpt, pckpt)])
def test_checkpoint_files_cross_load(tmp_path, writer, reader):
    path = str(tmp_path / "state.pkl")
    writer.save_pytree(path, _tree())
    assert reader.exists(path)
    _same_tree(reader.load_pytree(path), _tree())


@pytest.mark.parametrize("mod", [pckpt, jckpt])
def test_torn_write_keeps_the_commit_and_old_is_read(tmp_path, monkeypatch,
                                                     mod):
    path = str(tmp_path / "state.pkl")
    mod.save_pytree(path, _tree())
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "ckpt.write:torn#1")
    with pytest.raises(Exception, match="torn write"):
        mod.save_pytree(path, {"other": 1})
    _same_tree(mod.load_pytree(path), _tree())
    assert os.listdir(tmp_path) == ["state.pkl"]  # no tmp left behind
    # a crash between the rotation and the rename leaves only .old
    os.rename(path, path + ".old")
    for reader in (pckpt, jckpt):
        assert reader.exists(path)
        _same_tree(reader.load_pytree(path), _tree())


def test_orbax_format_is_refused(tmp_path):
    with pytest.raises(ValueError, match="Orbax"):
        pckpt.save_pytree(str(tmp_path / "x"), {}, format="orbax")


# --- TorchState in one process --------------------------------------------

def _model(seed: int):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 2))


def _train_step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(6, 4, generator=g)
    opt.zero_grad()
    model(x).square().mean().backward()
    opt.step()


def _weights(model):
    return [p.detach().clone() for p in model.state_dict().values()]


def test_torch_state_commit_and_restore(tmp_path):
    from horovod_tpu_torch import TorchState

    model = _model(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = TorchState(model, opt, epoch=0, batch=0)
    _train_step(model, opt, 1)
    state.batch = 1
    state.commit()
    committed = _weights(model)
    momentum = [opt.state[p]["momentum_buffer"].clone()
                for p in model.parameters()]
    _train_step(model, opt, 2)
    state.batch = 2
    state.restore()
    assert state.batch == 1
    assert all(torch.equal(a, b) for a, b in zip(_weights(model), committed))
    assert all(torch.equal(opt.state[p]["momentum_buffer"], m)
               for p, m in zip(model.parameters(), momentum))
    # the snapshot is a copy: training on does not change it
    _train_step(model, opt, 3)
    state.restore()
    assert all(torch.equal(a, b) for a, b in zip(_weights(model), committed))


def test_torch_state_departure_from_the_jax_shim(tmp_path, monkeypatch):
    """A relaunched world: a fresh model and optimizer and a state over the
    same store. The port's state comes back with the committed weights
    and momentum; the JAX shim's comes back with fresh weights (it stores
    the keyword attributes only)."""
    from horovod_tpu import torch as jtorch
    from horovod_tpu_torch import TorchState

    results = {}
    for name, cls in (("port", TorchState), ("jax", jtorch.TorchState)):
        store = str(tmp_path / f"{name}.pkl")
        monkeypatch.setenv("HOROVOD_ELASTIC_STORE", store)
        model = _model(0)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        state = cls(model, opt, batch=0)
        for step in range(3):
            _train_step(model, opt, step)
            state.batch = step + 1
            state.commit()
        committed = _weights(model)
        # the relaunch: new process objects, other initial weights
        model2 = _model(1)
        opt2 = torch.optim.SGD(model2.parameters(), lr=0.1, momentum=0.9)
        state2 = cls(model2, opt2, batch=0)
        assert state2.batch == 3
        same = all(torch.equal(a, b)
                   for a, b in zip(_weights(model2), committed))
        results[name] = (same, len(opt2.state))
    assert results["port"] == (True, 4)
    assert results["jax"] == (False, 0)


# --- the TCPStore port key ---------------------------------------------------

def test_relaunched_ranks_read_only_their_incarnations_store_key(
        monkeypatch):
    srv = RendezvousServer(secret_key="")
    port = srv.start()
    monkeypatch.setenv(penv.HOROVOD_GLOO_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(penv.HOROVOD_GLOO_RENDEZVOUS_PORT, str(port))
    monkeypatch.setenv("HOROVOD_SECRET_KEY", "")
    monkeypatch.setattr(context._ctx, "inits", 0)
    kv = KVStoreClient("127.0.0.1", port, secret_key="")
    try:
        monkeypatch.setenv(penv.HOROVOD_ELASTIC_EPOCH, "0")
        monkeypatch.setenv(penv.HOROVOD_RANK, "0")
        old = context._store(0, 2)
        assert kv.get(context._STORE_PORT_SCOPE,
                      "tcp_store_port.e0g0.0") == str(old.port).encode()
        # incarnation 1: a fresh process (inits 0 again) under epoch 1
        monkeypatch.setenv(penv.HOROVOD_ELASTIC_EPOCH, "1")
        monkeypatch.setenv(penv.HOROVOD_RANK, "1")
        got = {}
        t = threading.Thread(target=lambda: got.update(s=context._store(1, 2)),
                             daemon=True)
        t.start()
        t.join(1.5)
        assert t.is_alive(), "rank 1 dialed the last incarnation's store"
        monkeypatch.setenv(penv.HOROVOD_RANK, "0")
        new = context._store(0, 2)
        t.join(30)
        assert not t.is_alive() and new.port != old.port
        assert got["s"].port == new.port
        # a reset generation in the same process gets a key of its own too
        monkeypatch.setenv(penv.HOROVOD_ELASTIC_GEN, "2")
        assert context._store_port_key() == "tcp_store_port.e1g2.0"
    finally:
        srv.stop()


# --- the knobs -------------------------------------------------------------

def test_an_elastic_jax_job_warns_of_nothing(monkeypatch, tmp_path):
    knobs = {
        "HOROVOD_ELASTIC": "1", "HOROVOD_ELASTIC_STORE": str(tmp_path / "s"),
        "HOROVOD_ELASTIC_RESPAWN_ATTEMPTS": "2",
        "HOROVOD_ELASTIC_RESPAWN_BACKOFF": "0.5",
        "HOROVOD_ASYNC_CKPT": "1", "HOROVOD_ASYNC_CKPT_DIR": str(tmp_path),
        "HOROVOD_PREEMPT_GRACE_S": "5", "HOROVOD_FAULT_SPEC": "kv.get:delay#1",
        "HOROVOD_FAULT_SEED": "3"}
    from horovod_tpu.common import env as jenv

    for k, v in knobs.items():
        assert getattr(penv, k) == getattr(jenv, k) == k
        assert k not in penv.UNIMPLEMENTED_KNOBS
        monkeypatch.setenv(k, v)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        penv.warn_unimplemented()
    assert not caught, [str(w.message) for w in caught]
    # the warning still fires for a knob the tuple names (empty since the
    # autotuner was ported: HOROVOD_AUTOTUNE, its last knob, is put back)
    monkeypatch.setattr(penv, "UNIMPLEMENTED_KNOBS", ("HOROVOD_AUTOTUNE",))
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    with pytest.warns(RuntimeWarning, match="HOROVOD_AUTOTUNE"):
        penv.warn_unimplemented()


def test_function_executor_returns_the_last_rounds_results(tmp_path):
    """``ElasticFunctionExecutor`` over the port's driver: one local
    process a slot runs the pickled function; results in rank order."""
    from horovod_tpu_torch.elastic.executor import ElasticFunctionExecutor

    ex = ElasticFunctionExecutor(
        ElasticFunctionExecutor.create_settings(min_np=2, max_np=3),
        pelastic.FixedHosts({"localhost": 3}),
        env_vars={"HOROVOD_ELASTIC_STORE": str(tmp_path / "s.pkl")})
    ex.start()
    try:
        got = ex.run(os.getenv, args=("HOROVOD_RANK",))
    finally:
        ex.shutdown()
    assert got == ["0", "1", "2"]
