"""Where rank 0's ``TCPStore`` port comes from under the port's ``hvdrun``.

The launcher used to pick the port by binding port 0 and closing the
socket, and rank 0 bound it much later; another process could take it in
between (EADDRINUSE under a test run's parallel jobs). Now rank 0 opens
its store on port 0 and publishes the port it got through the launcher's
KV store, and the other ranks read it there before they dial. A
``MASTER_PORT`` the user sets still wins.
"""

import io
import os
import signal
import socket
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu_torch.common import context
from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.runner import hosts as phosts
from horovod_tpu_torch.runner import launch as plaunch
from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                   RendezvousServer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    out = hvd.allreduce(torch.full((4,), float(hvd.rank() + 1)), op=hvd.Sum,
                        name="x")
    assert torch.equal(out, torch.full((4,), 3.0)), out
    rank = hvd.rank()
    hvd.shutdown()
    print("LAUNCH_OK", rank)
""")

# ``python -m horovod_tpu_torch.runner`` with the launcher's old port choice
# pointed at a port another process holds: a launcher that still picks the
# store's port itself hands the workers that port
LAUNCHER = textwrap.dedent("""
    import sys
    from horovod_tpu_torch.runner import launch
    launch._free_port = lambda: int(sys.argv[1])
    sys.exit(launch.run_commandline(sys.argv[2:]))
""")


def test_job_completes_while_another_process_holds_a_port(tmp_path):
    """A 2-process gloo job through the port's ``hvdrun`` comes up while
    the port the launcher's old ``_free_port`` would hand out is held by a
    listening socket of another process."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop(penv.MASTER_PORT, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with socket.socket() as held:
        held.bind(("", 0))
        held.listen()
        p = subprocess.Popen(
            [sys.executable, "-c", LAUNCHER, str(held.getsockname()[1]),
             "-np", "2", sys.executable, str(script)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            out = p.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out = p.communicate()[0]
            raise AssertionError(f"the job timed out:\n{out}")
    assert p.returncode == 0, out
    assert "LAUNCH_OK 0" in out and "LAUNCH_OK 1" in out, out


@pytest.fixture
def launcher_env(monkeypatch):
    """A launcher's KV store (no secret) and a slot's environment without
    ``MASTER_PORT``. Yields the store's client."""
    monkeypatch.delenv(penv.HOROVOD_SECRET_KEY, raising=False)
    monkeypatch.delenv(penv.MASTER_PORT, raising=False)
    server = RendezvousServer(secret_key="")
    server.start()
    monkeypatch.setenv(penv.HOROVOD_GLOO_RENDEZVOUS_ADDR, "127.0.0.1")
    monkeypatch.setenv(penv.HOROVOD_GLOO_RENDEZVOUS_PORT, str(server.port))
    monkeypatch.setenv(penv.MASTER_ADDR, "127.0.0.1")
    monkeypatch.setenv(penv.HOROVOD_SIZE, "2")
    try:
        yield KVStoreClient("127.0.0.1", server.port, secret_key="")
    finally:
        server.stop()


def test_rank_zero_publishes_the_port_its_store_bound(launcher_env,
                                                      monkeypatch):
    kv = launcher_env
    monkeypatch.setenv(penv.HOROVOD_RANK, "0")
    master = context._store(0, 2)
    key = context._store_port_key()
    published = int(kv.get(context._STORE_PORT_SCOPE, key, timeout=1.0))
    assert published == master.port != 0
    # rank 1 reads the port from the KV store and dials the same store
    monkeypatch.setenv(penv.HOROVOD_RANK, "1")
    worker = context._store(1, 2)
    assert worker.port == master.port
    master.set("from0", "a")
    assert worker.get("from0") == b"a"


def test_an_explicit_master_port_wins(launcher_env, monkeypatch):
    """With ``MASTER_PORT`` set, rank 1 dials it and reads nothing from the
    KV store (which holds no port: a read would block)."""
    monkeypatch.setenv(penv.HOROVOD_RANK, "0")
    master = context._store(0, 2)
    monkeypatch.setenv(penv.MASTER_PORT, str(master.port))
    monkeypatch.setattr(context, "_STORE_PORT_KEY", "no.such.key")
    monkeypatch.setenv(penv.HOROVOD_RANK, "1")
    worker = context._store(1, 2)
    assert worker.port == master.port
    worker.set("from1", "b")
    assert master.get("from1") == b"b"


def test_a_launched_worker_needs_a_port_or_the_kv_address(monkeypatch):
    for k in (penv.MASTER_PORT, penv.HOROVOD_GLOO_RENDEZVOUS_ADDR,
              penv.HOROVOD_GLOO_RENDEZVOUS_PORT):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(penv.HOROVOD_RANK, "1")
    with pytest.raises(RuntimeError, match="neither MASTER_PORT"):
        context._store(1, 2)


@pytest.mark.parametrize("user_port", [None, "29511"])
def test_slots_get_master_port_only_from_the_user(monkeypatch, user_port):
    """The launcher starts no worker here (``Popen`` is a stand-in): every
    slot gets ``MASTER_ADDR``, and ``MASTER_PORT`` only when the user set
    one."""
    envs = []

    class _Exited:
        def __init__(self, cmd, env, **kw):
            envs.append(env)
            self.stdout, self.stderr = io.BytesIO(), io.BytesIO()

        def poll(self):
            return 0

    if user_port is None:
        monkeypatch.delenv(penv.MASTER_PORT, raising=False)
    else:
        monkeypatch.setenv(penv.MASTER_PORT, user_port)
    monkeypatch.setattr(plaunch.subprocess, "Popen", _Exited)
    slots = phosts.get_host_assignments([phosts.HostInfo("localhost", 2)], 2)
    assert plaunch.launch_slots(["true"], slots) == 0
    assert [e[penv.MASTER_ADDR] for e in envs] == ["127.0.0.1"] * 2
    assert [e.get(penv.MASTER_PORT) for e in envs] == [user_port] * 2
    assert not hasattr(plaunch, "_free_port")
