"""``hvdrun`` for the port — counterpart of ``horovod_tpu/runner/launch.py``
(``slot_env`` :49, ``launch_slots`` :144, ``make_parser`` :230,
``run_commandline`` :391, ``run`` :444).

    python -m horovod_tpu_torch.runner -np 2 python train.py
    python -m horovod_tpu_torch.runner -np 8 -H host1:4,host2:4 python train.py

The launcher mints the job's HMAC secret, starts the rendezvous KV store
(``runner/http_server.py``) that carries negotiation, and starts one worker
per slot with the slot's ``HOROVOD_*`` environment. Beside the JAX
package's variables, each slot gets ``MASTER_ADDR``, the host where rank 0
serves the ``torch.distributed`` ``TCPStore``. Its port is not chosen here:
rank 0 binds port 0 and publishes the port it got through the KV store
(``common/context.py``), so no other process can take it in between. A
``MASTER_PORT`` the user sets reaches every slot and wins. The JAX
package's ``HOROVOD_TPU_*`` variables are not set. One process drives one
GPU: a worker takes ``cuda:<HOROVOD_LOCAL_RANK>`` (``common/context.py``). The
first worker to fail ends the job, and its exit code is the launcher's.
Elastic launches, config files and the JAX package's runtime knobs that the
port does not read are left out.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from ..common import env as env_schema
from .hosts import (HostInfo, SlotInfo, get_host_assignments,
                    hosts_from_allocation, parse_hostfile, parse_hosts)
from .http_server import RendezvousServer

# the directory that holds the horovod_tpu_torch package
_IMPORT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def slot_env(slot: SlotInfo, rendezvous_addr: str, rendezvous_port: int,
             coordinator: str, extra_env: Optional[dict] = None) -> dict:
    """One slot's environment. ``coordinator`` is ``addr:port`` of rank 0's
    ``TCPStore``, or ``addr:`` when rank 0 picks the port itself. Workers
    can import the port even when the launcher runs from a source checkout:
    its import root leads ``PYTHONPATH``."""
    e = dict(os.environ)
    pythonpath = e.get("PYTHONPATH", "")
    if _IMPORT_ROOT not in pythonpath.split(os.pathsep):
        e["PYTHONPATH"] = _IMPORT_ROOT + (os.pathsep + pythonpath
                                          if pythonpath else "")
    master_addr, _, master_port = coordinator.rpartition(":")
    e.update({
        env_schema.HOROVOD_RANK: str(slot.rank),
        env_schema.HOROVOD_SIZE: str(slot.size),
        env_schema.HOROVOD_LOCAL_RANK: str(slot.local_rank),
        env_schema.HOROVOD_LOCAL_SIZE: str(slot.local_size),
        env_schema.HOROVOD_CROSS_RANK: str(slot.cross_rank),
        env_schema.HOROVOD_CROSS_SIZE: str(slot.cross_size),
        env_schema.HOROVOD_HOSTNAME: slot.hostname,
        env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR: rendezvous_addr,
        env_schema.HOROVOD_GLOO_RENDEZVOUS_PORT: str(rendezvous_port),
        env_schema.MASTER_ADDR: master_addr,
    })
    if master_port:
        e[env_schema.MASTER_PORT] = master_port
    if extra_env:
        e.update(extra_env)
    return e


def build_ssh_command(hostname: str, command: list[str], env: dict, *,
                      ssh_port: Optional[int] = None,
                      ssh_identity_file: Optional[str] = None) -> list[str]:
    """SSH fan-out command with the slot's environment inlined."""
    env_str = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items()
        if k.startswith("HOROVOD_")
        or k in ("PATH", "PYTHONPATH", env_schema.MASTER_ADDR,
                 env_schema.MASTER_PORT))
    ssh_args = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh_args += ["-p", str(ssh_port)]
    if ssh_identity_file:
        ssh_args += ["-i", ssh_identity_file]
    remote = f"cd {shlex.quote(os.getcwd())} && env {env_str} " \
             + " ".join(shlex.quote(c) for c in command)
    return ssh_args + [hostname, remote]


def _stream(prefix: str, pipe, out, tee_path: Optional[str] = None):
    tag = b"stdout" if out is sys.stdout.buffer else b"stderr"
    tee = open(tee_path, "wb") if tee_path else None
    try:
        for line in iter(pipe.readline, b""):
            out.write(b"[" + prefix.encode() + b"]<" + tag + b">: " + line)
            out.flush()
            if tee is not None:
                tee.write(line)
                tee.flush()
    finally:
        if tee is not None:
            tee.close()


def _output_threads(p, rank: int, output_filename: Optional[str]) -> list:
    """Rank-prefixed console streams for one worker, teed into
    ``<output_filename>/rank.<rank>.{out,err}`` when set."""
    threads = []
    for pipe, out, kind in ((p.stdout, sys.stdout.buffer, "out"),
                            (p.stderr, sys.stderr.buffer, "err")):
        tee = (os.path.join(output_filename, f"rank.{rank}.{kind}")
               if output_filename else None)
        t = threading.Thread(target=_stream, args=(str(rank), pipe, out, tee),
                             daemon=True)
        t.start()
        threads.append(t)
    return threads


def launch_slots(command: list[str], slots: list[SlotInfo], *,
                 ssh_port: Optional[int] = None,
                 ssh_identity_file: Optional[str] = None,
                 extra_env: Optional[dict] = None,
                 output_filename: Optional[str] = None,
                 network_interface: Optional[str] = None) -> int:
    """Start one worker per slot (local exec, or SSH for a remote host),
    stream their rank-prefixed output, and end the job on the first
    failure. Returns the job's exit code."""
    if output_filename:
        os.makedirs(output_filename, exist_ok=True)
    # the secret goes into this process's environment before the store
    # starts: the store reads it there, and every slot's environment
    # snapshot carries it to the worker
    from .secret import get_or_mint_env_secret

    get_or_mint_env_secret()
    rendezvous = RendezvousServer()
    rendezvous.start()
    from .network import is_local_host, pick_coordinator_address

    remote = sorted({s.hostname for s in slots
                     if not is_local_host(s.hostname)})
    if not remote:
        addr = "127.0.0.1"
    else:
        addr, _ = pick_coordinator_address(
            remote, iface_override=network_interface or os.environ.get(
                env_schema.HOROVOD_GLOO_IFACE))
    # rank 0 serves the TCPStore, so workers dial rank 0's host, which is
    # not the launcher's when the launcher holds no rank-0 slot; rank 0
    # picks the port unless the user set one
    store_host = (addr if is_local_host(slots[0].hostname)
                  else slots[0].hostname)
    coordinator = (f"{store_host}:"
                   f"{os.environ.get(env_schema.MASTER_PORT, '')}")

    procs: list[subprocess.Popen] = []
    threads = []
    try:
        for slot in slots:
            e = slot_env(slot, addr, rendezvous.port, coordinator, extra_env)
            if is_local_host(slot.hostname):
                cmd = command
            else:
                cmd = build_ssh_command(slot.hostname, command, e,
                                        ssh_port=ssh_port,
                                        ssh_identity_file=ssh_identity_file)
            p = subprocess.Popen(cmd, env=e, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
            procs.append(p)
            threads.extend(_output_threads(p, slot.rank, output_filename))

        exit_code = 0
        alive = set(range(len(procs)))
        while alive:
            for i in list(alive):
                rc = procs[i].poll()
                if rc is None:
                    continue
                alive.discard(i)
                if rc != 0:
                    # the first failure ends the job
                    exit_code = rc
                    for j in alive:
                        procs[j].send_signal(signal.SIGTERM)
                    for j in alive:
                        try:
                            procs[j].wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            procs[j].kill()
                    alive.clear()
                    break
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=2)
        return exit_code
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        rendezvous.stop()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdrun",
        description="Launch a horovod_tpu_torch job, one process per GPU.")
    p.add_argument("-np", "--num-proc", type=int, default=None)
    p.add_argument("-H", "--hosts", default=None,
                   help="host1:slots,host2:slots (default: localhost:np)")
    p.add_argument("--hostfile", default=None)
    p.add_argument("--from-allocation", action="store_true",
                   help="take the host list from the scheduler allocation's "
                        "environment (LSF or SLURM); -np defaults to every "
                        "allocated slot")
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("-i", "--ssh-identity-file", default=None)
    p.add_argument("--env", action="append", default=[],
                   help="KEY=VALUE to forward to workers (repeatable)")
    # runtime knobs -> the workers' environment
    p.add_argument("--fusion-threshold-mb", type=int, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=None)
    p.add_argument("--stall-check-shutdown-time-seconds", type=float,
                   default=None)
    p.add_argument("--output-filename", default=None,
                   help="directory for per-rank output files "
                        "rank.<r>.{out,err}; console streaming continues")
    p.add_argument("--network-interface", default=None,
                   help="NIC whose address workers dial for the rendezvous "
                        "store and rank 0's TCPStore; default: probe the "
                        "route to each worker host")
    p.add_argument("command", nargs=argparse.REMAINDER)
    return p


def _knob_env(args) -> dict:
    e = {}
    if args.fusion_threshold_mb is not None:
        e[env_schema.HOROVOD_FUSION_THRESHOLD] = str(
            args.fusion_threshold_mb << 20)
    if args.cycle_time_ms is not None:
        e[env_schema.HOROVOD_CYCLE_TIME] = str(args.cycle_time_ms)
    if args.stall_check_warning_time_seconds is not None:
        e[env_schema.HOROVOD_STALL_CHECK_TIME_SECONDS] = \
            str(args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        e[env_schema.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] = \
            str(args.stall_check_shutdown_time_seconds)
    for kv in args.env:
        k, _, v = kv.partition("=")
        e[k] = v
    return e


def run_commandline(argv=None) -> int:
    args = make_parser().parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdrun: no command given", file=sys.stderr)
        return 2
    if args.from_allocation:
        try:
            hosts = hosts_from_allocation(os.environ)
        except (ValueError, OSError) as e:
            print(f"hvdrun: {e}", file=sys.stderr)
            return 2
    elif args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = parse_hosts(args.hosts)
    else:
        hosts = [HostInfo("localhost", args.num_proc or 1)]
    if args.num_proc is None:
        args.num_proc = sum(h.slots for h in hosts)
    try:
        slots = get_host_assignments(hosts, args.num_proc)
    except ValueError as e:
        print(f"hvdrun: {e}", file=sys.stderr)
        return 2
    return launch_slots(command, slots, ssh_port=args.ssh_port,
                        ssh_identity_file=args.ssh_identity_file,
                        extra_env=_knob_env(args),
                        output_filename=args.output_filename,
                        network_interface=args.network_interface)


def run(fn, args=(), kwargs=None, np: int = 1,
        extra_env: Optional[dict] = None) -> list:
    """Run ``fn(*args, **kwargs)`` in ``np`` local workers and return their
    results in rank order. ``fn`` travels pickled, so it must be a module
    level function (or cloudpickle must be installed)."""
    import tempfile

    try:
        import cloudpickle as pickle
    except ImportError:
        import pickle

    kwargs = kwargs or {}
    with tempfile.TemporaryDirectory() as td:
        payload = os.path.join(td, "fn.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args, kwargs), f)
        out_tpl = os.path.join(td, "out.{rank}.pkl")
        helper = (
            "import pickle,os;"
            f"fn,a,k=pickle.load(open({payload!r},'rb'));"
            "r=fn(*a,**k);"
            f"pickle.dump(r,open({out_tpl!r}.format("
            "rank=os.environ['HOROVOD_RANK']),'wb'))")
        slots = get_host_assignments([HostInfo("localhost", np)], np)
        rc = launch_slots([sys.executable, "-c", helper], slots,
                          extra_env=extra_env)
        if rc != 0:
            raise RuntimeError(f"hvdrun job failed with exit code {rc}")
        results = []
        for r in range(np):
            with open(out_tpl.format(rank=r), "rb") as f:
                results.append(pickle.load(f))
        return results


def main():
    sys.exit(run_commandline())
