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

``--min-np``, ``--max-np`` or ``--host-discovery-script`` make the launch
elastic (``elastic/driver.py`` ``run_elastic``)::

    python -m horovod_tpu_torch.runner --min-np 2 --max-np 4 --host-discovery-script ./hosts.sh python train.py

``--config-file PATH`` fills every option the command line left unset
(JAX ``launch.py:333-343``): a key names an option (``num-proc`` or
``num_proc``), its value the option's. The JAX launcher reads YAML with
PyYAML, which the port does not need: it reads a JSON object, or the flat
subset of YAML a launcher config uses — one ``key: value`` a line, with
comments, blank lines, quoted or bare strings, integers, floats with a
point, YAML 1.1's booleans, ``null``/``~`` and flow lists of scalars —
and refuses anything else with an error that names the line. The JAX
package's runtime knobs that the port does not read are left out.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def _stream(prefix: str, pipe, out, tee_path: Optional[str] = None,
            tee_mode: str = "wb"):
    tag = b"stdout" if out is sys.stdout.buffer else b"stderr"
    tee = open(tee_path, tee_mode) if tee_path else None
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


def _output_threads(p, rank: int, output_filename: Optional[str],
                    first_incarnation: bool = True) -> list:
    """Rank-prefixed console streams for one worker, teed into
    ``<output_filename>/rank.<rank>.{out,err}`` when set: fresh files for a
    rank's first incarnation, appended to by the elastic driver's
    respawns, so one file tells the whole story of a rank."""
    threads = []
    for pipe, out, kind in ((p.stdout, sys.stdout.buffer, "out"),
                            (p.stderr, sys.stderr.buffer, "err")):
        tee = (os.path.join(output_filename, f"rank.{rank}.{kind}")
               if output_filename else None)
        t = threading.Thread(target=_stream,
                             args=(str(rank), pipe, out, tee,
                                   "wb" if first_incarnation else "ab"),
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
    p.add_argument("--config-file", default=None,
                   help="JSON, or flat 'key: value' YAML, giving options "
                        "the command line leaves unset")
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
    # elastic: any of the first three makes the launch elastic
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None,
                   help="executable printing the available hosts, one "
                        "'host' or 'host:slots' a line")
    p.add_argument("--slots-per-host", type=int, default=1,
                   help="slots of a discovered host printed without them")
    p.add_argument("command", nargs=argparse.REMAINDER)
    return p


class ConfigFileError(ValueError):
    """A ``--config-file`` the launcher cannot read."""


_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_-]*$")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL_FLOATS = {".inf": float("inf"), ".Inf": float("inf"),
                   ".INF": float("inf"), ".nan": float("nan"),
                   ".NaN": float("nan"), ".NAN": float("nan")}
# what YAML 1.1 reads as a base-60 number or a date: refused, not guessed
_REFUSED = re.compile(r"[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?$"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|=$|<<$")
_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False",
                                  "FALSE", "off", "Off", "OFF")})


def _yaml_scalar(text: str, where: str):
    """One scalar as PyYAML's ``safe_load`` reads it, within the subset."""
    if text[:1] in ("'", '"'):
        q = text[0]
        if len(text) < 2 or text[-1] != q:
            raise ConfigFileError(f"{where}: unterminated quoted string")
        body = text[1:-1]
        if q == "'":
            return body.replace("''", "'")
        try:
            return json.loads(text)
        except ValueError as e:
            raise ConfigFileError(f"{where}: {e}") from None
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        return int(text.replace("_", ""), 16)
    if _OCT.match(text):
        return int(text.replace("_", ""), 8)
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    sign = -1.0 if text[0] == "-" else 1.0
    special = _SPECIAL_FLOATS.get(text.lstrip("+-"))
    if special is not None:
        return sign * special
    if (_REFUSED.match(text) or text[0] in "[]{}&*!|>%@`,"
            or text.startswith(("- ", "? ")) or text in ("-", "?")
            or ": " in text or " #" in text or text.endswith(":")):
        raise ConfigFileError(f"{where}: {text!r} is outside the flat "
                              "YAML subset")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_config_text(text: str, name: str = "<config>") -> dict:
    """A ``--config-file``'s options: a JSON object, or the flat YAML
    subset the module docstring names; anything else raises
    ``ConfigFileError`` naming the line."""
    if text.lstrip().startswith("{"):
        try:
            cfg = json.loads(text)
        except ValueError as e:
            raise ConfigFileError(f"{name}: {e}") from None
        if not isinstance(cfg, dict):
            raise ConfigFileError(f"{name}: not a JSON object")
        return cfg
    cfg = {}
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ConfigFileError(f"{where}: one document only")
        if line[0] in " \t":
            raise ConfigFileError(f"{where}: indented (nested) lines are "
                                  "outside the flat YAML subset")
        key, sep, value = line.partition(":")
        if not sep or not _KEY.match(key):
            raise ConfigFileError(f"{where}: expected 'key: value', got "
                                  f"{raw.strip()!r}")
        if value and value[0] not in " \t":
            raise ConfigFileError(f"{where}: a space must follow ':'")
        value = value.strip()
        if key in cfg:
            raise ConfigFileError(f"{where}: {key!r} given twice")
        if value.startswith("["):
            if not value.endswith("]"):
                raise ConfigFileError(f"{where}: unterminated flow list")
            inner = value[1:-1].strip()
            items = [v.strip() for v in inner.split(",")] if inner else []
            if any(not v or v[0] in "[{" for v in items):
                raise ConfigFileError(f"{where}: a flow list holds "
                                      "scalars only")
            cfg[key] = [_yaml_scalar(v, where) for v in items]
        else:
            cfg[key] = _yaml_scalar(value, where)
    return cfg


def _apply_config_file(args):
    """Fill the options the command line left unset (None, False or an
    empty list) from ``args.config_file``."""
    if not args.config_file:
        return
    with open(args.config_file) as f:
        cfg = parse_config_text(f.read(), args.config_file)
    for k, v in cfg.items():
        k = k.replace("-", "_")
        if getattr(args, k, None) in (None, False, []):
            setattr(args, k, v)


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
    try:
        _apply_config_file(args)
    except (ConfigFileError, OSError) as e:
        print(f"hvdrun: --config-file: {e}", file=sys.stderr)
        return 2
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdrun: no command given", file=sys.stderr)
        return 2
    if args.host_discovery_script or args.min_np or args.max_np:
        from ..elastic.driver import run_elastic

        if args.num_proc is None:
            args.num_proc = 1
        return run_elastic(command, args)
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
