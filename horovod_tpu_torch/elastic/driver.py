"""The elastic driver: membership, stable rank assignment, respawn —
counterpart of ``horovod_tpu/elastic/driver.py`` (the reference Horovod's
``runner/elastic/driver.py``).

The driver polls host discovery every second, assigns ranks so that the
surviving hosts keep their order (rank 0 stays on a survivor), starts one
worker a slot with the slot's environment (``runner/launch.py``
``slot_env``) plus ``HOROVOD_ELASTIC=1`` and the round's
``HOROVOD_ELASTIC_EPOCH``, and watches the workers:

- every worker exits 0: the job is done;
- a worker fails: its host takes a strike. Below
  ``HOROVOD_ELASTIC_RESPAWN_ATTEMPTS`` (default 1) strikes the host is
  retried in the next round after a full-jitter backoff scaled by
  ``HOROVOD_ELASTIC_RESPAWN_BACKOFF``; past it the host is blacklisted.
  A clean exit clears the host's strikes;
- discovery changes: a new round.

Before a new round the driver bumps the epoch, publishes it under
``elastic/epoch`` in its KV store (the workers' ``State`` watches it),
and ends the live workers: SIGTERM, the grace window
(``HOROVOD_PREEMPT_GRACE_S``, 15 s) for a checkpoint flush, then SIGKILL.
The new round's workers are new processes that resume from
``HOROVOD_ELASTIC_STORE``; the epoch is in the key under which rank 0
publishes its ``TCPStore``'s port, so no new rank dials a dead store. A
failed collective inside a process is recovered there instead
(``elastic/__init__.py`` ``run``).

The driver's series: ``hvd_elastic_ranks_added_total``,
``_ranks_removed_total``, ``_resets_total``, ``_worker_failures_total``,
``_respawns_total``, ``_blacklists_total``, and the gauges
``hvd_elastic_epoch`` and ``hvd_elastic_world_size``.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import threading
import time
from typing import Callable, Optional

from ..common import env as env_schema
from ..runner.hosts import HostInfo, SlotInfo, get_host_assignments
from ..runner.http_server import RendezvousServer
from ..utils import faults as faults_mod
from ..utils import metrics as metrics_mod
from ..utils import retry as retry_mod
from .discovery import HostDiscoveryScript, HostManager
from .registration import FAILURE, SUCCESS, WorkerStateRegistry

LOG = logging.getLogger("horovod_tpu_torch")

DISCOVER_INTERVAL_S = 1.0


class WorkerHandle:
    """A worker's process handle (test doubles use threads)."""

    def poll(self) -> Optional[int]:
        raise NotImplementedError

    def terminate(self):
        raise NotImplementedError

    def kill(self):
        """Hard stop; handles with no harder signal terminate."""
        self.terminate()


class _SubprocessWorker(WorkerHandle):
    def __init__(self, popen: subprocess.Popen, stream_threads=()):
        self.popen = popen
        self._streams = list(stream_threads)

    def poll(self):
        rc = self.popen.poll()
        if rc is not None and self._streams:
            # the tee files hold the whole output before the driver acts,
            # so a respawned incarnation never interleaves with this one
            for t in self._streams:
                t.join(timeout=10)
                if t.is_alive():
                    LOG.warning(
                        "worker output stream still open 10 s after exit "
                        "(a child holding the pipe?); the tee file may "
                        "interleave with the next incarnation")
            self._streams = []
        return rc

    def terminate(self):
        try:
            self.popen.send_signal(signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self):
        try:
            self.popen.kill()
        except ProcessLookupError:
            pass


class ElasticDriver:
    """Round-based elastic driver with respawn-before-blacklist (module
    docstring)."""

    def __init__(self, discovery, min_np: int, max_np: Optional[int] = None,
                 reset_limit: Optional[int] = None,
                 respawn_retries: Optional[int] = None,
                 respawn_backoff_s: Optional[float] = None):
        self.host_manager = HostManager(discovery)
        self.min_np = min_np
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.respawn_retries = (
            respawn_retries if respawn_retries is not None
            else env_schema.get_int(
                env_schema.HOROVOD_ELASTIC_RESPAWN_ATTEMPTS, 1))
        self.respawn_backoff_s = (
            respawn_backoff_s if respawn_backoff_s is not None
            else env_schema.get_float(
                env_schema.HOROVOD_ELASTIC_RESPAWN_BACKOFF, 1.0))
        self.registry = WorkerStateRegistry()
        self.rendezvous = RendezvousServer()
        self.current_slots: list[SlotInfo] = []
        self._prev_host_order: list[str] = []
        self._prev_slot_ranks: set[int] = set()
        self._host_strikes: dict[str, int] = {}
        self._epoch = 0
        self._resets = 0
        self._stop = threading.Event()
        reg = metrics_mod.get_registry()
        self._m_rank_added = reg.counter(
            "hvd_elastic_ranks_added_total",
            "worker ranks added across elastic rounds")
        self._m_rank_removed = reg.counter(
            "hvd_elastic_ranks_removed_total",
            "worker ranks removed across elastic rounds")
        self._m_resets = reg.counter(
            "hvd_elastic_resets_total",
            "elastic resets (membership change or worker failure)")
        self._m_failures = reg.counter(
            "hvd_elastic_worker_failures_total",
            "worker processes that exited nonzero")
        self._m_respawns = reg.counter(
            "hvd_elastic_respawns_total",
            "failed hosts retried (respawn-before-blacklist)")
        self._m_blacklists = reg.counter(
            "hvd_elastic_blacklists_total",
            "hosts blacklisted after exhausting their respawn budget")
        self._m_epoch = reg.gauge("hvd_elastic_epoch",
                                  "current elastic incarnation")
        self._m_world = reg.gauge("hvd_elastic_world_size",
                                  "slots assigned in the current round")

    # -- assignments ---------------------------------------------------------
    def compute_assignments(self) -> list[SlotInfo]:
        """Stable assignment: the surviving hosts keep their order (rank 0
        stays on a survivor, whose state the others take), new hosts
        follow in sorted order."""
        hosts = self.host_manager.current_hosts
        if self._prev_host_order and not any(
                h in hosts for h in self._prev_host_order):
            raise RuntimeError(
                "no hosts from the previous round survive; cannot recover "
                "state")
        order = [h for h in self._prev_host_order if h in hosts]
        order += sorted(h for h in hosts if h not in order)
        np_avail = sum(hosts[h] for h in order)
        np = min(np_avail, self.max_np) if self.max_np else np_avail
        if np < self.min_np:
            raise RuntimeError(
                f"available slots {np_avail} < min_np {self.min_np}")
        slots = get_host_assignments([HostInfo(h, hosts[h]) for h in order],
                                     np)
        self._prev_host_order = order
        ranks = {s.rank for s in slots}
        self._m_rank_added.inc(len(ranks - self._prev_slot_ranks))
        self._m_rank_removed.inc(len(self._prev_slot_ranks - ranks))
        self._prev_slot_ranks = ranks
        self._m_world.set(len(slots))
        return slots

    # -- epoch ---------------------------------------------------------------
    def publish_epoch(self):
        from ..runner.http_server import KVStoreClient

        client = KVStoreClient("127.0.0.1", self.rendezvous.port)
        client.put("elastic", "epoch", str(self._epoch).encode())

    def bump_epoch(self):
        self._epoch += 1
        self._m_epoch.set(self._epoch)
        self.publish_epoch()

    # -- main loop -----------------------------------------------------------
    def run(self, create_worker: Callable[[SlotInfo, dict], WorkerHandle],
            base_env_fn: Callable[[SlotInfo], dict]) -> int:
        """Rounds of launch and watch until every worker of a round exits
        0 or recovery is impossible. Returns the job's exit code."""
        self.rendezvous.start()
        self.host_manager.update_available_hosts()
        self.publish_epoch()
        while not self._stop.is_set():
            try:
                slots = self.compute_assignments()
            except RuntimeError as e:
                LOG.error("elastic: %s", e)
                return 1
            # the round's whole assignment, for per-slot environments that
            # need cross-slot facts (make_base_env_fn)
            self.current_slots = slots
            self.registry.reset()
            workers: dict[int, tuple[SlotInfo, WorkerHandle]] = {}
            spawn_failed = None  # (slot, exception)
            for slot in slots:
                env = base_env_fn(slot)
                env[env_schema.HOROVOD_ELASTIC_EPOCH] = str(self._epoch)
                env[env_schema.HOROVOD_ELASTIC] = "1"
                try:
                    faults_mod.fault_point("elastic.spawn")
                    workers[slot.rank] = (slot, create_worker(slot, env))
                except Exception as e:
                    # a refused SSH or a missing binary counts as a failure
                    # of the worker on that host
                    spawn_failed = (slot, e)
                    break
            if spawn_failed is not None:
                slot, e = spawn_failed
                self._terminate(workers)
                rc = self._host_failure(slot, f"spawn failed: {e!r}")
            else:
                rc = self._monitor_round(workers)
            if rc is not None:
                return rc
            if (self.reset_limit is not None
                    and self._resets >= self.reset_limit):
                LOG.error("elastic: reset limit %d reached", self.reset_limit)
                return 1
        return 0

    def _monitor_round(self, workers) -> Optional[int]:
        """None: start a new round; an int: the job's exit code."""
        last_discovery = 0.0
        alive = dict(workers)
        failed: Optional[tuple[SlotInfo, int]] = None
        while alive:
            now = time.monotonic()
            if now - last_discovery >= DISCOVER_INTERVAL_S:
                last_discovery = now
                try:
                    faults_mod.fault_point("elastic.heartbeat")
                    changed = self.host_manager.update_available_hosts()
                except faults_mod.FaultInjectedError:
                    changed = False  # a skipped heartbeat delays detection
                if changed:
                    LOG.info("elastic: host membership changed; resetting")
                    self._resets += 1
                    self._m_resets.inc()
                    self.bump_epoch()
                    self._terminate(alive)
                    return None
            for rank in list(alive):
                slot, h = alive[rank]
                rc = h.poll()
                if rc is None:
                    continue
                del alive[rank]
                if rc == 0:
                    self.registry.record(f"{slot.hostname}:{slot.local_rank}",
                                         SUCCESS)
                    # a clean exit proves the host healthy
                    self._host_strikes.pop(slot.hostname, None)
                else:
                    self.registry.record(f"{slot.hostname}:{slot.local_rank}",
                                         FAILURE)
                    failed = (slot, rc)
                    break
            if failed:
                slot, rc = failed
                self._terminate(alive)
                return self._host_failure(slot, f"exited with code {rc}")
            time.sleep(0.05)
        return 0

    def _host_failure(self, slot: SlotInfo, what: str) -> Optional[int]:
        """Strike the failed slot's host: respawn it after a backoff while
        its budget lasts, else blacklist it. None: a new round; an int:
        the job's exit code."""
        host = slot.hostname
        self._m_failures.inc()
        strikes = self._host_strikes.get(host, 0) + 1
        self._host_strikes[host] = strikes
        budget = self.respawn_retries
        if strikes > budget:
            decision = (
                "blacklisting (first strike; respawn retries disabled)"
                if budget == 0 else
                f"blacklisting (respawn retries exhausted: "
                f"{strikes - 1}/{budget})")
            delay = 0.0
            self.host_manager.blacklist(host)
            self._m_blacklists.inc()
        else:
            # full jitter, so hosts that failed together do not come back
            # in lockstep
            delay = retry_mod.RetryPolicy(
                base_delay_s=self.respawn_backoff_s,
                max_delay_s=max(self.respawn_backoff_s, 30.0),
            ).backoff_delay(strikes)
            decision = (f"respawning before blacklist "
                        f"(attempt {strikes}/{budget}, "
                        f"backoff {delay:.1f}s)")
            self._m_respawns.inc()
        LOG.warning(
            "elastic: worker rank %d (slot %s:%d) %s; %s",
            slot.rank, host, slot.local_rank, what, decision)
        self._resets += 1
        self._m_resets.inc()
        self.bump_epoch()
        if self.host_manager.available_slots() < self.min_np:
            return 1
        if delay > 0:
            self._stop.wait(delay)  # stop() cuts the backoff short
        return None

    def _terminate(self, alive):
        """SIGTERM every live worker, wait out the grace window
        (``HOROVOD_PREEMPT_GRACE_S``) for checkpoint flushes, then SIGKILL
        the stragglers, logging each with its rank and elapsed time."""
        start = time.monotonic()
        for slot, h in alive.values():
            h.terminate()
        grace = env_schema.get_float(env_schema.HOROVOD_PREEMPT_GRACE_S,
                                     15.0)
        deadline = start + grace
        for slot, h in alive.values():
            while h.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            elapsed = time.monotonic() - start
            if h.poll() is None:
                LOG.warning(
                    "elastic: worker rank %d did not exit within the "
                    "%.1fs grace window after SIGTERM (%.1fs elapsed); "
                    "escalating to SIGKILL", slot.rank, grace, elapsed)
                h.kill()
            else:
                LOG.info(
                    "elastic: worker rank %d exited %.1fs after SIGTERM "
                    "(grace window %.1fs)", slot.rank, elapsed, grace)
        alive.clear()

    def stop(self):
        self._stop.set()
        self.rendezvous.stop()


def make_base_env_fn(driver: ElasticDriver, extra: dict,
                     hostname_override: Optional[str] = None,
                     network_interface: Optional[str] = None):
    """Each slot's environment for the driver's current round: the KV
    store's address routable from the round's remote hosts (127.0.0.1
    when every slot is local; ``network_interface`` pins the NIC), and
    rank 0's host as ``MASTER_ADDR`` (its ``TCPStore`` port is published
    through the KV store under the round's epoch, unless the user's
    ``MASTER_PORT`` is set)."""
    from ..runner.launch import slot_env
    from ..runner.network import is_local_host, pick_coordinator_address

    by_epoch: dict[int, tuple[str, str]] = {}

    def base_env(slot: SlotInfo) -> dict:
        ep = driver._epoch
        if ep not in by_epoch:
            slots = driver.current_slots or [slot]
            remote = sorted({s.hostname for s in slots
                             if not is_local_host(s.hostname)})
            if remote:
                addr, _ = pick_coordinator_address(
                    remote, iface_override=network_interface
                    or os.environ.get(env_schema.HOROVOD_GLOO_IFACE))
            else:
                addr = "127.0.0.1"
            s0 = next((s for s in slots if s.rank == 0), slot)
            store_host = (addr if is_local_host(s0.hostname)
                          else s0.hostname)
            by_epoch[ep] = (addr, f"{store_host}:"
                            f"{os.environ.get(env_schema.MASTER_PORT, '')}")
        addr, coordinator = by_epoch[ep]
        e = slot_env(slot, addr, driver.rendezvous.port, coordinator, extra)
        if hostname_override is not None:
            e[env_schema.HOROVOD_HOSTNAME] = hostname_override
        return e

    return base_env


def run_elastic(command: list[str], args) -> int:
    """``hvdrun``'s elastic mode (reference ``launch.py`` ``_run_elastic``).
    Returns the job's exit code."""
    import tempfile
    import uuid

    from ..runner.launch import _knob_env, _output_threads, build_ssh_command
    from ..runner.network import is_local_host
    from ..runner.secret import get_or_mint_env_secret

    if not args.host_discovery_script:
        raise SystemExit("elastic mode requires --host-discovery-script")
    # the secret must be in the environment before the driver's store
    # starts: the store reads it there, and every slot's environment
    # carries it through every incarnation
    get_or_mint_env_secret()
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    default_slots=args.slots_per_host)
    driver = ElasticDriver(discovery, min_np=args.min_np or 1,
                           max_np=args.max_np)
    extra = _knob_env(args)
    # the committed state a relaunched worker resumes from, unless the
    # caller's environment names one: one path string, resolved on each
    # host's own filesystem (stable assignment keeps rank 0, whose state
    # the others take, on a survivor)
    if not os.environ.get(env_schema.HOROVOD_ELASTIC_STORE):
        extra.setdefault(
            env_schema.HOROVOD_ELASTIC_STORE,
            os.path.join(tempfile.gettempdir(),
                         f"hvd_elastic_{uuid.uuid4().hex[:8]}.pkl"))
    base_env = make_base_env_fn(
        driver, extra,
        network_interface=getattr(args, "network_interface", None))
    out_dir = getattr(args, "output_filename", None)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    teed_ranks: set[int] = set()

    def create_worker(slot: SlotInfo, env: dict) -> WorkerHandle:
        if is_local_host(slot.hostname):
            cmd = command
        else:
            cmd = build_ssh_command(
                slot.hostname, command, env,
                ssh_port=getattr(args, "ssh_port", None),
                ssh_identity_file=getattr(args, "ssh_identity_file", None))
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        first = slot.rank not in teed_ranks
        teed_ranks.add(slot.rank)
        return _SubprocessWorker(p, _output_threads(
            p, slot.rank, out_dir, first_incarnation=first))

    try:
        return driver.run(create_worker, base_env)
    finally:
        driver.stop()
