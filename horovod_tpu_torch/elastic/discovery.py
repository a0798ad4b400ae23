"""Host discovery and the blacklist for elastic training — a copy of
``horovod_tpu/elastic/discovery.py`` (the reference Horovod's
``runner/elastic/discovery.py``): a ``HostDiscovery`` interface, the
``--host-discovery-script`` implementation (``host`` or ``host:slots``
lines on its stdout), fixed hosts, and ``HostManager`` with its blacklist.
In the port a slot is one worker process driving one GPU.
"""

from __future__ import annotations

import subprocess
import threading
from ..runner.hosts import HostInfo


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> dict[str, int]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Run the --host-discovery-script; stdout lines are ``host`` or
    ``host:slots``."""

    def __init__(self, script: str, default_slots: int = 1):
        self.script = script
        self.default_slots = default_slots

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        out = subprocess.run([self.script], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        hosts: dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                h, s = line.rsplit(":", 1)
                hosts[h] = int(s)
            else:
                hosts[line] = self.default_slots
        return hosts


class FixedHosts(HostDiscovery):
    def __init__(self, hosts: dict[str, int]):
        self._hosts = dict(hosts)

    def set(self, hosts: dict[str, int]):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        return dict(self._hosts)


class HostManager:
    """Tracks the current and the blacklisted hosts."""

    def __init__(self, discovery: HostDiscovery):
        self._discovery = discovery
        self._lock = threading.Lock()
        self._blacklist: set[str] = set()
        self._current: dict[str, int] = {}

    @property
    def current_hosts(self) -> dict[str, int]:
        with self._lock:
            return {h: s for h, s in self._current.items()
                    if h not in self._blacklist}

    def blacklist(self, host: str):
        """Exclude ``host`` from every later assignment."""
        with self._lock:
            self._blacklist.add(host)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._blacklist

    def update_available_hosts(self) -> bool:
        """Poll discovery; True if the usable membership changed."""
        found = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            prev = {h: s for h, s in self._current.items()
                    if h not in self._blacklist}
            self._current = found
            now = {h: s for h, s in found.items() if h not in self._blacklist}
            return prev != now

    def available_slots(self) -> int:
        return sum(self.current_hosts.values())
