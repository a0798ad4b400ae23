"""Coordinator-address selection for multi-host launches.

Reference: Horovod's runner/driver/driver_service.py:162-258
(``_driver_fn`` / ``get_common_interfaces``) — there the launcher SSHes a
task service onto every host, each task registers its NICs, and the
driver computes the intersection of mutually routable interfaces. The
TPU redesign is launcher-side and connectionless: for every remote
worker host, a UDP ``connect`` (no packet sent) asks the kernel's
routing table which local source address would reach it —
``getsockname`` after connect is the route lookup. One address reaching
every worker is the coordinator address; disagreement (multi-NIC,
split-horizon routes) triggers a warning naming the candidates and the
``--network-interface`` override (reference launch.py:275 ``--nics``).
"""

from __future__ import annotations

import logging
import socket
import struct
from typing import Optional, Sequence, Tuple

LOG = logging.getLogger("horovod_tpu_torch")

LOCAL_NAMES = ("localhost", "127.0.0.1", "::1")


_identity_cache: Optional[tuple] = None
_is_local_cache: dict = {}


def _local_identity() -> tuple:
    """(own names, own addresses) — cached once per process on SUCCESS:
    the launcher and the elastic driver call is_local_host in per-slot
    loops every (re)discovery cycle, and blocking DNS work there
    multiplies. A transient resolution failure is NOT cached (early-boot
    DNS would otherwise poison the whole process lifetime)."""
    global _identity_cache
    if _identity_cache is not None:
        return _identity_cache
    ok = True
    names = {socket.gethostname()}
    try:
        names.add(socket.getfqdn())
    except OSError:
        ok = False
    addrs = {"127.0.0.1", "::1"}
    try:
        addrs.update(ai[4][0] for ai in socket.getaddrinfo(
            socket.gethostname(), None))
    except OSError:
        ok = False
    result = (frozenset(names), frozenset(addrs))
    if ok:
        _identity_cache = result
    return result


def is_local_host(hostname: str) -> bool:
    """True when ``hostname`` names this machine — shortname, FQDN, or a
    loopback literal. Matching the FQDN matters operationally: a
    ``-H <local-fqdn>:N`` job must exec its slots directly, not SSH to
    itself (and must not run the remote route probe at all). Verdicts
    are memoized per process, except ones derived from a failed DNS
    lookup (transient — must stay retryable)."""
    if hostname in LOCAL_NAMES:
        return True
    cached = _is_local_cache.get(hostname)
    if cached is not None:
        return cached
    names, local_addrs = _local_identity()
    if hostname in names:
        _is_local_cache[hostname] = True
        return True
    try:
        # last resort: does the name resolve to one of our own addresses?
        addrs = {ai[4][0] for ai in socket.getaddrinfo(hostname, None)}
    except OSError:
        return False  # transient failure: do not cache
    verdict = bool(addrs & local_addrs)
    if len(_is_local_cache) < 4096:
        _is_local_cache[hostname] = verdict
    return verdict


def interface_address(ifname: str) -> str:
    """IPv4 address bound to ``ifname`` (Linux SIOCGIFADDR ioctl — the
    stdlib has no interface->address map).

    IPv4-only by construction: SIOCGIFADDR has no AF_INET6 variant, so
    an IPv6-only NIC raises the ValueError below naming the limitation
    (workers on v6-only fabrics should pass a literal coordinator
    address instead of --network-interface)."""
    import fcntl

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        packed = struct.pack("256s", ifname[:15].encode())
        return socket.inet_ntoa(
            fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24])  # SIOCGIFADDR
    except OSError as e:
        raise ValueError(
            f"--network-interface {ifname!r}: cannot read an IPv4 address "
            f"({e.strerror or e}); check the interface name with `ip -4 "
            "addr` (note: IPv6-only interfaces are not supported here — "
            "pass the coordinator address explicitly instead)") from e
    finally:
        s.close()


def source_address_for(host: str, port: int = 9) -> Optional[str]:
    """The local source address the kernel would route toward ``host``
    (UDP connect performs the route lookup without sending anything)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((host, port))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return None


def pick_coordinator_address(
        remote_hosts: Sequence[str],
        iface_override: Optional[str] = None) -> Tuple[str, bool]:
    """The address workers should dial for the rendezvous/coordinator.

    Returns ``(address, ambiguous)``; ``ambiguous`` is True when remote
    hosts route through different local addresses and the majority pick
    may be wrong for some of them (the warning advises the override).
    """
    if iface_override:
        addr = interface_address(iface_override)
        LOG.info("coordinator address %s from --network-interface %s",
                 addr, iface_override)
        return addr, False
    votes: dict[str, list[str]] = {}
    unresolved = []
    for h in remote_hosts:
        src = source_address_for(h)
        if src is None:
            unresolved.append(h)
            continue
        votes.setdefault(src, []).append(h)
    if not votes:
        # nothing resolved (names not in DNS yet, say): last resort is the
        # historical behavior — the launcher's FQDN
        LOG.warning(
            "could not resolve a route to any of %s; falling back to this "
            "host's FQDN for the coordinator address (override with "
            "--network-interface)", list(remote_hosts))
        return socket.getfqdn(), True
    best = max(votes, key=lambda a: len(votes[a]))
    ambiguous = len(votes) > 1 or bool(unresolved)
    if ambiguous:
        LOG.warning(
            "workers route through different local addresses (%s%s); using "
            "%s — if some workers cannot reach it, pass "
            "--network-interface <ifname> to pin the coordinator NIC "
            "(reference get_common_interfaces, driver_service.py:218)",
            {a: hs for a, hs in votes.items()},
            f"; unresolved: {unresolved}" if unresolved else "",
            best)
    return best, ambiguous
