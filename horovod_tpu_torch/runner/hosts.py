"""Host-list parsing and slot→rank assignment.

Reference: Horovod's runner/common/util/hosts.py — parse
``-H host1:4,host2:4`` (or a hostfile), produce per-slot assignments with
rank / local_rank / cross_rank triples (get_host_assignments, hosts.py:100).

A copy of ``horovod_tpu/runner/hosts.py``. In the port a slot is a worker
process driving one GPU, so ``slots`` is the number of GPUs a host runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts_str: str) -> list[HostInfo]:
    """Parse "host1:2,host2:4"; bare hostnames default to 1 slot."""
    out = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append(HostInfo(name, int(slots)))
        else:
            out.append(HostInfo(part, 1))
    return out


def parse_hostfile(path: str) -> list[HostInfo]:
    """mpirun-style hostfile: ``hostname slots=N`` per line."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=")[1])
            out.append(HostInfo(parts[0], slots))
    return out


def _expand_slurm_nodelist(nodelist: str) -> list[str]:
    """Expand SLURM's compressed node-list syntax
    (``node[001-003,007],login1`` → node001 node002 node003 node007
    login1), preserving zero padding."""
    import re

    parts: list[str] = []
    depth, cur = 0, ""
    for ch in nodelist:
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
            depth += ch == "["
            depth -= ch == "]"
    if cur:
        parts.append(cur)

    def expand_one(part: str) -> list[str]:
        # recurse on the suffix: a name may carry SEVERAL bracket groups
        # ("rack[1-2]n[1-4]" is valid SLURM compression)
        m = re.match(r"^(.*?)\[([^\]]+)\](.*)$", part)
        if not m:
            return [part] if part else []
        prefix, body, suffix = m.groups()
        tails = expand_one(suffix) or [""]
        out = []
        for item in body.split(","):
            if "-" in item:
                lo, hi = item.split("-", 1)
                width = len(lo)
                mids = [str(i).zfill(width)
                        for i in range(int(lo), int(hi) + 1)]
            else:
                mids = [item]
            for mid in mids:
                for tail in tails:
                    out.append(f"{prefix}{mid}{tail}")
        return out

    hosts: list[str] = []
    for part in parts:
        hosts.extend(expand_one(part))
    return hosts


def _expand_slurm_tasks_per_node(spec: str, n_nodes: int) -> list[int]:
    """Expand SLURM_TASKS_PER_NODE (``2(x3),1`` → [2, 2, 2, 1]); pad or
    trim to ``n_nodes`` (SLURM guarantees a match, but allocations edited
    by prolog scripts exist in the wild)."""
    import re

    counts: list[int] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        m = re.match(r"^(\d+)(?:\(x(\d+)\))?$", item)
        if not m:
            raise ValueError(f"unparseable SLURM_TASKS_PER_NODE item {item!r}")
        counts.extend([int(m.group(1))] * int(m.group(2) or 1))
    if len(counts) < n_nodes:
        counts += [counts[-1] if counts else 1] * (n_nodes - len(counts))
    return counts[:n_nodes]


def hosts_from_allocation(environ) -> list[HostInfo]:
    """Derive the host list from a scheduler allocation's environment
    (reference runner/js_run.py:1-146 + runner/util/lsf.py: horovodrun
    inside an LSF job reads the allocation instead of -H; here one
    ``--from-allocation`` flag covers LSF and SLURM).

    Precedence mirrors the reference's LSF helpers: the per-slot hostfile
    (LSB_DJOB_HOSTFILE) is ground truth, then LSB_MCPU_HOSTS, then
    LSB_HOSTS, then SLURM's nodelist + tasks-per-node."""
    path = environ.get("LSB_DJOB_HOSTFILE")
    if path:
        counts: dict[str, int] = {}
        with open(path) as f:
            for line in f:
                name = line.strip()
                if name:
                    counts[name] = counts.get(name, 0) + 1
        if counts:
            return [HostInfo(h, n) for h, n in counts.items()]

    mcpu = environ.get("LSB_MCPU_HOSTS")
    if mcpu:
        toks = mcpu.split()
        if len(toks) % 2:
            raise ValueError(f"malformed LSB_MCPU_HOSTS: {mcpu!r}")
        return [HostInfo(toks[i], int(toks[i + 1]))
                for i in range(0, len(toks), 2)]

    lsb_hosts = environ.get("LSB_HOSTS")
    if lsb_hosts:
        counts = {}
        for name in lsb_hosts.split():
            counts[name] = counts.get(name, 0) + 1
        return [HostInfo(h, n) for h, n in counts.items()]

    nodelist = environ.get("SLURM_JOB_NODELIST") or environ.get(
        "SLURM_NODELIST")
    if nodelist:
        names = _expand_slurm_nodelist(nodelist)
        tpn = environ.get("SLURM_TASKS_PER_NODE")
        if tpn:
            counts_l = _expand_slurm_tasks_per_node(tpn, len(names))
        else:
            per = int(environ.get("SLURM_NTASKS_PER_NODE", "1") or "1")
            counts_l = [per] * len(names)
        return [HostInfo(h, n) for h, n in zip(names, counts_l)]

    raise ValueError(
        "--from-allocation: no scheduler allocation found in the "
        "environment (looked for LSB_DJOB_HOSTFILE, LSB_MCPU_HOSTS, "
        "LSB_HOSTS, SLURM_JOB_NODELIST)")


def get_host_assignments(hosts: list[HostInfo], np: int,
                         min_np: Optional[int] = None) -> list[SlotInfo]:
    """Assign np worker slots across hosts (reference hosts.py:100):
    fill hosts in order; rank = global order, local_rank = index within
    host, cross_rank = index of the host among used hosts."""
    total = sum(h.slots for h in hosts)
    if np > total:
        if min_np is not None and min_np <= total:
            np = total
        else:
            raise ValueError(f"requested np={np} but only {total} slots available")
    slots: list[SlotInfo] = []
    rank = 0
    cross = 0
    for h in hosts:
        if rank >= np:
            break
        use = min(h.slots, np - rank)
        for lr in range(use):
            slots.append(SlotInfo(h.hostname, rank, np, lr, use, cross, 0))
            rank += 1
        cross += 1
    for s in slots:
        s.cross_size = cross
    return slots
