"""Environment knobs the port reads — the subset of
``horovod_tpu/common/env.py`` that this slice needs, under the same names,
so a launcher sets one environment for either package.
"""

from __future__ import annotations

import os

# worker identity (the set the reference's launcher injects per slot)
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"

# torch.distributed rendezvous (a TCPStore on rank 0) under a launcher
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"


def get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default
