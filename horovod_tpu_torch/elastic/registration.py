"""Worker state registry — a copy of ``horovod_tpu/elastic/registration.py``
(the reference Horovod's ``runner/elastic/registration.py``): READY,
SUCCESS and FAILURE counted per rendezvous round, which the elastic
driver's respawn and blacklist decisions read.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, verbose: bool = False):
        self._lock = threading.Condition()
        self._rounds: dict[int, dict[str, str]] = {}
        self._round = 0

    @property
    def round(self) -> int:
        return self._round

    def reset(self, new_round: Optional[int] = None):
        with self._lock:
            self._round = self._round + 1 if new_round is None else new_round
            self._rounds.setdefault(self._round, {})
            self._lock.notify_all()

    def record(self, worker: str, state: str, round_: Optional[int] = None):
        with self._lock:
            r = self._round if round_ is None else round_
            self._rounds.setdefault(r, {})[worker] = state
            self._lock.notify_all()

    def count(self, state: str, round_: Optional[int] = None) -> int:
        with self._lock:
            r = self._round if round_ is None else round_
            return sum(1 for s in self._rounds.get(r, {}).values() if s == state)

    def workers_in(self, state: str, round_: Optional[int] = None) -> list[str]:
        with self._lock:
            r = self._round if round_ is None else round_
            return sorted(w for w, s in self._rounds.get(r, {}).items()
                          if s == state)

    def wait_for(self, state: str, n: int, timeout: float = 30.0) -> bool:
        """Block until >= n workers report ``state`` this round."""
        end = time.monotonic() + timeout
        with self._lock:
            while self.count_unlocked(state) < n:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(remaining)
            return True

    def count_unlocked(self, state: str) -> int:
        return sum(1 for s in self._rounds.get(self._round, {}).values()
                   if s == state)
