"""Run a pickled function across the rounds of the elastic driver —
counterpart of ``horovod_tpu/elastic/executor.py``.

``ElasticFunctionExecutor`` drives :class:`elastic.driver.ElasticDriver`
with one local worker process a slot that unpickles the function, runs it
and pickles its result; committed ``State`` snapshots
(``HOROVOD_ELASTIC_STORE``, under the executor's work directory by
default) carry progress across rounds. ``run`` returns the results of the
last round's ranks in rank order. The JAX package's Ray and Spark adapters
build on it and are not ported.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
from types import SimpleNamespace
from typing import Callable, Optional

from .discovery import HostDiscovery
from .driver import ElasticDriver, WorkerHandle, make_base_env_fn
from ..runner.hosts import SlotInfo


def _serializer():
    """cloudpickle when available (it sends ``__main__``-defined functions
    and lambdas by value), else pickle."""
    try:
        import cloudpickle

        return cloudpickle
    except ImportError:
        return pickle


class _SubprocessFnWorker(WorkerHandle):
    """Runs the pickled user function in a subprocess on this host."""

    def __init__(self, payload: str, out_path: str, env: dict):
        code = (
            "import pickle, sys\n"
            f"sys.path[:0] = {list(sys.path)!r}\n"
            f"fn, args, kwargs = pickle.load(open({payload!r}, 'rb'))\n"
            "res = fn(*args, **kwargs)\n"
            f"pickle.dump(res, open({out_path!r}, 'wb'))\n"
        )
        self._p = subprocess.Popen([sys.executable, "-c", code], env=env)

    def poll(self):
        return self._p.poll()

    def terminate(self):
        try:
            self._p.terminate()
        except ProcessLookupError:
            pass


class ElasticFunctionExecutor:
    """``create_settings`` → ``start()`` → ``run(fn)`` → rank-ordered
    results of the final successful round."""

    @staticmethod
    def create_settings(min_np: int = 1, max_np: Optional[int] = None,
                        reset_limit: Optional[int] = None, **kwargs):
        return SimpleNamespace(min_np=min_np, max_np=max_np,
                               reset_limit=reset_limit, **kwargs)

    def __init__(self, settings, discovery: HostDiscovery,
                 env_vars: Optional[dict] = None):
        self.settings = settings
        self.discovery = discovery
        self.env_vars = dict(env_vars or {})
        self.driver: Optional[ElasticDriver] = None

    def start(self):
        self.driver = ElasticDriver(
            self.discovery, min_np=self.settings.min_np,
            max_np=self.settings.max_np,
            reset_limit=getattr(self.settings, "reset_limit", None))

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> list:
        if self.driver is None:
            raise RuntimeError("call start() before run()")
        driver = self.driver
        workdir = tempfile.mkdtemp(prefix="hvd_elastic_fn_")
        payload = os.path.join(workdir, "fn.pkl")
        with open(payload, "wb") as f:
            _serializer().dump((fn, args, kwargs or {}), f)

        extra = dict(self.env_vars)
        extra.setdefault("HOROVOD_ELASTIC_STORE",
                         os.path.join(workdir, "state.pkl"))
        round_ranks: dict[int, list[int]] = {}

        # workers all run on this machine (one process per slot), so a
        # discovery hostname like a remote node IP must not leak into the
        # worker's identity
        base_env = make_base_env_fn(driver, extra,
                                    hostname_override="localhost")

        def create_worker(slot: SlotInfo, env: dict) -> WorkerHandle:
            ep = driver._epoch
            round_ranks.setdefault(ep, []).append(slot.rank)
            out = os.path.join(workdir, f"out.{ep}.{slot.rank}.pkl")
            return _SubprocessFnWorker(payload, out, env)

        rc = driver.run(create_worker, base_env)
        if rc != 0:
            raise RuntimeError(f"elastic run failed with exit code {rc}")
        final_ep = max(round_ranks)
        results = []
        for rank in sorted(round_ranks[final_ep]):
            out = os.path.join(workdir, f"out.{final_ep}.{rank}.pkl")
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results

    def shutdown(self):
        if self.driver is not None:
            self.driver.stop()
            self.driver = None
