"""The joint online autotuner (``HOROVOD_AUTOTUNE``) — a copy of
``horovod_tpu/utils/autotune.py`` (reference ``parameter_manager``,
``bayesian_optimization.cc``, ``gaussian_process.cc``): Bayesian
optimization, a Gaussian process and expected improvement, over the
runtime's knobs, with each proposal carried to every rank by the
coordinator so all ranks run the same knobs at the same round.

The search space (``build_space``) holds the knobs the runtime can set:

- ``fusion``: the fusion threshold in bytes (log2, 1 to 256 MiB);
- ``cycle``: the cycle time in ms (log2, 0.5 to 25);
- ``hier_ar``/``hier_ag``: the hierarchical allreduce and allgather flags,
  on a card or at one rank;
- ``chunk``: the most tensors a fused chunk (0: bytes only;
  ``HOROVOD_PLAN_CHUNK_TENSORS``);
- ``compression``: the wire, none|bf16|int8|int4, at more than one rank
  and without the sharded update;
- ``hier_group``: the negotiation group size, under
  ``HOROVOD_HIER_NEGOTIATION``.

The JAX package's ``ring_slots`` knob is left out, as its own
``build_space`` leaves it out for a runtime without the setter: the port
has one fusion buffer. Where the JAX package counts processes
(``cross_size``), the port counts ranks (``size``): a port rank is a GPU,
and four GPUs in one box are one host but four contributions.

Categorical knobs are one-hot blocks that the GP sees only snapped; a UCB
bandit over one-knob-at-a-time arms explores first. The score is the perf
ledger's goodput (``PerfLedger.window_score``) when the ledger is on, else
bytes a second. A proposal goes to the coordinator
(``KVController.submit_params``), rides the next response and is applied
by every rank at its receipt (``BackgroundRuntime._apply_tuned_params``);
a world of one, which has no controller, applies it at once. A candidate
that regresses the score by ``HOROVOD_AUTOTUNE_REVERT_PCT`` percent for
``HOROVOD_AUTOTUNE_REVERT_WINDOWS`` windows is reverted to the best one
and penalized; a lasting change of the cycles' tensor signature restarts
the search; the winner persists to ``HOROVOD_AUTOTUNE_TUNED_FILE``
(either package reads the other's file).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
import zlib
from typing import Optional

import numpy as np

from . import faults as faults_mod
from . import flightrec as flightrec_mod
from . import lockcheck
from . import metrics as metrics_mod

LOG = logging.getLogger("horovod_tpu_torch")

#: compression mode -> the bits value the hvd_autotune_compression_bits
#: gauge publishes (0 = uncompressed wire)
_COMP_BITS = {"none": 0, "bf16": 16, "int8": 8, "int4": 4}

#: consecutive sample windows a NEW dominant workload signature must
#: persist before the search restarts — debounces runs whose tensor
#: names legitimately vary cycle-to-cycle
SHIFT_WINDOWS = 3

TUNED_FILE_VERSION = 1


# ===========================================================================
# Search space: mixed continuous / categorical knobs over [0,1]^d
# ===========================================================================

class Knob:
    """One tuned parameter: a named slice of the normalized vector."""

    dims = 1

    def __init__(self, name: str):
        self.name = name


class LogKnob(Knob):
    """Continuous knob searched in log2 space (1 dim)."""

    def __init__(self, name: str, lo: float, hi: float,
                 integer: bool = False):
        super().__init__(name)
        self.lo = math.log2(lo)
        self.hi = math.log2(hi)
        self.integer = integer

    def decode(self, seg):
        t = min(max(float(seg[0]), 0.0), 1.0)
        v = 2.0 ** (self.lo + t * (self.hi - self.lo))
        return int(round(v)) if self.integer else float(v)

    def encode(self, value):
        v = math.log2(max(float(value), 1e-9))
        return [min(max((v - self.lo) / (self.hi - self.lo), 0.0), 1.0)]


class BoolKnob(Knob):
    """Binary knob relaxed to one thresholded dim (the reference's
    categorical handling for the hierarchical flags)."""

    def decode(self, seg):
        return bool(float(seg[0]) >= 0.5)

    def encode(self, value):
        return [0.75 if value else 0.25]


class ChoiceKnob(Knob):
    """Categorical knob as a one-hot block (argmax decode)."""

    def __init__(self, name: str, choices):
        super().__init__(name)
        self.choices = tuple(choices)
        self.dims = len(self.choices)

    def decode(self, seg):
        return self.choices[int(np.argmax(np.asarray(seg, float)))]

    def encode(self, value):
        seg = [0.0] * self.dims
        if value in self.choices:
            idx = self.choices.index(value)
        elif isinstance(value, (int, float)):
            # out-of-menu runtime value (e.g. a hand-set env knob): snap
            # to the nearest choice rather than failing the sample loop
            idx = int(np.argmin([abs(float(c) - float(value))
                                 for c in self.choices]))
        else:
            raise ValueError(f"{self.name}: {value!r} not in {self.choices}")
        seg[idx] = 1.0
        return seg


class SearchSpace:
    """Ordered knob set <-> normalized vector in [0,1]^dims."""

    def __init__(self, knobs):
        self.knobs = tuple(knobs)
        self.offsets = {}
        off = 0
        for k in self.knobs:
            self.offsets[k.name] = off
            off += k.dims
        self.dims = off

    def to_params(self, x) -> dict:
        x = np.asarray(x, float)
        out = {}
        for k in self.knobs:
            off = self.offsets[k.name]
            out[k.name] = k.decode(x[off:off + k.dims])
        return out

    def from_params(self, params: dict) -> np.ndarray:
        segs = []
        for k in self.knobs:
            segs.extend(k.encode(params[k.name]))
        return np.asarray(segs, float)

    def snap(self, x) -> np.ndarray:
        """Clip to [0,1] and collapse every one-hot block to a pure
        one-hot — the only encodings the GP is ever fit on or queried at,
        so categorical blocks stay on the feasible manifold."""
        x = np.clip(np.asarray(x, float), 0.0, 1.0)
        for k in self.knobs:
            if isinstance(k, ChoiceKnob):
                off = self.offsets[k.name]
                block = x[off:off + k.dims]
                hot = int(np.argmax(block))
                block[:] = 0.0
                block[hot] = 1.0
        return x

    def snap_rows(self, rows) -> np.ndarray:
        return np.stack([self.snap(r) for r in np.asarray(rows, float)])

    def arms(self):
        """The bandit's one-knob-at-a-time arms: every (knob, choice)
        over the categorical/boolean knobs."""
        out = []
        for k in self.knobs:
            if isinstance(k, ChoiceKnob):
                out.extend((k.name, i) for i in range(k.dims))
            elif isinstance(k, BoolKnob):
                out.extend((k.name, i) for i in (0, 1))
        return out

    def set_arm(self, x, arm):
        name, i = arm
        off = self.offsets[name]
        for k in self.knobs:
            if k.name == name:
                if isinstance(k, ChoiceKnob):
                    x[off:off + k.dims] = 0.0
                    x[off + i] = 1.0
                else:
                    x[off] = 0.75 if i else 0.25
                return
        raise KeyError(name)

    def continuous_offsets(self):
        return [self.offsets[k.name] for k in self.knobs
                if isinstance(k, LogKnob)]


def build_space(runtime, config=None) -> SearchSpace:
    """The joint space for one runtime: a knob appears only where it
    applies and is legal. ``size`` counts the contributions (a rank is a
    GPU), where the JAX package reads ``cross_size``. The hierarchical
    flags need collectives across processes that gloo on the CPU cannot
    run at more than one rank; the wire needs more than one rank and no
    sharded update; the group size a hierarchical controller."""
    knobs = [
        LogKnob("fusion", 1 << 20, 256 << 20, integer=True),
        LogKnob("cycle", 0.5, 25.0),
    ]
    ps = getattr(runtime, "process_set", None)
    size = int(getattr(ps, "size", 1) or 1) if ps is not None else 1
    device = getattr(runtime, "device", None)
    backend = getattr(device, "type", "cpu")
    if size <= 1 or backend != "cpu":
        knobs.append(BoolKnob("hier_ar"))
        knobs.append(BoolKnob("hier_ag"))
    if hasattr(runtime, "set_plan_chunk_tensors"):
        knobs.append(ChoiceKnob("chunk", (0, 2, 4, 8, 16)))
    if (hasattr(runtime, "set_compression_spec") and size > 1
            and not getattr(runtime, "_sharded_update", False)):
        knobs.append(ChoiceKnob("compression",
                                ("none", "bf16", "int8", "int4")))
    ctl = getattr(runtime, "controller", None)
    if (ctl is not None and getattr(ctl, "_hier", False)
            and hasattr(ctl, "set_group_size")):
        size = int(getattr(ctl, "size", 2))
        choices = tuple(sorted({min(k, size) for k in (2, 4, 8, 16, 32)}))
        knobs.append(ChoiceKnob("hier_group", choices))
    return SearchSpace(knobs)


# ===========================================================================
# Surrogate + acquisition
# ===========================================================================

class _GP:
    """Minimal RBF-kernel Gaussian process (reference gaussian_process.cc
    role), inputs normalized to [0,1]^d. ``fit`` retries the Cholesky with
    escalating jitter — duplicate observations (a penalized candidate is
    re-observed at its own x) make the plain kernel matrix singular."""

    def __init__(self, length_scale: float = 0.25, noise: float = 1e-3):
        self.ls = length_scale
        self.noise = noise
        self._X: Optional[np.ndarray] = None
        self._alpha = None
        self._L = None

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray):
        self._X = X
        K = self._k(X, X)
        noise = self.noise
        err = None
        for _ in range(8):
            try:
                self._L = np.linalg.cholesky(K + noise * np.eye(len(X)))
                err = None
                break
            except np.linalg.LinAlgError as e:
                err = e
                noise *= 10.0
        if err is not None:
            raise err
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y))

    def predict(self, Xs: np.ndarray):
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu, np.sqrt(var)


def _expected_improvement(mu, sigma, best, xi: float = 0.01):
    """EI acquisition (reference bayesian_optimization.cc:ExpectedImprovement
    semantics, original formula implementation)."""
    z = (mu - best - xi) / sigma
    # standard normal pdf/cdf without scipy
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
    return (mu - best - xi) * cdf + sigma * pdf


def _argmax_tiebreak(ei, mu) -> int:
    """Deterministic acquisition argmax: EI ties (common when the
    surrogate is flat — every candidate far from data has the same EI)
    break on the posterior mean, then on index."""
    ei = np.round(np.asarray(ei, float), 12)
    top = np.flatnonzero(ei == ei.max())
    if len(top) == 1:
        return int(top[0])
    return int(top[int(np.argmax(np.asarray(mu, float)[top]))])


class BayesianOptimizer:
    """Propose points in normalized [0,1]^d maximizing EI. With a
    ``space``, categorical blocks are snapped to feasible one-hots and
    the first ``n_random`` proposals come from a UCB bandit over
    one-knob-at-a-time arms around the incumbent (the small-sample phase
    where a GP posterior is meaningless); without one, the legacy
    uniform-exploration behavior is preserved. Fully deterministic for a
    fixed seed and observation sequence."""

    def __init__(self, dims: int = 2, n_random: int = 4, seed: int = 0,
                 space: Optional[SearchSpace] = None):
        self.dims = dims
        self.n_random = n_random
        self.rng = np.random.RandomState(seed)
        self.space = space
        self.X: list[np.ndarray] = []
        self.y: list[float] = []
        self._arms = space.arms() if space is not None else []
        self._arm_n: dict = {}
        self._arm_sum: dict = {}
        self._last_arm = None

    def observe(self, x: np.ndarray, score: float):
        self.X.append(np.asarray(x, float))
        self.y.append(float(score))
        if self._last_arm is not None:
            a, self._last_arm = self._last_arm, None
            self._arm_n[a] = self._arm_n.get(a, 0) + 1
            self._arm_sum[a] = self._arm_sum.get(a, 0.0) + float(score)

    def penalize(self, x: np.ndarray):
        """Record ``x`` below the worst observation — the revert
        guardrail's memory: neither ``best()`` nor the surrogate will
        revisit a reverted candidate."""
        if not self.y:
            return
        worst = min(self.y)
        spread = (max(self.y) - worst) or abs(worst) or 1.0
        self.observe(np.asarray(x, float), worst - spread)

    def _explore(self) -> np.ndarray:
        if self._arms:
            inc = self.best()
            if inc is None:
                inc = np.full(self.dims, 0.5)
            x = np.array(inc, float, copy=True)
            # jitter the continuous dims around the incumbent so the
            # bandit rounds still gather curvature for the GP phase
            for off in self.space.continuous_offsets():
                x[off] = min(1.0, max(
                    0.0, x[off] + self.rng.uniform(-0.15, 0.15)))
            spread = ((max(self.y) - min(self.y)) if len(self.y) >= 2
                      else 0.0) or 1.0
            total = sum(self._arm_n.values()) + 1
            pick, pick_u = None, None
            for arm in self._arms:  # fixed order -> deterministic ties
                n = self._arm_n.get(arm, 0)
                if n == 0:
                    pick = arm
                    break
                u = (self._arm_sum[arm] / n
                     + spread * math.sqrt(2.0 * math.log(total) / n))
                if pick_u is None or u > pick_u:
                    pick, pick_u = arm, u
            self.space.set_arm(x, pick)
            self._last_arm = pick
            return self.space.snap(x)
        return self.rng.uniform(size=self.dims)

    def suggest(self) -> np.ndarray:
        if len(self.X) < self.n_random:
            return self._explore()
        X = np.stack(self.X)
        y = np.asarray(self.y)
        scale = y.std() or 1.0
        gp = _GP()
        gp.fit(X, (y - y.mean()) / scale)
        cand = self.rng.uniform(size=(256, self.dims))
        inc = self.best()
        if inc is not None:
            # local refinement pool around the incumbent: EI over pure
            # uniform candidates alone under-samples the basin the best
            # point sits in once dims grow past a handful
            local = np.clip(
                inc + self.rng.normal(scale=0.08, size=(64, self.dims)),
                0.0, 1.0)
            cand = np.vstack([cand, local])
        if self.space is not None:
            cand = self.space.snap_rows(cand)
        mu, sigma = gp.predict(cand)
        ei = _expected_improvement(mu, sigma, (y.max() - y.mean()) / scale)
        return cand[_argmax_tiebreak(ei, mu)]

    def best(self) -> Optional[np.ndarray]:
        if not self.X:
            return None
        return self.X[int(np.argmax(self.y))]


# ===========================================================================
# Tuned-file persistence (all-or-nothing)
# ===========================================================================

#: knob name -> validator for tuned-file reload; a file containing any
#: unknown key or failing any validator is rejected WHOLE (no partial
#: configs ever reach the runtime)
_PARAM_CHECKS = {
    "fusion": lambda v: isinstance(v, int) and v > 0,
    "cycle": lambda v: isinstance(v, (int, float)) and v > 0,
    "hier_ar": lambda v: isinstance(v, bool),
    "hier_ag": lambda v: isinstance(v, bool),
    "ring_slots": lambda v: isinstance(v, int) and v >= 1,
    "chunk": lambda v: isinstance(v, int) and v >= 0,
    "compression": lambda v: v in ("none", "bf16", "int8", "int4"),
    "hier_group": lambda v: isinstance(v, int) and v >= 1,
}


def save_tuned_config(path: str, params: dict, score: float) -> None:
    """Atomically persist the winning config (tmp + os.replace, so a kill
    mid-write can never leave a truncated file for reload to choke on)."""
    doc = {"version": TUNED_FILE_VERSION,
           "params": dict(params), "score": float(score)}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_tuned_config(path: str) -> Optional[dict]:
    """All-or-nothing reload: the params dict, or None if the file is
    missing, unparseable, the wrong version, or ANY key/value fails
    validation — a half-good file must not half-apply."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except Exception as e:
        LOG.warning("autotune tuned file %s unreadable: %s", path, e)
        return None
    if not isinstance(doc, dict) or doc.get("version") != TUNED_FILE_VERSION:
        LOG.warning("autotune tuned file %s: unsupported layout", path)
        return None
    params = doc.get("params")
    if not isinstance(params, dict) or not params:
        LOG.warning("autotune tuned file %s: missing params", path)
        return None
    for k, v in params.items():
        check = _PARAM_CHECKS.get(k)
        if check is None or not check(v):
            LOG.warning("autotune tuned file %s: bad entry %s=%r "
                        "(rejecting whole file)", path, k, v)
            return None
    return params


# ===========================================================================
# The autotuner
# ===========================================================================

class Autotuner:
    """Scores goodput windows and drives the synchronized joint search.

    ``sample()`` is called from the background cycle loop every N working
    cycles on every rank; only rank 0 (or a controller-less single
    process) updates the optimizer and proposes; other ranks apply
    proposals as they arrive on negotiated responses. ``note_cycle()``
    accumulates the per-cycle workload signature feeding shift detection.
    """

    def __init__(self, runtime, log_path: str = "", warmup_samples: int = 3,
                 max_samples: int = 20, config=None, tuned_file: str = None,
                 revert_pct: float = None, revert_windows: int = None,
                 seed: int = 0):
        self.runtime = runtime
        self.log_path = log_path
        self.warmup = warmup_samples
        self.max_samples = max_samples
        self.tuned_file = (tuned_file if tuned_file is not None
                           else getattr(config, "autotune_tuned_file", ""))
        self.revert_pct = float(
            revert_pct if revert_pct is not None
            else getattr(config, "autotune_revert_pct", 20.0))
        self.revert_windows = max(1, int(
            revert_windows if revert_windows is not None
            else getattr(config, "autotune_revert_windows", 2)))
        self._seed = int(seed)
        self._samples = 0
        self._last_bytes = 0
        self._last_time = time.monotonic()
        self._led_cursor = 0
        self.done = False
        self._final_submitted = False
        self._best_score: Optional[float] = None
        self._best_params: Optional[dict] = None
        self._strikes = 0
        # workload-shift detection state (note_cycle runs on the cycle
        # thread, metric readers elsewhere — the counts dict is the only
        # cross-thread shared state)
        self._lock = lockcheck.make_lock("autotune.state")
        self._sig_counts: dict = {}  # guarded-by: _lock
        self._active_sig: Optional[int] = None
        self._shift_sig: Optional[int] = None
        self._shift_seen = 0
        ctl = runtime.controller
        self._rank = ctl.rank if ctl is not None else 0
        self.space = build_space(runtime, config)
        self._opt = (self._new_opt() if self._rank == 0 else None)
        self._warm_params: Optional[dict] = None
        if self._rank == 0 and self.tuned_file:
            self._warm_params = load_tuned_config(self.tuned_file)
            if self._warm_params is not None:
                # drop knobs this runtime's space doesn't carry (e.g. a
                # file tuned with hierarchy on, reloaded without it)
                names = {k.name for k in self.space.knobs}
                self._warm_params = {k: v for k, v in
                                     self._warm_params.items() if k in names}
        reg = metrics_mod.get_registry()
        self._m_fusion = reg.gauge("hvd_autotune_fusion_threshold_bytes",
                                   "currently applied fusion threshold")
        self._m_cycle = reg.gauge("hvd_autotune_cycle_time_ms",
                                  "currently applied cycle time")
        self._m_score = reg.gauge("hvd_autotune_last_score_bytes_per_sec",
                                  "last goodput score sample")
        self._m_samples = reg.counter("hvd_autotune_samples_total",
                                      "autotune score samples taken")
        self._m_done = reg.gauge("hvd_autotune_converged",
                                 "1 once the search has converged")
        self._m_rounds = reg.counter("hvd_autotune_rounds_total",
                                     "candidate configs proposed")
        self._m_best = reg.gauge("hvd_autotune_best_score",
                                 "best goodput score observed")
        self._m_reverts = reg.counter(
            "hvd_autotune_reverts_total",
            "regressing candidates reverted by the guardrail")
        self._m_shifts = reg.counter(
            "hvd_autotune_workload_shifts_total",
            "workload-signature shifts that restarted the search")
        self._m_ring = reg.gauge("hvd_autotune_ring_slots",
                                 "currently applied staging-ring slots")
        self._m_chunk = reg.gauge("hvd_autotune_plan_chunk_tensors",
                                  "currently applied per-chunk tensor cap")
        self._m_comp = reg.gauge("hvd_autotune_compression_bits",
                                 "active wire compression width (0=none)")
        self._m_group = reg.gauge("hvd_autotune_hier_group_size",
                                  "currently applied hier group size")
        if log_path:
            with open(log_path, "w") as f:
                f.write("sample,fusion_bytes,cycle_ms,hier_allreduce,"
                        "hier_allgather,ring_slots,chunk_tensors,"
                        "compression,hier_group,score\n")

    def _new_opt(self) -> BayesianOptimizer:
        return BayesianOptimizer(dims=self.space.dims, n_random=4,
                                 seed=self._seed, space=self.space)

    # -- scoring ------------------------------------------------------------
    def _score(self) -> Optional[float]:
        led = getattr(self.runtime, "ledger", None)
        if led is not None:
            self._led_cursor, score, _ = led.window_score(self._led_cursor)
            return score
        now = time.monotonic()
        dt = now - self._last_time
        if dt <= 0:
            return None
        db = self.runtime.bytes_processed - self._last_bytes
        self._last_bytes = self.runtime.bytes_processed
        self._last_time = now
        return db / dt

    @staticmethod
    def _get_hier() -> tuple[bool, bool]:
        from ..common import context as ctx_mod

        cfg = ctx_mod._ctx.config
        return cfg.hierarchical_allreduce, cfg.hierarchical_allgather

    def _current_params(self) -> dict:
        """The runtime's live knob values in this space's vocabulary —
        what a harness reports as the active tuned config."""
        rt = self.runtime
        out = {}
        for k in self.space.knobs:
            n = k.name
            if n == "fusion":
                out[n] = int(rt.fusion_threshold)
            elif n == "cycle":
                out[n] = float(rt.cycle_time_ms)
            elif n == "hier_ar":
                out[n] = self._get_hier()[0]
            elif n == "hier_ag":
                out[n] = self._get_hier()[1]
            elif n == "chunk":
                out[n] = int(getattr(rt, "plan_chunk_tensors", 0))
            elif n == "compression":
                from ..ops import compression as compression_mod

                out[n] = compression_mod.mode_of_spec(
                    getattr(rt, "_quant", None))
            elif n == "hier_group":
                out[n] = int(rt.controller._group_size)
        return out

    def active_config(self) -> dict:
        return self._current_params()

    def _log(self, score: float):
        self._m_samples.inc()
        self._m_score.set(score)
        self._m_fusion.set(self.runtime.fusion_threshold)
        self._m_cycle.set(self.runtime.cycle_time_ms)
        self._m_done.set(1 if (self.done or self._final_submitted) else 0)
        if self._best_score is not None:
            self._m_best.set(self._best_score)
        p = self._current_params()
        self._m_ring.set(p.get("ring_slots", 0))
        self._m_chunk.set(p.get("chunk", 0))
        self._m_comp.set(_COMP_BITS.get(p.get("compression", "none"), 0))
        self._m_group.set(p.get("hier_group", 0))
        if self.log_path:
            ar, ag = self._get_hier()
            with open(self.log_path, "a") as f:
                f.write(f"{self._samples},{self.runtime.fusion_threshold},"
                        f"{self.runtime.cycle_time_ms},{int(ar)},{int(ag)},"
                        f"{p.get('ring_slots', '')},{p.get('chunk', '')},"
                        f"{p.get('compression', '')},"
                        f"{p.get('hier_group', '')},{score:.1f}\n")

    # -- workload-shift detection -------------------------------------------
    def note_cycle(self, batch):
        """Cheap per-working-cycle signature of the tensor names/shapes —
        called from the cycle loop only while tuning is on (the off state
        never reaches here; zero-cost contract)."""
        if not batch:
            return
        h = 0
        for e in batch:
            shape = tuple(getattr(e.tensor, "shape", ()) or ())
            # crc32, not hash(): stable across processes and restarts
            h ^= zlib.crc32(f"{e.name}:{shape}".encode())
        with self._lock:
            self._sig_counts[h] = self._sig_counts.get(h, 0) + 1

    def _window_sig(self) -> Optional[int]:
        """Dominant cycle signature of the window just ended (counts
        reset); deterministic tie-break on the signature value."""
        with self._lock:
            counts, self._sig_counts = self._sig_counts, {}
        if not counts:
            return None
        return max(sorted(counts), key=counts.get)

    def _check_shift(self, sig: Optional[int]):
        if sig is None:
            return
        if self._active_sig is None:
            self._active_sig = sig
            return
        if sig == self._active_sig:
            self._shift_sig = None
            self._shift_seen = 0
            return
        # new dominant signature: debounce — only a signature that stays
        # dominant for SHIFT_WINDOWS consecutive windows is a workload
        # shift (per-cycle name churn must not thrash the search)
        if sig == self._shift_sig:
            self._shift_seen += 1
        else:
            self._shift_sig = sig
            self._shift_seen = 1
        if self._shift_seen < SHIFT_WINDOWS:
            return
        self._active_sig = sig
        self._shift_sig = None
        self._shift_seen = 0
        self._m_shifts.inc()
        flightrec_mod.note("autotune_step", action="workload_shift",
                           sig=sig)
        if self._rank != 0:
            return
        LOG.info("autotune: workload shifted, restarting search")
        self._restart_search()

    def _restart_search(self):
        """Re-arm the search from scratch (rank 0 only): workload-shift
        restarts take this path. Old scores measured a
        different workload, so they are voided — including _best_score /
        _best_params, so the revert guardrail cannot loop the search
        back onto a config tuned for the pre-shift regime."""
        self._samples = 0
        self.done = False
        self._final_submitted = False
        self._strikes = 0
        self._best_score = None
        self._best_params = None
        self._opt = self._new_opt()
        self._m_done.set(0)

    # -- parameter broadcast (SynchronizeParameters, controller.cc:39-53) ---
    def _submit(self, params: dict, final: bool):
        """Hand the proposal to the coordinator: it rides the next
        negotiated response and applies on EVERY rank (this one included)
        at response receipt — never asynchronously, because a per-rank
        divergence in the program-shaping knobs (hier flags/group,
        compression) would build different programs for the same
        negotiated tensor and corrupt the wire."""
        p = dict(params)
        p["final"] = bool(final)
        ctl = self.runtime.controller
        if ctl is not None:
            ctl.submit_params(p)
            return
        # a world of one has no controller, hence no round to wait for:
        # the proposal applies now, at the cycle boundary this sample is
        self.runtime._apply_tuned_params(p)
        if final:
            self.done = True

    def _propose(self, params: dict, final: bool):
        """One atomic proposal: the fault point fires BEFORE anything is
        handed over, so an injected fault skips the round whole — a torn
        (partially submitted) config cannot exist."""
        faults_mod.fault_point("autotune.propose")
        flightrec_mod.note("autotune_step",
                           action="converge" if final else "propose",
                           sample=self._samples)
        self._m_rounds.inc()
        self._submit(params, final)

    def _guardrail(self, score: float, params_now: dict,
                   x_now: Optional[np.ndarray]) -> bool:
        """Convergence guardrail: a candidate regressing the score by
        >= revert_pct percent for revert_windows consecutive windows is
        reverted to the best known config and penalized. Returns True
        when a revert was submitted this window."""
        if self._best_score is None or self._best_params is None:
            return False
        if params_now == self._best_params:
            self._strikes = 0
            return False
        if score >= self._best_score * (1.0 - self.revert_pct / 100.0):
            self._strikes = 0
            return False
        self._strikes += 1
        if self._strikes < self.revert_windows:
            return False
        self._strikes = 0
        if x_now is not None and self._opt is not None:
            self._opt.penalize(x_now)
        self._m_reverts.inc()
        flightrec_mod.note("autotune_step", action="revert",
                           sample=self._samples)
        LOG.info("autotune: candidate regressed >=%.0f%% for %d windows, "
                 "reverting to best config", self.revert_pct,
                 self.revert_windows)
        self._propose(self._best_params,
                      final=self.done or self._final_submitted)
        return True

    def _converge(self):
        x_best = self._opt.best()
        params = (self.space.to_params(x_best) if x_best is not None
                  else self._current_params())
        self._final_submitted = True
        self._propose(params, final=True)
        self._m_done.set(1)
        if self.tuned_file:
            try:
                save_tuned_config(self.tuned_file, params,
                                  self._best_score or 0.0)
            except Exception:
                LOG.exception("autotune tuned-file write failed")
        LOG.info("autotune converged: %s", params)

    # -- main entry ---------------------------------------------------------
    def sample(self):
        if self._rank != 0:
            # params arrive via the negotiated response
            # (runtime._apply_tuned_params); score for observability only
            self._check_shift(self._window_sig())
            score = self._score()
            if score is not None:
                self._samples += 1
                self._log(score)
            return
        if self._warm_params is not None:
            # persisted config (tuned file): first proposal, through the
            # same synchronized path as any candidate
            p, self._warm_params = self._warm_params, None
            self._propose(p, final=False)
            return
        self._check_shift(self._window_sig())
        score = self._score()
        if score is None:
            return
        self._samples += 1
        self._log(score)
        if self.done or self._final_submitted:
            # steady state: the guardrail keeps watching (a re-applied
            # stale config after elastic restore, say, must still revert)
            self._guardrail(score, self._current_params(), None)
            return
        if self._samples <= self.warmup:
            return
        params_now = self._current_params()
        x_now = self.space.from_params(params_now)
        self._opt.observe(x_now, score)
        if self._best_score is None or score > self._best_score:
            self._best_score = score
            self._best_params = params_now
            self._m_best.set(score)
        if self._guardrail(score, params_now, x_now):
            return
        if self._samples >= self.max_samples + self.warmup:
            self._converge()
            return
        self._propose(self.space.to_params(self._opt.suggest()),
                      final=False)
