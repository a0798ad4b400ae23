"""The port's autotuner (``utils/autotune.py``) held against the JAX
package's: the search space's encodings, the seeded optimizer's
suggestions (bitwise), the guardrail, revert and workload-shift sequence,
the tuned file in both directions, the knobs ``build_space`` offers under
the port's rule (ranks, not hosts), and the runtime's setters and
all-or-nothing application. Then the tuner end to end at a world of one:
the trained parameters are bitwise the untuned run's."""

import os
import types

import numpy as np
import pytest
import torch

from horovod_tpu.common import context as jctx
from horovod_tpu.common import env as jenv
from horovod_tpu.ops import queue as jqueue
from horovod_tpu.utils import autotune as jat
import horovod_tpu_torch as hvd
import observe_probe
from horovod_tpu_torch.common import context as pctx
from horovod_tpu_torch.common import env as penv
from horovod_tpu_torch.ops import collectives as pcoll
from horovod_tpu_torch.ops import megaplan as pmp
from horovod_tpu_torch.ops import queue as pqueue
from horovod_tpu_torch.utils import autotune as pat

SEEDS = range(4)


def _knobs(mod):
    return [mod.LogKnob("fusion", 1 << 20, 256 << 20, integer=True),
            mod.LogKnob("cycle", 0.5, 25.0), mod.BoolKnob("hier_ar"),
            mod.BoolKnob("hier_ag"),
            mod.ChoiceKnob("chunk", (0, 2, 4, 8, 16)),
            mod.ChoiceKnob("compression", ("none", "bf16", "int8", "int4")),
            mod.ChoiceKnob("hier_group", (2, 4))]


@pytest.mark.parametrize("seed", SEEDS)
def test_search_space_encode_decode_snap_match_jax(seed):
    js, ps = jat.SearchSpace(_knobs(jat)), pat.SearchSpace(_knobs(pat))
    assert ps.dims == js.dims and ps.offsets == js.offsets
    rng = np.random.RandomState(seed)
    for x in rng.uniform(size=(16, js.dims)):
        assert np.array_equal(ps.snap(x), js.snap(x))
        params = js.to_params(x)
        assert ps.to_params(x) == params
        assert np.array_equal(ps.from_params(params), js.from_params(params))
    assert ps.arms() == js.arms()
    assert ps.continuous_offsets() == js.continuous_offsets()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_space", [False, True])
def test_optimizer_suggests_bitwise_the_jax_points(seed, with_space):
    rng = np.random.RandomState(100 + seed)
    scores = rng.uniform(1e8, 1e9, size=10)
    sugg = []
    for mod in (jat, pat):
        space = mod.SearchSpace(_knobs(mod)) if with_space else None
        dims = space.dims if space is not None else 4
        opt = mod.BayesianOptimizer(dims=dims, n_random=4, seed=0,
                                    space=space)
        out, x = [], np.full(dims, 0.5)
        for s in scores:
            opt.observe(x, s)
            x = opt.suggest()
            out.append(x)
        opt.penalize(out[-1])
        out.append(opt.best())
        sugg.append(out)
    for a, b in zip(*sugg):
        assert a.dtype == b.dtype and np.array_equal(a, b)


class _FakeRuntime:
    """What the autotuner reads and sets on a runtime, at a world of one:
    the knobs, and ``_apply_tuned_params`` recording each proposal."""

    def __init__(self, cfg):
        self.controller = None
        self.process_set = types.SimpleNamespace(size=1, cross_size=1,
                                                 name="global")
        self.device = types.SimpleNamespace(type="cpu")
        self.fusion_threshold = 64 << 20
        self.cycle_time_ms = 1.0
        self.plan_chunk_tensors = 0
        self.ledger = None
        self.bytes_processed = 0
        self.cfg = cfg
        self.applied = []

    def set_plan_chunk_tensors(self, n):
        self.plan_chunk_tensors = n

    def _apply_tuned_params(self, p):
        self.applied.append(dict(p))
        self.fusion_threshold = int(p.get("fusion", self.fusion_threshold))
        self.cycle_time_ms = float(p.get("cycle", self.cycle_time_ms))
        self.plan_chunk_tensors = int(p.get("chunk",
                                            self.plan_chunk_tensors))
        self.cfg.hierarchical_allreduce = bool(
            p.get("hier_ar", self.cfg.hierarchical_allreduce))
        self.cfg.hierarchical_allgather = bool(
            p.get("hier_ag", self.cfg.hierarchical_allgather))


def _batch(tag: str):
    return [types.SimpleNamespace(name=f"{tag}{i}", tensor=np.zeros(i + 1))
            for i in range(3)]


def _drive(mod, rt, scores, tuned_file=""):
    at = mod.Autotuner(rt, warmup_samples=2, max_samples=7,
                       tuned_file=tuned_file, revert_pct=20.0,
                       revert_windows=2, seed=0)
    it = iter(scores)
    at._score = lambda: next(it)
    for i in range(len(scores)):
        # a workload shift after the 18th window, held for three
        at.note_cycle(_batch("a" if i < 18 else "b"))
        at.sample()
    return at


@pytest.mark.parametrize("seed", SEEDS)
def test_guardrail_revert_and_shift_sequence_matches_jax(monkeypatch, seed,
                                                         tmp_path):
    rng = np.random.RandomState(seed)
    scores = list(rng.uniform(5e8, 1e9, size=26))
    for i in (6, 7, 12, 13):
        scores[i] = 1e7  # regressions the guardrail reverts
    monkeypatch.setattr(jctx._ctx, "config", jenv.RuntimeConfig())
    monkeypatch.setattr(pctx._ctx, "config", penv.RuntimeConfig())
    runs = []
    for mod, cfg, name in ((jat, jctx._ctx.config, "jax"),
                           (pat, pctx._ctx.config, "port")):
        reg = mod.metrics_mod.get_registry()
        before = [reg.counter_value(f"hvd_autotune_{k}_total")
                  for k in ("reverts", "workload_shifts")]
        rt = _FakeRuntime(cfg)
        at = _drive(mod, rt, scores, str(tmp_path / f"{name}.json"))
        # the series are the process's: each run's own increments
        counts = [reg.counter_value(f"hvd_autotune_{k}_total") - b
                  for k, b in zip(("reverts", "workload_shifts"), before)]
        runs.append((rt.applied, counts, at.done, at._samples,
                     at.active_config()))
    assert runs[1] == runs[0]
    assert any(p.get("final") for p in runs[1][0])
    assert runs[1][1][0] >= 1 and runs[1][1][1] == 1
    assert [k for k in runs[1][0][-1] if k != "final"] == \
        [k.name for k in pat.build_space(_FakeRuntime(None)).knobs]


@pytest.mark.parametrize("writer,reader", [(jat, pat), (pat, jat)])
def test_tuned_file_loads_in_the_other_package(tmp_path, writer, reader):
    params = {"fusion": 33554432, "cycle": 2.5, "hier_ar": False,
              "hier_ag": True, "chunk": 8, "compression": "none",
              "hier_group": 4}
    path = str(tmp_path / "tuned.json")
    writer.save_tuned_config(path, params, 1.5e9)
    assert reader.load_tuned_config(path) == params
    # a JAX file that carries the staging-ring knob loads too; the port's
    # space has no such knob and drops it at warm start
    writer.save_tuned_config(path, dict(params, ring_slots=4), 1.0)
    assert reader.load_tuned_config(path)["ring_slots"] == 4
    writer.save_tuned_config(path, dict(params, chunk=-1), 1.0)
    assert reader.load_tuned_config(path) is None  # all or nothing


def _space_runtime(size: int, cross: int, device: str, hier: bool = False,
                   sharded: bool = False):
    ctl = (types.SimpleNamespace(_hier=True, size=size, rank=0,
                                 set_group_size=lambda k: None)
           if hier else None)
    return types.SimpleNamespace(
        process_set=types.SimpleNamespace(size=size, cross_size=cross),
        device=types.SimpleNamespace(type=device), controller=ctl,
        set_plan_chunk_tensors=lambda n: None,
        set_compression_spec=lambda s: None, _sharded_update=sharded,
        _plans_enabled=True)


SPACE_CASES = [
    # (size, hosts, device, hier, sharded) -> the port's knobs
    ((1, 1, "cuda", False, False),
     ["fusion", "cycle", "hier_ar", "hier_ag", "chunk"]),
    ((4, 1, "cuda", False, False),  # four GPUs in one box
     ["fusion", "cycle", "hier_ar", "hier_ag", "chunk", "compression"]),
    ((4, 1, "cpu", False, False),
     ["fusion", "cycle", "chunk", "compression"]),
    ((4, 2, "cuda", True, False),
     ["fusion", "cycle", "hier_ar", "hier_ag", "chunk", "compression",
      "hier_group"]),
    ((2, 1, "cuda", False, True),
     ["fusion", "cycle", "hier_ar", "hier_ag", "chunk"]),
]


@pytest.mark.parametrize("case,want", SPACE_CASES,
                         ids=[f"{c[0]}ranks-{c[1]}hosts-{c[2]}"
                              f"{'-hier' if c[3] else ''}"
                              f"{'-sharded' if c[4] else ''}"
                              for c, _ in SPACE_CASES])
def test_build_space_counts_ranks_where_jax_counts_processes(case, want):
    """The wire knob appears at more than one rank (``size``), where the
    JAX package asks for more than one process (``cross_size``): four GPUs
    in one box are one host but four contributions. No ``ring_slots``:
    the port has one fusion buffer."""
    space = pat.build_space(_space_runtime(*case))
    assert [k.name for k in space.knobs] == want
    size, hosts = case[0], case[1]
    if size > 1 and hosts == 1 and not case[4]:
        # a literal copy of the JAX rule would never offer the wire here
        jspace = jat.build_space(types.SimpleNamespace(
            process_set=types.SimpleNamespace(cross_size=hosts),
            set_compression_spec=lambda s: None, _plans_enabled=True,
            controller=None))
        assert "compression" not in [k.name for k in jspace.knobs]
    if case[3]:
        assert space.knobs[-1].choices == (2, 4)


CAP_CASES = [(4096, [1024] * 9, 2), (1 << 20, [4096] * 40, 8),
             (1 << 20, [4096] * 40, 0), (8192, [1024] * 30 + [9000], 16)]


@pytest.mark.parametrize("threshold,sizes,cap", CAP_CASES)
def test_chunk_cap_matches_jax(threshold, sizes, cap):
    jx = [jqueue.TensorEntry(name=f"t{i}", op="allreduce",
                             tensor=np.zeros(n // 4, np.float32))
          for i, n in enumerate(sizes)]
    pt = [pqueue.TensorEntry(name=f"t{i}", op="allreduce",
                             tensor=torch.zeros(n // 4))
          for i, n in enumerate(sizes)]
    fake = types.SimpleNamespace(fusion_threshold=threshold,
                                 plan_chunk_tensors=cap)
    assert ([[e.name for e in c]
             for c in pqueue.BackgroundRuntime._chunk_group(fake, pt)]
            == [[e.name for e in c]
                for c in jqueue.BackgroundRuntime._chunk_group(fake, jx)])


@pytest.fixture
def world_of_one(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HOROVOD_"):
            monkeypatch.delenv(k)
    yield
    hvd.shutdown()


def test_setters_move_boundaries_and_drop_plans(world_of_one):
    hvd.init(device="cpu")
    rt = pctx.runtime()
    t = torch.ones(8)
    hvd.allreduce_(t, name="warm")
    assert pcoll._PLANS
    epoch = pmp.epoch()
    rt._apply_tuned_params({"fusion": 1 << 20, "cycle": 3.0, "chunk": 4,
                            "compression": "none", "hier_ar": False})
    assert (rt.fusion_threshold, rt.cycle_time_ms,
            rt.plan_chunk_tensors) == (1 << 20, 3.0, 4)
    assert rt.fusion_buffer.capacity == 1 << 20 and not pcoll._PLANS
    assert pmp.epoch() > epoch
    # all or nothing: one bad value and nothing moves
    for bad in ({"fusion": 1 << 21, "cycle": -1.0},
                {"chunk": 2, "compression": "int3"}):
        with pytest.raises(ValueError):
            rt._apply_tuned_params(bad)
        assert (rt.fusion_threshold, rt.cycle_time_ms,
                rt.plan_chunk_tensors) == (1 << 20, 3.0, 4)
    out = hvd.grouped_allreduce([torch.full((4,), float(i))
                                 for i in range(10)], name="g")
    assert [float(o[0]) for o in out] == [float(i) for i in range(10)]


def test_validation_matches_jax(world_of_one, monkeypatch):
    """The same proposals parse to the same knobs, or fail, in both
    runtimes' validators."""
    hvd.init(device="cpu")
    prt = pctx.runtime()
    jrt = types.SimpleNamespace(_sharded_update=False)
    for p in ({"fusion": "4096", "cycle": 2, "chunk": 0},
              {"hier_group": 2, "hier_ar": 1, "hier_ag": 0},
              {"compression": "bf16"}, {"compression": "int8"},
              {"fusion": 0}, {"cycle": 0.0}, {"chunk": -2},
              {"compression": "fp8"}, {"hier_group": 0}):
        try:
            want = jqueue.BackgroundRuntime._validate_tuned_params(jrt, p)
        except ValueError:
            with pytest.raises(ValueError):
                prt._validate_tuned_params(p)
            continue
        got = prt._validate_tuned_params(p)
        assert got.keys() == want.keys()
        for k in got:
            if k == "compression":
                assert (None if got[k] is None else got[k].signature()) == \
                    (None if want[k] is None else want[k].signature())
            else:
                assert got[k] == want[k] and type(got[k]) is type(want[k])


def _train(steps: int):
    import resnet_probe as rp
    import torch.nn.functional as F

    model = rp.build("tiny", torch.device("cpu"), 0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    images, labels = rp.synthetic_batch(0, 1, 2, 32, 10, 0,
                                        torch.device("cpu"))
    for _ in range(steps):
        opt.zero_grad()
        F.cross_entropy(model(images), labels).backward()
        opt.step()
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def test_autotuned_world_of_one_is_bitwise_the_untuned_run(world_of_one,
                                                          monkeypatch,
                                                          tmp_path):
    """Under ``HOROVOD_AUTOTUNE`` the tuner samples, proposes and applies
    at the end of a working cycle (a world of one has no response to carry
    a proposal); the knobs change chunking and timing only, so the
    parameters are bitwise the untuned run's; each log row shows the
    runtime's knobs at its sample, and each proposal is what the runtime
    runs at the next sample."""
    # one thread: the two runs' convolutions reduce in the same order, and
    # a loaded machine is not oversubscribed
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hvd.init(device="cpu")
        ref = _train(10)
        hvd.shutdown()
        got, rows, watch = _tuned_run(monkeypatch, tmp_path)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    logged = [[int(r[1]), float(r[2]), int(r[6] or 0)] for r in rows]
    # each row shows the knobs of its sample, and each proposal is what
    # the runtime ran at the next sample
    assert observe_probe.check_watch(watch, logged, True) >= 1
    assert len({tuple(row) for row in logged}) > 1  # proposals were applied


def _tuned_run(monkeypatch, tmp_path):
    log = tmp_path / "at.csv"
    for k, v in {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": str(log),
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "6",
                 "HOROVOD_PERFLEDGER": "1"}.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    watch = observe_probe.watch_autotuner(pctx.runtime().autotuner)
    got = _train(10)
    hvd.shutdown()
    return (got, [r.split(",") for r in log.read_text().splitlines()[1:]],
            watch)
