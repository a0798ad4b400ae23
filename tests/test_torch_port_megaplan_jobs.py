"""The megaplan and the hierarchical rounds across processes: one 2-process
and one 4-process gloo job through the port's ``hvdrun``, both started at
once. Each job runs a loop of one named ``grouped_allreduce_async_`` (four
tensors, AVERAGE) in several arms, each after a fresh ``hvd.init``:

- ``off``: neither knob;
- ``megaplan``: ``HOROVOD_MEGAPLAN=1`` at three stable rounds;
- ``hier``: ``HOROVOD_HIER_NEGOTIATION=1`` at ``HOROVOD_HIER_GROUP_SIZE=2``;
- ``hier_megaplan``: both;
- ``quant_megaplan`` (two ranks): the megaplan with the int8 wire;
- ``thread_megaplan``: the megaplan with the runtime's own cycle thread
  at a 5 ms cycle, timing and all.

Each arm bumps ``HOROVOD_ELASTIC_GEN`` before its ``init``, as an
elastic reinit does, so its rounds live under a prefix of their own in the
launcher's store. All arms but the last drive the cycle by hand
(``run_cycle`` once a step, the cycle thread asleep under a cycle time of
hours), so every step is one lockstep round on every rank and the counts
are exact: the coordinator
grants the lease on round 3 (after three all-marker rounds), the step of
that round captures, and the six later steps replay through lease rounds.
Under v2 the lease is never granted, and a quantized group never
captures. Every arm's outputs are equal on every rank, and every
uncompressed arm's are bitwise the ``off`` arm's.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10

JOB = """
    import json, os, sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    torch.set_num_threads(1)
    KNOBS = ("HOROVOD_MEGAPLAN", "HOROVOD_HIER_NEGOTIATION",
             "HOROVOD_HIER_GROUP_SIZE", "HOROVOD_COMPRESSION",
             "HOROVOD_QUANT_MIN_ELEMS", "HOROVOD_CYCLE_TIME")
    MP = {"HOROVOD_MEGAPLAN": "1"}
    HIER = {"HOROVOD_HIER_NEGOTIATION": "1", "HOROVOD_HIER_GROUP_SIZE": "2"}
    ARMS = [("off", {}), ("megaplan", MP), ("hier", HIER),
            ("hier_megaplan", dict(HIER, **MP))]
    if int(os.environ["HOROVOD_SIZE"]) == 2:
        ARMS.append(("quant_megaplan", dict(
            MP, HOROVOD_COMPRESSION="int8", HOROVOD_QUANT_MIN_ELEMS="16")))
    ARMS.append(("thread_megaplan", dict(MP, HOROVOD_CYCLE_TIME="5")))
    os.environ["HOROVOD_MEGAPLAN_STABLE_ROUNDS"] = "3"
    res, outs = {}, {}
    for gen, (arm, knobs) in enumerate(ARMS):
        for k in KNOBS:
            os.environ.pop(k, None)
        os.environ.update(knobs)
        # a new controller generation a re-init, as an elastic reinit
        # makes it: the launcher's store still holds the last one's rounds
        os.environ["HOROVOD_ELASTIC_GEN"] = str(gen)
        hand = "HOROVOD_CYCLE_TIME" not in knobs
        if hand:
            os.environ["HOROVOD_CYCLE_TIME"] = str(3.6e6)
        hvd.init(device="cpu")
        r = hvd.rank()
        rt = context.runtime()
        steps = []
        for step in range(STEPS):
            rs = np.random.RandomState(1000 * r + step)
            ts = [torch.from_numpy(rs.standard_normal(n).astype(np.float32))
                  for n in (64, 33, 7, 100)]
            hs = hvd.grouped_allreduce_async_(ts, name="g", op=hvd.Average)
            if hand:
                rt.run_cycle()
            for h in hs:
                hvd.synchronize(h)
            steps.append(torch.cat(ts).numpy())
        ctl = rt.controller
        outs[arm] = np.stack(steps)
        res[arm] = {"rounds": ctl.round, "fast": ctl.fast_rounds,
                    "lease": ctl.megaplan_lease, "wire": ctl.wire_format,
                    "work_cycles": rt.work_cycles,
                    "report": hvd.megaplan_report()}
        hvd.shutdown()
    np.savez(OUT.format(r) + ".npz", **outs)
    with open(OUT.format(r) + ".json", "w") as f:
        json.dump(res, f)
    print("JOB_OK", r)
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{np: [(outputs by arm, counters by arm) a rank]}; both jobs at once."""
    tmp = tmp_path_factory.mktemp("megaplan_jobs")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    for n in (2, 4):
        script = tmp / f"job{n}.py"
        script.write_text(f"OUT = {str(tmp / f'np{n}.{{}}')!r}\n"
                          f"STEPS = {STEPS}\n" + textwrap.dedent(JOB))
        procs[n] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(n), sys.executable, str(script)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
    try:
        for n, p in procs.items():
            try:
                out = p.communicate(timeout=180)[0]
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                out = p.communicate()[0]
                raise AssertionError(f"-np {n} job timed out:\n{out}")
            assert p.returncode == 0, out
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    got = {}
    for n in procs:
        got[n] = []
        for r in range(n):
            with open(tmp / f"np{n}.{r}.json") as f:
                counters = json.load(f)
            got[n].append((dict(np.load(tmp / f"np{n}.{r}.npz")), counters))
    return got


@pytest.mark.parametrize("n", [2, 4])
def test_outputs_agree_on_every_rank_and_with_the_flag_off(jobs, n):
    ranks = jobs[n]
    outs0 = ranks[0][0]
    for outs, _ in ranks[1:]:
        assert sorted(outs) == sorted(outs0)
        for arm in outs:
            np.testing.assert_array_equal(outs[arm], outs0[arm], err_msg=arm)
    for arm, a in outs0.items():
        if arm != "quant_megaplan":
            np.testing.assert_array_equal(a.view(np.uint32),
                                          outs0["off"].view(np.uint32),
                                          err_msg=arm)
    assert "quant_megaplan" not in outs0 or not np.array_equal(
        outs0["quant_megaplan"], outs0["off"])


@pytest.mark.parametrize("n", [2, 4])
def test_megaplan_takes_the_lease_captures_and_replays(jobs, n):
    for _, c in jobs[n]:
        mp = c["megaplan"]
        assert mp["wire"] == "v1" and mp["lease"] is True
        assert mp["rounds"] == STEPS and mp["fast"] == STEPS - 1
        rep = mp["report"]
        assert rep["captures"] == 1 and rep["capture_rounds"] == 4
        assert rep["replays"] == STEPS - 4 and rep["misses"] == 0
        assert rep["plan"]["tensors"] == 4 and rep["plan"]["chunks"] == 1
        assert c["off"]["report"] == {"enabled": False}
        assert c["off"]["lease"] is False
        assert c["thread_megaplan"]["report"]["enabled"] is True


@pytest.mark.parametrize("n", [2, 4])
def test_hier_speaks_v2_on_every_rank_and_never_leases(jobs, n):
    for _, c in jobs[n]:
        assert c["off"]["wire"] == "v1"
        for arm in ("hier", "hier_megaplan"):
            assert c[arm]["wire"] == "v2" and c[arm]["lease"] is False
            assert c[arm]["work_cycles"] == STEPS
        assert c["hier_megaplan"]["report"]["captures"] == 0


def test_a_quantized_group_never_captures(jobs):
    for _, c in jobs[2]:
        q = c["quant_megaplan"]
        # every round repeats, so the coordinator grants the lease, yet no
        # step is captured: the wire's residuals change every step
        assert q["lease"] is True and q["report"]["captures"] == 0
        assert q["report"]["replays"] == 0
