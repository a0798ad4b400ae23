"""Elastic training across processes: two-process gloo jobs through the
port's ``hvdrun``, all started at once, each running ``elastic_probe.py``'s
ResNet worker (stages (1, 1, 1, 1), 8 filters, 32², batch 2 a rank) or a
small ``nn.Linear`` stack:

- crash and respawn: the elastic launcher (``--min-np 2 --max-np 2``, a
  discovery script); rank 1 ``os._exit(1)``s after its step-3 commit; the
  driver respawns the host and 6 steps finish from the committed store in
  an incarnation other than 0, with parameters bitwise equal on every rank
  and bitwise those of an uninterrupted job; both ranks' tee files hold
  both incarnations;
- in-process reinit: a one-shot ``controller.submit`` fault on rank 0
  (the coordinator's rank) in step 3; rank 1 starves for
  ``HOROVOD_RESPONSE_TIMEOUT_S`` (10 s) and both ranks re-initialize
  under a new generation and finish, bitwise the uninterrupted job (a
  loaded machine can stretch a round past the timeout, which costs one
  more reset and generation, never a different result);
- ``TorchState``: commit, restore and sync over gloo (rank 0's model,
  optimizer and counters reach rank 1; the sampler's processed indices
  are merged).
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT = "ELASTIC_EVENT "

WORKER = ["--worker", "resnet", "--depth", "tiny", "--image", "32",
          "--batch", "2", "--steps", "6", "--commit-every", "1",
          "--max-world", "2", "--device", "cpu"]

STATE_JOB = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
    torch.manual_seed(r)  # every rank starts elsewhere
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    sampler = hvd.elastic.ElasticSampler(list(range(20)), shuffle=False)
    state = hvd.elastic.TorchState(model, opt, sampler=sampler,
                                   epoch=r + 5, batch=0)

    def weights():
        return [p.detach().clone() for p in model.state_dict().values()]

    def same_everywhere(ts):
        mine = [t.numpy().tobytes() for t in ts]
        return all(x == mine for x in hvd.allgather_object(mine))

    assert not same_everywhere(weights())
    sampler.record_indices(range(10 * r, 10 * r + 3))
    state.sync()
    assert same_everywhere(weights()) and state.epoch == 5
    assert sorted(sampler.processed_indices) == [0, 1, 2, 10, 11, 12]
    assert len(sampler) == 7 and sampler.indices[0] == (3 if r == 0 else 4)

    def step(seed):
        x = torch.randn(6, 4, generator=torch.Generator().manual_seed(seed))
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    step(r)
    state.batch = 1
    state.commit()
    committed = weights()
    momentum = [opt.state[p]["momentum_buffer"].clone()
                for p in model.parameters()]
    assert same_everywhere(committed)
    step(10 + r)
    state.batch = 2
    state.restore()
    assert state.batch == 1
    assert all(torch.equal(a, b) for a, b in zip(weights(), committed))
    assert all(torch.equal(opt.state[p]["momentum_buffer"], m)
               for p, m in zip(model.parameters(), momentum))
    hvd.shutdown()
    print(f"STATE_JOB_OK {r}", flush=True)
""")


def _events(out: str) -> list:
    return [json.loads(line[line.index(EVENT) + len(EVENT):])
            for line in out.splitlines() if EVENT in line]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_jobs")
    disc = tmp / "discover.sh"
    disc.write_text("#!/bin/sh\necho localhost:2\n")
    disc.chmod(0o755)
    state_script = tmp / "state_cases.py"
    state_script.write_text(STATE_JOB)
    probe = [sys.executable, os.path.join(REPO, "elastic_probe.py")]
    elastic = [sys.executable, "-m", "horovod_tpu_torch.runner",
               "--min-np", "2", "--max-np", "2",
               "--host-discovery-script", str(disc)]
    plain = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2"]
    specs = {
        "crash": (elastic + ["--output-filename", str(tmp / "logs")]
                  + probe + WORKER + ["--exit-rank", "1", "--exit-step", "3"],
                  {"HOROVOD_ELASTIC_STORE": str(tmp / "crash.pkl")}),
        "reference": (elastic + probe + WORKER,
                      {"HOROVOD_ELASTIC_STORE": str(tmp / "ref.pkl")}),
        "inproc": (plain + probe + WORKER
                   + ["--fault-rank", "0", "--fault-step", "3",
                      "--fault-site", "controller.submit"],
                   {"HOROVOD_RESPONSE_TIMEOUT_S": "10"}),
        "state": (plain + [sys.executable, str(state_script)], {}),
    }
    procs = {}
    for name, (cmd, extra) in specs.items():
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   HOROVOD_FUSION_THRESHOLD="0",
                   HOROVOD_ELASTIC_RESPAWN_BACKOFF="0.1",
                   HOROVOD_PREEMPT_GRACE_S="5", **extra)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs[name] = subprocess.Popen(
            cmd, cwd=str(tmp), env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True)
    out = {}
    try:
        for name, p in procs.items():
            stdout = p.communicate(timeout=180)[0]
            out[name] = (p.returncode, stdout, _events(stdout))
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    out["logs"] = tmp / "logs"
    return out


def _finals(ev):
    return {e["rank"]: e for e in ev if e["event"] == "final"}


def test_crash_respawns_and_resumes_from_the_store(jobs):
    rc, out, ev = jobs["crash"]
    assert rc == 0, out[-3000:]
    finals = _finals(ev)
    assert sorted(finals) == [0, 1], out[-3000:]
    assert {e["steps"] for e in finals.values()} == {6}
    assert all(e["inc"] > 0 for e in finals.values())
    assert len({e["params"] for e in finals.values()}) == 1
    exits = [e for e in ev if e["event"] == "exit"]
    assert [(e["rank"], e["inc"], e["step"]) for e in exits] == [(1, 0, 3)]
    # the relaunched world took the committed step 3 from the store
    starts = [e for e in ev if e["event"] == "start" and e["inc"] > 0]
    assert {e["batch_done"] for e in starts} == {3}
    # parameters bitwise those of the uninterrupted job
    rrc, rout, rev = jobs["reference"]
    assert rrc == 0, rout[-3000:]
    ref = _finals(rev)
    assert {e["inc"] for e in ref.values()} == {0}
    assert {e["params"] for e in finals.values()} == \
        {e["params"] for e in ref.values()}
    # each rank's tee file holds both incarnations
    for r in range(2):
        text = (jobs["logs"] / f"rank.{r}.out").read_text()
        incs = {json.loads(line[len(EVENT):])["inc"]
                for line in text.splitlines() if line.startswith(EVENT)}
        assert {0, 1} <= incs, (r, text[-2000:])


def test_in_process_reinit_under_a_new_generation(jobs):
    rc, out, ev = jobs["inproc"]
    assert rc == 0, out[-3000:]
    finals = _finals(ev)
    assert sorted(finals) == [0, 1], out[-3000:]
    gens = {e["gen"] for e in finals.values()}
    assert len(gens) == 1 and min(gens) >= 1, gens
    assert {e["inc"] for e in finals.values()} == {0}
    first = {}
    for e in ev:
        if e["event"] == "failure":
            first.setdefault(e["rank"], e["step"])
    assert first == {0: 3, 1: 3}, first
    # the starved rank re-initialized within seconds of its timeout
    for e in finals.values():
        assert e["readings"]["recovery_s"][0] < 60
    ref = _finals(jobs["reference"][2])
    assert {e["params"] for e in finals.values()} == \
        {e["params"] for e in ref.values()}


def test_torch_state_commit_restore_sync_over_gloo(jobs):
    rc, out, _ = jobs["state"]
    assert rc == 0, out[-3000:]
    assert "STATE_JOB_OK 0" in out and "STATE_JOB_OK 1" in out, out[-3000:]
