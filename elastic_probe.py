#!/usr/bin/env python3
"""Elastic training and checkpointing across GPUs through the port's
elastic ``hvdrun`` (root script, not part of the package).

    python3 elastic_probe.py [-np 4] [-H localhost:2,127.0.0.1:2]
        [--arms crash,resize,inproc,zero1_ckpt] [--device cpu]
        [--depth 50] [--image 224] [--batch 64] [--steps 12]
        [--lm-layers 12] [--timeout S]

Each arm starts elastic jobs (``--min-np``, ``--max-np``,
``--host-discovery-script`` over a file the arm writes) and checks what
their workers report, one JSON line an event (prefixed by the launcher):

- ``crash``: ResNet under ``hvd.elastic.run`` with ``TorchState(model,
  optimizer, sampler, epoch, batch)``, committing every 4 steps, respawn
  attempts 1; the last rank ``os._exit(1)``s after step 6 of incarnation
  0; the driver respawns its host and 12 steps finish at the full world.
  The parameters are bitwise equal on every rank after every step, and
  bitwise those of an uninterrupted job of the same world;
- ``resize``: the same with respawn attempts 0: the crashed rank's host is
  blacklisted and the world goes on at the other host's ranks, on the
  sampler's re-sharded remainder; img/s a GPU at each world;
- ``inproc``: rank 0's coordinator path fails once
  (``controller.submit:fail#1`` from step 6); every rank re-initializes
  in its process under generation 1 (the starved ranks after
  ``HOROVOD_RESPONSE_TIMEOUT_S``) and finishes; each rank's seconds from
  its failure to its next finished step;
- ``zero1_ckpt``: the transformer LM (full width, ``--lm-layers``)
  through ``ShardedUpdateEngine`` with ``HOROVOD_ASYNC_CKPT=1``,
  snapshotting every 2 steps; after the step-4 flush the last rank
  rewrites the discovery file to one slot fewer and dies; the driver
  relaunches the smaller world, which restores the shards N→M: its
  gathered state bitwise the saved one, and its losses bitwise those of a
  job of that world started from the same directory; the snapshot's host
  ms, copy ms and bytes on each rank, the writer's ms, the recovery time.

Every job uses ``HOROVOD_FUSION_THRESHOLD=0``, so the sum order never
follows a cycle's timing. The data is a seeded synthetic dataset read
through ``ElasticSampler``: every step each rank takes the first
``--batch`` indices of its shard of the unprocessed remainder and records
the whole global batch, so the processed set is the same on every rank
and a resumed run reads what an uninterrupted one reads.
A worker drives ``cuda:<rank>``: under ``-H`` the local ranks repeat
across the "hosts" of one machine. ``--device cpu`` runs the workers over
gloo (``--depth tiny --image 32 --batch 2`` rehearses the ResNet arms,
the LM at width 32). The exit code
is 0 only when every arm's checks passed. ``train_resnet`` is also
``chip_smoke.py``'s elastic path.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ARMS = ("crash", "resize", "inproc", "zero1_ckpt")
LR, MOMENTUM = 0.05, 0.9
EVENT = "ELASTIC_EVENT "


def emit(**kw):
    """One event line (the launcher prefixes it with the rank)."""
    print(EVENT + json.dumps(kw), flush=True)


def events(out: str) -> list:
    return [json.loads(line[line.index(EVENT) + len(EVENT):])
            for line in out.splitlines() if EVENT in line]


def digest(tensors) -> str:
    """sha1 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha1()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(t.view(torch.uint8).reshape(-1).numpy().tobytes())
    return h.hexdigest()


def global_batch(sampler, batch: int) -> list:
    """Every rank's next ``batch`` indices: the first of each rank's shard
    of the sampler's padded remainder (``ElasticSampler.reset``)."""
    rem, w = sampler.remaining_indices, sampler.num_replicas
    padded = list(rem)
    while padded and len(padded) < sampler.total_size:
        padded += padded[:sampler.total_size - len(padded)]
    return [padded[r::w][:batch] for r in range(w)]


def image_bank(n: int, image: int, device, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, image, image, generator=g).to(device)


def train_resnet(args, device=None, log=emit) -> dict:
    """ResNet under ``hvd.elastic.run`` (module docstring); ``hvd.init``
    runs here. ``args``: depth, image, batch, steps, commit_every, seed,
    and optionally exit_rank/exit_step (``os._exit(1)`` after that step's
    commit, on every rank, in incarnation 0) and fault_rank/fault_step/fault_site (a
    one-shot fault in this process). Returns the final digests and
    readings."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_start = time.time()
    hvd.init(device=device)
    dev, rank = hvd.device(), hvd.rank()
    inc = int(os.environ.get("HOROVOD_ELASTIC_EPOCH", "0"))
    stages, filters, classes = rp.CONFIGS[args.depth]
    bank = image_bank(args.batch, args.image, dev, args.seed)
    n_data = args.steps * args.batch * args.max_world
    model = rp.build(args.depth, dev, args.seed)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters())
    sampler = hvd.elastic.ElasticSampler(list(range(n_data)), shuffle=True,
                                         seed=args.seed)
    t_built = time.time()
    state = hvd.elastic.TorchState(model, opt, sampler=sampler, epoch=0,
                                   batch=0)
    log(event="start", rank=rank, inc=inc, world=hvd.size(),
        batch_done=state.batch, t_start=t_start, t_built=t_built,
        t_state=time.time())
    readings = {"step_ms": {}, "commit_ms": [], "recovery_s": [],
                "losses": []}
    pending = {"fail": None}
    fired = {"fault": False}

    def one_step(step: int):
        if (args.fault_step == step and rank == args.fault_rank
                and not fired["fault"]):
            fired["fault"] = True
            os.environ["HOROVOD_FAULT_SPEC"] = f"{args.fault_site}:fail#1"
        sampler.reset()
        everyone = global_batch(sampler, args.batch)
        mine = everyone[hvd.rank()]
        idx = torch.tensor(mine, device=dev)
        images = bank[idx % len(bank)]
        labels = idx % classes
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        value = loss.item()  # waits for the step's device work
        ms = (time.perf_counter() - t0) * 1e3
        sampler.record_indices([i for ids in everyone for i in ids])
        return value, ms

    @hvd.elastic.run
    def train(st):
        while st.batch < args.steps:
            step = st.batch + 1
            try:
                loss, ms = one_step(step)
            except HorovodInternalError:
                pending["fail"] = time.time()
                log(event="failure", rank=rank, inc=inc, step=step,
                    t=pending["fail"])
                raise
            world = hvd.size()
            if world > 1 and not rp.same_as_rank0(
                    list(model.parameters()), hvd.global_process_set().group):
                raise AssertionError(f"rank {rank}: parameters differ from "
                                     f"rank 0's after step {step}")
            st.batch = step
            readings["losses"].append(loss)
            readings["step_ms"].setdefault(world, []).append(ms)
            now = time.time()
            if pending["fail"] is not None:
                readings["recovery_s"].append(now - pending["fail"])
                pending["fail"] = None
            log(event="step", rank=rank, inc=inc, step=step, world=world,
                gen=int(os.environ.get("HOROVOD_ELASTIC_GEN", "0")),
                loss=loss, ms=ms, t=now)
            if step % args.commit_every == 0:
                t0 = time.perf_counter()
                st.commit()
                readings["commit_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                log(event="commit", rank=rank, inc=inc, step=step,
                    ms=readings["commit_ms"][-1])
            if inc == 0 and step == args.exit_step:
                # the exit follows the step's commit on every rank, the
                # store's writer included
                hvd.barrier()
                if rank == args.exit_rank:
                    log(event="exit", rank=rank, inc=inc, step=step,
                        t=time.time())
                    sys.stdout.flush()
                    os._exit(1)

    train(state)
    params = [p for p in model.parameters()]
    out = {"params": digest(params), "buffers": digest(model.buffers()),
           "steps": state.batch, "world": hvd.size(),
           "gen": int(os.environ.get("HOROVOD_ELASTIC_GEN", "0")),
           "readings": readings}
    log(event="final", rank=rank, inc=inc, **{k: v for k, v in out.items()
                                              if k != "readings"},
        readings=readings)
    out["model"] = model
    return out


# --- the ZeRO-1 LM with the async checkpointer --------------------------------

def lm_config(args, cuda: bool):
    import torch

    from horovod_tpu_torch.models.transformer import TransformerConfig

    if cuda:
        return TransformerConfig(vocab_size=32768, d_model=2048, n_heads=16,
                                 n_layers=args.lm_layers, d_ff=8192,
                                 max_seq=1024, dtype=torch.bfloat16), 8, None
    return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_seq=16,
                             dtype=torch.float32), 2, 1000


def lm_tokens(cfg, batch: int, seed: int, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=g).to(device)


def _same_state(a: dict, b: dict) -> bool:
    import torch

    if set(a["state"]) != set(b["state"]):
        return False
    for i, st in a["state"].items():
        other = b["state"][i]
        if set(st) != set(other):
            return False
        for k, v in st.items():
            w = other[k].to(v.device)
            if v.dtype != w.dtype or v.shape != w.shape or not torch.equal(
                    v.view(torch.uint8), w.view(torch.uint8)):
                return False
    return True


def train_lm_zero1(args, log=emit) -> dict:
    """The ``zero1_ckpt`` arm's worker (module docstring). With
    ``args.restore_from`` set it is the reference job: it restores that
    directory and trains on."""
    import torch

    import horovod_tpu_torch as hvd
    import resnet_probe as rp
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.opt.sharded import ShardedUpdateEngine
    from horovod_tpu_torch.parallel import ring_attention
    from horovod_tpu_torch.utils import async_ckpt

    t_start = time.time()
    hvd.init(device=args.device)
    dev, rank, world = hvd.device(), hvd.rank(), hvd.size()
    cuda = dev.type == "cuda"
    inc = int(os.environ.get("HOROVOD_ELASTIC_EPOCH", "0"))
    cfg, batch, mse = lm_config(args, cuda)
    ckpt = async_ckpt.get_checkpointer()
    if ckpt is None:
        raise AssertionError("HOROVOD_ASYNC_CKPT is not set")
    base = ckpt.directory
    model = TransformerLM(cfg, device=dev, seed=0)
    params = list(model.parameters())
    engine = ShardedUpdateEngine(
        lambda ps: torch.optim.SGD(ps, lr=1e-3, momentum=0.9),
        process_set=hvd.global_process_set(), min_shard_elems=mse)
    first = 1
    restore_dir = args.restore_from or (base if inc > 0 else None)
    if restore_dir is not None:
        t0 = time.time()
        manifest, _, replicated = async_ckpt.restore_sharded(
            restore_dir, params, engine)
        with torch.no_grad():
            for p, saved in zip(params, replicated):
                p.copy_(torch.from_numpy(saved))
        # the restored state, gathered over this world, against the saved
        # shards assembled from the directory
        m, payloads = async_ckpt.load_shards(restore_dir)
        saved = async_ckpt.assemble_full_state(m, payloads, params,
                                               min_shard_elems=mse)
        from horovod_tpu_torch.opt.sharded import plan_shard_layout

        want = async_ckpt.positional_state(saved, plan_shard_layout(
            params, m["world"], min_shard_elems=engine._mse,
            generation=m["generation"]))
        got = engine.full_state()
        same = _same_state(got, want)
        del got, want, saved, payloads
        first = manifest["step"] + 1
        log(event="restored", rank=rank, inc=inc, world=world,
            saved_world=manifest["world"], step=manifest["step"],
            bitwise=same, seconds=time.time() - t0, t_start=t_start)
        if not same:
            raise AssertionError(f"rank {rank}: the restored state is not "
                                 "the saved one")
        # later snapshots go beside the restored ones
        ckpt.directory = f"{base}.inc{inc}" if inc > 0 else f"{base}.ref"
        os.makedirs(ckpt.directory, exist_ok=True)
    else:
        engine.init(params)
    losses = {}
    after_snapshot = False
    for step in range(first, args.steps + 1):
        for p in params:
            p.grad = None
        tokens = lm_tokens(cfg, batch, 1000 * step + rank, dev)
        t0 = time.perf_counter()
        loss = lm_loss(model, tokens, attn_fn=ring_attention)
        loss.backward()
        engine.step(params)
        value = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        losses[step] = value
        if world > 1 and not rp.same_as_rank0(params,
                                              hvd.global_process_set().group):
            raise AssertionError(f"rank {rank}: parameters differ from "
                                 f"rank 0's after step {step}")
        log(event="step", rank=rank, inc=inc, step=step, world=world,
            loss=value, ms=ms, after_snapshot=after_snapshot, t=time.time())
        after_snapshot = False
        if step % 2 == 0:
            t0 = time.perf_counter()
            ckpt.snapshot(step, engine.optimizer.state_dict(),
                          replicated=params if rank == 0 else None,
                          layout=engine.layout)
            host_ms = (time.perf_counter() - t0) * 1e3
            after_snapshot = True
            log(event="snapshot", rank=rank, inc=inc, step=step,
                host_ms=host_ms, bytes=ckpt.last_snapshot_bytes)
        if inc == 0 and args.restore_from is None and step == args.exit_step:
            t0 = time.perf_counter()
            ok = ckpt.flush(deadline_s=600.0)
            log(event="flushed", rank=rank, inc=inc, step=step, ok=ok,
                ms=(time.perf_counter() - t0) * 1e3,
                write_ms=ckpt.last_write_s * 1e3,
                copy_ms=ckpt.last_copy_device_ms,
                shard_bytes=ckpt.last_shard_bytes)
            hvd.barrier()
            if rank == world - 1:
                with open(args.hosts_file, "w") as f:
                    f.write(f"localhost:{world - 1}\n")
                log(event="exit", rank=rank, inc=inc, step=step,
                    t=time.time())
            # the driver sees the smaller world within its discovery
            # period and ends this one
            time.sleep(args.timeout)
            os._exit(1)
    ckpt.flush(deadline_s=600.0)
    log(event="final", rank=rank, inc=inc, world=world, losses=losses,
        write_ms=ckpt.last_write_s * 1e3, copy_ms=ckpt.last_copy_device_ms,
        params=digest(params))
    hvd.shutdown()
    return losses


# --- the parent -------------------------------------------------------------

def _discovery(tmp: str, hosts: str) -> tuple:
    hosts_file = os.path.join(tmp, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write("\n".join(hosts.split(",")) + "\n")
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(script, 0o755)
    return script, hosts_file


def run_job(args, root: str, tmp: str, name: str, hosts: str, np_: int,
            worker_args: list, env_extra: dict, elastic: bool = True,
            min_np: int = None) -> list:
    """One ``hvdrun`` job of this script as the worker; returns its
    events."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner"]
    if elastic:
        script, hosts_file = _discovery(tmp, hosts)
        worker_args = worker_args + ["--hosts-file", hosts_file]
        cmd += ["--min-np", str(min_np or np_), "--max-np", str(np_),
                "--host-discovery-script", script,
                "--output-filename", os.path.join(tmp, name + ".logs")]
    else:
        cmd += ["-np", str(np_), "-H", hosts]
    cmd += [sys.executable, os.path.abspath(__file__)] + worker_args
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_FUSION_THRESHOLD="0",
               HOROVOD_ELASTIC_STORE=os.path.join(tmp, name + ".store.pkl"),
               HOROVOD_PREEMPT_GRACE_S="10",
               HOROVOD_ELASTIC_RESPAWN_BACKOFF="0.1")
    env.update(env_extra)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    # a session of its own, so a timeout ends the launcher and its workers
    p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=args.timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        print(p.communicate()[0][-20000:], flush=True)
        raise AssertionError(f"elastic_probe: job {name} timed out")
    with open(os.path.join(tmp, name + ".out"), "w") as f:
        f.write(out)
    ev = events(out)
    print(f"  job {name}: exit {p.returncode} after "
          f"{time.perf_counter() - t0:.1f} s, {len(ev)} events", flush=True)
    if p.returncode != 0:
        print(out[-20000:], flush=True)
        raise AssertionError(f"elastic_probe: job {name} exited "
                             f"{p.returncode}")
    return ev


def _finals(ev: list) -> dict:
    return {e["rank"]: e for e in ev if e["event"] == "final"}


def _resnet_args(args, extra: list) -> list:
    return ["--worker", "resnet", "--depth", args.depth, "--image",
            str(args.image), "--batch", str(args.batch), "--steps",
            str(args.steps), "--commit-every", "4", "--max-world",
            str(args.np)] + (["--device", args.device] if args.device
                             else []) + extra


def _img_s(ev: list, batch: int) -> dict:
    """img/s a GPU by world: the median step after each incarnation's
    first."""
    import statistics

    out = {}
    for world in sorted({e["world"] for e in ev if e["event"] == "step"}):
        ms = [e["ms"] for e in ev if e["event"] == "step"
              and e["world"] == world and e["rank"] == 0]
        ms = ms[1:] or ms
        if ms:
            out[world] = batch / (statistics.median(ms) / 1e3)
    return out


def arm_crash(args, root, tmp, respawn: int) -> dict:
    name = "crash" if respawn else "resize"
    last = args.np - 1
    env = {"HOROVOD_ELASTIC_RESPAWN_ATTEMPTS": str(respawn)}
    ev = run_job(args, root, tmp, name, args.hosts, args.np,
                 _resnet_args(args, ["--exit-rank", str(last),
                                     "--exit-step", "6"]), env,
                 min_np=args.np - _slots_of_last(args))
    finals = _finals(ev)
    incs = {e["inc"] for e in finals.values()}
    digests = {e["params"] for e in finals.values()}
    reading = {"finals": len(finals), "incarnations": sorted(incs),
               "worlds": sorted({e["world"] for e in finals.values()}),
               "steps": sorted({e["steps"] for e in finals.values()}),
               "bitwise_on_every_rank": len(digests) == 1,
               "img_s_per_gpu": _img_s(ev, args.batch)}
    exit_t = [e["t"] for e in ev if e["event"] == "exit"]
    later = [e["t"] for e in ev if e["event"] == "step" and e["inc"] > 0]
    if exit_t and later:
        reading["exit_to_first_step_s"] = min(later) - exit_t[0]
    reading["commit_ms"] = [e["ms"] for e in ev if e["event"] == "commit"
                            and e["rank"] == 0]
    want_world = args.np if respawn else args.np - _slots_of_last(args)
    if (0 in incs or len(digests) != 1 or reading["steps"] != [args.steps]
            or reading["worlds"] != [want_world]
            or len(finals) != want_world):
        raise AssertionError(f"{name}: {reading}")
    if respawn:
        ref = run_job(args, root, tmp, name + "_reference", args.hosts,
                      args.np, _resnet_args(args, []), {})
        rdig = {e["params"] for e in _finals(ref).values()}
        reading["bitwise_uninterrupted"] = rdig == digests
        reading["reference_img_s_per_gpu"] = _img_s(ref, args.batch)
        if rdig != digests:
            raise AssertionError(f"{name}: parameters differ from the "
                                 f"uninterrupted job's: {rdig} {digests}")
    return reading


def _slots_of_last(args) -> int:
    """Slots of the host the last rank runs on (blacklisted in resize)."""
    return int(args.hosts.split(",")[-1].rsplit(":", 1)[1])


def arm_inproc(args, root, tmp) -> dict:
    env = {"HOROVOD_RESPONSE_TIMEOUT_S": str(args.response_timeout)}
    ev = run_job(args, root, tmp, "inproc", args.hosts, args.np,
                 _resnet_args(args, ["--fault-rank", "0", "--fault-step",
                                     "6", "--fault-site",
                                     "controller.submit"]), env)
    finals = _finals(ev)
    reading = {
        "gens": sorted({e["gen"] for e in finals.values()}),
        "incarnations": sorted({e["inc"] for e in finals.values()}),
        "bitwise_on_every_rank": len({e["params"]
                                      for e in finals.values()}) == 1,
        "recovery_s_by_rank": {r: e["readings"]["recovery_s"]
                               for r, e in sorted(finals.items())},
        "failures": sorted({e["rank"] for e in ev
                            if e["event"] == "failure"})}
    if (reading["gens"] != [1] or reading["incarnations"] != [0]
            or not reading["bitwise_on_every_rank"]
            or len(finals) != args.np
            or reading["failures"] != list(range(args.np))):
        raise AssertionError(f"inproc: {reading}")
    return reading


def arm_zero1(args, root, tmp) -> dict:
    ckdir = os.path.join(tmp, "zero1.ckpt")
    env = {"HOROVOD_ASYNC_CKPT": "1", "HOROVOD_ASYNC_CKPT_DIR": ckdir,
           "HOROVOD_ELASTIC_RESPAWN_ATTEMPTS": "1"}
    common = ["--worker", "zero1", "--steps", "8", "--exit-step", "4",
              "--lm-layers", str(args.lm_layers)] + (
        ["--device", args.device] if args.device else [])
    ev = run_job(args, root, tmp, "zero1_ckpt", f"localhost:{args.np}",
                 args.np, common, env, min_np=args.np - 1)
    finals = _finals(ev)
    restored = [e for e in ev if e["event"] == "restored"]
    world = args.np - 1
    reading = {
        "incarnations": sorted({e["inc"] for e in finals.values()}),
        "world": sorted({e["world"] for e in finals.values()}),
        "restored_bitwise": [e["bitwise"] for e in restored],
        "restore_s": [e["seconds"] for e in restored],
        "snapshot_host_ms": {r: [e["host_ms"] for e in ev
                                 if e["event"] == "snapshot"
                                 and e["rank"] == r and e["inc"] == 0]
                             for r in range(args.np)},
        "snapshot_bytes": {e["rank"]: e["bytes"] for e in ev
                           if e["event"] == "snapshot" and e["inc"] == 0},
        "flushed": {e["rank"]: {k: e[k] for k in ("ok", "ms", "write_ms",
                                                   "copy_ms", "shard_bytes")}
                    for e in ev if e["event"] == "flushed"},
        "step_ms_after_snapshot": [e["ms"] for e in ev
                                   if e["event"] == "step" and e["rank"] == 0
                                   and e["after_snapshot"]],
        "step_ms_other": [e["ms"] for e in ev if e["event"] == "step"
                          and e["rank"] == 0 and not e["after_snapshot"]]}
    exit_t = [e["t"] for e in ev if e["event"] == "exit"]
    later = [e["t"] for e in ev if e["event"] == "step" and e["inc"] > 0]
    if exit_t and later:
        reading["exit_to_first_step_s"] = min(later) - exit_t[0]
    if (0 in reading["incarnations"] or reading["world"] != [world]
            or len(restored) != world or not all(reading["restored_bitwise"])
            or len(finals) != world):
        raise AssertionError(f"zero1_ckpt: {reading}")
    # the reference: a world of that size started from the same directory
    ref = run_job(args, root, tmp, "zero1_reference", f"localhost:{world}",
                  world, common + ["--restore-from", ckdir],
                  dict(env, HOROVOD_ASYNC_CKPT_DIR=ckdir), elastic=False)
    got = finals[0]["losses"]
    want = _finals(ref)[0]["losses"]
    reading["losses"] = got
    reading["losses_bitwise_reference"] = got == want
    if got != want:
        raise AssertionError(f"zero1_ckpt: losses {got} != {want}")
    return reading


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("-H", "--hosts", default=None,
                    help="host:slots,... (default localhost:np)")
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers over gloo")
    ap.add_argument("--depth", default="50")
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--lm-layers", type=int, default=12)
    ap.add_argument("--response-timeout", type=float, default=10.0)
    ap.add_argument("--timeout", type=float, default=900.0)
    # the worker's own
    ap.add_argument("--worker", choices=("resnet", "zero1"), default=None)
    ap.add_argument("--commit-every", type=int, default=4)
    ap.add_argument("--max-world", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exit-rank", type=int, default=-1)
    ap.add_argument("--exit-step", type=int, default=-1)
    ap.add_argument("--fault-rank", type=int, default=-1)
    ap.add_argument("--fault-step", type=int, default=-1)
    ap.add_argument("--fault-site", default="plan.dispatch")
    ap.add_argument("--hosts-file", default=None)
    ap.add_argument("--restore-from", default=None)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if args.worker and args.device is None:
        # one machine's GPUs as several hosts (-H): the local ranks repeat,
        # the global rank is the GPU
        args.device = f"cuda:{os.environ['HOROVOD_RANK']}"
    if args.worker == "resnet":
        train_resnet(args, device=args.device)
        import horovod_tpu_torch as hvd

        hvd.shutdown()
        return 0
    if args.worker == "zero1":
        train_lm_zero1(args)
        return 0
    arms = args.arms.split(",")
    if set(arms) - set(ARMS):
        raise SystemExit(f"--arms takes {ARMS}")
    args.hosts = args.hosts or f"localhost:{args.np}"
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="elastic_probe_")
    print(f"elastic_probe: {shutil.disk_usage(tmp).free} bytes free under "
          f"{tmp}", flush=True)
    readings = {}
    try:
        for arm in arms:
            t_arm = time.perf_counter()
            if arm in ("crash", "resize"):
                readings[arm] = arm_crash(args, root, tmp,
                                          respawn=1 if arm == "crash" else 0)
            elif arm == "inproc":
                readings[arm] = arm_inproc(args, root, tmp)
            else:
                readings[arm] = arm_zero1(args, root, tmp)
            readings[arm]["arm_s"] = time.perf_counter() - t_arm
            print(f"  {arm}: {json.dumps(readings[arm])}", flush=True)
    finally:
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(tmp) for f in fs)
        print(f"elastic_probe: {written} bytes written; removing {tmp}",
              flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"elastic_probe": readings, "ranks": args.np,
                      "hosts": args.hosts, "device": args.device or "cuda"}),
          flush=True)
    print(f"elastic_probe: {arms} at {args.np} ranks; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
