#!/usr/bin/env python3
"""The parallelism strategies across GPUs: the full-width LM under dp x tp,
tp, pp and FSDP, the MoE layer under ep, and the MoE exchange alone.

    python3 parallel_probe.py [-np 4] [--device cpu] [--depth full|tiny]
        [--steps 4] [--arms dp2_tp2,tp4,pp4,ep4,fsdp4,alltoall]
        [--out PATH] [--timeout S]

One ``hvdrun`` job of ``-np`` ranks (one GPU each, NCCL; ``--device cpu``:
gloo) runs the arms in turn. Each arm builds its mesh
(``parallel.create_mesh``), trains ``--steps`` steps with the step time as
the median after the first (host clock around work that ends in a read of
the loss), and holds its results against a one-process run of the same
model that every rank computes alone, with no exchange:

- ``dp2_tp2``: the LM (``bench_transformer.py:41-43``: vocab 32768,
  d_model 2048, 16 heads of 128, 12 layers, d_ff 8192, seq 1024, bf16 over
  fp32 weights), batch 8 a dp rank, ``data_parallel_step`` and
  ``DistributedOptimizer(SGD(1e-3, momentum=0.9), process_set=dp set)``;
  the reference trains the dense model on both dp shards (the mean of
  their losses): each rank's losses against its shard's, and its first
  step's gradients (the dp average) against the dense model's, sliced as
  ``param_specs`` shards them;
- ``tp4``: the same at tp 4 (batch 8; dp 1, so each rank's set is itself);
- ``pp4``: the LM's blocks as 4 stages, 8 microbatches of 1 x 1024,
  embedding on every rank and the final norm and tied classifier in
  ``pipeline_loss``'s loss; the replicated leaves' gradients summed over
  the stages. The reference is the sequential model on the whole batch:
  the first step's loss and the stage's gradients, then every step's loss;
- ``ep4``: ``moe_layer`` at d_model 2048, 8 experts (2 a rank), each the
  LM's gelu MLP (d_ff 8192), top-2, capacity factor 1.25, 2048 tokens a
  rank, bf16; loss the MSE to a seeded target plus 0.01 aux; ``gate_w``'s
  gradient averaged over the ranks (``hvd.allreduce_``), the experts'
  summed by the exchange. The reference runs every rank's tokens through
  a plain loop over all 8 experts with its own router (``plain_gating``),
  whose dispatch the layer's must equal bit for bit each step; the first
  step's output, aux and gradients, then every step's loss;
- ``fsdp4``: the LM under ``fsdp_train_step`` (SGD momentum 0.9), batch 8
  a rank, against the replicated run (``DistributedOptimizer`` over the
  four ranks): every step's loss, and the parameters after the steps
  relative to the replicated run's update;
- ``alltoall``: ``bench.py``'s config 5: 2048 tokens a rank of d 512 in
  bf16, the dispatch and combine exchanges (``parallel._comm.all_to_all``,
  one ``all_to_all_single`` each), checked to return the input, timed by
  CUDA events (host clock on the CPU).

Every arm checks after every step that each leaf is bitwise equal on the
ranks that hold it alike (a replicated leaf on all of them, a tp slice on
its dp group; broadcast from the first and compared), and reports the
parameter and optimizer-state bytes a rank, the flash and K1 launches and
the exchanges a step. ``LOSS_TOL`` and ``GRAD_TOL`` state the tolerances.
A failed check fails the job. ``--out`` gets every
rank's readings and the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

ARMS = ("dp2_tp2", "tp4", "pp4", "ep4", "fsdp4", "alltoall")
LR, MOMENTUM, AUX_WEIGHT, SEED = 1e-3, 0.9, 0.01, 0
# the one-process run's loss against the arm's, relative: bf16 products
# summed in another order (tp's partial sums, microbatch shapes); fp32 on
# the CPU. On four H100s the arms read up to 1.9e-5, and a step left out
# moves the LM's loss by 1.5e-4 or more
LOSS_TOL = {"bfloat16": 1e-4, "float32": 1e-5}
# each leaf's first-step gradient against the one-process run's, and
# FSDP's parameters against the replicated run's, relative in norm to that
# run's gradient or update: no gradient or update at all reads 1
GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
MOE = {"full": dict(d=2048, d_ff=8192, experts=8, k=2, factor=1.25,
                    tokens=2048),
       "tiny": dict(d=16, d_ff=32, experts=8, k=2, factor=1.25, tokens=16)}
A2A = {"full": (2048, 512), "tiny": (16, 8)}


def lm_config(depth: str):
    import torch

    from horovod_tpu_torch.models.transformer import TransformerConfig

    if depth == "full":  # benchmarks/bench_transformer.py:41-43
        return TransformerConfig(vocab_size=32768, d_model=2048, n_heads=16,
                                 n_layers=12, d_ff=8192, max_seq=1024,
                                 dtype=torch.bfloat16)
    return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=4, d_ff=64, max_seq=16,
                             dtype=torch.float32)


def tokens_for(cfg, batch: int, seed: int, device):
    """``batch`` sequences of ``max_seq + 1`` tokens (``chip_smoke.py``'s
    draw: the loss drops one token, so attention runs at ``max_seq``)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=g, device=device)


def attn_fn_for(device):
    """The flash kernel (a ring of one) on the card, plain attention on the
    CPU."""
    from horovod_tpu_torch.models.transformer import causal_attention
    from horovod_tpu_torch.parallel import ring_attention

    return causal_attention if device.type == "cpu" else ring_attention


# --- the MoE layer and its plain loop ---------------------------------------

def expert_mlp(p, x):
    """One expert: the LM's gelu MLP, weights fp32, products in x's
    dtype."""
    import torch.nn.functional as F

    w1, w2 = p
    return F.gelu(x @ w1.to(x.dtype), approximate="tanh") @ w2.to(x.dtype)


def moe_weights(m: dict, device, seed: int):
    """The router ``[d, E]`` and every expert's ``(w1 [E, d, d_ff], w2 [E,
    d_ff, d])``, fp32, std 0.02 (the router 1/sqrt(d))."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    d, f, e = m["d"], m["d_ff"], m["experts"]
    gate = torch.randn(d, e, generator=g, device=device) / math.sqrt(d)
    w1 = 0.02 * torch.randn(e, d, f, generator=g, device=device)
    w2 = 0.02 * torch.randn(e, f, d, generator=g, device=device)
    return gate, w1, w2


def plain_gating(gate_logits, n_experts: int, capacity: int, k: int):
    """The router as a plain loop, written apart from ``parallel.moe``:
    softmax; k rounds of argmax over the experts a token has not picked
    yet (picked ones masked to 0, as GShard does); each pick's place in its
    expert's queue counted token by token, after every pick of the earlier
    rounds; picks past ``capacity`` dropped; for k > 1 the kept picks' gate
    values renormalised to sum to 1 a token (top-1 keeps its raw value).
    Returns (slots, gates, aux): the kept (token, expert, place) triples,
    their combine weights (differentiable in the logits) and the
    load-balancing loss on the first pick."""
    import torch

    probs = torch.softmax(gate_logits.float(), dim=-1)
    t = probs.shape[0]
    taken = torch.zeros_like(probs, dtype=torch.bool)
    queue = [0] * n_experts
    slots, first = [], None
    for _ in range(k):
        picks = torch.argmax(probs.masked_fill(taken, 0.0), dim=-1)
        taken[torch.arange(t, device=probs.device), picks] = True
        picks = picks.tolist()
        first = picks if first is None else first
        for tok, j in enumerate(picks):
            if queue[j] < capacity:
                slots.append((tok, j, queue[j]))
            queue[j] += 1
    tok, exp = (torch.tensor([sl[c] for sl in slots], device=probs.device)
                for c in (0, 1))
    gates = probs[tok, exp]
    if k > 1:
        denom = torch.zeros(t, device=probs.device).index_add(0, tok, gates)
        gates = gates / denom[tok].clamp_min(1e-9)
    density = torch.bincount(torch.tensor(first, device=probs.device),
                             minlength=n_experts).float() / t
    aux = (density * probs.mean(dim=0)).sum() * n_experts
    return slots, gates, aux


def dispatch_of(slots, t: int, n_experts: int, capacity: int, device):
    """The dense ``[t, e, c]`` one-hot of ``slots``."""
    import torch

    d = torch.zeros(t, n_experts, capacity, device=device)
    d[tuple(torch.tensor(c, device=device) for c in zip(*slots))] = 1.0
    return d


def check_routing(x, gate_w, m: dict):
    """The layer's router (``parallel.moe``) on ``x``'s logits against
    ``plain_gating``: the dispatch bit for bit."""
    import torch

    from horovod_tpu_torch.parallel.moe import (capacity_for, top1_gating,
                                                topk_gating)

    e, t = m["experts"], x.shape[0]
    cap = capacity_for(t, e, m["factor"])
    with torch.no_grad():
        logits = x.float() @ gate_w.float()
        if m["k"] <= 1:
            got = top1_gating(logits, e, cap)[0]
        else:
            got = topk_gating(logits, e, cap, k=m["k"])[0]
        slots = plain_gating(logits, e, cap, m["k"])[0]
    if not torch.equal(got, dispatch_of(slots, t, e, cap, x.device)):
        raise AssertionError("the layer's dispatch differs from the plain "
                             "router's")


def plain_moe(x, gate_w, w1, w2, m: dict):
    """The MoE layer over one rank's tokens as a plain loop over all the
    experts: ``plain_gating``'s slots, each expert's queue filled from
    them, its MLP, each kept slot's output added to its token with its
    gate weight. Returns (y, aux)."""
    import torch

    e, (t, d) = m["experts"], x.shape
    cap = max(1, int(m["factor"] * t / e))
    slots, gates, aux = plain_gating(x.float() @ gate_w.float(), e, cap,
                                     m["k"])
    y = torch.zeros(t, d, device=x.device)
    for j in range(e):
        mine = [(n, tok, pos) for n, (tok, jj, pos) in enumerate(slots)
                if jj == j]
        if not mine:
            continue
        n_i, tok, pos = (torch.tensor(c, device=x.device)
                         for c in zip(*mine))
        xin = x.new_zeros(cap, d).index_copy(0, pos, x[tok])
        out = expert_mlp((w1[j], w2[j]), xin).float()
        y = y.index_add(0, tok, gates[n_i, None] * out[pos])
    return y.to(x.dtype), aux


# --- the pipelined LM --------------------------------------------------------

def lm_stage_fn(cfg, attn_fn):
    def stage(blocks, x):
        for blk in blocks:
            x = blk(x, cfg.dtype, attn_fn)
        return x
    return stage


def lm_pipeline_loss(model, blocks, toks, n_micro: int, group, attn_fn):
    """The LM's loss through ``pipeline_loss``: ``blocks`` are this rank's
    stage, the embedding runs on every rank (only stage 0 reads it), the
    final norm and the tied classifier in the loss."""
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel import pipeline_loss

    b, s = toks.shape[0], toks.shape[1] - 1
    inputs = model.embed_tokens(toks[:, :-1])
    inputs = inputs.reshape(n_micro, b // n_micro, s, -1)

    def loss_fn(outputs, targets):
        logits = model.head(outputs.reshape(b, s, -1))
        return F.cross_entropy(logits.reshape(b * s, -1), targets.reshape(-1))

    return pipeline_loss(lm_stage_fn(model.cfg, attn_fn), loss_fn, blocks,
                         inputs, toks[:, 1:], group=group)


# --- readings ----------------------------------------------------------------

def _launches() -> dict:
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_pack as fp

    return {"flash": sum(fa.kernel_launches.values()),
            "K1": sum(fp.kernel_launches.values())}


def _counts() -> dict:
    from horovod_tpu_torch.parallel import _comm

    return {**_launches(), **_comm.exchanges}


def _per_step(c0: dict, c1: dict, steps: int) -> dict:
    return {k: (c1[k] - c0[k]) / steps for k in c0}


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _state_bytes(opt) -> int:
    import torch

    return _bytes(t for st in opt.state.values() for t in st.values()
                  if isinstance(t, torch.Tensor))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def same_on(tensors: dict, group, what: str):
    """Each tensor bitwise equal on every rank of ``group``: the first
    rank's broadcast, compared."""
    import torch
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return
    src = dist.get_global_rank(group, 0)
    for name, t in tensors.items():
        ref = t.detach().clone()
        dist.broadcast(ref, src, group=group)
        if not torch.equal(ref, t.detach()):
            raise AssertionError(f"{what}: {name} differs from rank {src}'s")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def rel_err(got, want) -> float:
    return float((got.detach().float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _check_losses(arm: str, got: list, want: list, tol: float) -> float:
    if not all(math.isfinite(x) for x in got):
        raise AssertionError(f"{arm}: non-finite losses {got}")
    worst = max(_rel(a, b) for a, b in zip(got, want))
    if worst > tol:
        raise AssertionError(f"{arm}: losses {got} leave {tol} of the "
                             f"one-process run's {want}")
    return worst


def _timed(step, device):
    t0 = time.perf_counter()
    out = step()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _trace(step, device) -> dict | None:
    """One more step; on the card the first and last rank trace it
    (``chip_smoke.profile_step``: wall, device busy union, idle share, ms
    by kernel category)."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    if device.type != "cuda" or r not in (0, n - 1):
        step()
        _sync(device)
        return None
    from chip_smoke import profile_step

    prof = profile_step(step)
    return {"wall_ms": prof["wall_ms"], "union_ms": prof["union_ms"],
            "idle_share": max(0.0, 1.0 - prof["union_ms"] / prof["wall_ms"]),
            "categories": prof["categories"], "gaps": prof["gaps"],
            "top": prof["top"][:8]}


def _summary(ms: list) -> dict:
    return {"step_ms": ms, "median_step_ms":
            statistics.median(ms[1:]) if len(ms) > 1 else ms[0]}


# --- the arms ----------------------------------------------------------------

def _reference_lm(cfg, toks, shards: int, steps: int, device, attn_fn):
    """The dense LM trained alone on ``toks`` split into ``shards`` equal
    shards (the mean of their losses): each step's shard losses and ms,
    and the first step's gradients."""
    import torch

    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    model = TransformerLM(cfg, device=device, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    parts = toks.chunk(shards)
    losses, ms, grads = [], [], None
    for _ in range(steps):
        def step():
            opt.zero_grad()
            out = []
            for part in parts:
                loss = lm_loss(model, part, attn_fn=attn_fn)
                (loss / shards).backward()
                out.append(loss.item())
            opt.step()
            return out
        out, t = _timed(step, device)
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        losses.append(out)
        ms.append(t)
    del model, opt
    _free(device)
    return losses, ms, grads


def arm_tp(axes: dict, cfg, batch: int, steps: int, device, attn_fn):
    """The LM at dp x tp through ``data_parallel_step`` and the runtime."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (TransformerLM, lm_loss,
                                                      param_specs, tp_slice)
    from horovod_tpu_torch.parallel import create_mesh, data_parallel_step

    mesh = create_mesh(axes)
    dp, d = mesh.size("dp"), mesh.coords["dp"]
    toks = tokens_for(cfg, batch * dp, SEED, device)
    ref, ref_ms, ref_grads = _reference_lm(cfg, toks, dp, steps, device,
                                           attn_fn)
    model = TransformerLM(cfg, device=device, seed=SEED,
                          tp_group=mesh.group("tp"))
    mine = toks.chunk(dp)[d]

    def step_fn(model, opt, tokens):
        opt.zero_grad()
        loss = lm_loss(model, tokens, attn_fn=attn_fn)
        loss.backward()
        opt.step()
        return loss.item()

    step = data_parallel_step(step_fn, mesh=mesh, axis_name="dp")
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters(),
        process_set=step.process_set)
    specs = param_specs(cfg)
    params = dict(model.named_parameters())
    world = hvd.global_process_set().group
    tp, tp_rank = mesh.size("tp"), mesh.coords["tp"]
    losses, ms, grad_err = [], [], {}
    c0 = _counts()
    for s in range(steps):
        loss, t = _timed(lambda: step(model, opt, mine), device)
        if s == 0:  # the dp average the optimizer stepped with
            grad_err = {k: rel_err(p.grad, tp_slice(ref_grads[k], specs[k],
                                                    tp_rank, tp))
                        for k, p in params.items()}
            del ref_grads
        losses.append(loss)
        ms.append(t)
        same_on({k: p for k, p in params.items() if specs[k] is None},
                world, "replicated leaf")
        same_on({k: p for k, p in params.items() if specs[k] is not None},
                mesh.group("dp"), "tp slice")
    counts = _per_step(c0, _counts(), steps)
    dt = str(cfg.dtype).split(".")[-1]
    worst = max(grad_err.values())
    if worst > GRAD_TOL[dt]:
        raise AssertionError(f"{axes}: rank {hvd.rank()}'s gradients leave "
                             f"{GRAD_TOL[dt]} of the dense model's: {grad_err}")
    err = _check_losses(str(axes), losses, [x[d] for x in ref], LOSS_TOL[dt])
    trace = _trace(lambda: step(model, opt, mine), device)
    out = {"losses": losses, "ref_losses": [x[d] for x in ref],
           "max_loss_rel_err": err, "max_grad_rel_err": worst,
           "grad_rel_err": grad_err, "ref_step_ms": ref_ms, "trace": trace,
           "param_bytes": _bytes(params.values()),
           "opt_state_bytes": _state_bytes(opt), "per_step": counts,
           **_summary(ms)}
    del model, opt, params
    _free(device)
    return out


def arm_pp(cfg, steps: int, device, attn_fn, n_micro: int = 8):
    """The LM as ``pp`` stages through ``pipeline_loss``."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"pp": dist.get_world_size()})
    g, n, r = mesh.group("pp"), mesh.size("pp"), mesh.coords["pp"]
    per = cfg.n_layers // n
    toks = tokens_for(cfg, n_micro, SEED, device)
    # the sequential model: the first step's gradients, every step's loss
    model = TransformerLM(cfg, device=device, seed=SEED)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    ref, ref_ms, ref_grads = [], [], None
    for _ in range(steps):
        def ref_step():
            opt.zero_grad()
            loss = lm_loss(model, toks, attn_fn=attn_fn)
            loss.backward()
            return loss.item()
        loss, t = _timed(ref_step, device)
        if ref_grads is None:
            ref_grads = {k: p.grad.clone() for k, p in model.named_parameters()
                         if _stage_of(k, per) in (None, r)}
        opt.step()
        ref.append(loss)
        ref_ms.append(t)
    del model, opt
    _free(device)

    model = TransformerLM(cfg, device=device, seed=SEED)
    blocks = model.blocks[r * per:(r + 1) * per]
    model.blocks = torch.nn.ModuleList(blocks)  # this rank holds its stage
    shared = {k: p for k, p in model.named_parameters()
              if not k.startswith("blocks.")}
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    losses, ms, grad_err = [], [], {}
    c0 = _counts()
    def step():
        opt.zero_grad()
        loss = lm_pipeline_loss(model, blocks, toks, n_micro, g, attn_fn)
        loss.backward()
        # the stages' parts of the replicated leaves' gradients (the
        # position table's is stage 0's alone)
        for p in shared.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad, group=g)
        return loss

    for s in range(steps):
        loss, t = _timed(step, device)
        if s == 0:
            for k, p in model.named_parameters():
                ref_k = k if not k.startswith("blocks.") else \
                    f"blocks.{r * per + int(k.split('.')[1])}." \
                    f"{k.split('.', 2)[2]}"
                grad_err[ref_k] = rel_err(p.grad, ref_grads[ref_k])
        opt.step()
        losses.append(loss.item())
        ms.append(t)
        same_on(shared, g, "replicated leaf")
    counts = _per_step(c0, _counts(), steps)
    dt = str(cfg.dtype).split(".")[-1]
    err = _check_losses("pp", losses, ref, LOSS_TOL[dt])
    worst = max(grad_err.values())
    if worst > GRAD_TOL[dt]:
        raise AssertionError(f"pp: stage {r}'s gradients leave {GRAD_TOL[dt]} "
                             f"of the sequential model's: {grad_err}")
    trace = _trace(lambda: (step(), opt.step()), device)
    out = {"losses": losses, "ref_losses": ref, "max_loss_rel_err": err,
           "trace": trace,
           "max_grad_rel_err": worst, "grad_rel_err": grad_err,
           "ref_step_ms": ref_ms,
           "param_bytes": _bytes(model.parameters()),
           "opt_state_bytes": _state_bytes(opt), "per_step": counts,
           **_summary(ms)}
    del model, opt, blocks, shared
    _free(device)
    return out


def _stage_of(key: str, per: int):
    return int(key.split(".")[1]) // per if key.startswith("blocks.") else None


def arm_ep(m: dict, steps: int, device, dtype):
    """``moe_layer`` over the ep group against the plain loop."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import create_mesh, moe_layer

    mesh = create_mesh({"ep": hvd.size()})
    g, n, r = mesh.group("ep"), mesh.size("ep"), mesh.coords["ep"]
    e_local, t = m["experts"] // n, m["tokens"]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    xs = torch.randn(n, t, m["d"], generator=gen, device=device).to(dtype)
    tgts = torch.randn(n, t, m["d"], generator=gen, device=device)

    def loss_of(y, aux, tgt):
        return ((y.float() - tgt) ** 2).mean() + AUX_WEIGHT * aux

    # the plain loop over every rank's tokens and every expert
    gate, w1, w2 = (x.requires_grad_() for x in moe_weights(m, device, SEED))
    opt = torch.optim.SGD([gate, w1, w2], lr=LR, momentum=MOMENTUM)
    ref, ref_ms, first = [], [], None
    for _ in range(steps):
        def ref_step():
            opt.zero_grad()
            outs = [plain_moe(xs[j], gate, w1, w2, m) for j in range(n)]
            aux = sum(a for _, a in outs) / n  # the layer's mean over ranks
            per_rank = [loss_of(y, aux, tgts[j]) for j, (y, _) in
                        enumerate(outs)]
            sum(per_rank).backward()
            gate.grad.div_(n)  # the arm averages the router's gradient
            return outs, [x.item() for x in per_rank]
        (outs, per_rank), t_ms = _timed(ref_step, device)
        if first is None:
            first = {"y": outs[r][0].detach().clone(),
                     "aux": sum(a.item() for _, a in outs) / n,
                     "gate": gate.grad.clone(),
                     "w1": w1.grad[r * e_local:(r + 1) * e_local].clone(),
                     "w2": w2.grad[r * e_local:(r + 1) * e_local].clone()}
        opt.step()
        ref.append(per_rank[r])
        ref_ms.append(t_ms)
    del gate, w1, w2, opt
    _free(device)

    gate, w1, w2 = moe_weights(m, device, SEED)
    w1 = w1[r * e_local:(r + 1) * e_local].clone().requires_grad_()
    w2 = w2[r * e_local:(r + 1) * e_local].clone().requires_grad_()
    gate.requires_grad_()
    opt = torch.optim.SGD([gate, w1, w2], lr=LR, momentum=MOMENTUM)
    losses, ms, errs = [], [], {}
    c0 = _counts()
    def step():
        opt.zero_grad()
        y, aux = moe_layer(xs[r], gate, expert_mlp, (w1, w2), group=g,
                           capacity_factor=m["factor"], k=m["k"])
        loss = loss_of(y, aux, tgts[r])
        loss.backward()
        hvd.allreduce_(gate.grad, op=hvd.Average, name="moe.gate_w",
                       process_set=mesh.process_set("ep"))
        return y, aux, loss

    for s in range(steps):
        check_routing(xs[r], gate, m)
        (y, aux, loss), t_ms = _timed(step, device)
        if s == 0:
            errs = {"y": rel_err(y, first["y"]),
                    "aux": _rel(aux.item(), first["aux"]),
                    "gate": rel_err(gate.grad, first["gate"]),
                    "w1": rel_err(w1.grad, first["w1"]),
                    "w2": rel_err(w2.grad, first["w2"])}
        opt.step()
        losses.append(loss.item())
        ms.append(t_ms)
        same_on({"gate_w": gate}, g, "the router")
    counts = _per_step(c0, _counts(), steps)
    dt = str(dtype).split(".")[-1]
    err = _check_losses("ep", losses, ref, LOSS_TOL[dt])
    if max(errs.values()) > GRAD_TOL[dt]:
        raise AssertionError(f"ep: rank {r} against the plain loop: {errs}")
    trace = _trace(lambda: (step(), opt.step()), device)
    out = {"losses": losses, "ref_losses": ref, "max_loss_rel_err": err,
           "trace": trace,
           "first_step_rel_err": errs, "ref_step_ms": ref_ms,
           "capacity": max(1, int(m["factor"] * t / m["experts"])),
           "param_bytes": _bytes([gate, w1, w2]),
           "opt_state_bytes": _state_bytes(opt), "per_step": counts,
           **_summary(ms)}
    del gate, w1, w2, opt
    _free(device)
    return out


def arm_fsdp(cfg, batch: int, steps: int, device, attn_fn):
    """``fsdp_train_step`` against the replicated data-parallel run."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.parallel import create_mesh, fsdp_train_step

    mesh = create_mesh({"dp": hvd.size()})
    n, r = mesh.size("dp"), mesh.coords["dp"]
    mine = tokens_for(cfg, batch * n, SEED, device).chunk(n)[r]
    world = hvd.global_process_set().group

    def mean(x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=device)
        dist.all_reduce(t, group=world)
        return t.item() / n

    model = TransformerLM(cfg, device=device, seed=SEED)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters(),
        process_set=mesh.process_set("dp"))
    ref, ref_ms = [], []
    for _ in range(steps):
        def ref_step():
            opt.zero_grad()
            loss = lm_loss(model, mine, attn_fn=attn_fn)
            loss.backward()
            opt.step()
            return loss.item()
        loss, t = _timed(ref_step, device)
        ref.append(mean(loss))
        ref_ms.append(t)
        same_on(dict(model.named_parameters()), world, "replicated run")
    ref_bytes = (_bytes(model.parameters()), _state_bytes(opt))
    # the replicated run's update of each leaf, and where it ended
    ref_update = {k: p.detach() - init[k] for k, p in model.named_parameters()}
    del model, opt
    _free(device)

    model = TransformerLM(cfg, device=device, seed=SEED)
    make = fsdp_train_step(lambda m, tokens: lm_loss(m, tokens,
                                                     attn_fn=attn_fn),
                           lambda ps: torch.optim.SGD(ps, lr=LR,
                                                      momentum=MOMENTUM),
                           mesh, axis="dp")
    state, step = make(model)
    losses, ms = [], []
    c0 = _counts()
    for _ in range(steps):
        loss, t = _timed(lambda: step(mine).item(), device)
        losses.append(loss)
        ms.append(t)
        same_on({k: p for k, p in state.params.items()
                 if k not in state.shards}, world, "replicated leaf")
    counts = _per_step(c0, _counts(), steps)
    at_rest = state.bytes_a_rank()
    full = state.full_state_dict()
    # the parameters against the replicated run's, relative to its update
    update_err = {k: rel_err(full[k] - init[k], ref_update[k]) for k in full}
    del full, init, ref_update
    dt = str(cfg.dtype).split(".")[-1]
    worst = max(update_err.values())
    if worst > GRAD_TOL[dt]:
        raise AssertionError(f"fsdp: rank {r}'s parameters leave "
                             f"{GRAD_TOL[dt]} of the replicated run's "
                             f"update: {update_err}")
    err = _check_losses("fsdp", losses, ref, LOSS_TOL[dt])
    trace = _trace(lambda: step(mine), device)
    out = {"losses": losses, "ref_losses": ref, "max_loss_rel_err": err,
           "max_update_rel_err": worst, "update_rel_err": update_err,
           "ref_step_ms": ref_ms,
           "trace": trace,
           "param_bytes": at_rest["params"],
           "opt_state_bytes": at_rest["optimizer_state"],
           "replicated_param_bytes": ref_bytes[0],
           "replicated_opt_state_bytes": ref_bytes[1],
           "per_step": counts, **_summary(ms)}
    del model, state, step
    _free(device)
    return out


def arm_alltoall(shape, device, iters: int = 20, rounds: int = 5):
    """The MoE dispatch and combine exchanges alone: ``rounds`` of
    ``iters`` back to back, after a barrier (ms a pair of exchanges, so
    the ranks' skew at the barrier spreads over ``iters``)."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import _comm, create_mesh

    mesh = create_mesh({"ep": hvd.size()})
    g, n = mesh.group("ep"), mesh.size("ep")
    t, d = shape
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.randn(t, d, generator=gen, device=device).to(torch.bfloat16)

    def exchange():
        y = _comm.all_to_all(x.reshape(n, t // n, d), g)
        return _comm.all_to_all(y, g).reshape(t, d)

    if not torch.equal(exchange(), x):
        raise AssertionError("alltoall: dispatch and combine did not return "
                             "the input")
    ms = []
    for _ in range(rounds):
        dist.barrier(group=g)
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                exchange()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                exchange()
            ms.append((time.perf_counter() - t0) * 1e3 / iters)
    return {"ms": ms, "median_ms": statistics.median(ms),
            "bytes_a_rank": 2 * x.numel() * x.element_size(),
            "timer": "cuda events" if device.type == "cuda" else "host"}


def worker(args) -> int:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context

    if args.device == "cpu":
        torch.set_num_threads(1)
    hvd.init(device=args.device)
    device, r = hvd.device(), hvd.rank()
    cfg = lm_config(args.depth)
    attn_fn = attn_fn_for(device)
    batch = 8 if args.depth == "full" else 2
    arms = args.arms.split(",")
    res = {}
    for arm in arms:
        t0 = time.perf_counter()
        # the process sets the runtime holds when the arm starts (the
        # meshes of earlier arms add theirs)
        sets = len(context._require_init().process_sets)
        if arm == "dp2_tp2":
            res[arm] = arm_tp({"dp": 2, "tp": 2}, cfg, batch, args.steps,
                              device, attn_fn)
        elif arm == "tp4":
            res[arm] = arm_tp({"dp": 1, "tp": 4}, cfg, batch, args.steps,
                              device, attn_fn)
        elif arm == "pp4":
            res[arm] = arm_pp(cfg, args.steps, device, attn_fn)
        elif arm == "ep4":
            res[arm] = arm_ep(MOE[args.depth], args.steps, device,
                              cfg.dtype)
        elif arm == "fsdp4":
            res[arm] = arm_fsdp(cfg, batch, args.steps, device, attn_fn)
        elif arm == "alltoall":
            res[arm] = arm_alltoall(A2A[args.depth], device)
        else:
            raise ValueError(f"unknown arm {arm}")
        res[arm]["seconds"] = time.perf_counter() - t0
        res[arm]["process_sets_at_start"] = sets
        if device.type == "cuda":
            res[arm]["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        print(f"rank {r} {arm}: " + json.dumps(
            {k: v for k, v in res[arm].items()
             if k in ("median_step_ms", "median_ms", "max_loss_rel_err",
                      "param_bytes", "opt_state_bytes", "seconds")}),
            flush=True)
    with open(os.path.join(args.rank_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    print(f"PARALLEL_PROBE_OK {r}", flush=True)
    return 0


def _prebuild():
    """Both kernels the arms launch, one nvcc each, at once."""
    from horovod_tpu_torch.ops import _build

    errors = []

    def build(name):
        try:
            _build.build(name)
        except Exception as e:  # reported below, the probe then fails
            errors.append(e)

    threads = [threading.Thread(target=build, args=(n,))
               for n in ("flash_attention_sm90", "fused_pack")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-np", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the workers on gloo; default: one GPU "
                    "each")
    ap.add_argument("--depth", default="full", choices=("full", "tiny"))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if args.worker:
        return worker(args)
    import tempfile

    card = None
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card, flush=True)
        t0 = time.perf_counter()
        _prebuild()
        print(f"  kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    with tempfile.TemporaryDirectory() as rank_dir:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
               str(args.np), sys.executable, os.path.abspath(__file__),
               "--worker", "--rank-dir", rank_dir, "--depth", args.depth,
               "--steps", str(args.steps), "--arms", args.arms] + (
                   ["--device", args.device] if args.device else [])
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        try:
            out = p.communicate(timeout=args.timeout)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            print(p.communicate()[0])
            raise AssertionError("parallel_probe: the job timed out")
        print(out, flush=True)
        if p.returncode != 0 or not all(f"PARALLEL_PROBE_OK {k}" in out
                                        for k in range(args.np)):
            raise AssertionError("parallel_probe: the job failed")
        ranks = []
        for k in range(args.np):
            with open(os.path.join(rank_dir, f"rank{k}.json")) as f:
                ranks.append(json.load(f))
    readings = {"card": card, "np": args.np, "depth": args.depth,
                "device": args.device or "cuda", "steps": args.steps,
                "job_seconds": time.perf_counter() - t0, "ranks": ranks}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)
    for arm in args.arms.split(","):
        r0 = ranks[0][arm]
        keys = ("median_step_ms", "ref_step_ms", "median_ms",
                "max_loss_rel_err", "param_bytes", "opt_state_bytes")
        print(f"  {arm}: " + ", ".join(f"{k} {r0[k]}" for k in keys
                                       if k in r0), flush=True)
    print(f"parallel_probe: {args.np} ranks on {args.device or 'cuda'}, "
          f"arms {args.arms}, every check held", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except AssertionError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
