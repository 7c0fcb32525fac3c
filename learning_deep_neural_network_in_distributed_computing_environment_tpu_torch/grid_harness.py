"""Spawn targets that hold the rank grid's pieces against their dense
twins (``parallel/``), for the CPU tests and ``chip_smoke.py``; nothing on
the training path imports this module.

``module_worker`` runs one forward and backward of a model's rank-grid
shards (tensor-parallel module, ZeRO-3 shards) and of its dense twin in
the same rank, from the same parameters; ``vocab_stats_worker`` holds
``tp.vocab_parallel_token_stats`` against ``train.masked_token_stats``;
``gather_worker`` holds ``fsdp.gather_params`` and its reduce-scatter;
``moe_block_job`` runs one MoE layer on the rank's experts and F slice;
``sp_attention_job`` runs one of ``parallel/sp.py``'s attentions on the
rank's chunk of a sequence; ``pp_schedule_job`` runs one of
``parallel/pp.py``'s schedules on a stack of toy stages.  Each writes what
it found to ``{out_dir}/rank{r}-{i}.pt``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import mesh, weights
from .config import Config


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def module_job(job: dict, grid: mesh.Grid, device: torch.device) -> dict:
    """One job of ``module_worker``: ``job`` has ``model``, ``vocab``,
    ``kw`` (Config fields), ``state_dict`` (the dense twin's parameters,
    numpy; without it the seeded init of ``kw``'s seed, the same on every
    rank of one device type), ``x``, ``y``, ``m`` (the worker's batch).
    Under a pipe axis the rank's module is its stage and the step runs
    the microbatches by ``job["schedule"]`` (``pp_microbatches`` in
    ``kw``); the logits are the last stage's.  With ``num_experts`` in
    ``kw`` the loss adds ``moe_aux_weight`` times the MoE aux loss, over
    the fsdp size (each fsdp slice routes its own tokens: the dense twin
    runs the slices one by one).
    Returns the largest abs differences of this rank's logits (its slice of
    the batch over fsdp, its chunk of every sequence over seq, its vocab
    slice; 0.0 off the last stage) and of the worker's joined gradients
    from the dense twin's
    (``logits_err``, ``grads_err``: the comparison ``chip_smoke.py``
    gates, which the CPU tests check against their own), the count of
    leaves a grid axis shards; with experts, the rank's MoE aux loss
    (``aux``), the dense twin's over the same tokens (``dense_aux``: its
    fsdp slice's) and their abs difference (``aux_err``), all three None
    under pipe (a stage sums only its layers' aux, over its microbatches)
    and under seq (a chunk routes on its own, the twin does not); the
    flash launches of the rank's pass; unless ``summary``, also the rank's logits
    and loss, the whole gradients by JAX leaf key and the dense twin's
    logits, loss and gradients, for the tests' comparisons with JAX."""
    from .driver import build_model_for
    from .parallel.shards import GridParams
    from .parallel.tp import vocab_parallel_token_stats
    from .train import masked_token_stats, masked_weights
    cfg = Config(model=job["model"], compute_dtype="float32",
                 device=device.type, **job.get("kw", {}))
    dense = build_model_for(cfg, job["vocab"], device, job.get("shape"))
    if "state_dict" in job:
        dense.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in job["state_dict"].items()})
    tp = grid.groups["model"] if grid.size("model") > 1 else None
    split_seq = cfg.sequence_parallel != "none"
    sp = (grid.groups["seq"] if grid.size("seq") > 1 and split_seq
          else None)
    pipe = grid.groups["pipe"] if grid.size("pipe") > 1 else None
    ep = grid.groups["expert"] if grid.size("expert") > 1 else None
    module = build_model_for(
        cfg, job["vocab"], device, job.get("shape"), tp=tp, sp=sp,
        num_layers=None if pipe is None else
        len(dense.blocks) // pipe.world_size, ep=ep)
    gp = GridParams({k: p.detach() for k, p in dense.named_parameters()},
                    weights.state_layout(dense), module, grid, device,
                    shard_tok_emb=job["model"].startswith("gpt"),
                    split_seq=split_seq)
    x, y, m = (torch.as_tensor(job[k]).to(device) for k in ("x", "y", "m"))
    denom = masked_weights(y, m).sum().clamp_min(1.0)
    f = grid.groups.get("fsdp")
    n_slices = f.world_size if f is not None else 1
    xs, ys, ms = ((t.chunk(n_slices)[f.rank] for t in (x, y, m))
                  if n_slices > 1 else (x, y, m))
    experts = cfg.num_experts > 0
    aux_w = cfg.moe_aux_weight / n_slices
    if sp is not None:
        xs, ys = (t.chunk(sp.world_size, dim=1)[sp.rank] for t in (xs, ys))
    vocab_parallel = tp is not None and not job["model"].startswith("vit")
    from .ops import flash
    flash.reset_launch_counts()

    def stats(logits, ys, ms):
        ce, w, _c = (vocab_parallel_token_stats(logits, ys, ms, tp)
                     if vocab_parallel else masked_token_stats(logits, ys, ms))
        return (ce * w).sum() / denom

    rank_aux = None
    if pipe is None:
        with gp.applied():
            logits, rank_aux = (module(xs, with_aux=True) if experts
                                else (module(xs), None))
            loss = stats(logits, ys, ms)
            if rank_aux is not None:
                loss = loss + aux_w * rank_aux
            grads = torch.autograd.grad(loss, gp.params)
    else:
        logits, loss, grads = _pipe_step(job, cfg, gp, module, pipe, stats,
                                         xs, ys, ms, aux_w)
    launches = dict(flash.LAUNCHES)
    grads = gp.whole(gp.reduce_grads(list(grads)))
    out = {"logits": _np(logits), "loss": float(loss),
           "grads": {k: _np(g) for k, g in zip(gp.keys, grads)},
           "keys": list(gp.keys), "specs": gp.specs}
    names = [n for n, _p in dense.named_parameters()]
    # BatchNorm normalises, and an MoE layer routes, each fsdp slice on
    # its own: the dense twin runs the slices one by one over the whole
    # batch's denominator (JAX's FSDP semantics, train.py:1596-1622)
    parts, d_auxes, d_loss = [], [], 0.0
    for xs_, ys_, ms_ in zip(*(t.chunk(n_slices if experts
                                       or list(dense.buffers()) else 1)
                               for t in (x, y, m))):
        o, d_aux = (dense(xs_, with_aux=True) if experts
                    else (dense(xs_), None))
        parts.append(o)
        d_auxes.append(d_aux)
        ce, w, _c = masked_token_stats(o, ys_, ms_)
        d_loss = d_loss + (ce * w).sum() / denom
        if d_aux is not None:
            d_loss = d_loss + aux_w * d_aux
    d_logits = torch.cat(parts)
    d_grads = weights.jax_param_leaves(
        dict(zip(names, torch.autograd.grad(d_loss,
                                            list(dense.parameters())))),
        weights.state_layout(dense))
    # this rank's part of the dense twin's logits: its rows over fsdp, its
    # positions over seq, its vocab slice under vocab parallelism
    mine = d_logits.chunk(n_slices)[f.rank] if n_slices > 1 else d_logits
    if sp is not None:
        mine = mine.chunk(sp.world_size, dim=1)[sp.rank]
    if vocab_parallel:
        mine = mine.chunk(tp.world_size, dim=-1)[tp.rank]
    errs = {"logits_err": (float((logits - mine).detach().abs().max())
                           if logits.numel() else 0.0),
            "grads_err": max(float(np.abs(_np(g) - d_grads[k]).max())
                             for k, g in zip(gp.keys, grads)),
            "sharded": sum(any(gp.specs[k]) for k in gp.keys),
            "leaves": len(gp.keys),
            "launches": launches}
    if rank_aux is not None and sp is None:
        # the MoE aux losses summed over the layers: the rank's, and the
        # dense twin's over the same tokens (its fsdp slice)
        aux = float(rank_aux.detach())
        dense_aux = float(d_auxes[f.rank if n_slices > 1 else 0].detach())
        errs.update(aux=aux, dense_aux=dense_aux,
                    aux_err=abs(aux - dense_aux))
    else:
        errs.update(aux=None, dense_aux=None, aux_err=None)
    if job.get("summary"):
        return errs
    out.update(errs, dense_logits=_np(d_logits), dense_loss=float(d_loss),
               dense_grads=d_grads)
    return out


def _pipe_step(job, cfg, gp, module, pipe, stats, xs, ys, ms, aux_w):
    """One train step of a pipe stage (``job["schedule"]``, the engine's
    construction, each microbatch's MoE aux times ``aux_w`` over M):
    ``(logits, loss, gradients of the shards)``, the logits and loss the
    last stage's (empty and 0.0 elsewhere)."""
    from .parallel import pp
    m = cfg.pp_microbatches or pipe.world_size
    xm, ym, mm = pp.microbatches(m, xs, ys, ms)
    parts, sums = [], []

    def last(h, i):
        logits = module.logits(h)
        parts.append(logits.detach())
        return stats(logits, ym[i], mm[i]), torch.zeros(())

    grads = gp.accumulate_grads(lambda: sums.append(pp.model_pass(
        module, pipe, xm, last, job.get("schedule", "gpipe"), xs.device,
        aux_weight=aux_w / m)))
    loss = sums[0][0]
    logits = torch.cat(parts) if parts else torch.zeros(0)
    return logits, (0.0 if loss is None else loss), grads


def module_worker(rank: int, world_size: int, store_path: str,
                  job_path: str, out_dir: str, device: str = "cpu") -> None:
    """A rank of the module checks (a spawn target): ``job_path`` holds
    ``{"axes": {axis: size}, "jobs": [job, ...]}`` (``torch.save``);
    each job's result goes to ``rank{rank}-{i}.pt``.  A job with
    ``"axes"`` of its own runs on that grid (every rank makes each grid
    once, in job order).  On ``cuda`` every rank runs on the card
    (``mesh.worker_device``) and the module jobs record the flash
    kernels' launches of the shard's pass."""
    spec = torch.load(job_path, weights_only=False)
    device = mesh.worker_device(rank, device)
    # the fp32 comparisons must not drop to TF32 on a card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jobs = {"module": lambda job, grid: module_job(job, grid, device),
            "vocab": vocab_stats_job, "gather": gather_job,
            "sp": lambda job, grid: sp_attention_job(job, grid, device),
            "moe": lambda job, grid: moe_block_job(job, grid, device),
            "pp": lambda job, grid: pp_schedule_job(job, grid, device)}
    with mesh.init_group(rank, world_size, device, store_path) as world:
        grids = {}
        for i, job in enumerate(spec["jobs"]):
            axes = job.get("axes", spec["axes"])
            key = tuple(axes.items())
            if key not in grids:
                grids[key] = mesh.make_grid(world, axes)
            res = jobs[job.get("kind", "module")](job, grids[key])
            # whole or absent: a reader in a shared start polls for it
            path = os.path.join(out_dir, f"rank{rank}-{i}.pt")
            torch.save(res, path + ".tmp")
            os.replace(path + ".tmp", path)
        for grid in grids.values():
            grid.close()


MOE_LEAVES = ("gate", "w1", "b1", "w2", "b2")


def moe_slices(shapes: dict, e: tuple, t: tuple) -> dict:
    """{leaf: index tuple} of the MoE leaves (JAX layout: gate kernel [H,
    E], w1 [E, H, F], b1 [E, F], w2 [E, F, H], b2 [E, H]) that the rank at
    expert coordinate ``e`` and model coordinate ``t`` ((index, size)
    each) holds: its experts of the expert stacks, its F slice of w1, b1
    and w2; the gate whole."""
    def cut(n, c):
        return slice(c[0] * n // c[1], (c[0] + 1) * n // c[1])
    n_e, f = shapes["w1"][0], shapes["w1"][2]
    return {"gate": (slice(None),) * 2,
            "w1": (cut(n_e, e), slice(None), cut(f, t)),
            "b1": (cut(n_e, e), cut(f, t)),
            "w2": (cut(n_e, e), cut(f, t), slice(None)),
            "b2": (cut(n_e, e), slice(None))}


def moe_block_job(job: dict, grid: mesh.Grid, device: torch.device) -> dict:
    """One MoE layer (``models/moe.py``) on the rank's experts and F slice
    (its ``expert`` and ``model`` lines) and the dense layer in the same
    rank, from the same parameters: ``job["params"]`` ({leaf: array}, the
    JAX layout of ``MOE_LEAVES``), ``x`` [B, T, H] and the cotangent
    ``do``, fp32; ``capacity_factor``; the loss ``sum(out * do) +
    aux_weight * aux``.  Returns the largest abs differences of the
    output, the aux loss and each leaf's gradient (the rank's slice) from
    the dense layer's (``errors``); unless ``summary``, also the rank's
    output, aux and gradients (JAX layout) and its slices."""
    from .models.moe import MoEFFN
    tp = grid.groups["model"] if grid.size("model") > 1 else None
    ep = grid.groups["expert"] if grid.size("expert") > 1 else None
    params = {k: np.asarray(v, np.float32) for k, v in job["params"].items()}
    h, n_e = params["gate"].shape
    f = params["w1"].shape[2]
    idx = moe_slices({k: v.shape for k, v in params.items()},
                     (grid.index("expert"), grid.size("expert")),
                     (grid.index("model"), grid.size("model")))
    x = torch.as_tensor(job["x"]).to(device)
    do = torch.as_tensor(job["do"]).to(device)

    def run(layer, mine: bool):
        with torch.no_grad():
            for k in MOE_LEAVES:
                a = params[k][idx[k]] if mine else params[k]
                t = torch.as_tensor(np.ascontiguousarray(
                    a.T if k == "gate" else a))
                dst = layer.gate.weight if k == "gate" else getattr(layer, k)
                dst.copy_(t)
        out, aux = layer(x)
        loss = (out * do).sum() + job.get("aux_weight", 1.0) * aux
        ps = [layer.gate.weight] + [getattr(layer, k)
                                    for k in MOE_LEAVES[1:]]
        grads = torch.autograd.grad(loss, ps)
        g = {k: _np(v.T if k == "gate" else v)
             for k, v in zip(MOE_LEAVES, grads)}
        return _np(out), float(aux.detach()), g

    kw = dict(capacity_factor=job.get("capacity_factor", 1.25),
              device=device)
    got = run(MoEFFN(h, n_e, f, tp=tp, ep=ep, **kw), True)
    want = run(MoEFFN(h, n_e, f, **kw), False)
    res = {"errors": {
        "out": float(np.abs(got[0] - want[0]).max()),
        "aux": abs(got[1] - want[1]),
        **{k: float(np.abs(got[2][k] - want[2][k][idx[k]]).max())
           for k in MOE_LEAVES}}}
    if not job.get("summary"):
        res.update(out=got[0], aux=got[1], grads=got[2],
                   index={k: [(s.start, s.stop) for s in v]
                          for k, v in idx.items()})
    return res


def sp_inputs(job: dict) -> list[np.ndarray]:
    """``job``'s whole q, k, v and the cotangent ``do``, fp32, drawn from
    ``job["seed"]`` at ``job["shape"]`` (B, L, H, KV, D)."""
    b, l, h, kv, d = job["shape"]
    rng = np.random.default_rng(job["seed"])
    return [rng.standard_normal((b, l, n, d), dtype=np.float32)
            for n in (h, kv, kv, h)]


def sp_attention_job(job: dict, grid: mesh.Grid, device: torch.device
                     ) -> dict:
    """``attend`` with ``job["impl"]`` (ring, ring_zigzag, all_to_all) over
    the rank's ``seq`` line on its contiguous chunk of the whole q, k, v
    [B, L, heads, D] (``sp_inputs``, cast to ``job["dtype"]``, default
    fp32), and the gradients of ``sum(out * do)`` (``do`` the cotangent,
    fp32) with respect to the chunk's q, k and v, with the hops' counters
    and the pass's wall (ms, the card synchronised); and the same of the
    port's dense attention on the whole sequence in this rank.  Returns
    each result's max abs difference from the dense one's chunk over the
    dense tensor's max |value| (``errors``: the comparison
    ``chip_smoke.py`` gates, which the CPU tests check against their own);
    unless ``summary``, also both results in fp32."""
    from .ops.attention import attend
    from .parallel import sp
    g = grid.groups["seq"]
    dtype = getattr(torch, job.get("dtype", "float32"))
    causal = job.get("causal", False)
    whole = [torch.as_tensor(a).to(device) for a in sp_inputs(job)]
    lc = whole[0].shape[1] // g.world_size
    part = lambda t: t[:, g.rank * lc:(g.rank + 1) * lc]
    q, k, v = (part(t).to(dtype).requires_grad_() for t in whole[:3])
    do = part(whole[3])
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sp.reset_stats()
    sync()
    t0 = time.perf_counter()
    out = attend(q, k, v, impl=job["impl"], group=g, causal=causal)
    grads = torch.autograd.grad((out.float() * do).sum(), (q, k, v))
    sync()
    res = {"seq": g.rank, "stats": dict(sp.STATS),
           "ms": (time.perf_counter() - t0) * 1e3}
    got = [out.detach().float(), *(t.float() for t in grads)]
    full = [t.to(dtype).requires_grad_() for t in whole[:3]]
    d_out = attend(*full, impl="dense", causal=causal)
    d_grads = torch.autograd.grad((d_out.float() * whole[3]).sum(), full)
    want = [d_out.detach().float(), *(t.float() for t in d_grads)]
    res["errors"] = [float((a - part(b)).abs().max() / b.abs().max())
                     for a, b in zip(got, want)]
    if job.get("summary"):
        return res
    res.update(out=_np(got[0]), grads=[_np(t) for t in got[1:]],
               dense_out=_np(want[0]),
               dense_grads=[_np(t) for t in want[1:]])
    return res


def vocab_stats_job(job: dict, grid: mesh.Grid) -> dict:
    """``tp.vocab_parallel_token_stats`` on this rank's vocab slice of
    ``job["logits"]`` [.., V], and the gradient of the masked mean CE
    with respect to the slice."""
    from .parallel.tp import vocab_parallel_token_stats
    tp = grid.groups["model"]
    full = torch.as_tensor(job["logits"])
    v = full.shape[-1] // tp.world_size
    part = full[..., tp.rank * v:(tp.rank + 1) * v].clone().requires_grad_()
    labels, mask = torch.as_tensor(job["labels"]), torch.as_tensor(job["mask"])
    ce, w, correct = vocab_parallel_token_stats(part, labels, mask, tp)
    loss = (ce * w).sum() / w.sum().clamp_min(1.0)
    (g,) = torch.autograd.grad(loss, part)
    return {"ce": _np(ce), "w": _np(w), "correct": float(correct),
            "grad": _np(g)}


def gather_job(job: dict, grid: mesh.Grid) -> dict:
    """``fsdp.gather_params`` of this rank's shards of ``job["leaves"]``
    ({key: array}, sharded by ``fsdp.fsdp_param_specs``), and the shard
    gradients of ``sum(leaf * job["weights"][key] * (1 + rank))``: each
    must be the sum over ranks of the rank's cotangent slice."""
    from .parallel import fsdp
    g = grid.groups["fsdp"]
    leaves = {k: np.asarray(v) for k, v in job["leaves"].items()}
    specs = fsdp.fsdp_param_specs({k: v.shape for k, v in leaves.items()},
                                  axis_size=g.world_size)
    shards = weights.shard_params(leaves, specs,
                                  {"fsdp": (g.rank, g.world_size)})
    keys = list(leaves)
    params = [torch.from_numpy(np.ascontiguousarray(shards[k]))
              .requires_grad_() for k in keys]
    dims = [specs[k].index("fsdp") if "fsdp" in specs[k] else None
            for k in keys]
    full = fsdp.gather_params(params, dims, g)
    loss = sum((t * torch.as_tensor(job["weights"][k])).sum()
               for t, k in zip(full, keys)) * (1 + g.rank)
    grads = torch.autograd.grad(loss, params)
    grads = fsdp.reduce_replicated_grads(list(grads), dims, g)
    return {"full": {k: _np(t) for k, t in zip(keys, full)},
            "grads": {k: _np(t) for k, t in zip(keys, grads)},
            "specs": specs}


def pp_schedule_job(job: dict, grid: mesh.Grid, device: torch.device
                    ) -> dict:
    """``job["schedule"]`` (gpipe or 1f1b) over the rank's ``pipe`` line
    on a stack of toy stages (the JAX ``tests/test_pp.py`` ones): stage s
    maps ``a`` to ``tanh(a * w[s, 0])`` (``w`` [P, 1]) or ``tanh(a @
    w[s])`` (``w`` [P, D, D]); the loss of microbatch i is ``sum(y**2)``,
    or with ``head`` [D, K] and ``tgt`` [M, mb, K] ``sum((y @ head -
    tgt[i])**2) / (M * mb)``.  ``xs`` [M, mb, D] are the microbatches.
    Returns this rank's pieces (the last stage's outputs, loss and head
    gradient, its stage's weight gradient, stage 0's input gradient), the
    most microbatches it held in flight, the hops' counters, the pass's
    wall (ms, the card synchronised) and each piece's largest abs
    difference from the same computation run stage after stage in this
    rank (``errors``: the comparison ``chip_smoke.py`` gates, which the
    CPU tests check against their own); unless ``summary``, the pieces
    themselves."""
    from .parallel import pp
    g = grid.groups["pipe"]
    p, s = g.world_size, g.rank
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
    xs_all, w_all = t(job["xs"]), t(job["w"])
    head = None if job.get("head") is None else t(job["head"])
    tgt = None if job.get("tgt") is None else t(job["tgt"])
    m, mb = xs_all.shape[:2]
    matmul = w_all.ndim == 3

    def stage_fn(w, a):
        return torch.tanh(a @ w) if matmul else torch.tanh(a * w[0])

    def loss_fn(hp, y, i):
        if hp is None:
            return (y ** 2).sum()
        return ((y @ hp - tgt[i]) ** 2).sum() / (m * mb)

    xs = xs_all.clone().requires_grad_()
    w = w_all[s].clone().requires_grad_()
    hp = None if head is None else head.clone().requires_grad_()
    outs = []

    def last(y, i):
        outs.append(y.detach())
        return loss_fn(hp, y, i), torch.zeros((), device=device)

    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    pp.reset_stats()
    sync()
    t0 = time.perf_counter()
    loss, _ = pp.run(pp.order(job["schedule"], p, s, m), g,
                     first=lambda i: xs[i],
                     body=lambda a: (stage_fn(w, a), None),
                     last=last, shape=lambda i: tuple(xs_all.shape[1:]),
                     dtype=torch.float32, device=device)
    sync()
    res = {"stage": s, "stats": dict(pp.STATS),
           "ms": (time.perf_counter() - t0) * 1e3,
           "in_flight": pp.STATS["in_flight"],
           "in_flight_bound": pp.in_flight_bound(job["schedule"], p, s, m)}
    got = {"w_grad": w.grad}
    if s == 0:
        got["xs_grad"] = xs.grad
    if s == p - 1:
        got.update(out=torch.stack(outs), loss=loss)
        if hp is not None:
            got["head_grad"] = hp.grad
    # the same stack stage after stage, in this rank
    wd = w_all.clone().requires_grad_()
    xd = xs_all.clone().requires_grad_()
    hd = None if head is None else head.clone().requires_grad_()
    y = xd
    for k in range(p):
        y = stage_fn(wd[k], y)
    dloss = sum(loss_fn(hd, y[i], i) for i in range(m))
    dloss.backward()
    want = {"w_grad": wd.grad[s], "xs_grad": xd.grad, "out": y.detach(),
            "loss": dloss.detach(),
            "head_grad": None if hd is None else hd.grad}
    res["errors"] = {k: float((v - want[k]).abs().max())
                     for k, v in got.items()}
    if not job.get("summary"):
        res["got"] = {k: _np(v) for k, v in got.items()}
    return res
