"""Spawn targets that hold the rank grid's pieces against their dense
twins (``parallel/``), for the CPU tests and ``chip_smoke.py``; nothing on
the training path imports this module.

``module_worker`` runs one forward and backward of a model's rank-grid
shards (tensor-parallel module, ZeRO-3 shards) and of its dense twin in
the same rank, from the same parameters; ``vocab_stats_worker`` holds
``tp.vocab_parallel_token_stats`` against ``train.masked_token_stats``;
``gather_worker`` holds ``fsdp.gather_params`` and its reduce-scatter.
Each writes what it found to ``{out_dir}/rank{r}-{i}.pt``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import mesh, weights
from .config import Config


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def module_job(job: dict, grid: mesh.Grid, device: torch.device) -> dict:
    """One job of ``module_worker``: ``job`` has ``model``, ``vocab``,
    ``kw`` (Config fields), ``state_dict`` (the dense twin's parameters,
    numpy), ``x``, ``y``, ``m`` (the worker's batch).  Returns this rank's
    local logits and loss, the worker's whole gradients by JAX leaf key
    (joined from the shards), and the dense twin's logits, loss and
    gradients on the same batch."""
    from .driver import build_model_for
    from .parallel.shards import GridParams
    from .parallel.tp import vocab_parallel_token_stats
    from .train import masked_token_stats, masked_weights
    cfg = Config(model=job["model"], compute_dtype="float32",
                 device=device.type, **job.get("kw", {}))
    dense = build_model_for(cfg, job["vocab"], device, job.get("shape"))
    dense.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in job["state_dict"].items()})
    tp = grid.groups["model"] if grid.size("model") > 1 else None
    module = build_model_for(cfg, job["vocab"], device, job.get("shape"),
                             tp=tp)
    gp = GridParams({k: p.detach() for k, p in dense.named_parameters()},
                    weights.state_layout(dense), module, grid, device,
                    shard_tok_emb=job["model"].startswith("gpt"))
    x, y, m = (torch.as_tensor(job[k]).to(device) for k in ("x", "y", "m"))
    denom = masked_weights(y, m).sum().clamp_min(1.0)
    f = grid.groups.get("fsdp")
    xs, ys, ms = ((t.chunk(f.world_size)[f.rank] for t in (x, y, m))
                  if f is not None and f.world_size > 1 else (x, y, m))
    vocab_parallel = tp is not None and not job["model"].startswith("vit")
    from .ops import flash
    flash.reset_launch_counts()
    with gp.applied():
        logits = module(xs)
        ce, w, _c = (vocab_parallel_token_stats(logits, ys, ms, tp)
                     if vocab_parallel else masked_token_stats(logits, ys, ms))
        loss = (ce * w).sum() / denom
        grads = torch.autograd.grad(loss, gp.params)
    launches = dict(flash.LAUNCHES)
    grads = gp.whole(gp.reduce_grads(list(grads)))
    out = {"logits": _np(logits), "loss": float(loss), "launches": launches,
           "grads": {k: _np(g) for k, g in zip(gp.keys, grads)},
           "keys": list(gp.keys), "specs": gp.specs}
    names = [n for n, _p in dense.named_parameters()]
    n_slices = f.world_size if f is not None else 1
    if n_slices > 1 and list(dense.buffers()):
        # BatchNorm normalises each fsdp slice with its own statistics:
        # the dense twin runs the slices one by one over the whole batch's
        # denominator (JAX's FSDP semantics, train.py:1617-1622)
        parts, d_loss = [], 0.0
        for xs_, ys_, ms_ in zip(x.chunk(n_slices), y.chunk(n_slices),
                                 m.chunk(n_slices)):
            parts.append(dense(xs_))
            ce, w, _c = masked_token_stats(parts[-1], ys_, ms_)
            d_loss = d_loss + (ce * w).sum() / denom
        d_logits = torch.cat(parts)
    else:
        d_logits = dense(x)
        ce, w, _c = masked_token_stats(d_logits, y, m)
        d_loss = (ce * w).sum() / denom
    d_grads = torch.autograd.grad(d_loss, list(dense.parameters()))
    out.update(dense_logits=_np(d_logits), dense_loss=float(d_loss),
               dense_grads=weights.jax_param_leaves(
                   dict(zip(names, d_grads)), weights.state_layout(dense)))
    return out


def module_worker(rank: int, world_size: int, store_path: str,
                  job_path: str, out_dir: str, device: str = "cpu") -> None:
    """A rank of the module checks (a spawn target): ``job_path`` holds
    ``{"axes": {axis: size}, "jobs": [job, ...]}`` (``torch.save``);
    each job's ``module_job`` result goes to ``rank{rank}-{i}.pt``.  On
    ``cuda`` every rank runs on the card (``mesh.worker_device``) and the
    module jobs record the flash kernels' launches of the shard's pass."""
    spec = torch.load(job_path, weights_only=False)
    device = mesh.worker_device(rank, device)
    # the fp32 comparisons must not drop to TF32 on a card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with mesh.init_group(rank, world_size, device, store_path) as world:
        grid = mesh.make_grid(world, spec["axes"])
        for i, job in enumerate(spec["jobs"]):
            kind = job.get("kind", "module")
            res = (module_job(job, grid, device) if kind == "module"
                   else vocab_stats_job(job, grid) if kind == "vocab"
                   else gather_job(job, grid))
            torch.save(res, os.path.join(out_dir, f"rank{rank}-{i}.pt"))
        grid.close()


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
