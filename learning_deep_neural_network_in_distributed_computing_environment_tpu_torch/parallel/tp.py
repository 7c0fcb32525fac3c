"""Tensor parallelism (Megatron) over the ``model`` axis of the rank grid
(port of the JAX package's ``parallel/tp.py``).

Attention heads, the FFN hidden units and the vocabulary of the decode are
sharded over the ``model`` line of a worker (``mesh.Grid``); each TP region
is bracketed by the classic Megatron pair, here two autograd functions:

- ``copy_to_tp_region`` (f): the identity forward, an all-reduce of the
  gradient backward: where a replicated activation forks into per-shard
  compute, its gradient is the sum of every shard's;
- ``reduce_from_tp_region`` (g): an all-reduce forward (the row-parallel
  product's partial outputs summed), the identity backward.

The JAX package's entry marker is a plain identity because shard_map's
autodiff inserts that gradient sum itself; torch's autograd knows nothing
of the other ranks, so the sum is f's backward here (the module tests hold
the gradients against the dense twin and against JAX's).  With both
markers every activation outside a region is exact and replicated along
``model``, so the gradients of replicated parameters (embeddings, norms)
are exact on every rank and those of sharded parameters stay local.

``group`` is the rank's ``model`` line (``mesh.Group``); None, or a line
of one rank, makes every marker the identity, so one module code runs
dense.  Each all-reduce stages through host memory (gloo), in fp32 on the
wire, and is counted in ``STATS``: on one card this measures correctness
and the cost of the staging, not the speed of tensor parallelism.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .. import comms, mesh

# per process: the TP all-reduces run, the bytes handed to gloo and their
# wall time (host staging included)
STATS = {"calls": 0, "bytes": 0, "ms": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, ms=0.0)


def active(group: mesh.Group | None) -> bool:
    return group is not None and group.world_size > 1


def all_reduce(x: torch.Tensor, group: mesh.Group, op: str = "sum",
               stats: dict = STATS) -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor of ``x``'s dtype): staged
    through the group's pinned host buffer, floating types in fp32, and
    counted in ``stats``."""
    t0 = time.perf_counter()
    wire = x.float() if x.is_floating_point() else x
    host = comms._to_host(wire, group, f"tp/{wire.numel()}/{wire.dtype}")
    dist.all_reduce(host, op=_OPS[op], group=group.pg)
    out = comms._to_device(host, x.device).view(x.shape).to(x.dtype)
    stats["calls"] += 1
    stats["bytes"] += host.nbytes
    stats["ms"] += (time.perf_counter() - t0) * 1e3
    return out


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.group, ctx.stats = group, stats
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g.contiguous(), ctx.group, stats=ctx.stats),
                None, None)


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, stats):
        return all_reduce(x.contiguous(), group, stats=stats)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp_region(x: torch.Tensor, group: mesh.Group | None,
                      stats: dict = STATS) -> torch.Tensor:
    """Entry marker (Megatron f): identity; the gradient all-reduced."""
    return _CopyToRegion.apply(x, group, stats) if active(group) else x


def reduce_from_tp_region(x: torch.Tensor, group: mesh.Group | None,
                          stats: dict = STATS) -> torch.Tensor:
    """Exit marker (Megatron g): the partial outputs summed over
    ``group``; the gradient passes as it is."""
    return _ReduceFromRegion.apply(x, group, stats) if active(group) else x


def vocab_parallel_token_stats(logits: torch.Tensor, labels: torch.Tensor,
                               batch_mask: torch.Tensor,
                               group: mesh.Group):
    """(ce, weight, correct) over VOCAB-SHARDED logits: the twin of
    ``train.masked_token_stats`` on the gathered logits, without the full
    [.., V] tensor on any rank (the Megatron vocab-parallel cross-entropy,
    JAX ``tp.py:56-100``).

    ``logits`` [.., V/tp] is this rank's slice of the vocabulary (rank i
    covers ids [i*V/tp, (i+1)*V/tp)).  The max is taken without a
    gradient (the shift cancels analytically); the sum of exponentials and
    the label's logit are all-reduced once, together, through g; the
    global argmax is the smallest id attaining the global max (first index
    wins, as torch's argmax breaks ties)."""
    from ..train import masked_weights
    v_local = logits.shape[-1]
    off = group.rank * v_local
    x = logits.float()
    labels_safe = labels.clamp_min(0)
    m_local = x.detach().amax(-1)
    m = all_reduce(m_local, group, "max")
    loc = labels_safe - off
    in_shard = (loc >= 0) & (loc < v_local)
    picked = x.gather(-1, loc.clamp(0, v_local - 1)[..., None])[..., 0]
    sums = reduce_from_tp_region(torch.stack([
        torch.exp(x - m[..., None]).sum(-1),
        torch.where(in_shard, picked, torch.zeros_like(picked))]), group)
    ce = m + torch.log(sums[0]) - sums[1]
    w = masked_weights(labels, batch_mask)
    arg_local = off + x.detach().argmax(-1)
    pred = all_reduce(torch.where(m_local == m, arg_local,
                                  torch.full_like(arg_local,
                                                  torch.iinfo(
                                                      torch.int64).max)),
                      group, "min")
    correct = ((pred == labels) * w).sum()
    return ce, w, correct
