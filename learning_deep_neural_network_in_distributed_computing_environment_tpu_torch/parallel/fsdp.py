"""ZeRO-3 / FSDP over the ``fsdp`` axis of the rank grid (port of the JAX
package's ``parallel/fsdp.py``).

Each worker's batch, parameters, gradients and Adam moments are sharded
over the ``fsdp`` line of its ranks:

- storage: every large parameter leaf is split along its first dimension
  divisible by the axis size (``fsdp_param_specs``; ``add_fsdp_axis``
  claims a free dimension of a leaf tensor parallelism already shards);
  the dimension is chosen on the JAX package's layout of the leaf, so a
  rank's shard holds the elements of the JAX device at its coordinate;
  the Adam moments mirror the shards;
- compute: before each step the shards are all-gathered (``gather_params``,
  an autograd function whose backward is the reduce-scatter, sum), so each
  rank's gradient of a sharded leaf arrives as its shard of the
  batch-summed gradient; replicated leaves' partial gradients are summed
  by ``reduce_replicated_grads``;
- batch: the worker's batch is split over ``fsdp``, contiguous by index;
  the loss is a local numerator over the whole batch's denominator;
- the once-per-round sync runs over ``data`` on each coordinate's shards:
  it is elementwise, so it composes with the sharding.

Each collective stages through host memory (gloo): one all-gather of every
sharded leaf per step, one reduce-scatter (an ``all_to_all_single`` and a
sum in rank order) and one all-reduce of the replicated leaves' gradients;
``STATS`` counts them.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from .. import comms, mesh

# Leaves smaller than this stay replicated: gathering them costs more in
# collective latency than their shard saves in memory (BN scales, biases,
# LayerNorms).
MIN_SHARD_ELEMS = 1 << 14

# per process: the gathers and the gradient reductions run, the bytes
# handed to gloo and their wall time (host staging included)
STATS = {"gathers": 0, "gather_ms": 0.0, "gather_bytes": 0,
         "reduce_scatters": 0, "reduce_scatter_ms": 0.0,
         "reduce_scatter_bytes": 0, "replicated_ms": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("_ms") else 0


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _shard_dim(shape: tuple, size: int, k: int,
               occupied: frozenset = frozenset()) -> int | None:
    """First non-``occupied`` dimension divisible by ``k`` for a leaf of
    ``size`` elements; None -> replicate."""
    if size < MIN_SHARD_ELEMS:
        return None
    for d, s in enumerate(shape):
        if d not in occupied and s % k == 0 and s >= k:
            return d
    return None


def fsdp_param_specs(shapes: dict, *, axis: str = "fsdp",
                     axis_size: int) -> dict:
    """{leaf key: spec} sharding every large leaf over ``axis``; a spec is
    a tuple of one axis name or None per dimension (a PartitionSpec)."""
    out = {}
    for key, shape in shapes.items():
        parts = [None] * len(shape)
        d = _shard_dim(tuple(shape), _numel(shape), axis_size)
        if d is not None:
            parts[d] = axis
        out[key] = tuple(parts)
    return out


def add_fsdp_axis(specs: dict, shapes: dict, *, axis: str = "fsdp",
                  axis_size: int) -> dict:
    """Extend ``specs`` (e.g. the Megatron TP specs) with ``axis`` on a
    FREE dimension of each large leaf: the 2-D (fsdp, model) composition,
    ZeRO-3 inside tensor parallelism.  A leaf with no free divisible
    dimension stays replicated over ``axis``."""
    out = {}
    for key, shape in shapes.items():
        parts = list(specs[key]) + [None] * (len(shape) - len(specs[key]))
        occupied = frozenset(d for d, p in enumerate(parts) if p)
        d = _shard_dim(tuple(shape), _numel(shape), axis_size, occupied)
        if d is not None:
            parts[d] = axis
        out[key] = tuple(parts)
    return out


def gather_leaves(shards: Sequence[torch.Tensor], dims: Sequence,
                  group: mesh.Group) -> list[torch.Tensor]:
    """Every leaf of ``shards`` whole along ``dims`` (None: as it is), in
    one packed all-gather over ``group`` (no gradient)."""
    idx = [i for i, d in enumerate(dims) if d is not None]
    out = [s.detach() for s in shards]
    if not idx:
        return out
    flat = torch.cat([shards[i].detach().reshape(-1) for i in idx])
    n = group.world_size
    rows = comms._all_gather(flat, group, "fsdp/gather").view(n, -1)
    start = 0
    for i in idx:
        s, k = shards[i], shards[i].numel()
        out[i] = torch.cat([rows[j, start:start + k].view(s.shape)
                            for j in range(n)], dim=dims[i])
        start += k
    return out


class _Gather(torch.autograd.Function):
    """All-gather of shards along their dims (forward) and the
    reduce-scatter, sum, of the full gradients (backward), each one packed
    collective over ``group``."""

    @staticmethod
    def forward(ctx, group, dims, *shards):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [tuple(s.shape) for s in shards]
        ctx.device = shards[0].device
        t0 = time.perf_counter()
        out = gather_leaves(shards, dims, group)
        STATS["gathers"] += 1
        STATS["gather_bytes"] += (group.world_size - 1) * sum(
            s.nbytes for s in shards)
        STATS["gather_ms"] += (time.perf_counter() - t0) * 1e3
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        t0 = time.perf_counter()
        group, n = ctx.group, ctx.group.world_size
        full = [tuple(n * k if i == d else k for i, k in enumerate(s))
                for s, d in zip(ctx.shapes, ctx.dims)]
        grads = [torch.zeros(f, device=ctx.device) if g is None else g
                 for g, f in zip(grads, full)]
        send = torch.cat([
            torch.cat([g.float().narrow(d, j * s[d], s[d]).reshape(-1)
                       for g, s, d in zip(grads, ctx.shapes, ctx.dims)])
            for j in range(n)])
        rows = comms._all_to_all(send, group, "fsdp/rs")
        total = comms._fold(rows)
        out, start = [], 0
        for s in ctx.shapes:
            k = _numel(s)
            out.append(total[start:start + k].view(s))
            start += k
        STATS["reduce_scatters"] += 1
        STATS["reduce_scatter_bytes"] += (n - 1) * send.nbytes // n
        STATS["reduce_scatter_ms"] += (time.perf_counter() - t0) * 1e3
        return (None, None, *out)


def gather_params(shards: Sequence[torch.Tensor], dims: Sequence,
                  group: mesh.Group) -> list[torch.Tensor]:
    """The whole leaves of ``shards`` (``dims[i]``: the dimension leaf i is
    sharded along, None: replicated, passed as it is), gathered over
    ``group``; differentiating through this is the reduce-scatter."""
    idx = [i for i, d in enumerate(dims) if d is not None]
    out = list(shards)
    if not idx:
        return out
    gathered = _Gather.apply(group, [dims[i] for i in idx],
                             *[shards[i] for i in idx])
    for i, g in zip(idx, gathered):
        out[i] = g
    return out


@torch.no_grad()
def reduce_replicated_grads(grads: list, dims: Sequence,
                            group: mesh.Group) -> list:
    """Sum the gradients of REPLICATED leaves (``dims[i]`` None) over
    ``group``, in one all-reduce: each rank computed them on its slice of
    the batch.  Sharded leaves' gradients arrive reduce-scattered."""
    idx = [i for i, d in enumerate(dims) if d is None]
    if not idx:
        return list(grads)
    t0 = time.perf_counter()
    part = [grads[i] for i in idx]
    total = comms._all_reduce_sum(comms.flatten(part), group)
    out = list(grads)
    for i, g in zip(idx, comms.unflatten(total, part)):
        out[i] = g
    STATS["replicated_ms"] += (time.perf_counter() - t0) * 1e3
    return out
