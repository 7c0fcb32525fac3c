"""The once-per-round sync point: ``aggregate`` for all 12 modes
(``gradients | weights`` x ``equal | weighted`` x ``allreduce | ring |
double_ring``) over the worker group (port of the JAX package's
``comms.py:63-183``, without the chaos screen's ``poison``; ROADMAP queue
A.5).

The JAX package runs the modes as XLA collectives inside ``shard_map``;
here each worker is a process of a gloo group (``mesh.py``).  gloo's
collectives take CPU tensors, so a sync stages through the host: the
tensors are packed into one flat fp32 buffer, copied into pinned host
memory (the copy is waited for before gloo reads it), the collective runs
there, and what it received is copied back to the device, where the blend
runs in fp32 with the JAX expression order:

- ``allreduce``: ``all_reduce`` SUM, then ``total / n`` (equal) or
  ``w*x + (1-w) * ((total - x) / (n - 1))`` (weighted: the
  self-exclusive peer mean blended with the own value);
- ``ring``: send to ``(i + 1) % n``, receive from ``(i - 1) % n``; then
  ``(x + r) / 2`` or ``w*x + (1-w)*r``;
- ``double_ring``: the same with shift 2 added; then ``(x + r1 + r2) / 3``
  or ``w*x + ((1-w)/2) * (r1 + r2)``.  A shift of 0 (mod n), as the second
  hop at n = 2, receives the worker's own value, as XLA's ppermute does:
  that value is taken locally, never sent to self through gloo.

With one worker every mode is the identity, and no group exists.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import mesh

HOWS = ("equal", "weighted")
TOPOLOGIES = ("allreduce", "ring", "double_ring")
MODES = [(how, topology) for how in HOWS for topology in TOPOLOGIES]
_SHIFTS = {"ring": (1,), "double_ring": (1, 2)}


def ring_neighbors(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """The gossip ring's permutation for ``n`` workers: rank i sends to
    ``(i + shift) % n`` (JAX ``comms.ring_neighbors``)."""
    return [(i, (i + shift) % n) for i in range(n)]


def _validate(how: str, topology: str) -> None:
    if how not in HOWS:
        raise ValueError(f"how must be one of {HOWS}, got {how!r}")
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, got "
                         f"{topology!r}")


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat fp32 buffer of ``tensors`` in their logical element order."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> list[torch.Tensor]:
    """``flat`` cut into tensors shaped (and typed) like ``like``."""
    parts = flat.split([t.numel() for t in like])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(parts, like)]


def _to_host(x: torch.Tensor, group: mesh.Group, slot: str) -> torch.Tensor:
    """``x`` copied into the group's host buffer ``slot``; the copy from a
    card has finished when this returns (gloo reads the buffer at once)."""
    buf = group.host_buffer(slot, x.numel())
    buf.copy_(x, non_blocking=x.is_cuda)
    if x.is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return buf


def _to_device(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host buffer on ``device``, as a tensor of its own (the buffer is
    reused by the next sync)."""
    return buf.to(device, non_blocking=True, copy=True)


def _all_reduce_sum(x: torch.Tensor, group: mesh.Group) -> torch.Tensor:
    host = _to_host(x, group, "x")
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    return _to_device(host, x.device)


def _shifted(x: torch.Tensor, group: mesh.Group,
             shifts: Sequence[int]) -> list[torch.Tensor]:
    """For each shift s, the value of worker ``(rank - s) % n``: every
    rank sends to ``(rank + s) % n`` and receives from ``(rank - s) % n``
    in one batch of point-to-point ops."""
    n, i = group.world_size, group.rank
    remote = [s for s in shifts if s % n]
    got = {}
    if remote:
        src = _to_host(x, group, "x")
        ops = []
        for s in remote:
            got[s] = group.host_buffer(f"recv{s}", x.numel())
            ops.append(dist.P2POp(dist.isend, src, (i + s) % n, tag=s))
            ops.append(dist.P2POp(dist.irecv, got[s], (i - s) % n, tag=s))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # a shift of 0 (mod n) is the worker's own value, taken locally
    return [_to_device(got[s], x.device) if s in got else x for s in shifts]


def aggregate(tensors: Sequence[torch.Tensor], *, how: str = "equal",
              topology: str = "allreduce", local_weight: float = 0.5,
              group: mesh.Group | None = None) -> list[torch.Tensor]:
    """Aggregate one worker's tensors (parameters or gradients) across the
    group; returns new tensors shaped like ``tensors`` (the inputs
    themselves with one worker).  Every rank of the group must call it
    with the same mode and the same shapes."""
    _validate(how, topology)
    n = 1 if group is None else group.world_size
    if n == 1:
        return list(tensors)
    x = flatten(tensors)
    w = local_weight
    if topology == "allreduce":
        total = _all_reduce_sum(x, group)
        if how == "equal":
            out = total / n
        else:
            peers_mean = (total - x) / (n - 1)
            out = w * x + (1.0 - w) * peers_mean
    elif topology == "ring":
        (r,) = _shifted(x, group, _SHIFTS["ring"])
        out = (x + r) / 2.0 if how == "equal" else w * x + (1.0 - w) * r
    else:
        r1, r2 = _shifted(x, group, _SHIFTS["double_ring"])
        out = ((x + r1 + r2) / 3.0 if how == "equal"
               else w * x + ((1.0 - w) / 2.0) * (r1 + r2))
    return unflatten(out, tensors)


def wire_bytes(numel: int, topology: str, n: int) -> int:
    """fp32 bytes one worker sends per sync, modeled: a ring all-reduce
    sends 2(n-1)/n of the buffer, each gossip hop to another worker one
    buffer (a hop of 0 mod n sends nothing)."""
    size = 4 * numel
    if n == 1:
        return 0
    if topology == "allreduce":
        return 2 * (n - 1) * size // n
    return size * sum(1 for s in _SHIFTS[topology] if s % n)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def checksum(tensors: Sequence[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bits in logical element order: equal on two
    ranks exactly when the tensors are bitwise equal (up to a hash
    collision)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def modes_worker(rank: int, world_size: int, store_path: str,
                 device: str, in_path: str, out_dir: str,
                 local_weight: float = 0.7,
                 timeout_s: float = mesh.GROUP_TIMEOUT_S) -> None:
    """One rank of an all-modes check (a spawn target): joins the group,
    aggregates its own row of the worker-stacked leaves in ``in_path``
    (npz: ``leaf{j}`` of shape [world_size, ...]) in each of the six
    how x topology modes on ``device``, and writes
    ``{out_dir}/rank{rank}.npz`` with ``{how}-{topology}-leaf{j}``, the
    post-sync ``checksum-{how}-{topology}`` and the sync's wall
    ``ms-{how}-{topology}`` of each mode."""
    with np.load(in_path) as f:
        leaves = [f[f"leaf{j}"][rank] for j in range(len(f.files))]
    dev = mesh.worker_device(rank, device)
    out = {}
    with mesh.init_group(rank, world_size, dev, store_path,
                         timeout_s) as group:
        xs = [torch.from_numpy(a).to(dev) for a in leaves]
        for how, topology in MODES:
            t0 = time.perf_counter()
            agg = aggregate(xs, how=how, topology=topology,
                            local_weight=local_weight, group=group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[f"ms-{how}-{topology}"] = np.array(
                (time.perf_counter() - t0) * 1e3)
            for j, a in enumerate(agg):
                out[f"{how}-{topology}-leaf{j}"] = a.cpu().numpy()
            out[f"checksum-{how}-{topology}"] = np.array(checksum(agg))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
