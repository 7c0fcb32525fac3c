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


# --------------------------------------------------------------------------
# The simulated sync (JAX ``comms.py:185-455``): ``aggregate`` as stacked
# math on worker-stacked [N, ...] tensors in one process (the scenario lab,
# sim.py).  No group: every "collective" has a stacked twin —
#
# - psum/pmean accumulate in rank order, a sequential left fold over the
#   rows (``sim_fold``; a reassociating ``sum(0)`` would not match);
# - the ring's receive-from-(rank - shift) is ``torch.roll(x, shift, 0)``;
# - the blends are the JAX expressions, elementwise.
#
# The ``ok`` mask is the dense path's poison screen reused as the scenario
# surface: client sampling and worker dropout exclude rows from the blend
# the way a quarantined contribution is excluded, and an all-ones mask
# selects the unscreened values (``all_ok``).
# --------------------------------------------------------------------------

GOSSIP_HOPS = {"ring": 1, "double_ring": 2}


def sim_fold(x: torch.Tensor) -> torch.Tensor:
    """Sequential left fold of a stacked [N, ...] tensor over its leading
    axis in row order: ``((x[0] + x[1]) + x[2]) + ...``."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def sim_fold_rows(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``sim_fold`` of each tensor, as one multi-tensor add per row (the
    same additions in the same order, N launches instead of N per
    tensor)."""
    acc = [t[0].clone() for t in tensors]
    for i in range(1, tensors[0].shape[0] if tensors else 0):
        torch._foreach_add_(acc, [t[i] for t in tensors])
    return acc


def _recip(c: int) -> float:
    """``1 / c`` rounded to fp32: XLA compiles a division by a constant
    into a multiplication by its fp32 reciprocal, so the stacked twin
    multiplies too (``x * _recip(3)``, not ``x / 3``), which keeps the
    equal blends bitwise JAX's."""
    return float(np.float32(1.0) / np.float32(c))


def _rows(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-worker [N] vector broadcast against a stacked [N, ...] leaf."""
    return v.reshape(v.shape[0], *([1] * (leaf.ndim - 1)))


def sim_wire_bytes(shapes: Sequence, n: int, *, topology: str = "allreduce",
                   wire_dtype: torch.dtype | None = None) -> int:
    """Bytes ONE simulated worker's sync would move per round on the
    fabric the simulation stands in for: every tensor once per hop
    (gossip: ``GOSSIP_HOPS``; allreduce: one injection), in ``wire_dtype``
    when the simulated wire is compressed.  ``shapes`` are one worker's
    tensors (or ``(shape, dtype)`` pairs)."""
    if not shapes or n <= 1:
        return 0
    hops = GOSSIP_HOPS.get(topology, 1)
    total = 0
    for t in shapes:
        shape, dtype = ((t.shape, t.dtype) if isinstance(t, torch.Tensor)
                        else t)
        item = (wire_dtype or dtype).itemsize
        total += int(np.prod(shape, dtype=np.int64)) * item
    return hops * total


def _decode_rows(x32: torch.Tensor, wdt: torch.dtype) -> torch.Tensor:
    """Each worker row's payload as the simulated fabric delivers it (JAX
    ``comms._wire_codec`` per row): encoded in ``wdt`` and decoded to
    fp32.  bf16 is a plain downcast; int8 is symmetric round-half-to-even
    on the row's own max|x|/127 grid (the sender's fp32 scale rides with
    the payload)."""
    if wdt != torch.int8:
        return x32.to(wdt).float()
    flat = x32.reshape(x32.shape[0], -1)
    scale = torch.clamp_min(flat.abs().amax(1) / 127.0, 1e-30)
    q = torch.clamp(torch.round(flat / scale[:, None]), -127.0, 127.0).to(
        torch.int8)
    return (q.float() * scale[:, None]).reshape(x32.shape)


def aggregate_sim(tensors: Sequence[torch.Tensor], *, how: str = "equal",
                  topology: str = "allreduce", local_weight: float = 0.5,
                  ok: torch.Tensor | None = None,
                  wire_dtype: torch.dtype | None = None,
                  residual: Sequence[torch.Tensor] | None = None):
    """``aggregate`` on worker-STACKED tensors (each [N, ...]; JAX
    ``comms.aggregate_sim``): returns ``(aggregated, new_residual)``.

    ``ok`` — optional [N] contribution mask (bool or 0/1): masked rows are
    left out of every blend and the survivors renormalize, as the poison
    screen does; an all-ones mask selects the unscreened values.

    ``wire_dtype`` + ``residual`` — the simulated compressed wire
    (bfloat16/int8) with single-stage error feedback: each worker's
    transmitted payload is encoded per row, every value received from the
    fabric is the decoded fp32 payload, own values blend exactly, and the
    residual carries each worker's own transmission rounding into the
    next round.  ``new_residual`` is None unless error feedback is armed."""
    _validate(how, topology)
    tensors = list(tensors)
    if not tensors:
        return tensors, residual
    n = int(tensors[0].shape[0])
    compressed = wire_dtype is not None and wire_dtype != torch.float32
    ef = compressed and residual is not None
    if n == 1:
        return tensors, residual
    w = local_weight
    okf = okb = valid = all_ok = ok1f = ok2f = None
    if ok is not None:
        okf = ok.float()
        okb = okf > 0
        valid = torch.clamp_min(sim_fold(okf), 1.0)
        all_ok = valid >= n
        ok1f = torch.roll(okf, 1, 0)
        if topology == "double_ring":
            ok2f = torch.roll(okf, 2, 0)

    # what each worker transmits, as the fabric delivers it (fp32), and
    # what enters the blends (masked rows as zeros)
    res_list = list(residual) if ef else [None] * len(tensors)
    decs, new_res = [], []
    for x, res in zip(tensors, res_list):
        contrib = x.float() + res if ef else x.float()
        dec = _decode_rows(contrib, wire_dtype) if compressed else contrib
        decs.append(dec)
        new_res.append(contrib - dec if ef else None)
    xss = (decs if okb is None else
           [torch.where(_rows(okb, d), d, torch.zeros_like(d))
            for d in decs])
    # the all-reduce's sums, one row-ordered fold for all tensors
    totals = (sim_fold_rows(decs if how == "equal" else xss)
              if topology == "allreduce" else [None] * len(tensors))
    screened_totals = (sim_fold_rows(xss) if topology == "allreduce"
                       and how == "equal" and okb is not None
                       else [None] * len(tensors))

    def per_leaf(x, dec, xs, total, total_s):
        rows = lambda v: _rows(v, x)
        if topology == "allreduce":
            if how == "equal":
                out = (total * _recip(n)).expand(x.shape).contiguous()
                if okb is None:
                    return out
                screened = (total_s / valid).expand(x.shape)
                return torch.where(all_ok, out, screened)
            peers_mean = (total - dec) * _recip(n - 1)
            out = w * x + (1.0 - w) * peers_mean
            if okb is None:
                return out
            peers = torch.clamp_min(valid - 1.0, 1.0)
            screened = torch.where(
                rows(okb), w * x + (1.0 - w) * (total - xs) / peers,
                (total / valid).expand(x.shape))
            return torch.where(all_ok, out, screened)
        if topology == "ring":
            r = torch.roll(xs, 1, 0)
            out = ((x + r) * _recip(2) if how == "equal"
                   else w * x + (1.0 - w) * r)
            if okb is None:
                return out
            r_ok = rows(ok1f > 0)
            both = torch.logical_and(rows(okb), r_ok)
            if how == "equal":
                cnt = rows(okf + ok1f)
                screened = torch.where(
                    cnt > 0, (xs + r) / torch.clamp_min(cnt, 1.0), x)
            else:
                screened = torch.where(both, out, torch.where(r_ok, r, x))
            return torch.where(both, out, screened)
        # double_ring: blend with the two predecessors
        r1 = torch.roll(xs, 1, 0)
        r2 = torch.roll(xs, 2, 0)
        out = ((x + r1 + r2) * _recip(3) if how == "equal"
               else w * x + ((1.0 - w) / 2.0) * (r1 + r2))
        if okb is None:
            return out
        every = torch.logical_and(rows(okb), torch.logical_and(
            rows(ok1f > 0), rows(ok2f > 0)))
        cnt = rows(okf + ok1f + ok2f)
        if how == "equal":
            screened = torch.where(
                cnt > 0, (xs + r1 + r2) / torch.clamp_min(cnt, 1.0), x)
        else:
            pc = rows(ok1f + ok2f)
            pmean = (r1 + r2) / torch.clamp_min(pc, 1.0)
            screened = torch.where(
                rows(okb),
                torch.where(pc > 0, w * x + (1.0 - w) * pmean, x),
                torch.where(pc > 0, pmean, x))
        return torch.where(every, out, screened)

    agg = [per_leaf(*a) for a in zip(tensors, decs, xss, totals,
                                     screened_totals)]
    return agg, (new_res if ef else None)


def stale_delta(blended: Sequence[torch.Tensor],
                base: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Consensus displacement ``blended - base`` per tensor (JAX
    ``comms.stale_delta``): what a stale sync hands to a later round."""
    return torch._foreach_sub(list(blended), list(base))


def deliver_stale(params: Sequence[torch.Tensor],
                  delta: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Fold a stale consensus delta into freshly trained params:
    ``params + delta`` per tensor (JAX ``comms.deliver_stale``)."""
    return torch._foreach_add(list(params), list(delta))
