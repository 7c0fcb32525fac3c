"""The once-per-round sync point: ``aggregate`` for all 12 modes
(``gradients | weights`` x ``equal | weighted`` x ``allreduce | ring |
double_ring``) over the worker group (port of the JAX package's
``comms.py:63-183``, with the chaos screen's ``poison``).

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

import dataclasses
import hashlib
import os
import time
from typing import NamedTuple, Sequence

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
    """``x`` (flattened) copied into the group's host buffer ``slot`` of
    its dtype; the copy from a card has finished when this returns (gloo
    reads the buffer at once)."""
    buf = group.host_buffer(slot, x.numel(), x.dtype)
    buf.copy_(x.reshape(-1), non_blocking=x.is_cuda)
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
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group.pg)
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
            ops.append(dist.P2POp(dist.isend, src,
                                  group.peer((i + s) % n),
                                  group=group.pg, tag=s))
            ops.append(dist.P2POp(dist.irecv, got[s],
                                  group.peer((i - s) % n),
                                  group=group.pg, tag=s))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # a shift of 0 (mod n) is the worker's own value, taken locally
    return [_to_device(got[s], x.device) if s in got else x for s in shifts]


def aggregate(tensors: Sequence[torch.Tensor], *, how: str = "equal",
              topology: str = "allreduce", local_weight: float = 0.5,
              group: mesh.Group | None = None, poison=None):
    """Aggregate one worker's tensors (parameters or gradients) across the
    group; returns new tensors shaped like ``tensors`` (the inputs
    themselves with one worker).  Every rank of the group must call it
    with the same mode and the same shapes.

    ``poison`` (the chaos screen, JAX ``aggregate(poison=...)``): this
    worker's poison flag.  The contribution is screened sender-side (a
    poisoned or non-finite one enters the collectives as exact zeros) and
    every blend renormalizes over the valid contributions; the return is
    then ``(aggregated, ok)`` with ``ok`` this worker's 0/1 flag.  The
    flags ride one all_gather, so every rank knows them all: a round
    whose contributions are all valid runs the unscreened arithmetic
    itself (bitwise the unscreened round)."""
    _validate(how, topology)
    n = 1 if group is None else group.world_size
    ok = None if poison is None else contribution_ok(poison, tensors)
    if n == 1:
        return list(tensors) if ok is None else (list(tensors), float(ok))
    x = flatten(tensors)
    flags = None if ok is None else gather_flags(ok, group)
    screen = flags is not None and sum(flags) < n
    w = local_weight
    if screen:
        out = _screened_dense(x, ok, flags, how, topology, w, group)
    elif topology == "allreduce":
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
    agg = unflatten(out, tensors)
    return agg if ok is None else (agg, float(ok))


def _screened_dense(x, ok: bool, flags: list, how: str, topology: str,
                    w: float, group: mesh.Group) -> torch.Tensor:
    """The dense blends of a round with a quarantined contribution (JAX
    ``aggregate``'s screened branch): ``xs`` is the screened value."""
    n, i = group.world_size, group.rank
    valid = max(sum(flags), 1.0)
    xs = x if ok else torch.zeros_like(x)
    if topology == "allreduce":
        total = _all_reduce_sum(xs, group)
        if how == "equal":
            return total / valid
        if ok:
            return w * x + (1.0 - w) * (total - xs) / max(valid - 1.0, 1.0)
        return total / valid
    shifts = _SHIFTS[topology]
    received = _shifted(xs, group, shifts)
    peer_ok = [flags[(i - s) % n] > 0 for s in shifts]
    return gossip_screened(x, received, ok, peer_ok, how, w)


def gossip_screened(x, received: list, ok: bool, peer_ok: list, how: str,
                    w: float) -> torch.Tensor:
    """A gossip blend renormalized over the valid terms (JAX ``aggregate``
    / ``gossip_sync`` screened branches): ``received`` are the screened
    predecessors' values, ``peer_ok`` their flags.  Equal: the mean of the
    valid terms (own value when none is valid); weighted: a valid worker
    blends with the mean of its valid peers, a quarantined one adopts
    it."""
    if how == "equal":
        num = x if ok else torch.zeros_like(x)
        for r, r_ok in zip(received, peer_ok):
            if r_ok:
                num = num + r
        cnt = float(ok) + sum(float(f) for f in peer_ok)
        return num / max(cnt, 1.0) if cnt > 0 else x
    if len(received) == 1:
        (r1,), (r1_ok,) = received, peer_ok
        if ok and r1_ok:
            return w * x + (1.0 - w) * r1
        return r1 if r1_ok else x
    pn = torch.zeros_like(x)
    for r, r_ok in zip(received, peer_ok):
        if r_ok:
            pn = pn + r
    pc = sum(float(f) for f in peer_ok)
    pmean = pn / max(pc, 1.0)
    if ok:
        return w * x + (1.0 - w) * pmean if pc > 0 else x
    return pmean if pc > 0 else x


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
    ``{out_dir}/rank{rank}.npz`` (``save_npz``) with
    ``{how}-{topology}-leaf{j}``, the post-sync
    ``checksum-{how}-{topology}`` and the sync's wall
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
    save_npz(os.path.join(out_dir, f"rank{rank}.npz"), out)


def save_npz(path: str, arrays: dict) -> None:
    """``np.savez`` to ``path`` through a temporary file and a rename: a
    reader that waits for ``path`` never sees a half-written file."""
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


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
    """Each worker row's payload as the simulated fabric delivers it:
    ``wire_encode`` of each row (its own int8 scale), decoded to fp32."""
    flat = x32.reshape(x32.shape[0], -1)
    return wire_encode(flat, wdt)[1].reshape(x32.shape)


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


# --------------------------------------------------------------------------
# The bucketed sync engines (JAX ``comms.py:385-405, 454-704, 1092-1640``),
# host-staged over the gloo group.
#
# A worker's tensors are packed into one fp32 vector in the JAX package's
# flatten order (``WireLayout``: for a model, the order and element layout
# of its flax leaves, so the buckets, the int8 scales, the round
# optimizer's rows and the residual's positions are JAX's), cut into
# ~``bucket_bytes`` buckets (``bucket_plan``), and each bucket is synced on
# its own.  The arithmetic (pack, encode, decode, sums, blends) runs on the
# worker's device; between the arithmetic steps the wire payload is copied
# to pinned host memory, moved by gloo as bytes, and copied back:
#
# - ``sharded_opt_sync`` (allreduce): reduce-scatter as ``all_to_all_single``
#   of the bucket's n slices plus a local fp32 sum of the received slices
#   in rank order 0..n-1 (a compressed payload is decoded with its
#   sender's scale before the sum), the apply on the owned 1/n shard (or on
#   the gathered buffer under the replicated placement), then
#   ``all_gather`` of the shard;
# - ``gossip_sync`` (ring, double_ring): each hop one batch of
#   point-to-point sends of the bucket's payload, blended locally in fp32.
#
# Every rank sums the same slices in the same order, so an equal blend is
# bitwise the same on every rank.  ``group.wire`` counts the bytes handed
# to gloo for other ranks: the payload bytes equal ``sync_wire_bytes``
# (an int8 bucket's fp32 scale is counted apart, as JAX leaves it out).
# --------------------------------------------------------------------------

DEFAULT_BUCKET_BYTES = 4 << 20
OPT_PLACEMENTS = ("replicated", "sharded")
# the round optimizer's Adam moment rates (JAX ``ROUND_ADAM_B1/B2``)
ROUND_ADAM_B1 = 0.9
ROUND_ADAM_B2 = 0.999
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}


def wire_encode(x32: torch.Tensor, wdt: torch.dtype | None):
    """The wire codec (JAX ``_wire_codec``): ``(payload, fp32 decode of the
    payload, scale or None)``.  bf16 is a plain downcast; int8 is
    symmetric round-half-to-even on a max|x|/127 grid, one fp32 scale per
    row of a 2-D ``x32`` (per bucket for a 1-D one) riding next to the
    payload.  fp32 (or None) is the identity."""
    if wdt is None or wdt == torch.float32:
        return x32, x32, None
    if wdt != torch.int8:
        y = x32.to(wdt)
        return y, y.float(), None
    rows = x32.ndim == 2
    flat = x32 if rows else x32.reshape(1, -1)
    scale = torch.clamp_min(flat.abs().amax(1) / 127.0, 1e-30)
    q = torch.clamp(torch.round(flat / scale[:, None]), -127.0, 127.0).to(
        torch.int8)
    dec = q.float() * scale[:, None]
    if rows:
        return q, dec, scale
    return q.reshape(x32.shape), dec.reshape(x32.shape), scale[0]


class _Bucket(NamedTuple):
    """One contiguous 1-D collective segment of the packed tensors."""

    dtype: torch.dtype          # dtype of every leaf in the bucket
    padded: int                 # elements with zero padding; % n == 0
    items: tuple                # ((leaf_index, offset, size), ...)


def _shape_dtype(leaf) -> tuple[tuple, torch.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    shape, dtype = leaf
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(np.dtype(dtype)))
    return tuple(shape), dtype


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


def bucket_plan(leaves, n: int, bucket_bytes: int = DEFAULT_BUCKET_BYTES
                ) -> list[_Bucket]:
    """Greedy bucketing of ``leaves`` (tensors or ``(shape, dtype)``
    pairs) into ~``bucket_bytes`` segments (JAX ``bucket_plan``): leaves
    in order, grouped by dtype; a bucket closes once it reaches the
    target; a leaf is never split; each bucket is zero-padded to a
    multiple of ``n`` so the reduce-scatter tiles evenly."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(_shape_dtype(leaf)[1], []).append(i)
    out: list[_Bucket] = []
    for dtype, idxs in groups.items():
        target = max(1, int(bucket_bytes) // max(1, dtype.itemsize))
        items: list[tuple] = []
        offset = 0
        for i in idxs:
            size = _numel(_shape_dtype(leaves[i])[0])
            items.append((i, offset, size))
            offset += size
            if offset >= target:
                out.append(_Bucket(dtype, -(-offset // n) * n, tuple(items)))
                items, offset = [], 0
        if items:
            out.append(_Bucket(dtype, -(-offset // n) * n, tuple(items)))
    return out


def _filled(b: _Bucket) -> int:
    return sum(size for (_i, _off, size) in b.items)


def sync_wire_bytes(leaves, n: int, *, mode: str = "sharded",
                    wire_dtype: torch.dtype | None = None,
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    topology: str = "allreduce") -> int:
    """Per-worker bytes SENT by one round sync of ``leaves`` (JAX
    ``sync_wire_bytes``): ``dense`` every leaf in fp32 once per gossip hop
    (one injection for allreduce); ``sharded`` 2(n-1)/n of each padded
    bucket in the wire dtype; ``gossip`` each hop every filled bucket in
    the wire dtype.  The int8 scales are left out."""
    if not leaves or n <= 1:
        return 0
    hops = GOSSIP_HOPS.get(topology, 1)
    if mode == "dense":
        return hops * sum(_numel(s) * d.itemsize
                          for s, d in map(_shape_dtype, leaves))
    item = lambda b: (wire_dtype or b.dtype).itemsize
    plan = bucket_plan(leaves, n, bucket_bytes)
    if mode == "gossip":
        return sum(hops * _filled(b) * item(b) for b in plan)
    return sum(2 * (n - 1) * (b.padded // n) * item(b) for b in plan)


def bucket_name(i: int) -> str:
    return f"b{i:04d}"


def round_opt_init(leaves, n: int, rank: int, *, placement: str,
                   bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                   device: torch.device | str = "cpu") -> dict:
    """Worker ``rank``'s zero round-optimizer moments (JAX
    ``round_opt_init``, one row of its worker-stacked layout): per bucket
    ``{"mu", "nu"}`` of ``padded // n`` (sharded: the shard it owns) or
    ``padded`` (replicated) fp32 elements."""
    if placement not in OPT_PLACEMENTS:
        raise ValueError(
            f"placement must be one of {OPT_PLACEMENTS}, got {placement!r}")
    out = {}
    for i, b in enumerate(bucket_plan(leaves, n, bucket_bytes)):
        row = b.padded // n if placement == "sharded" else b.padded
        out[bucket_name(i)] = {
            "mu": torch.zeros(row, dtype=torch.float32, device=device),
            "nu": torch.zeros(row, dtype=torch.float32, device=device)}
    return out


class WireLayout:
    """Where each element of a worker's tensors sits in the packed sync
    vector.  ``leaves`` are the ``(shape, dtype)`` of the leaves the bucket
    plan sees (for a model: its flax ``params`` leaves in JAX flatten
    order, ``weights.wire_layout``); ``pieces`` lists, in packed order,
    ``(tensor index, axes)``: the tensor permuted by ``axes`` (None: as it
    is) and flattened.  Every tensor is one piece; the pieces of one leaf
    are consecutive (a stacked leaf holds one per layer)."""

    def __init__(self, leaves, pieces):
        self.leaves = [_shape_dtype(leaf) for leaf in leaves]
        self.pieces = [(int(i), None if axes is None else tuple(axes))
                       for i, axes in pieces]

    @classmethod
    def identity(cls, tensors) -> "WireLayout":
        return cls([_shape_dtype(t) for t in tensors],
                   [(i, None) for i in range(len(tensors))])

    @property
    def numel(self) -> int:
        return sum(_numel(s) for s, _d in self.leaves)

    def pack(self, tensors) -> torch.Tensor:
        """One fp32 vector of ``tensors`` in packed order (a copy)."""
        return torch.cat([
            (tensors[i] if axes is None else tensors[i].permute(*axes))
            .detach().reshape(-1).float() for i, axes in self.pieces])

    def unpack(self, flat: torch.Tensor, like) -> list[torch.Tensor]:
        """``flat`` cut into tensors shaped and typed like ``like``."""
        out = [None] * len(like)
        sizes = [like[i].numel() for i, _axes in self.pieces]
        for (i, axes), seg in zip(self.pieces, flat.split(sizes)):
            t = like[i]
            if axes is None:
                out[i] = seg.view(t.shape).to(t.dtype)
            else:
                shape = [t.shape[a] for a in axes]
                inv = [axes.index(d) for d in range(len(axes))]
                out[i] = seg.view(shape).permute(*inv).to(t.dtype)
        return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


def _all_to_all(x: torch.Tensor, group: mesh.Group, slot: str
                ) -> torch.Tensor:
    """The bucket ``x`` [padded] cut into n slices, slice j sent to rank
    j: returns [n, padded // n], row j the slice rank j sent here."""
    n = group.world_size
    send = _to_host(x, group, slot + "/a2a")
    recv = group.host_buffer(slot + "/a2a_recv", x.numel(), x.dtype)
    dist.all_to_all_single(_bytes(recv), _bytes(send), group=group.pg)
    group.count_wire("payload", (n - 1) * send.nbytes // n)
    return _to_device(recv, x.device).view(n, -1)


def _all_gather(x: torch.Tensor, group: mesh.Group, slot: str,
                kind: str = "payload") -> torch.Tensor:
    """Every rank's ``x`` (same size), concatenated in rank order."""
    n = group.world_size
    send = _to_host(x, group, slot + "/ag")
    recv = group.host_buffer(slot + "/ag_recv", n * x.numel(), x.dtype)
    dist.all_gather(list(_bytes(recv).view(n, -1).unbind(0)), _bytes(send),
                    group=group.pg)
    group.count_wire(kind, (n - 1) * send.nbytes)
    return _to_device(recv, x.device)


def _gather_decoded(payload, scale, group: mesh.Group, slot: str
                    ) -> torch.Tensor:
    """``all_gather`` of a wire payload (and, int8, of each sender's
    scale), each rank's segment decoded with its own scale."""
    full = _all_gather(payload, group, slot).float()
    if scale is None:
        return full
    scales = _all_gather(scale.reshape(1), group, slot + "/scale", "scale")
    return (full.view(group.world_size, -1) * scales[:, None]).reshape(-1)


def _fold(rows: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of [n, k] in rank order: ``((r0 + r1) + r2) ...``."""
    acc = rows[0]
    for j in range(1, rows.shape[0]):
        acc = acc + rows[j]
    return acc


def _check_fast(how: str, wire_dtype, residual, tensors) -> bool:
    if how not in HOWS:
        raise ValueError(f"how must be one of {HOWS}, got {how!r}")
    if residual is not None and len(residual) != len(tensors):
        raise ValueError(
            "residual must mirror the synced tensors: "
            f"{len(residual)} tensors vs {len(tensors)}")
    return wire_dtype is not None and wire_dtype != torch.float32


def sharded_opt_sync(tensors: Sequence[torch.Tensor], *, group: mesh.Group,
                     how: str = "equal", local_weight: float = 0.5,
                     wire_dtype: torch.dtype | None = None,
                     residual: Sequence[torch.Tensor] | None = None,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     opt_placement: str = "sharded",
                     tracker: dict | None = None,
                     layout: WireLayout | None = None,
                     residency: str = "replicated", buddy: bool = False,
                     poison=None) -> tuple:
    """The reduce-scatter sync of one worker's tensors (JAX
    ``sharded_opt_sync``): ``(synced tensors, new residual, new tracker)``,
    with the buddy rows appended when ``buddy`` and this worker's 0/1
    validity flag appended when ``poison`` is given.

    Semantics of ``aggregate(topology="allreduce")``: ``equal`` the
    cross-worker mean, ``weighted`` the self-exclusive peer-mean blend.
    ``wire_dtype`` (bf16/int8) compresses both phases; ``residual``
    (tensors like ``tensors``) arms error feedback: each worker carries
    its own contribution's rounding and, on a compressed wire, n x the
    rounding of the gathered mean over the shard it owns.
    ``opt_placement``: the equal blend's scale on the owned shard
    (``sharded``) or on the gathered buffer (``replicated``, fp32 only);
    bitwise equal in fp32.  ``tracker`` (``round_opt_init``'s row) takes
    one Adam moment update of the cross-worker mean.

    ``residency="resident"`` ends the sync at the scatter: the first
    return value is then ``{bucket: [padded // n]}``, this worker's
    decoded post-apply shard, and the next round's ``resident_gather``
    rebuilds the tensors bit for bit (equal blend, sharded placement).
    ``buddy`` sends this worker's shard-resident rows (the resident row in
    the wire dtype, the EF residual's owned span, the sharded tracker's
    rows) to its ring successor: the appended ``{bucket: {"params",
    "res", "mu", "nu"}}`` holds the PREDECESSOR's rows, counted in
    ``group.wire["buddy"]`` (``buddy_wire_bytes``).  ``poison``: the chaos
    screen, as in ``aggregate``: a quarantined contribution enters the
    sum as zeros (its EF residual resets with it) and the blend
    renormalizes over the valid workers."""
    compressed = _check_fast(how, wire_dtype, residual, tensors)
    if opt_placement not in OPT_PLACEMENTS:
        raise ValueError(
            f"opt_placement must be one of {OPT_PLACEMENTS}, got "
            f"{opt_placement!r}")
    if residency not in PARAM_RESIDENCIES:
        raise ValueError(f"residency must be one of {PARAM_RESIDENCIES}, "
                         f"got {residency!r}")
    resident = residency == "resident"
    if resident and (how != "equal" or opt_placement != "sharded"):
        raise ValueError(
            "a scatter-resident output requires the equal blend on the "
            "sharded placement: the weighted own-term blend is "
            "irreducibly per-worker and a replicated apply produces no "
            f"shard-side output (got how={how!r}, "
            f"opt_placement={opt_placement!r})")
    if compressed and opt_placement != "sharded":
        raise ValueError(
            "a compressed wire quantizes the gathered mean, which forces "
            "the scale-then-encode apply onto the shard: opt_placement "
            f"must be 'sharded', got {opt_placement!r}")
    n = 1 if group is None else group.world_size
    if buddy and n < 2:
        raise ValueError(
            "buddy redundancy needs a worker axis of size >= 2 (a lone "
            "worker has no ring successor to back its shard up on)")
    tensors = list(tensors)
    ok = None if poison is None else contribution_ok(poison, tensors,
                                                     residual)
    if not tensors or n == 1:
        if resident:
            raise ValueError(
                "a scatter-resident output needs a worker axis of size "
                ">= 2 and a non-empty tree (nothing to shard)")
        out = (tensors, residual, tracker)
        return out if ok is None else (*out, float(ok))
    layout = layout or WireLayout.identity(tensors)
    rank = group.rank
    flags = None if ok is None else gather_flags(ok, group)
    screen = flags is not None and sum(flags) < n
    valid = max(sum(flags), 1.0) if flags is not None else float(n)
    x = layout.pack(tensors)
    r = layout.pack(residual) if residual is not None else None
    out = None if resident else torch.empty_like(x)
    new_r = torch.empty_like(x) if r is not None else None
    new_tracker = {} if tracker is not None else None
    resident_out, buddy_out = {}, {}
    quantized = wire_dtype == torch.int8
    w = local_weight
    start = 0
    for bi, b in enumerate(bucket_plan(layout.leaves, n, bucket_bytes)):
        filled, row = _filled(b), b.padded // n
        name = bucket_name(bi)
        seg = slice(start, start + filled)
        buf = x[seg] if r is None else x[seg] + r[seg]
        if b.padded > filled:
            buf = torch.cat([buf, buf.new_zeros(b.padded - filled)])
        if screen and not ok:
            # sender-side quarantine: exact zeros, never 0 * NaN
            buf = torch.zeros_like(buf)
        slot = f"sharded/{name}"
        sent, sent32, sent_scale = wire_encode(buf, wire_dtype)
        err = buf - sent32 if r is not None else None
        pieces = _all_to_all(sent, group, slot)
        if quantized:
            scales = _all_gather(sent_scale.reshape(1), group,
                                 slot + "/scale", "scale")
            shard32 = _fold(pieces.float() * scales[:, None])
        else:
            shard32 = _fold(pieces.float())
        full = None
        if how == "equal":
            if opt_placement == "replicated" and not compressed:
                # gather the raw shard sums, scale the whole buffer on
                # every worker (the ZeRO-1 baseline, bitwise the same)
                gathered = _all_gather(shard32, group, slot + "/sum")
                full = gathered / valid if screen else gathered / n
                track32 = full
            else:
                mean32 = shard32 / valid if screen else shard32 / n
                mean, mean32_dec, mean_scale = wire_encode(mean32,
                                                           wire_dtype)
                if err is not None and compressed:
                    # second stage: the gathered mean is wire-rounded too;
                    # its owner carries n x that rounding at its span
                    own = slice(rank * row, (rank + 1) * row)
                    err[own] = err[own] + n * (mean32 - mean32_dec)
                if resident:
                    # the sync ends here: the decoded shard IS the state
                    resident_out[name] = mean32_dec
                    if buddy:
                        hop = [mean] + ([] if mean_scale is None
                                        else [mean_scale.reshape(1)])
                        if err is not None:
                            hop.append(err[rank * row:(rank + 1) * row])
                        got = ring_hop(hop, group, slot + "/buddy",
                                       n_scale=int(mean_scale is not None))
                        bud = {"params": got[0].float()}
                        if mean_scale is not None:
                            bud["params"] = bud["params"] * got[1]
                        if err is not None:
                            bud["res"] = got[-1]
                        buddy_out[name] = bud
                else:
                    full = _gather_decoded(mean, mean_scale, group,
                                           slot + "/mean")
                track32 = mean32
        else:
            # the own term is per worker: gather the encoded sum, blend
            # locally with the own contribution the peers received
            tq, _tq32, tq_scale = wire_encode(shard32, wire_dtype)
            total = _gather_decoded(tq, tq_scale, group, slot + "/sum")
            own = sent32
            if not screen:
                full = w * own + (1.0 - w) * (total - own) / (n - 1)
                track32 = (shard32 / n if opt_placement == "sharded"
                           else total / n)
            else:
                # a valid worker renormalizes its peer mean; a
                # quarantined one adopts the valid consensus
                full = (w * own + (1.0 - w) * (total - own)
                        / max(valid - 1.0, 1.0) if ok else total / valid)
                track32 = (shard32 if opt_placement == "sharded"
                           else total) / valid
        if new_tracker is not None:
            if name not in tracker:
                raise ValueError(
                    f"round-optimizer tracker has no bucket {name} "
                    "(bucket plan / tracker layout mismatch)")
            mu, nu = tracker[name]["mu"], tracker[name]["nu"]
            expect = row if opt_placement == "sharded" else b.padded
            if mu.shape[-1] != expect:
                raise ValueError(
                    f"round-optimizer bucket {name} row has "
                    f"{mu.shape[-1]} elements, expected {expect} for "
                    f"opt_placement={opt_placement!r} (sync_bucket_mb "
                    "or placement changed since the state was built?)")
            g = track32
            new_tracker[name] = {
                "mu": ROUND_ADAM_B1 * mu + (1.0 - ROUND_ADAM_B1) * g,
                "nu": ROUND_ADAM_B2 * nu + (1.0 - ROUND_ADAM_B2) * (g * g)}
            if buddy and opt_placement == "sharded":
                got = ring_hop([new_tracker[name]["mu"],
                                new_tracker[name]["nu"]], group,
                               slot + "/buddy_opt")
                buddy_out.setdefault(name, {}).update(mu=got[0], nu=got[1])
        if full is not None:
            out[seg] = full[:filled]
        if new_r is not None:
            new_r[seg] = err[:filled]
        start += filled
    res = residual if new_r is None else layout.unpack(new_r, residual)
    first = resident_out if resident else layout.unpack(out, tensors)
    ret = [first, res, new_tracker]
    if buddy:
        ret.append(buddy_out)
    if ok is not None:
        ret.append(float(ok))
    return tuple(ret)


def _hops(sent: torch.Tensor, sent32: torch.Tensor, scale, group: mesh.Group,
          shifts: Sequence[int], slot: str) -> list[torch.Tensor]:
    """For each shift s the fp32 decode of worker ``(rank - s) % n``'s
    payload: one batch of point-to-point sends (an int8 payload's scale
    travels beside it); a shift of 0 (mod n) is the worker's own payload,
    taken locally."""
    n, i = group.world_size, group.rank
    remote = [s for s in shifts if s % n]
    got, got_scale = {}, {}
    if remote:
        src = _to_host(sent, group, slot + "/send")
        # the scale stages through a pinned buffer too: a blocking copy
        # would be an implicit sync (--sanitize)
        src_scale = (_to_host(scale.reshape(1), group, slot + "/send_scale")
                     if scale is not None else None)
        ops = []
        for s in remote:
            got[s] = group.host_buffer(f"{slot}/recv{s}", sent.numel(),
                                       sent.dtype)
            ops += [dist.P2POp(dist.isend, _bytes(src),
                               group.peer((i + s) % n),
                               group=group.pg, tag=s),
                    dist.P2POp(dist.irecv, _bytes(got[s]),
                               group.peer((i - s) % n),
                               group=group.pg, tag=s)]
            group.count_wire("payload", src.nbytes)
            if scale is not None:
                got_scale[s] = group.host_buffer(f"{slot}/recv_scale{s}", 1)
                ops += [dist.P2POp(dist.isend, src_scale,
                                   group.peer((i + s) % n),
                                   group=group.pg, tag=100 + s),
                        dist.P2POp(dist.irecv, got_scale[s],
                                   group.peer((i - s) % n),
                                   group=group.pg, tag=100 + s)]
                group.count_wire("scale", 4)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = []
    for s in shifts:
        if s not in got:
            out.append(sent32)
            continue
        r32 = _to_device(got[s], sent.device).float()
        if scale is not None:
            r32 = r32 * _to_device(got_scale[s], sent.device)
        out.append(r32)
    return out


def gossip_sync(tensors: Sequence[torch.Tensor], *, group: mesh.Group,
                topology: str, how: str = "equal",
                local_weight: float = 0.5,
                wire_dtype: torch.dtype | None = None,
                residual: Sequence[torch.Tensor] | None = None,
                bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                layout: WireLayout | None = None, poison=None) -> tuple:
    """One bucketed ring/double-ring gossip round (JAX ``gossip_sync``):
    ``(blended tensors, new residual)``, plus this worker's 0/1 validity
    flag when ``poison`` is given.  The blends are ``aggregate``'s
    expressions on the packed buckets (bitwise the dense path in fp32);
    ``wire_dtype`` compresses the sent payload only; ``residual`` arms
    error feedback: each worker sends ``encode(x + residual)`` and keeps
    the rounding of that transmission.  ``poison``: a quarantined
    transmission travels as zeros and the blend renormalizes over the
    valid terms (a worker whose predecessor is quarantined keeps its own
    value; a quarantined one adopts its valid neighbours')."""
    if topology not in GOSSIP_HOPS:
        raise ValueError(
            f"topology must be one of {tuple(GOSSIP_HOPS)}, got "
            f"{topology!r} (allreduce rides sharded_opt_sync)")
    _check_fast(how, wire_dtype, residual, tensors)
    n = 1 if group is None else group.world_size
    tensors = list(tensors)
    ok = None if poison is None else contribution_ok(poison, tensors,
                                                     residual)
    if not tensors or n == 1:
        return ((tensors, residual) if ok is None
                else (tensors, residual, float(ok)))
    layout = layout or WireLayout.identity(tensors)
    flags = None if ok is None else gather_flags(ok, group)
    shifts = _SHIFTS[topology]
    peer_ok = (None if flags is None else
               [flags[(group.rank - s) % n] > 0 for s in shifts])
    screen = flags is not None and sum(flags) < n
    x = layout.pack(tensors)
    r = layout.pack(residual) if residual is not None else None
    out = torch.empty_like(x)
    new_r = torch.empty_like(x) if r is not None else None
    w = local_weight
    start = 0
    for bi, b in enumerate(bucket_plan(layout.leaves, n, bucket_bytes)):
        seg = slice(start, start + _filled(b))
        buf = x[seg]
        send = buf if r is None else buf + r[seg]
        if screen and not ok:
            send = torch.zeros_like(send)
        sent, sent32, scale = wire_encode(send, wire_dtype)
        if new_r is not None:
            new_r[seg] = send - sent32
        received = _hops(sent, sent32, scale, group, shifts,
                         f"gossip/{bucket_name(bi)}")
        if screen and not (ok and all(peer_ok)):
            blended = gossip_screened(buf, received, ok, peer_ok, how, w)
        elif topology == "ring":
            (r1,) = received
            blended = ((buf + r1) / 2.0 if how == "equal"
                       else w * buf + (1.0 - w) * r1)
        else:
            r1, r2 = received
            blended = ((buf + r1 + r2) / 3.0 if how == "equal"
                       else w * buf + ((1.0 - w) / 2.0) * (r1 + r2))
        out[seg] = blended
        start += seg.stop - seg.start
    synced = layout.unpack(out, tensors)
    res = residual if new_r is None else layout.unpack(new_r, residual)
    return (synced, res) if ok is None else (synced, res, float(ok))


# --------------------------------------------------------------------------
# The hierarchical two-level sync (JAX ``comms.py:1692-2053``): S slices of
# W workers, slice-major.  Per bucket, over each worker's two lines of the
# slice grid (``mesh.make_grid(world, {"slice": S, "data": W})``):
#
# 1. inner level, the slice's data line: the sharded engine's pack, encode
#    on ``wire_dtype`` and reduce-scatter (``_all_to_all`` + a fold in rank
#    order), so each worker holds the sum of its 1/W shard of the bucket;
# 2. the slice mean on the shard, ``m32 = shard32 / W``: the same on every
#    worker of the slice, which is what lets the outer hop ride the shard;
# 3. outer level, the slice line: the gossip hop(s) of ``topology``
#    (``_hops``) carry the shard in ``outer_wire_dtype`` (an int8 scale
#    travels beside its payload; the receiver decodes with the sender's);
# 4. the blend, on the shard;
# 5. the inner all-gather of the blended shard, or, resident, the sync ends
#    at the scatter and the decoded shard is the state.
#
# Error feedback is per level: the inner residual is the flat engine's two
# stages (own contribution, and W x the gather's rounding at the owned
# span); the outer residual, ``{bucket: [padded // W]}``, carries the fp32
# rounding of this worker's own outer transmission.  The double ring posts
# both outer hops in one batch before either blend term is used (JAX fences
# them with ``optimization_barrier``).  ``aggregate_hier`` is the dense
# twin: per element the same sums in the same order, no buckets, no wire.
# --------------------------------------------------------------------------


def _check_hier(topology: str, how: str) -> None:
    if topology not in GOSSIP_HOPS:
        raise ValueError(
            f"hierarchical outer topology must be one of "
            f"{tuple(GOSSIP_HOPS)}, got {topology!r} (an allreduce outer "
            "level is the flat S*W engine)")
    if how not in HOWS:
        raise ValueError(f"how must be one of {HOWS}, got {how!r}")


def _check_inner(inner_group) -> int:
    nw = 1 if inner_group is None else inner_group.world_size
    if nw < 2:
        raise ValueError(
            "the hierarchical sync needs an inner worker axis of size "
            ">= 2 (the outer gossip rides the 1/W scatter shard; with "
            "W = 1 there is no inner level — run the flat gossip engine)")
    return nw


def _gossip_blend(m, received: list, topology: str, how: str, w: float):
    """The gossip blend of ``m`` with its predecessors' values."""
    if topology == "ring":
        (r1,) = received
        return (m + r1) / 2.0 if how == "equal" else w * m + (1.0 - w) * r1
    r1, r2 = received
    return ((m + r1 + r2) / 3.0 if how == "equal"
            else w * m + ((1.0 - w) / 2.0) * (r1 + r2))


def aggregate_hier(tensors: Sequence[torch.Tensor], *,
                   inner_group: mesh.Group, outer_group: mesh.Group,
                   topology: str, how: str = "equal",
                   local_weight: float = 0.5) -> list[torch.Tensor]:
    """The dense hierarchical twin (JAX ``aggregate_hier``): the slice mean
    over the inner line (every worker's whole tensors gathered, summed in
    rank order, over W), the gossip blend of ``topology`` over the outer
    line in fp32, and for ``weighted`` the flat self-exclusive form with
    the blended slice total (``W * g``).  No buckets, no wire: the
    reference ``hierarchical_sync`` is held against bitwise in fp32."""
    _check_hier(topology, how)
    nw = _check_inner(inner_group)
    x = flatten(tensors)
    m = _fold(_all_gather(x, inner_group, "hier_dense/x").view(nw, -1)) / nw
    g = _gossip_blend(m, _shifted(m, outer_group, _SHIFTS[topology]),
                      topology, how, local_weight)
    if how == "weighted":
        w = local_weight
        g = w * x + (1.0 - w) * (nw * g - x) / (nw - 1)
    return unflatten(g, tensors)


def hier_wire_bytes(leaves, n_inner: int, *, topology: str,
                    wire_dtype: torch.dtype | None = None,
                    outer_wire_dtype: torch.dtype | None = None,
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> dict:
    """Per-worker bytes one hierarchical sync sends, by level (JAX
    ``hier_wire_bytes``): ``ici``, the inner sharded engine's 2(W-1)/W of
    each padded bucket in the inner wire; ``dcn``, hops x padded/W of each
    bucket in the outer wire.  int8 scales left out."""
    if not leaves or n_inner < 1:
        return {"ici": 0, "dcn": 0}
    hops = GOSSIP_HOPS.get(topology, 1)
    ici = dcn = 0
    for b in bucket_plan(list(leaves), n_inner, bucket_bytes):
        row = b.padded // n_inner
        ici += 2 * (n_inner - 1) * row * (wire_dtype or b.dtype).itemsize
        dcn += hops * row * (outer_wire_dtype or b.dtype).itemsize
    return {"ici": ici, "dcn": dcn}


def hier_outer_residual_init(leaves, n_inner: int, *,
                             bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                             device: torch.device | str = "cpu") -> dict:
    """This worker's zero outer residual (JAX ``hier_outer_residual_init``,
    one row of its worker-stacked layout): ``{bucket: [padded // W]}``
    fp32."""
    return {bucket_name(i): torch.zeros(b.padded // n_inner,
                                        dtype=torch.float32, device=device)
            for i, b in enumerate(bucket_plan(list(leaves), n_inner,
                                              bucket_bytes))}


def hierarchical_sync(tensors: Sequence[torch.Tensor], *,
                      inner_group: mesh.Group, outer_group: mesh.Group,
                      topology: str, how: str = "equal",
                      local_weight: float = 0.5,
                      wire_dtype: torch.dtype | None = None,
                      outer_wire_dtype: torch.dtype | None = None,
                      residual: Sequence[torch.Tensor] | None = None,
                      outer_residual: dict | None = None,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                      layout: WireLayout | None = None,
                      residency: str = "replicated") -> tuple:
    """One hierarchical round sync of one worker's tensors (JAX
    ``hierarchical_sync``; the section comment above): ``(synced tensors,
    new residual, new outer residual)``.  ``wire_dtype`` compresses the
    inner collectives, ``outer_wire_dtype`` the outer hops; ``residual``
    (tensors like ``tensors``) and ``outer_residual``
    (``hier_outer_residual_init``'s) each arm their level's error
    feedback.  ``residency="resident"`` ends at the inner scatter: the
    first value is then ``{bucket: [padded // W]}``, this worker's decoded
    shard of its slice's consensus, which ``resident_gather`` over the
    inner line rebuilds bit for bit."""
    _check_hier(topology, how)
    if residency not in PARAM_RESIDENCIES:
        raise ValueError(f"residency must be one of {PARAM_RESIDENCIES}, "
                         f"got {residency!r}")
    resident = residency == "resident"
    if resident and how != "equal":
        raise ValueError(
            "a scatter-resident hierarchical output requires the equal "
            "blend: the weighted own-term makes every worker's output "
            "per-worker state (config.py resolves weighted to the "
            "replicated residency)")
    compressed_in = _check_fast(how, wire_dtype, residual, tensors)
    nw = _check_inner(inner_group)
    tensors = list(tensors)
    if not tensors:
        return tensors, residual, outer_residual
    layout = layout or WireLayout.identity(tensors)
    irank = inner_group.rank
    shifts = _SHIFTS[topology]
    x = layout.pack(tensors)
    r = layout.pack(residual) if residual is not None else None
    out = None if resident else torch.empty_like(x)
    new_r = torch.empty_like(x) if r is not None else None
    new_outer = {} if outer_residual is not None else None
    resident_out = {}
    w = local_weight
    start = 0
    for bi, b in enumerate(bucket_plan(layout.leaves, nw, bucket_bytes)):
        filled, row = _filled(b), b.padded // nw
        name = bucket_name(bi)
        seg = slice(start, start + filled)
        slot = f"hier/{name}"
        # ---- inner level: pack, encode, reduce-scatter -----------------
        buf = x[seg] if r is None else x[seg] + r[seg]
        if b.padded > filled:
            buf = torch.cat([buf, buf.new_zeros(b.padded - filled)])
        sent, sent32, sent_scale = wire_encode(buf, wire_dtype)
        err = buf - sent32 if r is not None else None
        pieces = _all_to_all(sent, inner_group, slot)
        if sent_scale is not None:
            scales = _all_gather(sent_scale.reshape(1), inner_group,
                                 slot + "/scale", "scale")
            shard32 = _fold(pieces.float() * scales[:, None])
        else:
            shard32 = _fold(pieces.float())
        # ---- the slice mean on the shard, then the outer hop(s) --------
        m32 = shard32 / nw
        o_send = m32
        if new_outer is not None:
            if name not in outer_residual:
                raise ValueError(
                    f"outer residual has no bucket {name} (bucket plan "
                    "/ outer-residual layout mismatch)")
            o_res = outer_residual[name]
            if tuple(o_res.shape) != (row,):
                raise ValueError(
                    f"outer residual bucket {name} row has shape "
                    f"{tuple(o_res.shape)}, expected {(row,)} "
                    "(sync_bucket_mb or worker count changed?)")
            o_send = m32 + o_res.float()
        osent, osent32, oscale = wire_encode(o_send, outer_wire_dtype)
        if new_outer is not None:
            new_outer[name] = o_send - osent32
        received = _hops(osent, osent32, oscale, outer_group, shifts,
                         slot + "/outer")
        g32 = _gossip_blend(m32, received, topology, how, w)
        # ---- the apply on the shard, then the inner gather -------------
        gq, gq_dec, gq_scale = wire_encode(g32, wire_dtype)
        if err is not None and compressed_in and how == "equal":
            # the inner stage 2: the owner of the span carries W x the
            # gather payload's rounding into its next contribution
            own = slice(irank * row, (irank + 1) * row)
            err[own] = err[own] + nw * (g32 - gq_dec)
        full = None
        if how == "equal":
            if resident:
                resident_out[name] = gq_dec
            else:
                full = _gather_decoded(gq, gq_scale, inner_group,
                                       slot + "/mean")
        else:
            gfull = _gather_decoded(gq, gq_scale, inner_group, slot + "/sum")
            own = sent32
            full = w * own + (1.0 - w) * (nw * gfull - own) / (nw - 1)
        if full is not None:
            out[seg] = full[:filled]
        if new_r is not None:
            new_r[seg] = err[:filled]
        start += filled
    res = residual if new_r is None else layout.unpack(new_r, residual)
    outer = outer_residual if new_outer is None else new_outer
    first = resident_out if resident else layout.unpack(out, tensors)
    return first, res, outer


def fast_sync(tensors, *, group: mesh.Group, mode: str, how: str = "equal",
              topology: str = "allreduce", local_weight: float = 0.5,
              wire_dtype: torch.dtype | None = None, residual=None,
              bucket_bytes: int = DEFAULT_BUCKET_BYTES,
              opt_placement: str = "sharded", tracker: dict | None = None,
              layout: WireLayout | None = None,
              residency: str = "replicated", buddy: bool = False,
              poison=None, outer_group: mesh.Group | None = None,
              outer_wire_dtype: torch.dtype | None = None,
              outer_residual: dict | None = None) -> tuple:
    """One sync by engine ``mode`` (JAX ``make_host_sync``'s dispatch):
    ``dense`` (``aggregate``), ``gossip`` (ring/double_ring), ``sharded``
    (allreduce) or ``hier`` (``hierarchical_sync``: ``group`` is the inner
    line, ``outer_group`` the outer one); ``(synced, new_residual,
    new_tracker)``, then the buddy rows when ``buddy`` (sharded only) and
    this worker's validity flag when ``poison`` is given; ``hier`` returns
    its new outer residual fourth (it takes neither)."""
    if mode == "hier":
        if buddy or poison is not None or tracker is not None:
            raise ValueError(
                "the hierarchical sync takes no buddy hop, poison flag or "
                "round optimizer (--chaos and buddy redundancy are refused "
                "under --num_slices > 1; the tracker stays off)")
        first, res, outer = hierarchical_sync(
            tensors, inner_group=group, outer_group=outer_group,
            topology=topology, how=how, local_weight=local_weight,
            wire_dtype=wire_dtype, outer_wire_dtype=outer_wire_dtype,
            residual=residual, outer_residual=outer_residual,
            bucket_bytes=bucket_bytes, layout=layout, residency=residency)
        return first, res, tracker, outer
    if mode == "dense":
        out = aggregate(tensors, how=how, topology=topology,
                        local_weight=local_weight, group=group,
                        poison=poison)
        if poison is None:
            return out, residual, tracker
        return out[0], residual, tracker, out[1]
    if mode == "gossip":
        out = gossip_sync(
            tensors, group=group, topology=topology, how=how,
            local_weight=local_weight, wire_dtype=wire_dtype,
            residual=residual, bucket_bytes=bucket_bytes, layout=layout,
            poison=poison)
        return (out[0], out[1], tracker, *out[2:])
    if mode != "sharded":
        raise ValueError(f"mode must be dense, gossip, sharded or hier, "
                         f"got {mode!r}")
    return sharded_opt_sync(
        tensors, group=group, how=how, local_weight=local_weight,
        wire_dtype=wire_dtype, residual=residual, bucket_bytes=bucket_bytes,
        opt_placement=opt_placement, tracker=tracker, layout=layout,
        residency=residency, buddy=buddy, poison=poison)


# --------------------------------------------------------------------------
# The chaos screen, scatter-resident parameters and the buddy hop (JAX
# ``comms.py:646-1090``).  The host-side layouts are numpy, worker-stacked
# as in JAX: a resident layout is ``{bucket: [n, padded // n]}`` (row w is
# worker w's contiguous 1/n shard of the packed consensus vector, pad
# positions exactly zero), the round optimizer's ``{bucket: {"mu", "nu"}}``
# rows the same or ``[n, padded]``, a buddy layout ``{bucket: {"params",
# "res", "mu", "nu": [n, row]}}`` whose row w is worker (w - 1) % n's.
# They are copies and permutations, so they equal JAX's bit for bit.
# --------------------------------------------------------------------------

PARAM_RESIDENCIES = ("replicated", "resident")


def contribution_ok(poison, tensors, residual=None) -> bool:
    """Whether this worker's sync contribution is valid (JAX
    ``_contribution_ok``): not poisoned, and every tensor (and the EF
    residual folded into it) finite."""
    if bool(poison):
        return False
    parts = list(tensors) + list(residual or [])
    if not parts:
        return True
    return bool(torch.stack([torch.isfinite(t).all() for t in parts]).all())


def gather_flags(ok: bool, group: mesh.Group) -> list[float]:
    """Every rank's 0/1 validity flag, in rank order (one all_gather of a
    float; the JAX screen's psum and ppermuted flags read the same)."""
    flags = _all_gather(torch.tensor([float(ok)]), group, "screen/flag",
                        "flag")
    return [float(f) for f in flags]


def ring_hop(tensors: list, group: mesh.Group, slot: str,
             n_scale: int = 0, kind: str = "buddy") -> list:
    """Send ``tensors`` to the ring successor ``(rank + 1) % n`` and return
    the predecessor's, on this worker's device (one batch of
    point-to-point ops).  The bytes count under ``group.wire[kind]``,
    those of ``tensors[1:1 + n_scale]`` (int8 scales) under ``"scale"``."""
    n, i = group.world_size, group.rank
    ops, got = [], []
    for j, t in enumerate(tensors):
        src = _to_host(t.contiguous(), group, f"{slot}/send{j}")
        dst = group.host_buffer(f"{slot}/recv{j}", t.numel(), t.dtype)
        ops += [dist.P2POp(dist.isend, _bytes(src),
                           group.peer((i + 1) % n),
                           group=group.pg, tag=200 + j),
                dist.P2POp(dist.irecv, _bytes(dst),
                           group.peer((i - 1) % n),
                           group=group.pg, tag=200 + j)]
        group.count_wire("scale" if 1 <= j <= n_scale else kind,
                         src.nbytes)
        got.append(dst)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_to_device(g, t.device).view(t.shape)
            for g, t in zip(got, tensors)]


@dataclasses.dataclass(frozen=True)
class ParamsTemplate:
    """One worker's parameters as the host re-layouts see them (the
    counterpart of JAX's per-worker ``ShapeDtypeStruct`` tree): the
    tensors' names, shapes and dtypes in module order, and the
    ``WireLayout`` that packs them in JAX's flatten order.  Picklable:
    membership snapshots carry it."""

    names: tuple
    shapes: tuple
    dtypes: tuple
    leaves: tuple
    pieces: tuple

    @classmethod
    def of(cls, names, tensors, layout: "WireLayout | None" = None):
        tensors = list(tensors)
        layout = layout or WireLayout.identity(tensors)
        return cls(tuple(names), tuple(tuple(t.shape) for t in tensors),
                   tuple(str(t.dtype).removeprefix("torch.")
                         for t in tensors),
                   tuple((tuple(s), str(d).removeprefix("torch."))
                         for s, d in layout.leaves),
                   tuple(layout.pieces))

    def layout(self) -> "WireLayout":
        return WireLayout(self.leaves, self.pieces)

    def like(self) -> list[torch.Tensor]:
        return [torch.empty(s, dtype=getattr(torch, d), device="meta")
                for s, d in zip(self.shapes, self.dtypes)]


def _packed(template: ParamsTemplate, row) -> np.ndarray:
    """One worker's tensors (``template`` order) as the packed fp32
    vector (numpy, a copy)."""
    return template.layout().pack(
        [torch.as_tensor(np.asarray(a)) for a in row]).numpy()


def _unpacked(template: ParamsTemplate, vec: np.ndarray) -> list:
    return [t.contiguous().numpy() for t in template.layout().unpack(
        torch.from_numpy(np.ascontiguousarray(vec)), template.like())]


def _leaf_starts(leaves) -> list[int]:
    sizes = [_numel(_shape_dtype(leaf)[0]) for leaf in leaves]
    return [int(x) for x in np.concatenate([[0], np.cumsum(sizes)])]


def _positions(b: _Bucket, starts: list[int]) -> np.ndarray:
    """Where a bucket's filled elements sit in the packed vector."""
    return np.concatenate([np.arange(starts[j], starts[j] + size)
                           for (j, _off, size) in b.items])


def round_opt_relayout(tracker: dict, leaves, n_new: int, *, placement: str,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> dict:
    """Re-lay a HOST round-optimizer tracker out for a new worker count
    (JAX ``round_opt_relayout``): the moment vector is worker-invariant,
    so it is rebuilt from the rows, re-padded (pad positions hold exact
    zeros) and re-split.  ``leaves``: the layout's ``(shape, dtype)``."""
    plan = bucket_plan(list(leaves), max(1, n_new), bucket_bytes)
    out: dict = {}
    for i, b in enumerate(plan):
        name = bucket_name(i)
        if name not in tracker:
            raise ValueError(
                f"round-optimizer tracker has no bucket {name} "
                f"({len(tracker)} buckets vs plan {len(plan)})")
        filled = _filled(b)
        row_new = b.padded // n_new if placement == "sharded" else b.padded
        out[name] = {}
        for m in ("mu", "nu"):
            arr = np.asarray(tracker[name][m])
            vec = arr.reshape(-1) if placement == "sharded" else arr[0]
            if vec.size < filled:
                raise ValueError(
                    f"round-optimizer bucket {name}/{m} carries "
                    f"{vec.size} elements but the plan needs {filled}")
            vec = vec[:filled]
            pad = (n_new * row_new if placement == "sharded"
                   else b.padded) - filled
            if pad:
                vec = np.concatenate([vec, np.zeros(pad, vec.dtype)])
            out[name][m] = (vec.reshape(n_new, row_new)
                            if placement == "sharded"
                            else np.broadcast_to(vec, (n_new, b.padded))
                            .copy())
    return out


def resident_from_tree(tensors, n: int, *, template: ParamsTemplate,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> dict:
    """HOST: one worker's CONSENSUS tensors (``template`` order) packed
    into the resident layout ``{bucket: [n, padded // n]}`` (JAX
    ``resident_from_tree``)."""
    vec = _packed(template, tensors)
    starts = _leaf_starts(template.leaves)
    out = {}
    for i, b in enumerate(bucket_plan(list(template.leaves), n,
                                      bucket_bytes)):
        full = np.zeros(b.padded, np.float32)
        full[:_filled(b)] = vec[_positions(b, starts)]
        out[bucket_name(i)] = full.reshape(n, b.padded // n)
    return out


def resident_to_tree(resident: dict, *, template: ParamsTemplate,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> list:
    """HOST: a resident layout back into the consensus tensors (numpy, in
    ``template`` order): the host twin of the round-entry gather, bit for
    bit (JAX ``resident_to_tree``).  The worker count is read off the
    rows."""
    n = next((int(np.shape(a)[0]) for a in resident.values()), 0)
    if not n:
        raise ValueError("resident params layout is empty")
    starts = _leaf_starts(template.leaves)
    vec = np.empty(starts[-1], np.float32)
    plan = bucket_plan(list(template.leaves), n, bucket_bytes)
    for i, b in enumerate(plan):
        name = bucket_name(i)
        if name not in resident:
            raise ValueError(
                f"resident params layout has no bucket {name} "
                f"({len(resident)} buckets vs plan {len(plan)})")
        arr = np.asarray(resident[name])
        if arr.shape != (n, b.padded // n):
            raise ValueError(
                f"resident params bucket {name} has shape {arr.shape}, "
                f"expected {(n, b.padded // n)} (sync_bucket_mb or "
                "worker count changed since the state was built?)")
        vec[_positions(b, starts)] = arr.reshape(-1)[:_filled(b)]
    return _unpacked(template, vec)


def resident_relayout(resident: dict, leaves, n_new: int, *,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> dict:
    """Re-tile a HOST resident layout for a new worker count (JAX
    ``resident_relayout``): rebuild the vector, re-pad, re-split."""
    plan = bucket_plan(list(leaves), max(1, n_new), bucket_bytes)
    out: dict = {}
    for i, b in enumerate(plan):
        name = bucket_name(i)
        if name not in resident:
            raise ValueError(
                f"resident params layout has no bucket {name} "
                f"({len(resident)} buckets vs plan {len(plan)})")
        vec = np.asarray(resident[name]).reshape(-1)
        filled = _filled(b)
        if vec.size < filled:
            raise ValueError(
                f"resident params bucket {name} carries {vec.size} "
                f"elements but the plan needs {filled}")
        vec = vec[:filled]
        if b.padded > filled:
            vec = np.concatenate([vec, np.zeros(b.padded - filled,
                                                vec.dtype)])
        out[name] = vec.reshape(n_new, b.padded // n_new)
    return out


def resident_rows(tensors, n: int, rank: int, *, template: ParamsTemplate,
                  bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                  device: torch.device | str = "cpu") -> dict:
    """Worker ``rank``'s row of ``resident_from_tree`` on ``device``."""
    full = resident_from_tree(
        [t.detach().cpu() if isinstance(t, torch.Tensor) else t
         for t in tensors], n, template=template, bucket_bytes=bucket_bytes)
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank])).to(device)
            for k, v in full.items()}


def resident_gather(shards: dict, *, group: mesh.Group,
                    layout: WireLayout, like,
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> list:
    """The round-entry gather (JAX ``resident_gather``): every rank's
    resident row of each bucket, all_gathered in rank order, unpacked into
    tensors shaped and typed like ``like`` on the rows' device."""
    n = group.world_size
    plan = bucket_plan(layout.leaves, n, bucket_bytes)
    parts = []
    for i, b in enumerate(plan):
        name = bucket_name(i)
        if name not in shards:
            raise ValueError(
                f"resident params layout has no bucket {name} "
                f"({len(shards)} buckets vs plan {len(plan)})")
        row = shards[name]
        if tuple(row.shape) != (b.padded // n,):
            raise ValueError(
                f"resident params bucket {name} row has shape "
                f"{tuple(row.shape)}, expected {(b.padded // n,)} "
                "(sync_bucket_mb or worker count changed?)")
        parts.append(_all_gather(row, group,
                                 f"resident/{name}")[:_filled(b)])
    return layout.unpack(torch.cat(parts), like)


def buddy_wire_bytes(leaves, n: int, *, wire_dtype=None,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     params: bool = True, tracker: bool = False,
                     ef: bool = False) -> int:
    """Per-worker bytes the buddy hop sends per sync (JAX
    ``buddy_wire_bytes``): per bucket the ``padded / n`` resident row in
    the wire dtype, the EF residual's owned span and the two tracker rows
    in fp32; int8 scales left out.  Zero when nothing is shard-resident."""
    if not leaves or n <= 1:
        return 0
    total = 0
    for b in bucket_plan(list(leaves), n, bucket_bytes):
        row = b.padded // n
        if params:
            total += row * (wire_dtype or b.dtype).itemsize
        if ef:
            total += row * 4
        if tracker:
            total += 2 * row * 4
    return total


def derive_buddy(template: ParamsTemplate, n: int, *,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 params_resident: dict | None = None,
                 round_opt: dict | None = None, residual=None,
                 opt_placement: str = "sharded") -> dict | None:
    """HOST: the buddy layout a state's shard-resident rows imply (JAX
    ``derive_buddy``): ``buddy[bucket][comp][w]`` is worker ``(w - 1) %
    n``'s row, what the hop delivers.  ``residual``: the stacked EF
    residual, a list of ``[n, ...]`` arrays in ``template`` order (each
    worker's OWN span goes in).  None when nothing is shard-resident."""
    if n < 2 or not template.leaves:
        return None
    tracker_on = round_opt is not None and opt_placement == "sharded"
    if params_resident is None and residual is None and not tracker_on:
        return None
    starts = _leaf_starts(template.leaves)
    res_vecs = (None if residual is None else
                [_packed(template, [np.asarray(a)[w] for a in residual])
                 for w in range(n)])
    out: dict = {}
    for i, b in enumerate(bucket_plan(list(template.leaves), n,
                                      bucket_bytes)):
        name, row = bucket_name(i), b.padded // n
        bud: dict = {}
        if params_resident is not None:
            arr = np.asarray(params_resident[name])
            if arr.shape != (n, row):
                raise ValueError(
                    f"resident params bucket {name} has shape "
                    f"{arr.shape}, expected {(n, row)}")
            bud["params"] = np.roll(arr, 1, axis=0).copy()
        if res_vecs is not None:
            pos = _positions(b, starts)
            mat = np.zeros((n, b.padded), np.float32)
            for w in range(n):
                mat[w, :len(pos)] = res_vecs[w][pos]
            spans = np.stack([mat[w, w * row:(w + 1) * row]
                              for w in range(n)])
            bud["res"] = np.roll(spans, 1, axis=0).copy()
        if tracker_on:
            for m in ("mu", "nu"):
                arr = np.asarray(round_opt[name][m])
                if arr.shape != (n, row):
                    raise ValueError(
                        f"round-opt bucket {name}/{m} has shape "
                        f"{arr.shape}, expected {(n, row)} (buddy "
                        "redundancy covers the SHARDED placement)")
                bud[m] = np.roll(arr, 1, axis=0).copy()
        out[name] = bud
    return out


def buddy_restore_rows(parts: dict, buddy: dict, lost_positions,
                       template: ParamsTemplate, *,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> dict:
    """HOST: rebuild CRASHED workers' shard-resident rows from their
    buddy copies (JAX ``buddy_restore_rows``).  ``parts``: any of
    ``params_resident`` ({bucket: [n, row]}), ``round_opt`` ({bucket:
    {"mu", "nu"}}) and ``residual`` (list of ``[n, ...]`` arrays in
    ``template`` order).  Lost position p's holder is ``(p + 1) % n``; a
    holder that is lost too is a double fault and raises.  The residual's
    lost span is FOLDED into the holder's residual; the other rows are
    patched in place.  Returns new arrays, inputs untouched."""
    resident = parts.get("params_resident")
    round_opt = parts.get("round_opt")
    residual = parts.get("residual")
    n = None
    for comp in (resident, round_opt):
        if comp:
            first = next(iter(comp.values()))
            arr = first.get("mu") if isinstance(first, dict) else first
            n = int(np.shape(arr)[0])
            break
    if n is None and residual is not None:
        n = int(np.shape(residual[0])[0])
    if n is None:
        raise ValueError("nothing shard-resident to restore")
    lost = sorted(set(int(p) for p in lost_positions))
    for p in lost:
        if not 0 <= p < n:
            raise ValueError(f"lost position {p} outside worker axis {n}")
        if (p + 1) % n in lost:
            raise ValueError(
                f"double fault: crashed worker at position {p} and its "
                f"buddy at position {(p + 1) % n} are both lost — the span "
                "exists nowhere in memory (fall back to the newest "
                "committed checkpoint)")
    plan = bucket_plan(list(template.leaves), n, bucket_bytes)
    out = dict(parts)
    if resident is not None:
        patched = {k: np.asarray(v).copy() for k, v in resident.items()}
        for i in range(len(plan)):
            name = bucket_name(i)
            for p in lost:
                patched[name][p] = np.asarray(
                    buddy[name]["params"])[(p + 1) % n]
        out["params_resident"] = patched
    if round_opt is not None and any("mu" in bud for bud in buddy.values()):
        patched = {k: {m: np.asarray(v).copy() for m, v in d.items()}
                   for k, d in round_opt.items()}
        for i in range(len(plan)):
            name = bucket_name(i)
            for p in lost:
                for m in ("mu", "nu"):
                    patched[name][m][p] = np.asarray(
                        buddy[name][m])[(p + 1) % n]
        out["round_opt"] = patched
    if residual is not None and any("res" in bud for bud in buddy.values()):
        starts = _leaf_starts(template.leaves)
        rows = [np.asarray(a).copy() for a in residual]
        for holder in sorted({(p + 1) % n for p in lost}):
            vec = _packed(template, [a[holder] for a in rows])
            for i, b in enumerate(plan):
                row, pos = b.padded // n, _positions(b, starts)
                span = np.asarray(buddy[bucket_name(i)]["res"])[holder]
                for p in lost:
                    if (p + 1) % n != holder:
                        continue
                    lo, hi = p * row, min((p + 1) * row, len(pos))
                    if lo < hi:
                        vec[pos[lo:hi]] += span[:hi - lo]
            for a, v in zip(rows, _unpacked(template, vec)):
                a[holder] = v
        out["residual"] = rows
    return out
