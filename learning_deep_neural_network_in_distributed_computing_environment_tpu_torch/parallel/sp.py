"""Sequence parallelism over the ``seq`` axis of the rank grid (port of the
JAX package's ``parallel/sp.py``): ring attention, its zig-zag causal
variant and all-to-all (Ulysses) attention.

Each rank of a ``seq`` line (``mesh.Group``) holds one contiguous chunk
``[B, L/S, H, D]`` of the worker's queries, keys and values; the three
functions return the rank's chunk of the attention over the whole
sequence.  The JAX package computes this attention with einsums, outside
any Pallas kernel, and so does the port: ``torch.einsum`` on the fp32
upcast of the model-dtype inputs (the JAX package's
``preferred_element_type=float32``), the online softmax in fp32.

JAX's ``lax.ppermute`` and ``lax.all_to_all`` carry their own gradients;
here each hop is an autograd function whose backward is the inverse hop
(``_Exchange``: the cotangent travels back along the permutation;
``_AllToAll``: the inverse all-to-all).  Every hop of one attention call
packs all the tensors it moves into one flat buffer, so each call is a
chain of single collectives whose backward order the data dependencies
fix on every rank, whatever blocks a rank skipped.  A hop stages through
the group's pinned host buffers (device -> host -> gloo -> device), the
bytes moved as ``uint8``, and is counted in ``STATS``: on one card this
measures correctness and the cost of the staging, not the speed of
sequence parallelism.

What differs from the JAX package, by design: the ring runs S-1 hops
(JAX rotates S times and drops the last rotation, which changes no
value); the zig-zag ring skips a dead sub-block with a Python ``if`` (a
rank knows its index) where JAX uses ``lax.cond``.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

from .. import comms, mesh
from ..ops.attention import (NEG_INF, causal_mask, dot_product_attention,
                             kv_group_size)

# per process: the hops run (point-to-point exchanges and all-to-alls), the
# bytes handed to gloo for other ranks and their wall time (host staging
# included); and the gradients' all-reduce over the seq line, apart
STATS = {"calls": 0, "bytes": 0, "ms": 0.0,
         "grad_calls": 0, "grad_bytes": 0, "grad_ms": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("ms") else 0


def _count(t0: float, nbytes: int) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += int(nbytes)
    STATS["ms"] += (time.perf_counter() - t0) * 1e3


def _inverse(perm: Sequence[int]) -> tuple:
    out = [0] * len(perm)
    for src, dst in enumerate(perm):
        out[dst] = src
    return tuple(out)


def exchange(flats: Sequence[torch.Tensor], group: mesh.Group,
             perms: Sequence[Sequence[int]]) -> list[torch.Tensor]:
    """Flat tensor k of every rank moved along permutation ``perms[k]``
    (group rank j sends to ``perms[k][j]``), all in one batch of
    point-to-point ops; returns what this rank received.  A rank that
    keeps its own tensor takes it locally."""
    i = group.rank
    t0 = time.perf_counter()
    ops, got, sent = [], {}, 0
    for k, (x, perm) in enumerate(zip(flats, perms)):
        dst = perm[i]
        if dst == i:
            continue
        src = perm.index(i)
        send = comms._to_host(x, group, f"sp/{k}/send")
        got[k] = group.host_buffer(f"sp/{k}/recv", x.numel(), x.dtype)
        ops.append(dist.P2POp(dist.isend, send.view(torch.uint8),
                              group.peer(dst), group=group.pg, tag=k))
        ops.append(dist.P2POp(dist.irecv, got[k].view(torch.uint8),
                              group.peer(src), group=group.pg, tag=k))
        sent += send.nbytes
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _count(t0, sent)
    return [comms._to_device(got[k], x.device) if k in got else x
            for k, x in enumerate(flats)]


def all_to_all(flat: torch.Tensor, group: mesh.Group) -> torch.Tensor:
    """``flat`` cut into S equal slices, slice j sent to group rank j;
    returns the slices received, in rank order, as one flat tensor."""
    t0 = time.perf_counter()
    n = group.world_size
    send = comms._to_host(flat, group, "sp/a2a/send")
    recv = group.host_buffer("sp/a2a/recv", flat.numel(), flat.dtype)
    dist.all_to_all_single(recv.view(torch.uint8), send.view(torch.uint8),
                           group=group.pg)
    _count(t0, (n - 1) * send.nbytes // n)
    return comms._to_device(recv, flat.device)


class _Exchange(torch.autograd.Function):
    """``exchange`` forward; the cotangents sent back along the inverse
    permutations backward."""

    @staticmethod
    def forward(ctx, group, perms, *flats):
        ctx.group, ctx.perms = group, perms
        out = exchange(flats, group, perms)
        return tuple(o.view_as(o) if o is x else o
                     for o, x in zip(out, flats))

    @staticmethod
    def backward(ctx, *grads):
        inv = [_inverse(p) for p in ctx.perms]
        back = exchange([g.contiguous() for g in grads], ctx.group, inv)
        return (None, None, *back)


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` forward and backward (slice j of the cotangent goes
    back to the rank it came from)."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        return all_to_all(flat, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


def permute(parts: Sequence[Sequence[torch.Tensor]], group: mesh.Group,
            perms: Sequence[Sequence[int]]) -> list[list[torch.Tensor]]:
    """Each list of tensors ``parts[k]`` moved along ``perms[k]`` (one
    packed buffer per list, every list in one differentiable exchange)."""
    flats = [torch.cat([t.reshape(-1) for t in ts]) for ts in parts]
    moved = _Exchange.apply(group, tuple(tuple(p) for p in perms), *flats)
    return [[p.view(t.shape) for p, t in
             zip(m.split([t.numel() for t in ts]), ts)]
            for m, ts in zip(moved, parts)]


def _ring(n: int) -> tuple:
    return tuple((j + 1) % n for j in range(n))


def _scores(qf: torch.Tensor, kb: torch.Tensor, rep: int, scale: float
            ) -> torch.Tensor:
    """fp32 scores [B, H, Lq, Lk] of queries ``qf`` ([B, Lq, H/rep, rep,
    D], fp32) against one K block [B, Lk, KV, D]."""
    b, lq, g, r, _ = qf.shape
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kb.float()) * scale
    return s.reshape(b, g * r, lq, kb.shape[1])


def _update(state, s: torch.Tensor, vb: torch.Tensor, rep: int):
    """One online-softmax step (JAX ``sp.py:84-110``): ``state`` = (o [B,
    H, Lq, D], m, l [B, H, Lq]) in fp32; the probabilities are cast to
    v's dtype before the product, as in the JAX package."""
    o, m, l = state
    b, h, lq, lk = s.shape
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(-1)
    pg = p.to(vb.dtype).float().reshape(b, h // rep, rep, lq, lk)
    pv = torch.einsum("bgrqk,bkgd->bgrqd", pg, vb.float()).reshape(
        b, h, lq, -1)
    return o * corr[..., None] + pv, m_new, l


def _zero_state(b: int, h: int, lq: int, d: int, device):
    return (torch.zeros(b, h, lq, d, device=device),
            torch.full((b, h, lq), float("-inf"), device=device),
            torch.zeros(b, h, lq, device=device))


def _finish(state, dtype) -> torch.Tensor:
    """[B, H, Lq, D] accumulators -> [B, Lq, H, D] outputs in ``dtype``."""
    o, _m, l = state
    return (o / l[..., None]).to(dtype).transpose(1, 2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: mesh.Group, causal: bool = False) -> torch.Tensor:
    """Blockwise ring attention, bidirectional or causal (JAX
    ``ring_attention`` :26).

    q [B, Lc, H, D], k/v [B, Lc, KV, D]: this rank's chunk of the ``group``
    ring.  The K/V chunk rotates i -> i+1; at rotation t this rank holds
    the chunk of rank ``(idx - t) % n``, masked causally by global
    positions when ``causal`` (a fully future block masks to -1e30 and
    contributes 0, computed as in the JAX package).  Under GQA the
    rotating K/V are ``rep``x smaller than the queries."""
    n, idx = group.world_size, group.rank
    b, lc, h, d = q.shape
    rep = kv_group_size(q, k)
    scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, lc, h // rep, rep, d)
    state = _zero_state(b, h, lc, d, q.device)
    kb, vb = k, v
    for t in range(n):
        s = _scores(qf, kb, rep, scale)
        if causal:
            src = (idx - t) % n                 # the chunk's home rank
            cm = causal_mask(lc, lc, q_offset=idx * lc, k_offset=src * lc,
                             device=q.device)
            s = torch.where(cm, s, torch.full_like(s, NEG_INF))
        state = _update(state, s, vb, rep)
        if t + 1 < n:
            (kb, vb), = permute([(kb, vb)], group, [_ring(n)])
    return _finish(state, q.dtype)


def _zigzag_home(hh: int, n: int) -> int:
    """The rank holding global half-chunk ``hh`` under zig-zag."""
    return hh if hh < n else 2 * n - 1 - hh


def ring_attention_zigzag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          group: mesh.Group) -> torch.Tensor:
    """Causal ring attention with zig-zag half-chunk balancing (JAX
    ``ring_attention_zigzag`` :115).

    Inputs and outputs are in the contiguous layout (rank i holds
    ``[i*Lc, (i+1)*Lc)``, RoPE applied at global positions); the sequence
    is cut into 2n half-chunks and rank i computes halves (i, 2n-1-i), so
    every rotation has the same causally live work on every rank.  A dead
    (q-half, kv-half) sub-block is skipped.  The chunk must be even."""
    n, idx = group.world_size, group.rank
    b, lc, h, d = q.shape
    if lc % 2:
        raise ValueError(f"zig-zag ring needs an even per-device chunk "
                         f"length, got {lc}")
    rep = kv_group_size(q, k)
    half = lc // 2
    scale = 1.0 / d ** 0.5
    perm1 = tuple(_zigzag_home(2 * j, n) for j in range(n))
    perm2 = tuple(_zigzag_home(2 * j + 1, n) for j in range(n))
    even = idx % 2 == 0
    # to zig-zag: each rank's first half along perm1, its second along
    # perm2 (q, k and v in one exchange); slot A holds global half idx,
    # slot B half 2n-1-idx
    r1, r2 = permute([[x[:, :half] for x in (q, k, v)],
                      [x[:, half:] for x in (q, k, v)]], group,
                     [perm1, perm2])
    a, bs = (r1, r2) if even else (r2, r1)
    (qa, ka, va), (qb, kb, vb) = a, bs
    qa = qa.float().reshape(b, half, h // rep, rep, d)
    qb = qb.float().reshape(b, half, h // rep, rep, d)
    ga, gb = idx, 2 * n - 1 - idx
    sa = _zero_state(b, h, half, d, q.device)
    sb = _zero_state(b, h, half, d, q.device)

    def update(qh, kh, vh, st, gq, gk):
        if gk > gq:                  # causally dead: never computed
            return st
        s = _scores(qh, kh, rep, scale)
        if gk == gq:                 # the diagonal sub-block
            s = torch.where(causal_mask(half, half, device=q.device), s,
                            torch.full_like(s, NEG_INF))
        return _update(st, s, vh, rep)

    for t in range(n):
        src = (idx - t) % n
        for kh, vh, gk in ((ka, va, src), (kb, vb, 2 * n - 1 - src)):
            sa = update(qa, kh, vh, sa, ga, gk)
            sb = update(qb, kh, vh, sb, gb, gk)
        if t + 1 < n:
            (ka, kb, va, vb), = permute([(ka, kb, va, vb)], group,
                                        [_ring(n)])
    out_a, out_b = _finish(sa, q.dtype), _finish(sb, q.dtype)
    # back to the contiguous layout: this rank's even global half along
    # the inverse of perm1, its odd one along the inverse of perm2
    evn, odd = (out_a, out_b) if even else (out_b, out_a)
    (first,), (second,) = permute([[evn], [odd]], group,
                                  [_inverse(perm1), _inverse(perm2)])
    return torch.cat([first, second], dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: mesh.Group, causal: bool = False
                      ) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) attention (JAX ``ulysses_attention``
    :250): one all-to-all trades the sequence shards of q, k and v for
    head shards (each rank then holds the whole sequence for H/S heads),
    the port's dense attention runs on them, and a second all-to-all
    trades back.  Needs H and KV divisible by S."""
    n = group.world_size
    b, lc, h, d = q.shape
    kv = k.shape[2]
    if h % n or kv % n:
        raise ValueError(
            f"ulysses attention needs query heads ({h}) and kv heads ({kv}) "
            f"divisible by the seq-axis size ({n}); use ring attention "
            "otherwise")
    xs = (q, k, v)
    # slice j for rank j: its heads of q, k and v, packed
    send = torch.cat([x.chunk(n, dim=2)[j].reshape(-1)
                      for j in range(n) for x in xs])
    recv = _AllToAll.apply(send, group).view(n, -1)
    sizes = [x.numel() // n for x in xs]
    rows = [row.split(sizes) for row in recv]
    qh, kh, vh = (torch.cat([rows[j][i].view(b, lc, x.shape[2] // n, d)
                             for j in range(n)], dim=1)
                  for i, x in enumerate(xs))       # [B, L, heads/S, D]
    out = dot_product_attention(qh, kh, vh, causal=causal)
    send = torch.cat([c.reshape(-1) for c in out.chunk(n, dim=1)])
    back = _AllToAll.apply(send, group).view(n, b, lc, h // n, d)
    return torch.cat(back.unbind(0), dim=2)        # [B, Lc, H, D]


@torch.no_grad()
def all_reduce_grads(grads: list, group: mesh.Group) -> list:
    """The gradients summed over the seq line in one fp32 all-reduce: each
    rank computed them on its chunk of every sequence (JAX ``psum`` over
    ``seq``, ``train.py:1703-1706``)."""
    t0 = time.perf_counter()
    flat = comms.flatten(grads)
    total = comms._all_reduce_sum(flat, group)
    STATS["grad_calls"] += 1
    STATS["grad_bytes"] += flat.nbytes
    STATS["grad_ms"] += (time.perf_counter() - t0) * 1e3
    return comms.unflatten(total, grads)
