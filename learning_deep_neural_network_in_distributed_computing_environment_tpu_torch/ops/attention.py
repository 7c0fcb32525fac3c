"""Attention ops: one entry point, ``attend(q, k, v, impl=..., causal=...)``,
with tensors in the JAX layout [batch, seq, heads, head_dim] (port of the
JAX package's ``ops/attention.py:29-137``).

- ``dense``: plain PyTorch dot-product attention (fp32 softmax);
- ``flash``: the hand-written Hopper kernels (``ops/flash.py``); on CPU
  tensors their plain PyTorch versions.

K/V may carry fewer heads than Q (grouped-query attention); every impl
consumes the grouped K/V without expanding it to the full head count.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary position embedding, rotate-half convention (JAX package:
    ``ops/attention.py:32-48``).

    ``x`` [B, L, H, Dh], ``pos`` [L] absolute token positions.  Angles are
    computed in fp32 and the result is cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)      # [Dh/2]
    ang = pos.float()[:, None] * freqs[None, :]                  # [L, Dh/2]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def causal_mask(lq: int, lk: int, q_offset: int = 0, k_offset: int = 0,
                device=None) -> torch.Tensor:
    """[lq, lk] bool mask: query at global position q_offset+i may attend
    key positions <= it."""
    qpos = q_offset + torch.arange(lq, device=device)[:, None]
    kpos = k_offset + torch.arange(lk, device=device)[None, :]
    return kpos <= qpos


def kv_group_size(q: torch.Tensor, k: torch.Tensor) -> int:
    """Queries per K/V head (1 = MHA)."""
    h, kv = q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"query heads ({h}) not divisible by kv heads "
                         f"({kv})")
    return h // kv


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, KV, D] -> [B, Lq, H, D]; softmax in fp32.

    Scores are taken from the fp32 upcast of q and k (the products of two
    bf16 values are exact in fp32, as with the JAX package's
    ``preferred_element_type=float32``); the probabilities are cast to
    v's dtype before the second product."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    rep = kv_group_size(q, k)
    # head h <-> (group h // rep, member h % rep)
    qg = q.float().reshape(b, lq, h // rep, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) / d ** 0.5
    s = s.reshape(b, h, lq, lk)
    if causal:
        cm = causal_mask(lq, lk, device=q.device)
        mask = cm if mask is None else torch.logical_and(mask, cm)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    wg = w.reshape(b, h // rep, rep, lq, lk)
    out = torch.einsum("bgrqk,bkgd->bqgrd", wg, v)
    return out.reshape(b, lq, h, d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None, impl: str = "dense",
           axis_name: Optional[str] = None,
           causal: bool = False) -> torch.Tensor:
    if impl == "dense":
        return dot_product_attention(q, k, v, mask, causal=causal)
    if impl == "flash":
        from .flash import flash_attention
        return flash_attention(q, k, v, mask, causal=causal)
    if impl in ("ring", "ring_zigzag", "all_to_all"):
        raise NotImplementedError(
            f"{impl} attention (sequence parallelism over axis "
            f"{axis_name!r}) is not ported yet; it arrives with ROADMAP "
            "queue A.11 (sequence-parallel slice)")
    raise ValueError(f"unknown attention impl {impl!r}")
