"""Cache-aware autoregressive decode over a paged KV cache (port of the JAX
package's ``models/decode.py``), reading the port's own GPT and Llama
modules: each block's parameters where they live, no restacking.

Layout (vLLM-style paged attention as plain PyTorch gathers; the JAX
package runs it as plain XLA, with no custom kernel):

- the cache is one pool of ``num_pages`` fixed-size pages per layer:
  ``k/v [num_layers, num_pages, page_size, kv_heads, head_dim]``;
- a sequence owns a page-table row ``[pages_per_seq]`` mapping position
  ``p`` to ``(table[p // page_size], p % page_size)``;
- page 0 is the trash page: the allocator never hands it out, and every
  masked write (prefill padding, inactive decode slots) goes there, so
  each program keeps one shape;
- attention gathers a slot's pages into a ``[pages_per_seq * page_size]``
  key/value run under the cache-offset causal mask ``kpos <= position``:
  stale rows of recycled pages sit where the mask excludes them.

``forward_paged`` serves every program: prefill at ``[1, bucket]`` tokens,
decode at ``[max_batch, 1]`` and a speculative pair's verify at
``[max_batch, k+1]``.  It writes the new keys and values into the pools in
place; ``speculative_accept`` is the verify's accept/reject step.

Numerics: the JAX decode's operation for operation at fp32 (LayerNorm as
E[x²] − μ² in fp32, RMSNorm, RoPE at the cache positions, grouped-query
einsums, softmax in fp32, top-1 MoE with no capacity limit), which is the
only compute dtype the JAX decode traces (under bfloat16 its scan carry
changes dtype and it refuses).  Under bfloat16 the port casts as its
training forward does (``models/bert.py::dense``): products in the compute
dtype, norms in fp32, the cache in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .bert import dense

TRASH_PAGE = 0   # reserved page id for masked writes (never allocated)


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static architecture facts of a served model (``spec_from_model``)."""

    family: str                  # "gpt" | "llama"
    num_layers: int
    hidden: int
    num_heads: int
    num_kv_heads: int            # == num_heads for MHA
    head_dim: int
    vocab: int
    max_len: int                 # gpt position-table bound (0 = unbounded)
    rope_theta: float            # llama
    num_experts: int             # > 0 => MoE FFN blocks
    dtype: torch.dtype = torch.float32


def spec_from_model(model) -> DecodeSpec:
    """The decode spec of the port's ``GPTForCausalLM`` or
    ``LlamaForCausalLM``."""
    fam = {"GPTForCausalLM": "gpt", "LlamaForCausalLM": "llama"}.get(
        type(model).__name__)
    if fam is None:
        raise ValueError(
            f"serving supports the autoregressive families (gpt_*/llama_*, "
            f"optionally MoE); got model class {type(model).__name__} — "
            "bert/vit/cnn models have no decode path")
    if getattr(model, "sp", None) is not None:
        # JAX decode.py:90
        raise ValueError("serving runs the single-replica dense twin; "
                         "TP/SP train-model variants are not servable")
    attn = model.blocks[0].attn
    return DecodeSpec(
        family=fam, num_layers=len(model.blocks),
        hidden=model.tok_emb.weight.shape[1], num_heads=attn.num_heads,
        num_kv_heads=attn.num_kv_heads, head_dim=attn.head_dim,
        vocab=model.num_classes, max_len=getattr(model, "max_len", 0) or 0,
        rope_theta=float(attn.rope_theta or 10000.0),
        num_experts=model.num_experts, dtype=model.dtype)


def init_paged_cache(spec: DecodeSpec, num_pages: int, page_size: int,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (k, v) page pools [L, P, page_size, KV, head_dim]."""
    shape = (spec.num_layers, num_pages, page_size, spec.num_kv_heads,
             spec.head_dim)
    return (torch.zeros(shape, dtype=spec.dtype, device=device),
            torch.zeros(shape, dtype=spec.dtype, device=device))


# ----------------------------------------------------------------------
# Shared numerics (the JAX decode's own formulas)
# ----------------------------------------------------------------------

def _layernorm(x: torch.Tensor, ln) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    y = (xf - mu) * torch.rsqrt(var + ln.eps)
    return (y * ln.weight.float() + ln.bias.float()).to(x.dtype)


def _rmsnorm(x: torch.Tensor, norm, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * norm.weight.float()).to(x.dtype)


def rope_rows(x: torch.Tensor, positions: torch.Tensor, theta: float
              ) -> torch.Tensor:
    """``ops.attention.rope`` with a position per row: ``x`` [B, T, H, D]
    at ``positions`` [B, T]; angles in fp32, result in ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs              # [B, T, D/2]
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def paged_attend(q, k_new, v_new, *, positions, num_valid, page_table,
                 k_pages, v_pages) -> torch.Tensor:
    """The attention core of prefill and decode.  ``q/k_new/v_new``
    [B, T, H|KV, D] are this call's projections at ``positions`` [B, T];
    the new K/V are written into one layer's pools ``k_pages/v_pages``
    [P, page_size, KV, D] in place (rows ``i >= num_valid[b]`` to the
    trash page), then each slot's pages are gathered to a run of
    S = pages_per_seq * page_size keys and attended under ``kpos <=
    position``.  Returns [B, T, H, D]."""
    b, t = q.shape[:2]
    page_size = k_pages.shape[1]
    pages_per_seq = page_table.shape[1]
    page_idx = (positions // page_size).clamp(0, pages_per_seq - 1)
    dest_page = page_table.gather(1, page_idx)                     # [B, T]
    valid = (torch.arange(t, device=q.device)[None, :]
             < num_valid[:, None])
    dest_page = torch.where(valid, dest_page,
                            torch.full_like(dest_page, TRASH_PAGE))
    dest_page, dest_row = dest_page.reshape(-1), (positions
                                                  % page_size).reshape(-1)
    k_pages[dest_page, dest_row] = k_new.reshape(
        b * t, *k_new.shape[2:]).to(k_pages.dtype)
    v_pages[dest_page, dest_row] = v_new.reshape(
        b * t, *v_new.shape[2:]).to(v_pages.dtype)
    s = pages_per_seq * page_size
    k_all = k_pages[page_table].reshape(b, s, *k_pages.shape[2:])
    v_all = v_pages[page_table].reshape(b, s, *v_pages.shape[2:])
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, None, None, :] <= positions[:, None, :, None]
    return dot_product_attention(q, k_all, v_all, mask=mask)


# ----------------------------------------------------------------------
# Per-family block decode
# ----------------------------------------------------------------------

def _moe_ffn(moe, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Top-1 expert FFN without a capacity limit (the JAX decode's
    ``_moe_ffn``): every expert's FFN computed, combined by the one-hot
    gate."""
    b, t, h = x.shape
    toks = x.reshape(b * t, h)
    probs = torch.softmax(toks.float() @ moe.gate.weight.float().t(), -1)
    gate, expert_idx = probs.max(-1).values, probs.argmax(-1)
    onehot = (expert_idx[:, None] == torch.arange(
        probs.shape[-1], device=x.device)).float()
    w1, b1 = moe.w1.to(dtype), moe.b1.to(dtype)
    w2, b2 = moe.w2.to(dtype), moe.b2.to(dtype)
    h1 = F.gelu(torch.einsum("nh,ehf->nef", toks.to(dtype), w1) + b1[None],
                approximate="none")
    ye = torch.einsum("nef,efh->neh", h1, w2) + b2[None]
    combine = (onehot * gate[:, None]).to(dtype)
    return torch.einsum("ne,neh->nh", combine, ye).reshape(b, t, h)


def _attn_proj(attn, x: torch.Tensor, spec: DecodeSpec, positions):
    """q/k/v of one block at ``positions`` (RoPE-rotated for llama, so the
    cached keys carry their positions)."""
    b, t, _ = x.shape
    h, kv, dh = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if attn.gqa:
        q = dense(x, attn.q, spec.dtype).view(b, t, h, dh)
        k, v = dense(x, attn.kv, spec.dtype).view(b, t, 2, kv, dh).unbind(2)
    else:
        q, k, v = dense(x, attn.qkv, spec.dtype).view(b, t, 3, h,
                                                      dh).unbind(2)
    if spec.family == "llama":
        q = rope_rows(q, positions, spec.rope_theta)
        k = rope_rows(k, positions, spec.rope_theta)
    return q, k, v


def _block(spec: DecodeSpec, block, x, positions, num_valid, page_table,
           kc, vc) -> torch.Tensor:
    """One decoder block against one layer's pools ``kc/vc``."""
    dt = spec.dtype
    gpt = spec.family == "gpt"
    h = _layernorm(x, block.ln1) if gpt else _rmsnorm(x, block.rms1)
    q, k, v = _attn_proj(block.attn, h, spec, positions)
    out = paged_attend(q, k, v, positions=positions, num_valid=num_valid,
                       page_table=page_table, k_pages=kc, v_pages=vc)
    a = dense(out.reshape(*out.shape[:2], -1), block.attn.out, dt)
    if block.attn.out_bias is not None:
        a = a + block.attn.out_bias.to(a.dtype)
    x = x + a
    f = _layernorm(x, block.ln2) if gpt else _rmsnorm(x, block.rms2)
    if spec.num_experts:
        f = _moe_ffn(block.moe, f, dt)
    elif gpt:
        f = F.gelu(dense(f, block.ffn_in, dt), approximate="tanh")
        f = dense(f, block.ffn_out, dt) + block.ffn_bias.to(dt)
    else:
        f = dense(F.silu(dense(f, block.ffn_in, dt))
                  * dense(f, block.ffn_up, dt), block.ffn_out, dt)
    return x + f


# ----------------------------------------------------------------------
# The paged forward (prefill and decode)
# ----------------------------------------------------------------------

def forward_paged(spec: DecodeSpec, model, tokens, lengths, num_valid,
                  page_table, k_pages, v_pages,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply ``model`` to ``tokens [B, T]`` whose rows sit at cache offsets
    ``lengths [B]``; ``num_valid [B]`` counts each row's real new tokens
    (the rest write to the trash page); ``page_table [B, pages_per_seq]``;
    ``k_pages/v_pages`` [L, P, page_size, KV, D] take this call's keys and
    values in place.  Returns logits [B, T, vocab] in the compute dtype."""
    dt = spec.dtype
    if positions is None:
        positions = lengths[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]
    emb = model.tok_emb.weight
    x = F.embedding(tokens, emb.to(dt))
    if spec.family == "gpt":
        pos_tab = model.pos_emb.weight.to(dt)
        x = x + pos_tab[positions.clamp(0, pos_tab.shape[0] - 1)]
    for layer, block in enumerate(model.blocks):
        x = _block(spec, block, x, positions, num_valid, page_table,
                   k_pages[layer], v_pages[layer])
    if spec.family == "gpt":
        return torch.einsum("bth,vh->btv", _layernorm(x, model.ln_f),
                            emb.to(dt))
    return dense(_rmsnorm(x, model.rms_f), model.lm_head, dt)


def speculative_accept(logits: torch.Tensor, draft: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy accept/reject of one speculation burst, on the device (JAX
    ``models/decode.py:302-338``).

    ``logits [B, k+1, vocab]`` are the target's verify logits at positions
    ``C .. C+k`` (the pending token and the k drafted ones); ``draft
    [B, k]`` the draft's proposals.  The target's token at ``C+j`` is
    ``t_j = argmax``, the twin of the plain decode step's greedy sample.
    ``acc = min(longest matching prefix, k-1)`` (a cumulative product of
    the matches) and ``emitted = d_1 .. d_acc, t_acc`` with the tail -1.
    The cap costs nothing (when all k match, ``t_{k-1}`` is ``d_k``) and
    keeps both pools filled exactly to the new length after committing
    ``acc + 1`` tokens: the draft wrote ``C .. C+k-1``, so no catch-up
    program of another shape exists, and rollback is page-table
    arithmetic.  Returns ``(emitted [B, k] int32, acc [B] int32)``."""
    k = draft.shape[1]
    tgt = logits.argmax(-1).to(torch.int32)                    # [B, k+1]
    draft = draft.to(torch.int32)
    match = (draft == tgt[:, :-1]).to(torch.int32)             # [B, k]
    acc = torch.cumprod(match, dim=1).sum(1).clamp_max(k - 1).to(torch.int32)
    bonus = tgt.gather(1, acc[:, None].long())                 # [B, 1]
    idx = torch.arange(k, device=draft.device)[None, :]
    emitted = torch.where(idx < acc[:, None], draft,
                          torch.where(idx == acc[:, None], bonus,
                                      torch.full_like(draft, -1)))
    return emitted, acc


def sample_seed(seed: int, rid: int, position: int) -> int:
    """The draw's seed: a function of (seed, request id, position) only."""
    return int(np.random.SeedSequence([int(seed), int(rid), int(position)])
               .generate_state(1, np.uint64)[0])


def sample_tokens(logits: torch.Tensor, temps, rids, gen_pos,
                  seed: int) -> torch.Tensor:
    """Greedy (temp <= 0: ``argmax``) or temperature sampling of one token
    per row of ``logits [B, vocab]``; ``temps``, ``rids`` and ``gen_pos``
    (the absolute position of the token being generated) are host arrays.
    A temperature row draws Gumbel noise from a generator seeded by
    ``sample_seed(seed, rid, position)`` alone, so batched continuous
    decoding samples the stream a single-sequence decode would."""
    out = logits.argmax(-1)
    temps = np.asarray(temps, np.float32)
    for i in np.flatnonzero(temps > 0.0):
        g = torch.Generator(device=logits.device).manual_seed(
            sample_seed(seed, rids[i], gen_pos[i]))
        u = torch.rand(logits.shape[-1], generator=g, device=logits.device)
        noisy = (logits[i].float() / max(float(temps[i]), 1e-6)
                 - torch.log(-torch.log(u)))
        out[i] = noisy.argmax()
    return out
