"""Self-attention shared by the transformer families (port of the JAX
package's ``models/bert.py:36-112``; ``BertForMLM`` itself waits for
ROADMAP queue A.7).

Compute-dtype semantics mirror flax's ``dtype=``: parameters stay fp32 and
each dense op casts its input, weight and bias to the compute dtype
(``dense`` below), so a bf16 run does its products in bf16 exactly where
the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (flax ``Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
               ) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics and normalization in fp32,
    output in ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


class SelfAttention(nn.Module):
    """Multi-head (fused ``qkv`` projection) or grouped-query (separate
    ``q`` / ``kv`` projections) attention on [B, L, hidden] inputs.

    Projection weights are ``nn.Linear`` [out, in] with the output features
    ordered like the flax ``DenseGeneral`` kernels' trailing axes
    ((3, H, Dh) for ``qkv``, (2, KV, Dh) for ``kv``); ``weights.py``
    converts between the two layouts.  ``rope_theta`` rotates q and k
    (never v) at positions ``arange(L)`` before ``attend`` (the Llama
    recipe)."""

    def __init__(self, hidden: int, num_heads: int, *,
                 num_kv_heads: Optional[int] = None, use_bias: bool = True,
                 causal: bool = False, attention_impl: str = "dense",
                 rope_theta: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        # falsy num_kv_heads (None or the config's 0 sentinel) means MHA
        self.gqa = bool(num_kv_heads) and num_kv_heads != num_heads
        self.num_kv_heads = num_kv_heads if self.gqa else num_heads
        if self.gqa and num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        self.causal = causal
        self.rope_theta = rope_theta
        self.attention_impl = attention_impl
        self.dtype = dtype
        inner = num_heads * self.head_dim
        if self.gqa:
            self.q = nn.Linear(hidden, inner, bias=use_bias, device=device)
            self.kv = nn.Linear(hidden, 2 * self.num_kv_heads * self.head_dim,
                                bias=use_bias, device=device)
        else:
            self.qkv = nn.Linear(hidden, 3 * inner, bias=use_bias,
                                 device=device)
        self.out = nn.Linear(inner, hidden, bias=False, device=device)
        self.out_bias = (nn.Parameter(torch.zeros(hidden, device=device))
                         if use_bias else None)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        from ..ops.attention import attend, rope
        b, l, _ = x.shape
        h, kv, dh = self.num_heads, self.num_kv_heads, self.head_dim
        if self.gqa:
            q = dense(x, self.q, self.dtype).view(b, l, h, dh)
            k, v = dense(x, self.kv, self.dtype).view(b, l, 2, kv, dh).unbind(2)
        else:
            q, k, v = dense(x, self.qkv, self.dtype).view(
                b, l, 3, h, dh).unbind(2)
        if self.rope_theta is not None:
            pos = torch.arange(l, device=x.device)
            q = rope(q, pos, self.rope_theta)
            k = rope(k, pos, self.rope_theta)
        # q/k/v stay strided views of the projection output (q/k are new
        # tensors under RoPE); the flash kernels read them through their
        # strides
        out = attend(q, k, v, mask=mask, impl=self.attention_impl,
                     causal=self.causal)
        y = dense(out.reshape(b, l, h * dh), self.out, self.dtype)
        if self.out_bias is None:
            return y
        return y + self.out_bias.to(self.dtype)
