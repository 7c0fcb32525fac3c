"""Llama-style causal language model (port of the JAX package's
``models/llama.py:43-101, 141-238``): pre-norm RMSNorm, rotary position
embeddings inside attention (no position table), a SwiGLU FFN, no biases
anywhere, and an untied LM head.  ``num_kv_heads`` below ``num_heads``
gives grouped-query attention.

Parameters are fp32; ``dtype`` is the compute dtype, applied per op as in
flax (``models/bert.py::dense``), and the logits come out in it.  MoE
FFNs, layer scan, tensor/pipeline parallelism and remat are not ported
(the config rejects them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bert import SelfAttention, dense

INIT_STD = 0.02
RMS_EPS = 1e-5


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=1e-5, dtype=...)``: the mean of squares in
    fp32, the scale folded into the ``rsqrt`` factor, output in the
    compute dtype.  The scale parameter is fp32."""

    def __init__(self, hidden: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + RMS_EPS)
        return (xf * (mul * self.weight)).to(dtype)


class LlamaBlock(nn.Module):
    """Pre-norm decoder block: x + attn(rms1(x)); x + swiglu(rms2(x))."""

    def __init__(self, hidden: int, num_heads: int, ffn_dim: int, *,
                 num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", device=None):
        super().__init__()
        self.dtype = dtype
        self.rms1 = RMSNorm(hidden, device=device)
        self.attn = SelfAttention(hidden, num_heads,
                                  num_kv_heads=num_kv_heads, use_bias=False,
                                  causal=True, attention_impl=attention_impl,
                                  rope_theta=rope_theta, dtype=dtype,
                                  device=device)
        self.rms2 = RMSNorm(hidden, device=device)
        self.ffn_in = nn.Linear(hidden, ffn_dim, bias=False, device=device)
        self.ffn_up = nn.Linear(hidden, ffn_dim, bias=False, device=device)
        self.ffn_out = nn.Linear(ffn_dim, hidden, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.rms1(x, self.dtype))
        f = self.rms2(x, self.dtype)
        gate = dense(f, self.ffn_in, self.dtype)
        up = dense(f, self.ffn_up, self.dtype)
        return x + dense(F.silu(gate) * up, self.ffn_out, self.dtype)


class LlamaForCausalLM(nn.Module):
    """Token ids [B, L] -> next-token logits [B, L, vocab] in the compute
    dtype.  Labels come shifted from the data pipeline."""

    def __init__(self, num_classes: int = 32000, num_layers: int = 16,
                 hidden: int = 1024, num_heads: int = 16, ffn_dim: int = 2816,
                 rope_theta: float = 10000.0,
                 num_kv_heads: Optional[int] = None, *,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.dtype = dtype
        self.tok_emb = nn.Embedding(num_classes, hidden, device=device)
        self.blocks = nn.ModuleList(
            LlamaBlock(hidden, num_heads, ffn_dim, num_kv_heads=num_kv_heads,
                       rope_theta=rope_theta, dtype=dtype,
                       attention_impl=attention_impl, device=device)
            for _ in range(num_layers))
        self.rms_f = RMSNorm(hidden, device=device)
        self.lm_head = nn.Linear(hidden, num_classes, bias=False,
                                 device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers: N(0, 0.02) for every dense kernel and
        embedding, ones for the RMSNorm scales, drawn from ``generator``
        (on the parameters' device)."""
        for module in self.modules():
            if isinstance(module, RMSNorm):
                module.weight.fill_(1.0)
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, INIT_STD, generator=generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = F.embedding(input_ids, self.tok_emb.weight.to(self.dtype))
        for block in self.blocks:
            x = block(x)
        return dense(self.rms_f(x, self.dtype), self.lm_head, self.dtype)
