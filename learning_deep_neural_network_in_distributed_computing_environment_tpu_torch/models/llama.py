"""Llama-style causal language model (port of the JAX package's
``models/llama.py:43-101, 141-238``): pre-norm RMSNorm, rotary position
embeddings inside attention (no position table), a SwiGLU FFN, no biases
anywhere, and an untied LM head.  ``num_kv_heads`` below ``num_heads``
gives grouped-query attention.

Parameters are fp32; ``dtype`` is the compute dtype, applied per op as in
flax (``models/bert.py::dense``), and the logits come out in it.
``num_experts > 0`` swaps SwiGLU for the Switch-MoE FFN; blocks run under
the ``--remat_policy`` (``models/remat.py``).

Under tensor parallelism (``tp``, the rank's ``model`` line; JAX
``llama.py:60-170``) each block holds its local query and K/V heads
(``kv_local``), the SwiGLU split by columns (``ffn_in``, ``ffn_up``) then
rows (``ffn_out``), and the untied head is vocab-parallel (the local V/T
rows of ``lm_head``); the token table stays replicated.  Under a pipe
axis the first stage runs ``embed``, each stage ``stage`` on its blocks
and the last ``head`` (``parallel/pp.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tp import copy_to_tp_region, reduce_from_tp_region
from .bert import SelfAttention, dense, run_stack, tp_local
from .remat import Remat, checkpoint_name

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
    """Pre-norm decoder block: x + attn(rms1(x)); x + swiglu(rms2(x)).
    Returns ``(y, aux)``: aux is the MoE FFN's load-balance loss, or
    None."""

    def __init__(self, hidden: int, num_heads: int, ffn_dim: int, *,
                 num_kv_heads: Optional[int] = None, num_experts: int = 0,
                 capacity_factor: float = 1.25,
                 rope_theta: float = 10000.0,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", tp=None, sp=None, ep=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.tp = tp
        self.rms1 = RMSNorm(hidden, device=device)
        self.attn = SelfAttention(hidden, num_heads,
                                  num_kv_heads=num_kv_heads, use_bias=False,
                                  causal=True, attention_impl=attention_impl,
                                  rope_theta=rope_theta, dtype=dtype, tp=tp,
                                  sp=sp, device=device)
        self.rms2 = RMSNorm(hidden, device=device)
        if num_experts:
            from .moe import MoEFFN
            self.moe = MoEFFN(hidden, num_experts, ffn_dim,
                              capacity_factor=capacity_factor, dtype=dtype,
                              tp=tp, ep=ep, device=device)
        else:
            f = tp_local(ffn_dim, tp, "ffn_dim")   # column-parallel SwiGLU
            self.ffn_in = nn.Linear(hidden, f, bias=False, device=device)
            self.ffn_up = nn.Linear(hidden, f, bias=False, device=device)
            self.ffn_out = nn.Linear(f, hidden, bias=False, device=device)

    def forward(self, x: torch.Tensor):
        a = checkpoint_name(self.attn(self.rms1(x, self.dtype)), "attn_out")
        x = x + a
        f = self.rms2(x, self.dtype)
        aux = None
        if hasattr(self, "moe"):
            f, aux = self.moe(f)
        else:
            f = copy_to_tp_region(f, self.tp)
            gate = dense(f, self.ffn_in, self.dtype)
            up = dense(f, self.ffn_up, self.dtype)
            f = reduce_from_tp_region(
                dense(F.silu(gate) * up, self.ffn_out, self.dtype), self.tp)
        f = checkpoint_name(f, "mlp_out")
        return checkpoint_name(x + f, "block_out"), aux


class LlamaForCausalLM(nn.Module):
    """Token ids [B, L] -> next-token logits [B, L, vocab] in the compute
    dtype.  Labels come shifted from the data pipeline."""

    def __init__(self, num_classes: int = 32000, num_layers: int = 16,
                 hidden: int = 1024, num_heads: int = 16, ffn_dim: int = 2816,
                 rope_theta: float = 10000.0,
                 num_kv_heads: Optional[int] = None, *,
                 num_experts: int = 0, capacity_factor: float = 1.25,
                 remat_policy: str = "none",
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", tp=None, sp=None, ep=None,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_experts = num_experts
        self.dtype = dtype
        self.tp = tp
        self.sp = sp
        self.remat = Remat(remat_policy)
        v_local = tp_local(num_classes, tp, "vocab size (vocab-parallel "
                                            "head)")
        self.tok_emb = nn.Embedding(num_classes, hidden, device=device)
        self.blocks = nn.ModuleList(
            LlamaBlock(hidden, num_heads, ffn_dim, num_kv_heads=num_kv_heads,
                       num_experts=num_experts,
                       capacity_factor=capacity_factor,
                       rope_theta=rope_theta, dtype=dtype,
                       attention_impl=attention_impl, tp=tp, sp=sp, ep=ep,
                       device=device)
            for _ in range(num_layers))
        # this rank's query and K/V heads and their width (the weight
        # conversion's); without tensor parallelism the global counts
        attn = self.blocks[0].attn
        self.num_heads = attn.num_heads
        self.num_kv_heads = attn.num_kv_heads if num_kv_heads else \
            num_kv_heads
        self.head_dim = hidden // num_heads
        self.rms_f = RMSNorm(hidden, device=device)
        self.lm_head = nn.Linear(hidden, v_local, bias=False, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers: N(0, 0.02) for every dense kernel and
        embedding, ones for the RMSNorm scales, drawn from ``generator``
        (on the parameters' device)."""
        from .moe import MoEFFN
        for module in self.modules():
            if isinstance(module, RMSNorm):
                module.weight.fill_(1.0)
            elif isinstance(module, MoEFFN):
                module.init_parameters(generator)
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, INIT_STD, generator=generator)

    def forward(self, input_ids: torch.Tensor, with_aux: bool = False):
        """Logits, and with ``with_aux`` also the summed MoE load-balance
        loss (None without experts)."""
        x, aux = self.stage(self.embed(input_ids))
        logits = self.logits(x)
        return (logits, aux) if with_aux else logits

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The token lookup: the first pipeline stage's part (JAX
        ``mode="embed"``)."""
        return F.embedding(input_ids, self.tok_emb.weight.to(self.dtype))

    def stage(self, x: torch.Tensor):
        """This module's blocks (a pipeline stage's, JAX ``mode="stage"``):
        ``(x, summed MoE aux loss or None)``."""
        return run_stack(self.blocks, x, self.remat)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``rms_f`` and the untied LM head: the last pipeline stage's part
        (JAX ``mode="head"``)."""
        return dense(copy_to_tp_region(self.rms_f(x, self.dtype), self.tp),
                     self.lm_head, self.dtype)

    def activation_shape(self, x: torch.Tensor) -> tuple:
        """The shape of the activation between two blocks for input
        ``x`` (what a pipeline stage receives)."""
        return (*x.shape[:2], self.tok_emb.embedding_dim)
