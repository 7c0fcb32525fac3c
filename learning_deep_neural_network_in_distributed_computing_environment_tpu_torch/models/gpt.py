"""GPT-2-style causal language model (port of the JAX package's
``models/gpt.py:37-245``): pre-LN blocks, learned position embeddings,
tanh-GELU FFN (or a Switch-MoE FFN with ``num_experts > 0``) and a tied LM
head (logits = hidden @ tok_emb^T); ``gpt2_small`` has the canonical
124,439,808 parameters.  Blocks run under the ``--remat_policy``
(``models/remat.py``).

Parameters are fp32; ``dtype`` is the compute dtype, applied per op as in
flax (``models/bert.py::dense`` / ``layer_norm``), and the logits come out
in it.

Under tensor parallelism (``tp``, the rank's ``model`` line; JAX
``gpt.py:173-231``) the blocks hold their head and FFN shards
(``bert.SelfAttention``, the column/row FFN) and the TIED head is
vocab-parallel: the embedding table holds this rank's V/T rows, the lookup
is masked to them and summed over ``model`` (g), and the logits are the
local vocab slice of the same table (``shard_tok_emb``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tp import copy_to_tp_region, reduce_from_tp_region
from .bert import (SelfAttention, dense, init_flax, layer_norm, run_stack,
                   seq_offset, tp_local)
from .remat import Remat, checkpoint_name


class GPTBlock(nn.Module):
    """Pre-LN decoder block: x + attn(ln1(x)); x + ffn(ln2(x)).  Returns
    ``(y, aux)``: aux is the MoE FFN's load-balance loss, or None."""

    def __init__(self, hidden: int, num_heads: int, ffn_dim: int, *,
                 num_experts: int = 0, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", tp=None, sp=None, ep=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.tp = tp
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5, device=device)
        self.attn = SelfAttention(hidden, num_heads, causal=True,
                                  attention_impl=attention_impl, dtype=dtype,
                                  tp=tp, sp=sp, device=device)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-5, device=device)
        if num_experts:
            from .moe import MoEFFN
            self.moe = MoEFFN(hidden, num_experts, ffn_dim,
                              capacity_factor=capacity_factor, dtype=dtype,
                              tp=tp, ep=ep, device=device)
        else:
            f = tp_local(ffn_dim, tp, "ffn_dim")   # column-parallel FFN
            self.ffn_in = nn.Linear(hidden, f, device=device)
            self.ffn_out = nn.Linear(f, hidden, bias=False, device=device)
            self.ffn_bias = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x: torch.Tensor):
        a = checkpoint_name(self.attn(layer_norm(x, self.ln1, self.dtype)),
                            "attn_out")
        x = x + a
        f = layer_norm(x, self.ln2, self.dtype)
        aux = None
        if hasattr(self, "moe"):
            f, aux = self.moe(f)
        else:
            f = dense(F.gelu(dense(copy_to_tp_region(f, self.tp),
                                   self.ffn_in, self.dtype),
                             approximate="tanh"), self.ffn_out, self.dtype)
            f = (reduce_from_tp_region(f, self.tp)
                 + self.ffn_bias.to(self.dtype))
        f = checkpoint_name(f, "mlp_out")
        return checkpoint_name(x + f, "block_out"), aux


class GPTForCausalLM(nn.Module):
    """Token ids [B, L] -> next-token logits [B, L, vocab] in the compute
    dtype.  Labels come shifted from the data pipeline
    (``data/sources.py::_lm_synthetic``)."""

    def __init__(self, num_classes: int = 50257, num_layers: int = 12,
                 hidden: int = 768, num_heads: int = 12, ffn_dim: int = 3072,
                 max_len: int = 1024, *, num_experts: int = 0,
                 capacity_factor: float = 1.25, remat_policy: str = "none",
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", tp=None, sp=None, ep=None,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_experts = num_experts
        self.max_len = max_len
        self.dtype = dtype
        self.tp = tp
        self.sp = sp
        self.remat = Remat(remat_policy)
        # the vocab-parallel tied head: this rank's rows of the table
        self.tok_emb = nn.Embedding(
            tp_local(num_classes, tp, "vocab size (vocab-parallel tied "
                                      "head)"), hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, hidden, device=device)
        self.blocks = nn.ModuleList(
            GPTBlock(hidden, num_heads, ffn_dim, num_experts=num_experts,
                     capacity_factor=capacity_factor, dtype=dtype,
                     attention_impl=attention_impl, tp=tp, sp=sp, ep=ep,
                     device=device)
            for _ in range(num_layers))
        # this rank's heads and their width (the weight conversion's)
        self.num_heads = self.blocks[0].attn.num_heads
        self.head_dim = hidden // num_heads
        self.ln_f = nn.LayerNorm(hidden, eps=1e-5, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers (``bert.init_flax``), drawn from
        ``generator`` (on the parameters' device)."""
        init_flax(self, generator)

    def forward(self, input_ids: torch.Tensor, with_aux: bool = False):
        """Logits, and with ``with_aux`` also the summed MoE load-balance
        loss (None without experts)."""
        table = self.tok_emb.weight.to(self.dtype)
        x, aux = self.stage(self.embed(input_ids, table))
        logits = self.logits(x, table)
        return (logits, aux) if with_aux else logits

    def embed(self, input_ids: torch.Tensor,
              table: torch.Tensor | None = None) -> torch.Tensor:
        """Token + position embeddings: the first pipeline stage's part
        (JAX ``mode="embed"``).  ``table``: the compute-dtype token table
        (the forward casts it once for the lookup and the tied head)."""
        l = input_ids.shape[1]
        # under sequence parallelism: this rank's chunk of every sequence
        off = seq_offset(self.sp, l)
        if off + l > self.max_len:
            raise ValueError(f"sequence length {off + l} exceeds max_len "
                             f"{self.max_len}")
        if table is None:
            table = self.tok_emb.weight.to(self.dtype)
        return self._embed(input_ids, table) + self.pos_emb.weight[
            off:off + l].to(self.dtype)

    def stage(self, x: torch.Tensor):
        """This module's blocks (a pipeline stage's, JAX ``mode="stage"``):
        ``(x, summed MoE aux loss or None)``."""
        return run_stack(self.blocks, x, self.remat)

    def logits(self, x: torch.Tensor,
               table: torch.Tensor | None = None) -> torch.Tensor:
        """``ln_f`` and the tied LM head, logits = x @ tok_emb^T (the local
        vocab slice under tensor parallelism): the last pipeline stage's
        part (JAX ``mode="head"``).  Under a pipe axis the first and the
        last stage each hold the table, and its gradient is the sum of
        their two contributions."""
        if table is None:
            table = self.tok_emb.weight.to(self.dtype)
        return copy_to_tp_region(layer_norm(x, self.ln_f, self.dtype),
                                 self.tp) @ table.t()

    def activation_shape(self, x: torch.Tensor) -> tuple:
        """The shape of the activation between two blocks for input
        ``x`` (what a pipeline stage receives)."""
        return (*x.shape[:2], self.pos_emb.embedding_dim)

    def _embed(self, input_ids: torch.Tensor, table: torch.Tensor
               ) -> torch.Tensor:
        """Token lookup; under tensor parallelism this rank holds vocab rows
        [t*V/tp, (t+1)*V/tp): the masked local lookups sum to the full
        embedding over ``model`` (JAX ``gpt.py:211-226``), and each rank's
        table gradient stays its local scatter-add."""
        if self.tp is None or self.tp.world_size == 1:
            return F.embedding(input_ids, table)
        v_local = table.shape[0]
        loc = input_ids - self.tp.rank * v_local
        hit = (loc >= 0) & (loc < v_local)
        tok = F.embedding(loc.clamp(0, v_local - 1), table)
        tok = torch.where(hit[..., None], tok, torch.zeros_like(tok))
        return reduce_from_tp_region(tok, self.tp)
