"""GPT-2-style causal language model (port of the JAX package's
``models/gpt.py:37-245``): pre-LN blocks, learned position embeddings,
tanh-GELU FFN and a tied LM head (logits = hidden @ tok_emb^T);
``gpt2_small`` has the canonical 124,439,808 parameters.

Parameters are fp32; ``dtype`` is the compute dtype, applied per op as in
flax (``models/bert.py::dense`` / ``layer_norm``), and the logits come out
in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bert import SelfAttention, dense, layer_norm

INIT_STD = 0.02


class GPTBlock(nn.Module):
    """Pre-LN decoder block: x + attn(ln1(x)); x + ffn(ln2(x))."""

    def __init__(self, hidden: int, num_heads: int, ffn_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", device=None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5, device=device)
        self.attn = SelfAttention(hidden, num_heads, causal=True,
                                  attention_impl=attention_impl, dtype=dtype,
                                  device=device)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-5, device=device)
        self.ffn_in = nn.Linear(hidden, ffn_dim, device=device)
        self.ffn_out = nn.Linear(ffn_dim, hidden, bias=False, device=device)
        self.ffn_bias = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln1, self.dtype))
        f = dense(layer_norm(x, self.ln2, self.dtype), self.ffn_in,
                  self.dtype)
        f = dense(F.gelu(f, approximate="tanh"), self.ffn_out, self.dtype)
        return x + (f + self.ffn_bias.to(self.dtype))


class GPTForCausalLM(nn.Module):
    """Token ids [B, L] -> next-token logits [B, L, vocab] in the compute
    dtype.  Labels come shifted from the data pipeline
    (``data/sources.py::_lm_synthetic``)."""

    def __init__(self, num_classes: int = 50257, num_layers: int = 12,
                 hidden: int = 768, num_heads: int = 12, ffn_dim: int = 3072,
                 max_len: int = 1024, *, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_heads = num_heads
        self.max_len = max_len
        self.dtype = dtype
        self.tok_emb = nn.Embedding(num_classes, hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, hidden, device=device)
        self.blocks = nn.ModuleList(
            GPTBlock(hidden, num_heads, ffn_dim, dtype=dtype,
                     attention_impl=attention_impl, device=device)
            for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(hidden, eps=1e-5, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The flax initializers: N(0, 0.02) for every dense kernel and
        embedding, zeros for biases, ones/zeros for LayerNorm, drawn from
        ``generator`` (on the parameters' device)."""
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, INIT_STD, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, (GPTBlock, SelfAttention)):
                for name in ("ffn_bias", "out_bias"):
                    p = getattr(module, name, None)
                    if p is not None:
                        p.zero_()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        l = input_ids.shape[1]
        if l > self.max_len:
            raise ValueError(f"sequence length {l} exceeds max_len "
                             f"{self.max_len}")
        table = self.tok_emb.weight.to(self.dtype)
        x = F.embedding(input_ids, table) + self.pos_emb.weight[:l].to(
            self.dtype)
        for block in self.blocks:
            x = block(x)
        # tied LM head: logits = x @ tok_emb^T
        return layer_norm(x, self.ln_f, self.dtype) @ table.t()
