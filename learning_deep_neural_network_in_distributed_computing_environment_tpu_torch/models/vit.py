"""Vision Transformer (port of the JAX package's ``models/vit.py:31-154``):
non-overlapping patches -> one dense product -> learned position table ->
the post-LN ``EncoderLayer`` stack shared with BERT -> mean-pool over
patches -> an fp32 classifier.  No class token: at 224x224 with 16x16
patches the sequence is 196, not a multiple of the flash kernels' 64-row
tiles, so ViT runs them on a ragged tail.

ViT-S/16 defaults: 12 layers, hidden 384, 6 heads, FFN 1536.

The patch embedding is the flax kernel [p*p*c, H] read in its (p, q, c)
order against the patch view of the [B, H, W, C] image
(``models/vit.py:31-54``); it is held here as an ``nn.Linear`` with the
transposed [H, p*p*c] weight.

Under tensor parallelism (``tp``, the rank's ``model`` line) the encoder
blocks hold their head and FFN shards, as JAX's ViT wires BERT's
``EncoderLayer``; the patch embedding, the position table and the
classifier stay replicated, so the logits are whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bert import EncoderLayer, dense, init_flax, run_stack
from .remat import Remat


class ViT(nn.Module):
    """Images [B, H, W, C] -> class logits [B, num_classes] in fp32;
    ``forward(x, with_aux=True)`` also returns the summed MoE load-balance
    loss (None without experts)."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 num_layers: int = 12, hidden: int = 384, num_heads: int = 6,
                 ffn_dim: int = 1536, *, input_shape=(224, 224, 3),
                 num_experts: int = 0, capacity_factor: float = 1.25,
                 remat_policy: str = "none",
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", tp=None, ep=None,
                 device=None):
        super().__init__()
        h, w, c = input_shape
        if h % patch or w % patch:
            raise ValueError(f"input {h}x{w} not divisible by patch {patch}")
        self.num_classes = num_classes
        self.num_experts = num_experts
        self.patch = patch
        self.dtype = dtype
        self.tp = tp
        self.remat = Remat(remat_policy)
        n = (h // patch) * (w // patch)
        self.patch_embed = nn.Linear(patch * patch * c, hidden, device=device)
        self.pos_emb = nn.Parameter(torch.empty(1, n, hidden, device=device))
        self.blocks = nn.ModuleList(
            EncoderLayer(hidden, num_heads, ffn_dim, num_experts=num_experts,
                         capacity_factor=capacity_factor, dtype=dtype,
                         attention_impl=attention_impl, tp=tp, ep=ep,
                         device=device)
            for _ in range(num_layers))
        # this rank's heads and their width (the weight conversion's)
        self.num_heads = self.blocks[0].attn.num_heads
        self.head_dim = hidden // num_heads
        self.head = nn.Linear(hidden, num_classes, device=device)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_flax(self, generator)

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        x, aux = self.stage(self.embed(x))
        logits = self.logits(x)
        return (logits, aux) if with_aux else logits

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Patchify, the patch product and the position table: the first
        pipeline stage's part (JAX ``mode="embed"``)."""
        b, h, w, c = x.shape
        p = self.patch
        # [B, h/p, p, w/p, p, c] -> [B, N, (p, q, c)]
        patches = (x.to(self.dtype).reshape(b, h // p, p, w // p, p, c)
                   .permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, (h // p) * (w // p), p * p * c))
        x = dense(patches, self.patch_embed, self.dtype)
        return x + self.pos_emb.to(self.dtype)

    def stage(self, x: torch.Tensor):
        """This module's blocks (a pipeline stage's, JAX ``mode="stage"``):
        ``(x, summed MoE aux loss or None)``."""
        return run_stack(self.blocks, x, self.remat)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Mean-pool over patches and the fp32 classifier: the last
        pipeline stage's part (JAX ``mode="head"``)."""
        return F.linear(x.mean(1).float(), self.head.weight, self.head.bias)

    def activation_shape(self, x: torch.Tensor) -> tuple:
        """The shape of the activation between two blocks for images
        ``x`` [B, H, W, C] (what a pipeline stage receives)."""
        b, h, w, _c = x.shape
        return (b, (h // self.patch) * (w // self.patch),
                self.patch_embed.out_features)
