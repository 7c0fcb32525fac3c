"""BERT masked-LM and the pieces the transformer families share (port of
the JAX package's ``models/bert.py:36-383``): ``SelfAttention``, the
post-LN ``EncoderLayer`` (BERT and ViT), ``BertForMLM`` and ``run_stack``,
which applies a stack of blocks under the ``--remat_policy`` and sums the
MoE load-balance losses they return.

BERT-base defaults: 12 layers, hidden 768, 12 heads, FFN 3072, position
table 512.  The model takes no attention mask, as the JAX model is called
without one: its attention is the full bidirectional kernel.

Compute-dtype semantics mirror flax's ``dtype=``: parameters stay fp32 and
each dense op casts its input, weight and bias to the compute dtype
(``dense`` below), so a bf16 run does its products in bf16 exactly where
the JAX package does.

Tensor parallelism (``tp``: the rank's ``model`` line, a ``mesh.Group``;
JAX ``bert.py:56-164, 312-368``): each module holds its shard, the local
H/T heads (and K/V heads) of the attention, the F/T columns then rows of
the FFN and the V/T vocabulary rows of the MLM decode, between the Megatron
markers of ``parallel/tp.py``; the model's output is then its LOCAL vocab
slice and the loss goes through ``tp.vocab_parallel_token_stats``.
``tp_param_specs`` names the dimension of each parameter leaf, in the JAX
package's layout, that the ``model`` axis shards.

Expert parallelism (``ep``: the rank's ``expert`` line): each MoE layer
holds its rank's experts (``models/moe.py``); everything else is
replicated along the line.

Sequence parallelism (``sp``: the rank's ``seq`` line; JAX ``bert.py:91-95,
324-328``): the model reads its chunk of every sequence, so the learned
positions and the RoPE angles start at ``seq_offset``, and the attention
(``attention_impl`` ring, ring_zigzag or all_to_all) runs over the line.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tp import copy_to_tp_region, reduce_from_tp_region
from .remat import Remat, checkpoint_name

INIT_STD = 0.02
LN_EPS = 1e-12


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
                 dtype: torch.dtype = torch.float32, tp=None, sp=None,
                 device=None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by num_heads "
                             f"{num_heads}")
        t = tp_size(tp)
        if num_heads % t:
            raise ValueError(
                f"num_heads {num_heads} not divisible by tp_size {t} "
                "(head-sharded tensor parallelism)")
        self.tp = tp
        self.sp = sp
        self.head_dim = hidden // num_heads
        # falsy num_kv_heads (None or the config's 0 sentinel) means MHA
        self.gqa = bool(num_kv_heads) and num_kv_heads != num_heads
        if self.gqa and num_heads % num_kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        if self.gqa and num_kv_heads % t:
            raise ValueError(f"num_kv_heads {num_kv_heads} not divisible by "
                             f"tp_size {t}")
        # this rank's heads (all of them without tensor parallelism)
        self.num_heads = num_heads // t
        self.num_kv_heads = (num_kv_heads if self.gqa else num_heads) // t
        self.causal = causal
        self.rope_theta = rope_theta
        self.attention_impl = attention_impl
        self.dtype = dtype
        inner = self.num_heads * self.head_dim
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
        x = copy_to_tp_region(x, self.tp)
        if self.gqa:
            q = dense(x, self.q, self.dtype).view(b, l, h, dh)
            k, v = dense(x, self.kv, self.dtype).view(b, l, 2, kv, dh).unbind(2)
        else:
            q, k, v = dense(x, self.qkv, self.dtype).view(
                b, l, 3, h, dh).unbind(2)
        if self.rope_theta is not None:
            # under sequence parallelism this rank holds chunk
            # ``sp.rank``: rotated keys travel the ring position-encoded
            pos = torch.arange(l, device=x.device) + seq_offset(self.sp, l)
            q = rope(q, pos, self.rope_theta)
            k = rope(k, pos, self.rope_theta)
        # q/k/v stay strided views of the projection output (q/k are new
        # tensors under RoPE); the flash kernels read them through their
        # strides
        out = attend(q, k, v, mask=mask, impl=self.attention_impl,
                     group=self.sp, causal=self.causal)
        y = reduce_from_tp_region(
            dense(out.reshape(b, l, h * dh), self.out, self.dtype), self.tp)
        if self.out_bias is None:
            return y
        return y + self.out_bias.to(self.dtype)


def seq_offset(sp, l: int) -> int:
    """The global position of this rank's first token: chunk ``sp.rank``
    of length ``l`` on the rank's ``seq`` line (None: 0)."""
    return 0 if sp is None else sp.rank * l


def tp_size(tp) -> int:
    """The ``model`` axis size of ``tp`` (a ``mesh.Group``; None: 1)."""
    return 1 if tp is None else tp.world_size


def tp_local(n: int, tp, what: str) -> int:
    """``n`` units split over ``tp``: this rank's count."""
    t = tp_size(tp)
    if n % t:
        raise ValueError(f"{what} {n} not divisible by tp_size {t}")
    return n // t


def run_stack(blocks, x: torch.Tensor, remat: Remat):
    """Apply ``blocks`` in order, each under ``remat``; every block returns
    ``(x, aux)`` with ``aux`` its MoE load-balance loss or None.  Returns
    ``(x, sum of the aux losses or None)``: the aux losses are outputs of
    the block calls, so a recomputed forward never adds them again."""
    aux = None
    for block in blocks:
        x, a = remat(block, x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


@torch.no_grad()
def init_flax(model: nn.Module, generator: torch.Generator) -> None:
    """The flax initializers of the BERT, GPT and ViT families: N(0, 0.02)
    for every dense kernel, embedding, position table, MoE gate and expert
    kernel, zeros for biases, ones/zeros for LayerNorm, each drawn once
    from ``generator`` (on the parameters' device)."""
    from .moe import MoEFFN
    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, INIT_STD, generator=generator)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, MoEFFN):
            module.init_parameters(generator)
    if isinstance(getattr(model, "pos_emb", None), nn.Parameter):  # ViT
        model.pos_emb.normal_(0.0, INIT_STD, generator=generator)
    for module in model.modules():
        for name in ("ffn_bias", "out_bias"):
            p = getattr(module, name, None)
            if isinstance(p, nn.Parameter):
                p.zero_()


class EncoderLayer(nn.Module):
    """Post-LN encoder block (original BERT): ``h = LN(x + attn(x))``, then
    ``LN(h + ffn(h))`` with an exact-GELU FFN whose output bias is added
    after ``ffn_out``, or a Switch-MoE FFN (``num_experts > 0``).  Both
    LayerNorms take eps 1e-12 and give the compute dtype.  Returns ``(y,
    aux)``: aux is the MoE layer's load-balance loss, or None."""

    def __init__(self, hidden: int, num_heads: int, ffn_dim: int, *,
                 num_experts: int = 0, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "dense", tp=None, sp=None, ep=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.tp = tp
        self.attn = SelfAttention(hidden, num_heads,
                                  attention_impl=attention_impl, dtype=dtype,
                                  tp=tp, sp=sp, device=device)
        self.ln_attn = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
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
        self.ln_ffn = nn.LayerNorm(hidden, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor):
        a = checkpoint_name(self.attn(x), "attn_out")
        x = layer_norm(x + a, self.ln_attn, self.dtype)
        aux = None
        if hasattr(self, "moe"):
            f, aux = self.moe(x)
        else:
            f = F.gelu(dense(copy_to_tp_region(x, self.tp), self.ffn_in,
                             self.dtype), approximate="none")
            f = reduce_from_tp_region(dense(f, self.ffn_out, self.dtype),
                                      self.tp) + self.ffn_bias.to(self.dtype)
        f = checkpoint_name(f, "mlp_out")
        y = layer_norm(x + f, self.ln_ffn, self.dtype)
        return checkpoint_name(y, "block_out"), aux


class BertForMLM(nn.Module):
    """Token ids [B, L] -> MLM logits [B, L, vocab] in the compute dtype.

    Embeddings (token + learned position) and ``ln_emb`` run in fp32 and
    the result is cast to the compute dtype (``models/bert.py:331-332``);
    the untied MLM head (dense -> exact GELU -> LayerNorm -> decoder) runs
    in the compute dtype.  ``forward(ids, with_aux=True)`` also returns
    the summed MoE load-balance loss (None without experts)."""

    def __init__(self, num_classes: int = 30522, num_layers: int = 12,
                 hidden: int = 768, num_heads: int = 12, ffn_dim: int = 3072,
                 max_len: int = 512, *, num_experts: int = 0,
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
        v_local = tp_local(num_classes, tp,
                           "vocab size (vocab-parallel MLM head)")
        self.tok_emb = nn.Embedding(num_classes, hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, hidden, device=device)
        self.ln_emb = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.blocks = nn.ModuleList(
            EncoderLayer(hidden, num_heads, ffn_dim, num_experts=num_experts,
                         capacity_factor=capacity_factor, dtype=dtype,
                         attention_impl=attention_impl, tp=tp, sp=sp,
                         ep=ep, device=device)
            for _ in range(num_layers))
        # this rank's heads and their width (the weight conversion's)
        self.num_heads = self.blocks[0].attn.num_heads
        self.head_dim = hidden // num_heads
        self.mlm_dense = nn.Linear(hidden, hidden, device=device)
        self.mlm_ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.mlm_decoder = nn.Linear(hidden, v_local, device=device)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_flax(self, generator)

    def forward(self, input_ids: torch.Tensor, with_aux: bool = False):
        x, aux = self.stage(self.embed(input_ids))
        logits = self.logits(x)
        return (logits, aux) if with_aux else logits

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token + position embeddings and ``ln_emb``: the first pipeline
        stage's part (JAX ``mode="embed"``)."""
        l = input_ids.shape[1]
        off = seq_offset(self.sp, l)
        if off + l > self.max_len:
            raise ValueError(f"sequence length {off + l} exceeds max_len "
                             f"{self.max_len}")
        x = self.tok_emb(input_ids) + self.pos_emb.weight[off:off + l]
        return F.layer_norm(x, self.ln_emb.normalized_shape,
                            self.ln_emb.weight, self.ln_emb.bias,
                            LN_EPS).to(self.dtype)

    def stage(self, x: torch.Tensor):
        """This module's blocks (a pipeline stage's, JAX ``mode="stage"``):
        ``(x, summed MoE aux loss or None)``."""
        return run_stack(self.blocks, x, self.remat)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The MLM decode: the last pipeline stage's part (JAX
        ``mode="head"``)."""
        x = F.gelu(dense(x, self.mlm_dense, self.dtype), approximate="none")
        x = copy_to_tp_region(layer_norm(x, self.mlm_ln, self.dtype),
                              self.tp)
        return dense(x, self.mlm_decoder, self.dtype)

    def activation_shape(self, x: torch.Tensor) -> tuple:
        """The shape of the activation between two blocks for input
        ``x`` (what a pipeline stage receives)."""
        return (*x.shape[:2], self.ln_emb.normalized_shape[0])


def _tp_parts(names: list, ndim: int, axis: str,
              shard_tok_emb: bool = False) -> list:
    """The Megatron sharding of one leaf (JAX ``bert.py:386-440``), as one
    entry per dimension of the UNSTACKED leaf in the JAX layout: qkv
    kernel [H, 3, heads, hd] / bias [3, heads, hd] on heads; the GQA q
    [H, heads, hd] and kv [H, 2, kv, hd] on heads; attn out kernel
    [heads, hd, H] and ffn_out kernel [F, H] on dim 0 (row-parallel);
    ffn_in / ffn_up kernel [H, F] / bias [F] on F (column-parallel); the
    MLM decode and the Llama head kernel [H, V] / bias [V] on V; GPT's tied
    table [V, H] on V with ``shard_tok_emb``; the MoE expert stacks per
    expert on F: w1 [E, H, F] and b1 [E, F] column-parallel, w2 [E, F, H]
    row-parallel (the gate and b2 replicated; ``moe.with_expert_overlay``
    puts the leading E dimension on ``expert``); everything else
    replicated."""
    parts = [None] * ndim
    if "moe" in names:
        if "w1" in names and ndim == 3:
            parts[2] = axis
        elif "b1" in names and ndim == 2:
            parts[1] = axis
        elif "w2" in names and ndim == 3:
            parts[1] = axis
        return parts
    if "qkv" in names:
        parts[2 if ndim == 4 else 1] = axis
    elif "q" in names:
        parts[1 if ndim == 3 else 0] = axis
    elif "kv" in names:
        parts[2 if ndim == 4 else 1] = axis
    elif "out" in names and ndim == 3:
        parts[0] = axis
    elif "ffn_in" in names or "ffn_up" in names:
        parts[1 if ndim == 2 else 0] = axis
    elif "ffn_out" in names and ndim == 2:
        parts[0] = axis
    elif "mlm_decoder" in names or "lm_head" in names:
        parts[1 if ndim == 2 else 0] = axis
    elif shard_tok_emb and "tok_emb" in names and ndim == 2:
        parts[0] = axis
    return parts


def tp_param_specs(shapes: dict, axis: str = "model", *,
                   shard_tok_emb: bool = False) -> dict:
    """{leaf key: spec} of the Megatron sharding over ``axis`` for the
    ``params`` leaves of a transformer in the JAX layout (``shapes``:
    ``weights.param_leaf_shapes``, keys like ``['layers']['layer']['attn']
    ['qkv']['kernel']``); a spec has one axis name or None per dimension.
    The stacked ``layers`` leaves lead with the [num_layers] dimension,
    which ``model`` leaves alone (JAX ``tp_param_specs``)."""
    out = {}
    for key, shape in shapes.items():
        names = re.findall(r"\['([^']*)'\]", key)
        if "layers" in names:
            out[key] = (None, *_tp_parts(names, len(shape) - 1, axis))
        else:
            out[key] = tuple(_tp_parts(names, len(shape), axis,
                                       shard_tok_emb=shard_tok_emb))
    return out


def pp_tp_param_specs(shapes: dict, *, pipe_axis: str = "pipe",
                      axis: str = "model", shard_tok_emb: bool = False
                      ) -> dict:
    """{leaf key: spec} under both pipeline and tensor parallelism (JAX
    ``pp_tp_param_specs``, shared by llama): the stacked ``layers`` leaves
    shard their leading (layer) dimension over ``pipe_axis`` and their
    inner dimensions by the Megatron pattern; the leaves outside the stack
    take the plain tensor-parallel specs."""
    out = tp_param_specs(shapes, axis, shard_tok_emb=shard_tok_emb)
    for key, spec in out.items():
        if "layers" in re.findall(r"\['([^']*)'\]", key):
            out[key] = (pipe_axis, *spec[1:])
    return out
