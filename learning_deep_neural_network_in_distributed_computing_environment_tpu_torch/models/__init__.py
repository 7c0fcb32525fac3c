"""Model zoo of the port (JAX package: ``models/__init__.py:13-168``).

Every registry name of the JAX package: the CNN ladder (``enhanced_cnn``,
the reference's model; ``mlp``, ``lenet5``, ``resnet18``, ``resnet50``) and
the transformer families (BERT MLM, GPT-2, Llama, ViT), each of the latter
with an optional Switch-MoE FFN (``num_experts``) and a ``remat_policy``.
"""

from __future__ import annotations

from typing import Any

MODEL_INPUT_SPECS = {
    # name -> (example input shape without batch, num_classes or vocab)
    "enhanced_cnn": ((32, 32, 3), 10),
    "mlp": ((28, 28, 1), 10),
    "lenet5": ((28, 28, 1), 10),
    "resnet18": ((32, 32, 3), 10),
    "resnet50": ((224, 224, 3), 1000),
    "bert_base": ((128,), 30522),
    "bert_tiny": ((128,), 30522),
    "gpt2_small": ((128,), 50257),
    "gpt_small": ((128,), 50257),
    "gpt_tiny": ((128,), 50257),
    "llama_medium": ((1024,), 32000),
    "llama_tiny": ((128,), 32000),
    "vit_s16": ((224, 224, 3), 1000),
    "vit_b16": ((224, 224, 3), 1000),
    "vit_tiny": ((32, 32, 3), 10),
}

# sizes of the GPT-2 family (the JAX registry's defaults)
_GPT_SIZES = {
    "gpt2_small": {},
    "gpt_small": dict(num_layers=4, hidden=128, num_heads=4, ffn_dim=256),
    "gpt_tiny": dict(num_layers=2, hidden=64, num_heads=4, ffn_dim=128),
}
# sizes of the Llama family (the JAX registry's defaults)
_LLAMA_SIZES = {
    "llama_medium": {},
    "llama_tiny": dict(num_layers=2, hidden=64, num_heads=4, ffn_dim=176),
}
# sizes of the BERT family (the JAX registry's defaults)
_BERT_SIZES = {
    "bert_base": {},
    "bert_tiny": dict(num_layers=2, hidden=64, num_heads=4, ffn_dim=128),
}
# sizes of the ViT family (the JAX registry's defaults)
_VIT_SIZES = {
    "vit_s16": {},
    "vit_b16": dict(hidden=768, num_heads=12, ffn_dim=3072),
    "vit_tiny": dict(patch=8, num_layers=2, hidden=64, num_heads=4,
                     ffn_dim=128),
}

# image models that infer their first layer (or ViT's position table) from
# the input shape in flax (here: ``input_shape=(H, W, C)``)
SHAPED_BY_INPUT = ("mlp", "lenet5", *_VIT_SIZES)

# The named-activation vocabulary of the transformer blocks (JAX
# ``models/__init__.py:137-150``): the ``checkpoint_name`` labels a
# ``--remat_policy save_names:<set>`` / ``offload_names:<set>`` selects from
# (``models/remat.py``):
# - ``attn_out``: the attention sublayer's output [B, L, H];
# - ``mlp_out``: the FFN / MoE sublayer's output [B, L, H];
# - ``block_out``: the block's output (the layer boundary);
# - ``moe_dispatch``: the MoE dispatch product's expert-batched tokens
#   [E, C, H], emitted only with ``num_experts > 0``.
REMAT_NAMES = ("attn_out", "mlp_out", "block_out", "moe_dispatch")


def is_attention_model(name: str) -> bool:
    """Transformer families: they take ``attention_impl``; the CNNs do
    not (the JAX package's ``models/__init__.py:98``)."""
    return name.lower().startswith(("bert", "gpt", "llama", "vit"))


def is_token_model(name: str) -> bool:
    """Models whose input is a token-id sequence [B, L], the shape
    sequence parallelism shards (the JAX package's
    ``models/__init__.py:114``); ViT takes images."""
    return name.lower().startswith(("bert", "gpt", "llama"))


def remat_name_vocab(name: str, num_experts: int = 0) -> tuple[str, ...]:
    """The ``checkpoint_name`` labels the ``name`` family's blocks emit:
    none for the CNN/MLP families, ``moe_dispatch`` only with experts."""
    if not is_attention_model(name):
        return ()
    base = REMAT_NAMES[:3]
    return base + REMAT_NAMES[3:] if num_experts > 0 else base


def num_layers_of(name: str) -> int:
    """The block count of a transformer of the registry (the stacked
    ``layers`` axis a pipe axis cuts into stages)."""
    return len(get_model(name, device="meta").blocks)


def ffn_dim_of(name: str) -> int:
    """The FFN width of a transformer of the registry (each MoE expert's
    F, which the ``model`` axis splits)."""
    return get_model(name, device="meta").blocks[0].ffn_in.out_features


def get_model(name: str, **kw: Any):
    """Build a torch module by registry name."""
    name = name.lower()
    if name not in MODEL_INPUT_SPECS:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_INPUT_SPECS)}")
    if name in SHAPED_BY_INPUT and "input_shape" not in kw:
        kw["input_shape"] = MODEL_INPUT_SPECS[name][0]
    if name == "enhanced_cnn":
        from .cnn import EnhancedCNNModel
        return EnhancedCNNModel(**kw)
    if name == "mlp":
        from .mlp import MLP
        return MLP(**kw)
    if name == "lenet5":
        from .lenet import LeNet5
        return LeNet5(**kw)
    if name in ("resnet18", "resnet50"):
        from . import resnet
        return (resnet.ResNet18 if name == "resnet18" else resnet.ResNet50)(
            **kw)
    if name in _GPT_SIZES:
        from .gpt import GPTForCausalLM
        return GPTForCausalLM(**{**_GPT_SIZES[name], **kw})
    if name in _LLAMA_SIZES:
        from .llama import LlamaForCausalLM
        return LlamaForCausalLM(**{**_LLAMA_SIZES[name], **kw})
    if name in _BERT_SIZES:
        from .bert import BertForMLM
        return BertForMLM(**{**_BERT_SIZES[name], **kw})
    from .vit import ViT
    return ViT(**{**_VIT_SIZES[name], **kw})
