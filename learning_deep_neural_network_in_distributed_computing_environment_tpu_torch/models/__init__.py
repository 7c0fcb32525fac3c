"""Model zoo of the port (JAX package: ``models/__init__.py:13-168``).

Ported so far: the GPT-2 and Llama families.  Every other registry name
of the JAX package is known here and raises "not yet ported" with the
ROADMAP item that ports it.
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


def get_model(name: str, **kw: Any):
    """Build a torch module by registry name."""
    name = name.lower()
    if name not in MODEL_INPUT_SPECS:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_INPUT_SPECS)}")
    if name in _GPT_SIZES:
        from .gpt import GPTForCausalLM
        return GPTForCausalLM(**{**_GPT_SIZES[name], **kw})
    if name in _LLAMA_SIZES:
        from .llama import LlamaForCausalLM
        return LlamaForCausalLM(**{**_LLAMA_SIZES[name], **kw})
    where = ("A.2 (CNN main path)" if name in (
        "enhanced_cnn", "mlp", "lenet5", "resnet18", "resnet50")
        else "A.7 (transformer families)")
    raise NotImplementedError(
        f"model {name!r} is not yet ported to the PyTorch package; it "
        f"arrives with ROADMAP queue {where}")
