"""PyTorch/CUDA port of the local-SGD distributed training framework.

The JAX package ``learning_deep_neural_network_in_distributed_computing_environment_tpu``
is the reference; this package re-implements it slice by slice for an
NVIDIA H100 and imports nothing from it (it keeps its own copies of the
numpy-only modules it needs).

Ported so far: the local-SGD trainer on one worker or N worker processes
(``main.py`` -> ``config_from_args`` -> ``driver.train_global``) with the
paper's 12 sync modes, every model of the JAX registry (the CNN ladder;
GPT-2, Llama, BERT MLM and ViT, each with an optional Switch-MoE FFN,
per-block remat and gradient accumulation), and hand-written Hopper
flash-attention kernels for ``--attention_impl flash`` (``ops/flash.py``,
sources under ``csrc/``).

Entry points run on CUDA unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``); on the CPU every kernel wrapper
computes its plain PyTorch version instead.
"""
