"""Two-layer MLP (port of the JAX package's ``models/mlp.py:18-31``): flat
[B, D] or image [B, H, W, C] inputs, flattened in NHWC order, -> dense
``hidden`` -> ReLU -> dense classes (fp32).  No BatchNorm.  The first
layer's width is the product of ``input_shape`` (flax infers it)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .bert import dense
from .cnn import init_image_model, xavier_uniform_


class MLP(nn.Module):
    def __init__(self, num_classes: int = 10, hidden: int = 256,
                 input_shape: tuple = (28, 28, 1), *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(math.prod(input_shape), hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, num_classes, device=device)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_image_model(self, generator, xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.relu(dense(x, self.Dense_0, self.dtype))
        return dense(x, self.Dense_1, torch.float32)
