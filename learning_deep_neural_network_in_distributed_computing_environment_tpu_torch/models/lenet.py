"""LeNet-5 (port of the JAX package's ``models/lenet.py:34-102``): conv
6@5x5 (SAME) -> tanh -> 2x2 average pool -> conv 16@5x5 (VALID) -> tanh ->
2x2 average pool -> dense 120 -> 84 -> classes, tanh activations.

The JAX package writes its two convs as im2col matmuls (a TPU choice); the
same kernel and bias make them a plain conv, which is what runs here.  The
parameter names stay flax's (``ConvIm2Col_0``, ``Dense_0``, ...).  Inputs
are NHWC; the activations are flattened in NHWC order before the first
dense layer, as the JAX model flattens them, so transplanted dense kernels
compute the same function.  flax infers the input channels and the
flattened width from the first input; here they follow from
``input_shape`` (H, W, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bert import dense
from .cnn import conv, init_image_model, xavier_uniform_


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10,
                 input_shape: tuple = (28, 28, 1), *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        h, w, c = input_shape
        # SAME is symmetric k // 2 = 2 for the 5x5 kernel, VALID is none;
        # each pool halves: h -> h / 2 -> h / 2 - 4 -> (h / 2 - 4) / 2
        self.ConvIm2Col_0 = nn.Conv2d(c, 6, 5, padding=2, device=device)
        self.ConvIm2Col_1 = nn.Conv2d(6, 16, 5, padding=0, device=device)
        flat = 16 * ((h // 2 - 4) // 2) * ((w // 2 - 4) // 2)
        self.Dense_0 = nn.Linear(flat, 120, device=device)
        self.Dense_1 = nn.Linear(120, 84, device=device)
        self.Dense_2 = nn.Linear(84, num_classes, device=device)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_image_model(self, generator, xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.avg_pool2d(torch.tanh(conv(x, self.ConvIm2Col_0, self.dtype)),
                         2)
        x = F.avg_pool2d(torch.tanh(conv(x, self.ConvIm2Col_1, self.dtype)),
                         2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = torch.tanh(dense(x, self.Dense_0, self.dtype))
        x = torch.tanh(dense(x, self.Dense_1, self.dtype))
        return dense(x, self.Dense_2, torch.float32)
