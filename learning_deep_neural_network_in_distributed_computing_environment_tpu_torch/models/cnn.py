"""The reference's flagship model, ``EnhancedCNNModel`` (port of the JAX
package's ``models/cnn.py:34-100``): a ResNet-style CNN for 32x32x3 -> 10
classes.  Prep conv 3->w + BN + ReLU; four stages of two residual blocks
(w -> 2w -> 4w -> 8w -> 16w, the first block of each stage stride 2 with a
1x1-conv + BN shortcut); global average pool; FC 16w -> classes.  At the
reference width w=64 it has 44,595,786 parameters.

Inputs are NHWC, as in the JAX package; the forward permutes them to an
NCHW view, which for a contiguous NHWC tensor has ``channels_last``
strides, so with the module in ``channels_last`` (``driver.build_model_for``)
cuDNN runs every conv without a layout transpose.  Conv weights are
[cout, cin, kh, kw] (flax: [kh, kw, cin, cout]; ``weights.py`` converts).

Compute dtype as in flax's ``dtype=``: each conv casts its input and
weight, BatchNorm outputs follow (``models/norm.py``), the residual add and
the global average pool run in it, and the FC runs in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype
         ) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (flax ``Conv(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    stride = layer.stride
    if x.device.type == "cpu" and layer.kernel_size == (1, 1) \
            and stride != (1, 1):
        # the same products: a strided 1x1 conv is the 1x1 conv of the
        # subsampled input.  On the CPU, oneDNN's weight gradient of the
        # strided form corrupts the heap at some shapes (torch 2.13, e.g.
        # [4, 8, 32, 32] channels_last input, 16 outputs, stride 2)
        x, stride = x[:, :, ::stride[0], ::stride[1]], 1
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, stride,
                    layer.padding)


def conv2d(cin: int, cout: int, k: int, stride: int = 1, *, device=None
           ) -> nn.Conv2d:
    """A bias-free k x k conv with flax's symmetric ``k // 2`` padding."""
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False, device=device)


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``xavier_uniform`` (``variance_scaling(1, fan_avg, uniform)``):
    U(-a, a) with a = sqrt(6 / (fan_in + fan_out)), receptive field
    included; ``w`` is [out, in, ...] here."""
    field = math.prod(w.shape[2:])
    a = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * field))
    w.uniform_(-a, a, generator=generator)


@torch.no_grad()
def he_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``he_normal`` (``variance_scaling(2, fan_in,
    truncated_normal)``): a normal truncated at two standard deviations,
    rescaled so its standard deviation is sqrt(2 / fan_in)."""
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    # .87962566103423978 is the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def init_image_model(model: nn.Module, generator: torch.Generator,
                     kernel_init) -> None:
    """``kernel_init`` for every conv and dense kernel, zero biases, BN
    scale 1 / bias 0 and statistics mean 0 / var 1."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            kernel_init(module.weight, generator)
            if module.bias is not None:
                with torch.no_grad():
                    module.bias.zero_()
        elif isinstance(module, BatchNorm):
            module.reset_parameters()


class ResBlock(nn.Module):
    """conv3x3(s)-BN-ReLU-conv3x3-BN + shortcut, ReLU; the shortcut is a
    1x1 conv + BN when the stride or the width changes."""

    def __init__(self, cin: int, features: int, stride: int = 1, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv2d(cin, features, 3, stride, device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = conv2d(features, features, 3, device=device)
        self.bn2 = BatchNorm(features, device=device)
        self.has_shortcut = stride != 1 or cin != features
        if self.has_shortcut:
            self.shortcut_conv = conv2d(cin, features, 1, stride,
                                        device=device)
            self.shortcut_bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        out = self.bn2(conv(out, self.conv2, self.dtype))
        sc = (self.shortcut_bn(conv(x, self.shortcut_conv, self.dtype))
              if self.has_shortcut else x)
        return F.relu(out + sc.to(out.dtype))


class EnhancedCNNModel(nn.Module):
    """Images [B, 32, 32, 3] (NHWC) -> logits [B, classes] in fp32."""

    def __init__(self, num_classes: int = 10, width: int = 64, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        w = width
        self.prep_conv = conv2d(3, w, 3, device=device)
        self.prep_bn = BatchNorm(w, device=device)
        cin = w
        for i, feats in enumerate((2 * w, 4 * w, 8 * w, 16 * w)):
            setattr(self, f"layer{i + 1}_block0",
                    ResBlock(cin, feats, 2, dtype=dtype, device=device))
            setattr(self, f"layer{i + 1}_block1",
                    ResBlock(feats, feats, 1, dtype=dtype, device=device))
            cin = feats
        self.fc = nn.Linear(cin, num_classes, device=device)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform conv and FC kernels, zero FC bias (the
        reference's ``main.py:33-37``)."""
        init_image_model(self, generator, xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.prep_bn(conv(x, self.prep_conv, self.dtype)))
        for i in range(1, 5):
            for j in range(2):
                x = getattr(self, f"layer{i}_block{j}")(x)
        x = x.mean((2, 3))                   # global average pool
        return F.linear(x.float(), self.fc.weight, self.fc.bias)
