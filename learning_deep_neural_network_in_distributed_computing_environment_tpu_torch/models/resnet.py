"""ResNet-18/50 (port of the JAX package's ``models/resnet.py:19-113``):
He-initialised ResNet v1 with a ``cifar`` stem (3x3 conv, no max-pool) or
an ``imagenet`` stem (7x7/2 conv + 3x3/2 max-pool with padding 1).

NHWC inputs, ``channels_last`` compute and the compute-dtype rules are
those of ``models/cnn.py``; the FC runs in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .cnn import conv, conv2d, he_normal_, init_image_model
from .norm import BatchNorm


class BasicBlock(nn.Module):
    expansion = 1

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
            self.conv_sc = conv2d(cin, features, 1, stride, device=device)
            self.bn_sc = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        out = self.bn2(conv(out, self.conv2, self.dtype))
        if self.has_shortcut:
            x = self.bn_sc(conv(x, self.conv_sc, self.dtype))
        return F.relu(out + x.to(out.dtype))


class Bottleneck(nn.Module):
    """1x1 -> 3x3(s) -> 1x1 (4x wide) bottleneck."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        out = 4 * features
        self.conv1 = conv2d(cin, features, 1, device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = conv2d(features, features, 3, stride, device=device)
        self.bn2 = BatchNorm(features, device=device)
        self.conv3 = conv2d(features, out, 1, device=device)
        self.bn3 = BatchNorm(out, device=device)
        self.has_shortcut = stride != 1 or cin != out
        if self.has_shortcut:
            self.conv_sc = conv2d(cin, out, 1, stride, device=device)
            self.bn_sc = BatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        out = F.relu(self.bn2(conv(out, self.conv2, self.dtype)))
        out = self.bn3(conv(out, self.conv3, self.dtype))
        if self.has_shortcut:
            x = self.bn_sc(conv(x, self.conv_sc, self.dtype))
        return F.relu(out + x.to(out.dtype))


class ResNet(nn.Module):
    """Images [B, H, W, 3] (NHWC) -> logits [B, classes] in fp32; blocks
    named ``stage{i}_block{j}`` as in flax."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BasicBlock,
                 num_classes: int = 1000, stem: str = "imagenet",
                 width: int = 64, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"stem must be 'imagenet' or 'cifar', got "
                             f"{stem!r}")
        self.dtype = dtype
        self.stem = stem
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = (conv2d(3, width, 7, 2, device=device)
                          if stem == "imagenet"
                          else conv2d(3, width, 3, device=device))
        self.stem_bn = BatchNorm(width, device=device)
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, f"stage{i + 1}_block{j}",
                        block(cin, width * 2 ** i, stride, dtype=dtype,
                              device=device))
                cin = width * 2 ** i * block.expansion
        self.fc = nn.Linear(cin, num_classes, device=device)

    def init_parameters(self, generator: torch.Generator) -> None:
        """He truncated-normal conv and FC kernels, zero FC bias."""
        init_image_model(self, generator, he_normal_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_bn(conv(x, self.stem_conv, self.dtype)))
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, 2, 1)
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                x = getattr(self, f"stage{i + 1}_block{j}")(x)
        x = x.mean((2, 3))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


def ResNet18(num_classes: int = 10, stem: str = "cifar", **kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, stem, **kw)


def ResNet50(num_classes: int = 1000, stem: str = "imagenet", **kw
             ) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes, stem, **kw)
