"""ResNet-50 trunk (conv1 .. layer3), NCHW.

Counterpart of ``swinvox_tpu/models/resnet.py``: 7x7/2 stem, 3x3/2
max-pool with -inf padding, bottleneck stages ``stage_depths`` (default
[3, 4, 6]) of widths (64, 128, 256) x 4.  [B, 3, 224, 224] ->
[B, 1024, 14, 14].  BatchNorm in eval or train mode (``train``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import Conv, Norm, max_pool


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity/projection shortcut."""

    def __init__(self, in_features: int, width: int, strides: int = 1,
                 project: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = Conv(in_features, width, (1, 1), use_bias=False,
                          dtype=dtype)
        self.bn1 = Norm(width, dtype)
        self.conv2 = Conv(width, width, (3, 3), strides=strides, padding=1,
                          use_bias=False, dtype=dtype)
        self.bn2 = Norm(width, dtype)
        self.conv3 = Conv(width, width * 4, (1, 1), use_bias=False,
                          dtype=dtype)
        self.bn3 = Norm(width * 4, dtype)
        self.project = project
        if project:
            self.downsample_conv = Conv(in_features, width * 4, (1, 1),
                                        strides=strides, use_bias=False,
                                        dtype=dtype)
            self.downsample_bn = Norm(width * 4, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        shortcut = x
        if self.project:
            shortcut = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(out + shortcut)


class ResNet50Trunk(nn.Module):
    """conv1..layer3 of ResNet-50. [B, 3, 224, 224] -> [B, 1024, 14, 14]."""

    def __init__(self, dtype=torch.bfloat16,
                 stage_depths: Tuple[int, int, int] = (3, 4, 6)):
        super().__init__()
        self.conv1 = Conv(3, 64, (7, 7), strides=2, padding=3,
                          use_bias=False, dtype=dtype)
        self.bn1 = Norm(64, dtype)
        in_features = 64
        self.block_names = []
        for stage_idx, (depth, width) in enumerate(
            zip(stage_depths, (64, 128, 256))
        ):
            for block_idx in range(depth):
                first = block_idx == 0
                name = f"layer{stage_idx + 1}_block{block_idx}"
                self.add_module(name, Bottleneck(
                    in_features, width,
                    strides=2 if (first and stage_idx > 0) else 1,
                    project=first, dtype=dtype,
                ))
                self.block_names.append(name)
                in_features = width * 4

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), train))
        # torch maxpool k3 s2 p1 pads with -inf, as the JAX trunk does
        x = max_pool(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return x
