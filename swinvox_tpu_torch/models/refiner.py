"""3D U-Net-style refiner over the merged volume, NCDHW.

Counterpart of ``swinvox_tpu/models/refiner.py``: three Conv3d(k4, p2) +
BatchNorm + LeakyReLU + MaxPool3d(2) levels (1 -> 32 -> 64 -> 128
channels, 32^3 -> 4^3), an FC bottleneck 8192 -> 2048 -> 8192 (ReLU),
three ConvTranspose3d(k4, s2, p1) levels with additive skips, and
(input + reconstruction) * 0.5 — still logits.

With ``down1_pallas`` (``REFINER_DOWN1_PALLAS``) the 1-channel first conv
runs as ``ops/pallas_down1.conv3d_down1``: the stock conv forward and
kernel L's fused backward, the kernel cast to the compute dtype and the
bias added outside, as in JAX.

The JAX refiner flattens the 4^3 x 128 bottleneck channels-last
(D, H, W, C); this one permutes NCDHW to that order before ``fc1`` and
back after ``fc2``, so the flax dense kernels load unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    Norm,
    max_pool,
)
from swinvox_tpu_torch.ops.pallas_down1 import conv3d_down1


class Refiner(nn.Module):
    def __init__(self, leaky_value: float = 0.2, tconv_use_bias: bool = False,
                 dtype=torch.bfloat16, down1_pallas: bool = False):
        super().__init__()
        self.leaky_value = leaky_value
        self.down1_pallas = down1_pallas
        self.dtype = dtype
        for name, ci, co in (("down1", 1, 32), ("down2", 32, 64),
                             ("down3", 64, 128)):
            self.add_module(f"{name}_conv",
                            Conv(ci, co, (4, 4, 4), padding=2, dtype=dtype))
            self.add_module(f"{name}_bn", Norm(co, dtype))
        self.fc1 = Dense(8192, 2048, dtype=dtype)
        self.fc2 = Dense(2048, 8192, dtype=dtype)
        for name, ci, co in (("up1", 128, 64), ("up2", 64, 32)):
            self.add_module(f"{name}_tconv", ConvTranspose(
                ci, co, (4, 4, 4), strides=2, padding=1,
                use_bias=tconv_use_bias, dtype=dtype))
            self.add_module(f"{name}_bn", Norm(co, dtype))
        self.up3_tconv = ConvTranspose(32, 1, (4, 4, 4), strides=2, padding=1,
                                       use_bias=tconv_use_bias, dtype=dtype)

    def _down(self, x: torch.Tensor, name: str, train: bool) -> torch.Tensor:
        conv = getattr(self, f"{name}_conv")
        if self.down1_pallas and x.shape[1] == 1:
            y = conv3d_down1(x.permute(0, 2, 3, 4, 1),
                             conv.kernel.permute(2, 3, 4, 1, 0).to(self.dtype))
            y = (y + conv.bias.to(y.dtype)).permute(0, 4, 1, 2, 3)
        else:
            y = conv(x)
        y = getattr(self, f"{name}_bn")(y, train)
        y = F.leaky_relu(y, self.leaky_value)
        return max_pool(y, 2)  # k4 p2 grows 32 -> 33; the pool floors to 16

    def _up(self, x: torch.Tensor, name: str, train: bool) -> torch.Tensor:
        y = getattr(self, f"{name}_bn")(getattr(self, f"{name}_tconv")(x),
                                        train)
        return F.relu(y)

    def forward(self, coarse_volumes: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """[B, 32, 32, 32] logits -> [B, 32, 32, 32] refined logits."""
        x32 = coarse_volumes[:, None].to(self.dtype)
        x16 = self._down(x32, "down1", train)
        x8 = self._down(x16, "down2", train)
        x4 = self._down(x8, "down3", train)  # [B, 128, 4, 4, 4]
        b = x4.shape[0]
        flat = x4.permute(0, 2, 3, 4, 1).reshape(b, 8192)
        flat = F.relu(self.fc1(flat))
        flat = F.relu(self.fc2(flat))
        x4_r = x4 + flat.reshape(b, 4, 4, 4, 128).permute(0, 4, 1, 2, 3)
        x8_r = x8 + self._up(x4_r, "up1", train)
        x16_r = x16 + self._up(x8_r, "up2", train)
        out = (x32 + self.up3_tconv(x16_r)) * 0.5
        return out[:, 0]
