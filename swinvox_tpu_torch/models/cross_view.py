"""Cross-view attention: multi-head attention across the view axis.

Counterpart of ``swinvox_tpu/models/cross_view.py``, on NCHW maps
[B*N, C, H, W].  Each view's map is projected to Q/K/V by 1x1 convs after
a depthwise strided downsample; per (view, head) Q/K/V are flattened to
one vector, scores [B, heads, N, N] are scaled by 1/sqrt(head_dim * N),
softmaxed over views, and the value mix is projected back, bilinearly
upsampled and added to the input, then a 1x1-conv FFN (exact GELU),
BatchNorm and dropout 0.1 (in training, its mask drawn from the caller's
generator).

The per-view vectors are flattened here in (head_dim, h, w) order and in
JAX in (h, w, head_dim) order; dot products and the view mix are sums
over that axis and do not depend on its order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import (
    Conv,
    Norm,
    dropout,
    mm_f32,
    resize_bilinear,
)


class CrossViewAttention(nn.Module):
    def __init__(self, in_channels: int = 512, num_heads: int = 4,
                 reduction_ratio: int = 4, spatial_downsample_ratio: int = 2,
                 dtype=torch.bfloat16, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_heads = num_heads
        self.reduced = in_channels // reduction_ratio
        self.r = spatial_downsample_ratio
        self.dtype = dtype
        if self.r > 1:
            self.downsample_qkv = Conv(
                in_channels, in_channels, (self.r, self.r), strides=self.r,
                feature_group_count=in_channels, dtype=dtype,
            )
        self.qkv_conv = Conv(in_channels, 3 * self.reduced, (1, 1),
                             dtype=dtype)
        self.proj_conv = Conv(self.reduced, in_channels, (1, 1), dtype=dtype)
        self.ffn_fc1 = Conv(in_channels, in_channels, (1, 1), dtype=dtype)
        self.ffn_fc2 = Conv(in_channels, in_channels, (1, 1), dtype=dtype)
        self.batch_norm = Norm(in_channels, dtype)

    def forward(self, x: torch.Tensor, n_views: int, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B*N, C, H, W] with views of one object adjacent."""
        bn, c, h, w = x.shape
        b = bn // n_views
        heads = self.num_heads
        hd = self.reduced // heads
        x_qkv = self.downsample_qkv(x) if self.r > 1 else x
        nh, nw = x_qkv.shape[2:]
        qkv = self.qkv_conv(x_qkv).reshape(b, n_views, 3, heads, hd * nh * nw)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [B, heads, N, hd*nh*nw]

        if n_views == 1:
            # softmax over a singleton view axis is exactly 1.0: the mix is v
            attended = v.to(self.dtype)
        else:
            # the scale rounded to float32 first, as JAX computes it
            scale = float(np.float32(1.0) / np.sqrt(np.float32(hd * n_views)))
            scores = mm_f32(q, k.transpose(-1, -2)) * scale
            probs = torch.softmax(scores, dim=-1)
            attended = mm_f32(probs.to(v.dtype), v).to(self.dtype)

        # back to per-view maps [B*N, reduced, nh, nw]
        attended = attended.permute(0, 2, 1, 3).reshape(bn, self.reduced,
                                                        nh, nw)
        attended = self.proj_conv(attended)
        if self.r > 1:
            attended = resize_bilinear(attended, (h, w))
        y = attended + x  # residual around attention only
        y = self.ffn_fc2(F.gelu(self.ffn_fc1(y)))
        y = self.batch_norm(y, train)
        return dropout(y, self.dropout_rate, train, generator)
