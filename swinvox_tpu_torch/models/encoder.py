"""Hybrid ResNet-50 + Swin-Tiny encoder with cross-view fusion.

Counterpart of ``swinvox_tpu/models/encoder.py``: per view,
  * ResNet-50 trunk -> 1x1 reduce to 256 -> 2x2 avg-pool -> [256, 7, 7];
  * Swin-Tiny stages, each LayerNorm([C, H, W]) and dropout 0.05 (in
    training), then per-stage 1x1 reduce to 256 and strided-conv chains
    down to 7x7, summed (or, single-stage, the last stage reduced);
  * concat -> [512, 7, 7]; cross-view attention over the view axis;
  * fusion conv 512 -> 256 and three 3x3 conv blocks.

In: [B, N, 224, 224, 3] -> out [B*N, 256, 7, 7] (NCHW, views adjacent).
Training draws its masks from the caller's generator in the JAX order:
the Swin's drop paths, the stage dropouts, then CVA's dropout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.cross_view import CrossViewAttention
from swinvox_tpu_torch.models.layers import (
    Conv,
    LayerNorm,
    Norm,
    avg_pool,
    dropout,
)
from swinvox_tpu_torch.models.resnet import ResNet50Trunk
from swinvox_tpu_torch.models.swin import SwinTiny

_SWIN_CHANNELS = (96, 192, 384, 768)


class Encoder(nn.Module):
    def __init__(
        self,
        use_swin_multi_stage: bool = True,
        swin_stages: Tuple[int, ...] = (0, 1, 2, 3),
        use_cross_view_attention: bool = True,
        cross_att_num_heads: int = 4,
        cross_att_reduction_ratio: int = 4,
        att_spatial_downsample_ratio: int = 2,
        dtype=torch.bfloat16,
        use_pallas_swin_block: bool = False,
        use_pallas_swin_block_train: bool = False,
        use_rewindow_chain: bool = True,
        swin_depths: Tuple[int, ...] = (2, 2, 6, 2),
        resnet_stage_depths: Tuple[int, int, int] = (3, 4, 6),
        use_pallas: bool = False,
    ):
        super().__init__()
        self.use_swin_multi_stage = use_swin_multi_stage
        self.swin_stages = tuple(swin_stages)
        self.use_cross_view_attention = use_cross_view_attention
        self.dtype = dtype
        self.stage_dropout = 0.05
        self.resnet = ResNet50Trunk(dtype, tuple(resnet_stage_depths))
        self.resnet_reduce = Conv(1024, 256, (1, 1), dtype=dtype)
        self.swin = SwinTiny(
            depths=tuple(swin_depths), dtype=dtype,
            use_pallas_block=use_pallas_swin_block,
            use_pallas_block_train=use_pallas_swin_block_train,
            use_rewindow_chain=use_rewindow_chain,
            use_pallas=use_pallas,
        )
        for j, s in enumerate(self.swin_stages):
            # the swin resizes every input to its img_size (224)
            side = self.swin.img_size // 4 // 2**s
            self.add_module(f"swin_stage_norm{j}", LayerNorm(
                (_SWIN_CHANNELS[s], side, side), dtype))
        if use_swin_multi_stage:
            for j, s in enumerate(self.swin_stages):
                self.add_module(f"swin_reduce{j}",
                                Conv(_SWIN_CHANNELS[s], 256, (1, 1),
                                     dtype=dtype))
                for step in range(3 - s):
                    self.add_module(f"swin_down{j}_{step}_conv", Conv(
                        256, 256, (3, 3), strides=2, padding=1, dtype=dtype))
                    self.add_module(f"swin_down{j}_{step}_bn",
                                    Norm(256, dtype))
        else:
            self.swin_reduce = Conv(_SWIN_CHANNELS[self.swin_stages[-1]], 256,
                                    (1, 1), dtype=dtype)
        if use_cross_view_attention:
            self.cross_view_attention = CrossViewAttention(
                512, cross_att_num_heads, cross_att_reduction_ratio,
                att_spatial_downsample_ratio, dtype,
            )
        cin = 512
        for name in ("fusion", "layer1", "layer2", "layer3"):
            self.add_module(f"{name}_conv",
                            Conv(cin, 256, (3, 3), padding=1, dtype=dtype))
            self.add_module(f"{name}_bn", Norm(256, dtype))
            cin = 256

    def forward(self, rendering_images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n_views, h, w, c = rendering_images.shape
        img = rendering_images.reshape(b * n_views, h, w, c).to(self.dtype)

        # ---- ResNet branch (NCHW) ----------------------------------------
        rf = self.resnet(img.permute(0, 3, 1, 2), train)
        rf = avg_pool(self.resnet_reduce(rf), 2)  # [BN, 256, 7, 7]

        # ---- Swin branch (NHWC stage maps -> NCHW) -----------------------
        all_stages = self.swin(img, train, generator)
        selected = [
            dropout(getattr(self, f"swin_stage_norm{j}")(
                all_stages[s].permute(0, 3, 1, 2)), self.stage_dropout, train,
                generator)
            for j, s in enumerate(self.swin_stages)
        ]
        if self.use_swin_multi_stage:
            sf = 0
            for j, (s, feat) in enumerate(zip(self.swin_stages, selected)):
                feat = getattr(self, f"swin_reduce{j}")(feat)
                for step in range(3 - s):
                    feat = getattr(self, f"swin_down{j}_{step}_conv")(feat)
                    feat = F.relu(getattr(self, f"swin_down{j}_{step}_bn")(
                        feat, train))
                sf = sf + feat
        else:
            sf = self.swin_reduce(selected[-1])

        # ---- fuse ---------------------------------------------------------
        x = torch.cat([rf, sf], dim=1)  # [BN, 512, 7, 7]
        if self.use_cross_view_attention:
            x = self.cross_view_attention(x, n_views, train, generator)
        for name in ("fusion", "layer1", "layer2", "layer3"):
            x = getattr(self, f"{name}_conv")(x)
            x = F.relu(getattr(self, f"{name}_bn")(x, train))
        return x
