"""Per-view 2D -> 3D lifting decoder, NCDHW.

Counterpart of ``swinvox_tpu/models/decoder.py``: adaptive-avg-pool the
7x7 features to 2x2, replicate along a new depth axis into a 2^3 cube,
then transposed convs 256 -> 128 -> 64 -> 32 -> 8 doubling the grid
2^3 -> 32^3 (the first with kernel (6, 4, 4), padding (2, 1, 1)) and a
1x1x1 transposed conv to one logit channel.

In: [B*N, 256, 7, 7].  Returns
  raw_features [B*N, 9, 32, 32, 32]  (8 feature channels + the logit)
  coarse       [B, N, 32, 32, 32]    logits per view
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import (
    ConvTranspose,
    Norm,
    adaptive_avg_pool_7_to_2,
)

_SPECS = (  # (in, out, kernel, padding)
    (256, 128, (6, 4, 4), (2, 1, 1)),
    (128, 64, (4, 4, 4), (1, 1, 1)),
    (64, 32, (4, 4, 4), (1, 1, 1)),
    (32, 8, (4, 4, 4), (1, 1, 1)),
)


class Decoder(nn.Module):
    def __init__(self, tconv_use_bias: bool = False, dtype=torch.bfloat16):
        super().__init__()
        for i, (cin, cout, k, p) in enumerate(_SPECS):
            self.add_module(f"tconv{i + 1}", ConvTranspose(
                cin, cout, k, strides=2, padding=p, use_bias=tconv_use_bias,
                dtype=dtype))
            self.add_module(f"bn{i + 1}", Norm(cout, dtype))
        self.tconv5 = ConvTranspose(8, 1, (1, 1, 1), use_bias=tconv_use_bias,
                                    dtype=dtype)

    def forward(self, features: torch.Tensor, n_views: int,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        bn, c = features.shape[:2]
        x = adaptive_avg_pool_7_to_2(features)  # [BN, 256, 2, 2]
        x = x[:, :, None].expand(bn, c, 2, 2, 2)  # new leading depth axis
        for i in range(len(_SPECS)):
            x = getattr(self, f"tconv{i + 1}")(x)
            x = F.relu(getattr(self, f"bn{i + 1}")(x, train))
        logits = self.tconv5(x)  # [BN, 1, 32, 32, 32]
        raw_features = torch.cat([x, logits], dim=1)
        coarse = logits.reshape(bn // n_views, n_views, 32, 32, 32)
        return raw_features, coarse
