"""Context-aware merger: per-voxel softmax weighting over views, NCDHW.

Counterpart of ``swinvox_tpu/models/merger.py`` at inference: four
stacked Conv3d(9 -> 9, k3) blocks over each view's raw features, concat
of the four outputs -> Conv3d(36 -> 9) -> Conv3d(9 -> 1), each with
BatchNorm (eval) and LeakyReLU(0.2); softmax of the per-view scalar
fields over the view axis weights the per-view coarse logits.

At one view the softmax weight is exactly 1, so the merged volume is the
coarse volume (the JAX package's ``single_view_identity``) and the conv
stack does not run.  The JAX merger kernels (fused inference stack,
training stack, band and slab convs) are off the serving path and not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import Conv, Norm

_CHANNELS = ((9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1))


class Merger(nn.Module):
    def __init__(self, leaky_value: float = 0.2, dtype=torch.bfloat16,
                 single_view_identity: bool = True):
        super().__init__()
        self.leaky_value = leaky_value
        self.dtype = dtype
        self.single_view_identity = single_view_identity
        for i, (ci, co) in enumerate(_CHANNELS):
            self.add_module(f"conv{i + 1}",
                            Conv(ci, co, (3, 3, 3), padding=1, dtype=dtype))
            self.add_module(f"bn{i + 1}", Norm(co, dtype))

    def _layer(self, i: int, y: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(y))
        return F.leaky_relu(y, self.leaky_value)

    def forward(self, raw_features: torch.Tensor,
                coarse_volumes: torch.Tensor) -> torch.Tensor:
        """raw_features [B*N, 9, 32^3], coarse [B, N, 32^3] -> [B, 32^3]."""
        b, n_views = coarse_volumes.shape[:2]
        if self.single_view_identity and n_views == 1:
            return coarse_volumes[:, 0].float().to(self.dtype)
        y = raw_features
        intermediates = []
        for i in range(4):
            y = self._layer(i, y)
            intermediates.append(y)
        y = self._layer(4, torch.cat(intermediates, dim=1))
        y = self._layer(5, y)
        weights = torch.softmax(y.reshape(b, n_views, 32, 32, 32).float(),
                                dim=1)
        merged = (coarse_volumes.float() * weights).sum(1)
        return merged.to(self.dtype)
