"""Context-aware merger: per-voxel softmax weighting over views, NCDHW.

Counterpart of ``swinvox_tpu/models/merger.py``: four stacked
Conv3d(9 -> 9, k3) blocks over each view's raw features, concat of the
four outputs -> Conv3d(36 -> 9) -> Conv3d(9 -> 1), each with BatchNorm and
LeakyReLU(0.2); softmax of the per-view scalar fields over the view axis
weights the per-view coarse logits.

At one view the softmax weight is exactly 1, so the merged volume is the
coarse volume (the JAX package's ``single_view_identity``): at inference
the conv stack does not run, and in training it runs forward only,
without gradient, for its BatchNorm statistics (every merger gradient is
exactly zero there).  The stack's route is chosen in the JAX order:

  1. ``use_pallas`` (``USE_PALLAS_MERGER``), inference:
     ``ops/pallas_merger.merger_view_weights`` (kernel I, BatchNorm folded
     from the running statistics);
  2. ``use_stack`` (``USE_MERGER_STACK``), training, when the volume count
     B*N is a multiple of 16 and at most ``stack_max_volumes``:
     ``ops/pallas_merger_stack.merger_stack`` (kernels E and F);
  3. ``use_slab`` (``USE_SLAB_MERGER``), training and inference: each conv
     through ``ops/pallas_slab_conv.slab_conv3d`` (kernels J and K) with
     the float32 kernel;
  4. ``use_pallas_train`` (``USE_PALLAS_MERGER_TRAIN``), training: each
     conv through ``ops/pallas_band_conv.band_conv3d`` (kernels J and K)
     with the kernel cast to the compute dtype;
  5. otherwise plain convs.

On routes 3 and 4 the bias, BatchNorm (train-mode batch statistics) and
LeakyReLU stay in plain torch around the kernel, on channels-last views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import Conv, Norm
from swinvox_tpu_torch.ops.pallas_band_conv import band_conv3d
from swinvox_tpu_torch.ops.pallas_merger import merger_view_weights
from swinvox_tpu_torch.ops.pallas_merger_stack import merger_stack
from swinvox_tpu_torch.ops.pallas_slab_conv import slab_conv3d

_CHANNELS = ((9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1))


class Merger(nn.Module):
    def __init__(self, leaky_value: float = 0.2, dtype=torch.bfloat16,
                 single_view_identity: bool = True, use_stack: bool = False,
                 stack_max_volumes: int = 64, use_pallas: bool = False,
                 use_slab: bool = False, use_pallas_train: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.use_slab = use_slab
        self.use_pallas_train = use_pallas_train
        self.leaky_value = leaky_value
        self.dtype = dtype
        self.single_view_identity = single_view_identity
        self.use_stack = use_stack
        self.stack_max_volumes = stack_max_volumes
        for i, (ci, co) in enumerate(_CHANNELS):
            self.add_module(f"conv{i + 1}",
                            Conv(ci, co, (3, 3, 3), padding=1, dtype=dtype))
            self.add_module(f"bn{i + 1}", Norm(co, dtype))

    def _layer(self, i: int, y: torch.Tensor, train: bool) -> torch.Tensor:
        y = getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(y),
                                        train)
        return F.leaky_relu(y, self.leaky_value)

    def _plain(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        intermediates = []
        for i in range(4):
            y = self._layer(i, y, train)
            intermediates.append(y)
        y = self._layer(4, torch.cat(intermediates, dim=1), train)
        return self._layer(5, y, train)

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """Training stack through kernels E/F: BatchNorm 0..4 normalize
        inside it and take their running update from its statistics;
        BatchNorm 5 normalizes here from raw5's own statistics, so
        autograd covers its backward."""
        convs = [getattr(self, f"conv{i + 1}") for i in range(6)]
        norms = [getattr(self, f"bn{i + 1}") for i in range(6)]
        raw5, means, vars_ = merger_stack(
            x.permute(0, 2, 3, 4, 1).to(self.dtype).contiguous(),
            [c.kernel.permute(2, 3, 4, 1, 0) for c in convs],
            [c.bias for c in convs],
            [n.scale for n in norms[:5]], [n.bias for n in norms[:5]],
            leaky=self.leaky_value,
        )
        for i in range(5):
            norms[i]._update(means[i], vars_[i])
        r32 = raw5.permute(0, 4, 1, 2, 3).float()
        m5 = r32.mean((0, 2, 3, 4))
        v5 = (r32 * r32).mean((0, 2, 3, 4)) - m5 * m5
        y5 = norms[5](r32, True, external_stats=(m5, v5))
        return F.leaky_relu(y5, self.leaky_value)

    def _layered(self, x: torch.Tensor, train: bool,
                 band: bool) -> torch.Tensor:
        """The six layers with each conv through kernels J and K: the slab
        route (float32 kernel, float32 dW) or the banded one (kernel in
        the compute dtype, so dW is rounded to it).  [V, 1, 32, 32, 32]."""

        def layer(i: int, y: torch.Tensor) -> torch.Tensor:
            conv = getattr(self, f"conv{i + 1}")
            k = conv.kernel.permute(2, 3, 4, 1, 0)  # DHWIO
            if band:
                z = band_conv3d(y.to(self.dtype), k.to(self.dtype))
            else:
                z = slab_conv3d(y.to(self.dtype), k)
            z = getattr(self, f"bn{i + 1}")(
                (z + conv.bias.to(self.dtype)).permute(0, 4, 1, 2, 3), train)
            return F.leaky_relu(z, self.leaky_value).permute(0, 2, 3, 4, 1)

        y = x.permute(0, 2, 3, 4, 1)  # channels-last view
        acts = []
        for i in range(4):
            y = layer(i, y)
            acts.append(y)
        y = layer(4, torch.cat(acts, -1))
        return layer(5, y).permute(0, 4, 1, 2, 3)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """Inference stack through kernel I: [V, 32, 32, 32] f32 logits."""
        convs = [getattr(self, f"conv{i + 1}") for i in range(6)]
        norms = [getattr(self, f"bn{i + 1}") for i in range(6)]
        return merger_view_weights(
            x.permute(0, 2, 3, 4, 1).to(self.dtype).contiguous(),
            [c.kernel.permute(2, 3, 4, 1, 0) for c in convs],
            [c.bias for c in convs],
            [(n.scale, n.bias, n.mean, n.var) for n in norms],
            leaky=self.leaky_value,
        )

    def forward(self, raw_features: torch.Tensor,
                coarse_volumes: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """raw_features [B*N, 9, 32^3], coarse [B, N, 32^3] -> [B, 32^3]."""
        b, n_views = coarse_volumes.shape[:2]
        identity = self.single_view_identity and n_views == 1
        stack = (self.use_stack and train and (b * n_views) % 16 == 0
                 and b * n_views <= self.stack_max_volumes)
        # the JAX precedence: fused (inference) > stack (training) > slab
        # (both) > band (training) > plain convs
        if self.use_pallas and not train:
            run = self._fused
        elif stack:
            run = self._stack
        elif self.use_slab or (self.use_pallas_train and train):
            band = not self.use_slab
            run = lambda y: self._layered(y, train, band)  # noqa: E731
        else:
            run = lambda y: self._plain(y, train)  # noqa: E731
        if identity:
            if train:
                with torch.no_grad():  # for the BatchNorm statistics only
                    run(raw_features)
            return coarse_volumes[:, 0].float().to(self.dtype)
        y = run(raw_features)
        weights = torch.softmax(y.reshape(b, n_views, 32, 32, 32).float(),
                                dim=1)
        merged = (coarse_volumes.float() * weights).sum(1)
        return merged.to(self.dtype)
