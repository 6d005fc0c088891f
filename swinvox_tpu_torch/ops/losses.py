"""Losses and voxel metrics, float32.

Counterpart of ``swinvox_tpu/ops/losses.py``:
  * BCE-with-logits, mean over all voxels, in the stable form
    max(x, 0) - x*z + log1p(exp(-|x|));
  * per-sample IoU over binarization thresholds, 1 where the union is 0;
  * per-sample F-score from tp/fp/fn with eps 1e-8.
"""

from __future__ import annotations

from typing import Sequence

import torch


def bce_with_logits_per_sample(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """Per-sample mean BCE: [B, ...] -> [B] (float32)."""
    x = logits.float()
    z = labels.float()
    loss = x.clamp_min(0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return loss.reshape(loss.shape[0], -1).mean(1)


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, float32."""
    return bce_with_logits_per_sample(logits, labels).mean()


def _binarize(volume_prob, ground_truth, thresholds):
    probs = volume_prob.float()[:, None]  # [B, 1, D, H, W]
    th = torch.tensor(thresholds, dtype=torch.float32,
                      device=probs.device).view(1, -1, 1, 1, 1)
    pred = (probs >= th).float()  # [B, T, D, H, W]
    return pred, ground_truth.float()[:, None]


def voxel_iou(volume_prob: torch.Tensor, ground_truth: torch.Tensor,
              thresholds: Sequence[float] = (0.2, 0.3, 0.4, 0.5)
              ) -> torch.Tensor:
    """Per-sample IoU at each threshold: [B, len(thresholds)]."""
    pred, gt = _binarize(volume_prob, ground_truth, thresholds)
    inter = (pred * gt).sum((2, 3, 4))
    union = (pred + gt).clamp(0.0, 1.0).sum((2, 3, 4))
    return torch.where(union > 0, inter / union.clamp_min(1.0),
                       torch.ones_like(union))


def voxel_fscore(volume_prob: torch.Tensor, ground_truth: torch.Tensor,
                 thresholds: Sequence[float] = (0.2, 0.3, 0.4, 0.5),
                 eps: float = 1e-8) -> torch.Tensor:
    """Per-sample F1 at each threshold: [B, len(thresholds)]."""
    pred, gt = _binarize(volume_prob, ground_truth, thresholds)
    tp = (pred * gt).sum((2, 3, 4))
    fp = (pred * (1.0 - gt)).sum((2, 3, 4))
    fn = ((1.0 - pred) * gt).sum((2, 3, 4))
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    return 2.0 * precision * recall / (precision + recall + eps)
