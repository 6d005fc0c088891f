"""Standalone evaluation: ``test_net``.

Counterpart of ``test_net`` in ``swinvox_tpu/train/trainer.py`` (reference
core/test.py:24-89, standalone path): build the model the config
describes, load the checkpoint's weights (``--weights`` or
``CONST.WEIGHTS``; a JAX checkpoint file, full or params-only), evaluate
the test split of ``DATASET.TEST_DATASET`` and stream the epoch metrics
to ``DIR.OUT_PATH/<timestamp>/logs/test.jsonl``.  It runs on one device,
``cuda`` unless the caller asks for another; the voxel renders of the
first samples and ``train_net`` are not ported yet.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Union

import torch

from swinvox_tpu_torch.data.pipeline import build_loader
from swinvox_tpu_torch.data.taxonomy import DATASET_INDEX_MAPPING, DatasetType
from swinvox_tpu_torch.models.swinvox import SwinVoxModel
from swinvox_tpu_torch.train.checkpoint import load_checkpoint
from swinvox_tpu_torch.train.evaluator import evaluate
from swinvox_tpu_torch.utils.metrics_logger import MetricsLogger


def test_net(cfg, epoch_idx: int = -1, weights: Optional[str] = None,
             device: Union[str, torch.device] = "cuda") -> float:
    """Evaluates the checkpoint on the test split; returns the max over
    thresholds of the mean IoU."""
    cfg.validate()
    model = SwinVoxModel.from_config(cfg)
    weights = weights or cfg.CONST.WEIGHTS
    if weights:
        load_checkpoint(weights, model)
    model.to(device)
    loader = build_loader(cfg, DatasetType.TEST)
    taxonomies = DATASET_INDEX_MAPPING[cfg.DATASET.TEST_DATASET](
        cfg).taxonomy_info()
    output_dir = os.path.join(cfg.DIR.OUT_PATH,
                              datetime.now().isoformat().replace(":", "-"))
    writer = MetricsLogger(os.path.join(output_dir, "logs"), "test")
    try:
        return evaluate(cfg, model, loader, taxonomies, epoch_idx=epoch_idx,
                        enable_merger=cfg.NETWORK.USE_MERGER,
                        enable_refiner=cfg.NETWORK.USE_REFINER,
                        metrics_logger=writer)
    finally:
        writer.close()
