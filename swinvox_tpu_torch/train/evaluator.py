"""Evaluation loop — the reference's test_net (core/test.py:24-273).

Counterpart of ``swinvox_tpu/train/evaluator.py`` for one process: losses
x10, sigmoid, binarize at each TEST.VOXEL_THRESH, per-sample IoU (1 where
the union is empty) and F-score, per-taxonomy means, sample-weighted
overall means, the printed IoU and F-score tables with the published
baseline column from the taxonomy JSON, and the max over thresholds of
the mean IoU as the result.

As in JAX, samples are evaluated in fixed-shape batches of
``TEST.EVAL_BATCH_SIZE`` (the last one padded with its last sample and
the padding masked out of every metric), and up to two batches stay in
flight: the card runs one while the host assembles the next, and a
batch's metrics are copied back only when a third is queued.  A loader
that augments on the card (``TRAIN.DEVICE_AUGMENT``) ships raw samples
and their parameters, which ``apply_device_augment`` turns into the
batch's images on the model's device.  The multi-process mesh path and
the voxel renders (``render_dir``) are not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from swinvox_tpu_torch.data.device_augment import apply_device_augment
from swinvox_tpu_torch.data.pipeline import BatchLoader
from swinvox_tpu_torch.data.taxonomy import TaxonomyInfo
from swinvox_tpu_torch.train.steps import make_eval_step
from swinvox_tpu_torch.utils.meters import AverageMeter

log = logging.getLogger(__name__)


def evaluate(
    cfg,
    model,
    loader: BatchLoader,
    taxonomies: Dict[str, TaxonomyInfo],
    epoch_idx: int = 0,
    eval_batch_size: Optional[int] = None,
    enable_merger: bool = True,
    enable_refiner: bool = True,
    metrics_logger=None,
    print_tables: bool = True,
) -> float:
    """Evaluates ``model`` (on its device) over ``loader``; returns the
    max over thresholds of the sample-weighted mean IoU (-1 if empty)."""
    thresholds = tuple(cfg.TEST.VOXEL_THRESH)
    eval_step = make_eval_step(model, thresholds)
    batch_size = eval_batch_size or cfg.TEST.EVAL_BATCH_SIZE
    model.eval()

    encoder_losses = AverageMeter()
    refiner_losses = AverageMeter()
    test_iou: Dict[str, List[np.ndarray]] = {}
    test_fscore: Dict[str, List[np.ndarray]] = {}
    pend_img, pend_vol, pend_tax = [], [], []
    pend_aug: List[dict] = []  # device augmentation: per-sample parameters
    inflight = []
    n_seen = 0
    device = next(model.parameters()).device

    def submit():
        if not pend_img:
            return
        n = len(pend_img)
        pad = batch_size - n
        host = {"images": np.stack(pend_img + [pend_img[-1]] * pad)}
        volumes = np.stack(pend_vol + [pend_vol[-1]] * pad).astype(np.uint8)
        if pend_aug:
            for k in pend_aug[0]:
                host[f"aug_{k}"] = np.stack(
                    [p[k] for p in pend_aug] + [pend_aug[-1][k]] * pad)
            pend_aug.clear()
        out = eval_step(apply_device_augment(host, cfg, device), volumes,
                        enable_merger=enable_merger,
                        enable_refiner=enable_refiner)
        out.pop("probs")
        inflight.append((out, list(pend_tax), n))
        pend_img.clear()
        pend_vol.clear()
        pend_tax.clear()

    def drain():
        nonlocal n_seen
        out, tax, n = inflight.pop(0)
        host = {k: v.cpu().numpy()[:n] for k, v in out.items()}
        encoder_losses.update(float(host["encoder_loss"].mean()), n)
        refiner_losses.update(float(host["refiner_loss"].mean()), n)
        for i, tid in enumerate(tax):
            test_iou.setdefault(tid, []).append(host["iou"][i])
            test_fscore.setdefault(tid, []).append(host["fscore"][i])
        n_seen += n

    for batch in loader:
        for i in range(batch.images.shape[0]):
            pend_img.append(batch.images[i])
            pend_vol.append(batch.volumes[i])
            pend_tax.append(batch.taxonomy_ids[i])
            if batch.aug is not None:
                pend_aug.append({k: v[i] for k, v in batch.aug.items()})
            if len(pend_img) == batch_size:
                submit()
                while len(inflight) > 2:
                    drain()
    submit()
    while inflight:
        drain()

    if n_seen == 0:
        log.warning("evaluate: empty loader")
        return -1.0

    # per-taxonomy means + sample-weighted overall (reference :194-206)
    mean_iou = np.zeros(len(thresholds))
    mean_fscore = np.zeros(len(thresholds))
    per_tax_iou, per_tax_fscore = {}, {}
    tax_counts = {tid: len(rows) for tid, rows in test_iou.items()}
    for tid, rows in test_iou.items():
        per_tax_iou[tid] = np.mean(rows, axis=0)
        mean_iou += per_tax_iou[tid] * len(rows)
    for tid, rows in test_fscore.items():
        per_tax_fscore[tid] = np.mean(rows, axis=0)
        mean_fscore += per_tax_fscore[tid] * len(rows)
    mean_iou /= n_seen
    mean_fscore /= n_seen

    if print_tables:
        n_views = cfg.CONST.N_VIEWS_RENDERING
        _print_table("TEST RESULTS (IoU)", per_tax_iou, tax_counts,
                     taxonomies, thresholds, mean_iou, n_views, True)
        _print_table("TEST RESULTS (F-score)", per_tax_fscore, tax_counts,
                     taxonomies, thresholds, mean_fscore, n_views, False)

    max_iou = float(np.max(mean_iou))
    if metrics_logger is not None:
        metrics_logger.add_scalar("EncoderDecoder/EpochLoss",
                                  encoder_losses.avg, epoch_idx)
        metrics_logger.add_scalar("Refiner/EpochLoss", refiner_losses.avg,
                                  epoch_idx)
        metrics_logger.add_scalar("Refiner/IoU", max_iou, epoch_idx)
        metrics_logger.add_scalar("Refiner/F-score",
                                  float(np.max(mean_fscore)), epoch_idx)
    log.info("Eval epoch %d: EDLoss=%.4f RLoss=%.4f max IoU=%.4f", epoch_idx,
             encoder_losses.avg, refiner_losses.avg, max_iou)
    return max_iou


def _print_table(title, per_tax, tax_counts, taxonomies, thresholds,
                 overall, n_views, baselines):
    print(f"============================ {title} "
          "============================")
    header = (["Taxonomy", "#Sample", "Baseline"]
              + [f"t={t:.2f}" for t in thresholds])
    print("\t".join(header))
    for tid, values in per_tax.items():
        info = taxonomies.get(tid)
        name = (info.taxonomy_name if info else tid).ljust(8)
        bstr = "N/a"
        if baselines and info and info.baselines:
            b = info.baselines.get(f"{n_views}-view")
            bstr = f"{b:.4f}" if b is not None else "N/a"
        print("\t".join([name, str(tax_counts[tid]), bstr]
                        + [f"{v:.4f}" for v in values]))
    print("Overall \t\t\t" + "\t".join(f"{v:.4f}" for v in overall))
    print()
