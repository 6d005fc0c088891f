"""The training loop ``train_net`` and standalone evaluation ``test_net``.

Counterparts of ``train_net`` and ``test_net`` in
``swinvox_tpu/train/trainer.py`` (reference core/train.py:35-376 and
core/test.py:24-89), on one device: ``cuda`` unless the caller asks for
another.

``train_net``: the train loader (train transform, random views, seeded
shuffle) and the validation loader, per-module optimizers with
MultiStepLR over the epoch's steps, resume from ``CONST.WEIGHTS`` under
``TRAIN.RESUME_TRAIN`` (a full checkpoint of either package restores
weights, optimizer states, step and the meta's ``epoch_idx``,
``best_iou`` and ``best_epoch``, so the loop starts again at the epoch
the file was saved after, as in JAX; a params-only file restores the
weights and starts at epoch 0), the epoch gates
``EPOCH_START_USE_MERGER`` and ``EPOCH_START_USE_REFINER``, the batch
losses every ``LOG_EVERY`` batches and the epoch losses into
``logs/train.jsonl``, the ``UPDATE_N_VIEWS_RENDERING`` redraw from
``(seed, epoch)``, per-epoch validation into ``logs/val.jsonl``, and the
best-IoU and ``SAVE_FREQ`` checkpoints under
``DIR.OUT_PATH/<timestamp>/checkpoints`` beside ``config.json``.  Every
scalar also goes to TensorBoard event files, one directory per stream
(``logs/train/``, ``logs/val/``).  Dropout and drop-path masks come from
one ``torch.Generator`` seeded before each step from ``(CONST.RNG_SEED +
1, step)``, as the JAX step folds the step into its key, so a resumed run
draws what an uninterrupted one draws.  Under ``TRAIN.DEVICE_AUGMENT``
the loaders ship raw batches and ``apply_device_augment`` makes the
images on the card before each step (and in ``evaluate``).  With
``DIR.PROFILE_DIR`` set (the runner's ``--profile``), batches 2-6 of the
first epoch run under ``torch.profiler`` and its trace is written there
(``<host>_<pid>.<ns>.pt.trace.json``, Chrome trace format).  The loaders
are closed in a ``finally``.  Not ported: the mesh (``PARALLEL.*`` and
``CONST.DEVICE_SELECT`` beyond one device, refused here and in
``test_net``) and the voxel renders.

``test_net``: load the checkpoint's weights (``--weights`` or
``CONST.WEIGHTS``; full or params-only), evaluate the test split of
``DATASET.TEST_DATASET`` and stream the epoch metrics to
``DIR.OUT_PATH/<timestamp>/logs/test.jsonl``.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from datetime import datetime
from typing import Optional, Union

import numpy as np
import torch

from swinvox_tpu_torch.config import require_one_device
from swinvox_tpu_torch.data.device_augment import (
    apply_device_augment,
    batch_to_host_dict,
)
from swinvox_tpu_torch.data.pipeline import build_loader
from swinvox_tpu_torch.data.taxonomy import DATASET_INDEX_MAPPING, DatasetType
from swinvox_tpu_torch.models.swinvox import SwinVoxModel
from swinvox_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from swinvox_tpu_torch.train.evaluator import evaluate
from swinvox_tpu_torch.train.state import create_train_state, module_params
from swinvox_tpu_torch.train.steps import make_train_step
from swinvox_tpu_torch.utils.meters import AverageMeter
from swinvox_tpu_torch.utils.metrics_logger import MetricsLogger

log = logging.getLogger(__name__)


def _output_dir(cfg) -> str:
    return os.path.join(cfg.DIR.OUT_PATH,
                        datetime.now().isoformat().replace(":", "-"))


def step_seed(cfg, step: int) -> int:
    """The seed of the dropout generator at ``step``, from
    ``(CONST.RNG_SEED + 1, step)``."""
    return int(np.random.SeedSequence(
        [cfg.CONST.RNG_SEED + 1, int(step)]).generate_state(1)[0])


def train_net(cfg, device: Union[str, torch.device] = "cuda") -> float:
    """Trains ``cfg.TRAIN.NUM_EPOCHS`` epochs (from the resumed epoch);
    returns the best validation IoU (max over thresholds)."""
    cfg.validate()
    require_one_device(cfg)
    train_loader = build_loader(cfg, DatasetType.TRAIN)
    val_loader = build_loader(cfg, DatasetType.VAL)
    try:
        return _train(cfg, torch.device(device), train_loader, val_loader)
    finally:
        train_loader.close()
        val_loader.close()


class _Trace:
    """``torch.profiler`` over a span of steps (the card's kernels too when
    the model is on one), written to ``out_dir`` when stopped."""

    def __init__(self, out_dir: str, device: torch.device):
        self.out_dir = out_dir
        self.device = device
        self.prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"{socket.gethostname()}_"
                            f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        log.info("Wrote profiler trace to %s", path)


def _train(cfg, device, train_loader, val_loader) -> float:
    steps_per_epoch = max(1, len(train_loader))
    state, optimizers = create_train_state(
        cfg, steps_per_epoch=steps_per_epoch, device=device)
    model = state.model
    for name in optimizers:
        log.info("Parameters in %s: %d.", name.capitalize(),
                 sum(p.numel() for p in module_params(model, name).values()))
    train_step = make_train_step(model, optimizers,
                                 grad_accum_steps=cfg.TRAIN.GRAD_ACCUM_STEPS)

    init_epoch, best_iou, best_epoch = 0, -1.0, -1
    if cfg.CONST.WEIGHTS and cfg.TRAIN.RESUME_TRAIN:
        meta = load_checkpoint(cfg.CONST.WEIGHTS, state)
        if meta.get("format") == "params-only":
            log.warning("%s is a params-only export; resuming weights at "
                        "epoch 0 with fresh optimizer state",
                        cfg.CONST.WEIGHTS)
        else:
            init_epoch = meta["epoch_idx"]
            best_iou = meta["best_iou"]
            best_epoch = meta["best_epoch"]

    output_dir = _output_dir(cfg)
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    writer = MetricsLogger(os.path.join(output_dir, "logs"), "train")
    val_writer = MetricsLogger(os.path.join(output_dir, "logs"), "val")
    trace = _Trace(cfg.DIR.PROFILE_DIR, device)
    try:
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        taxonomies = DATASET_INDEX_MAPPING[cfg.DATASET.TEST_DATASET](
            cfg).taxonomy_info()
        generator = torch.Generator(device=device)
        n_batches = len(train_loader)
        for epoch_idx in range(init_epoch, cfg.TRAIN.NUM_EPOCHS):
            epoch_start = time.time()
            batch_time, data_time = AverageMeter(), AverageMeter()
            encoder_losses, refiner_losses = AverageMeter(), AverageMeter()
            enable_merger = (cfg.NETWORK.USE_MERGER and
                             epoch_idx >= cfg.TRAIN.EPOCH_START_USE_MERGER)
            enable_refiner = (cfg.NETWORK.USE_REFINER and
                              epoch_idx >= cfg.TRAIN.EPOCH_START_USE_REFINER)
            train_loader.set_epoch(epoch_idx)
            profiling = cfg.DIR.PROFILE_DIR and epoch_idx == init_epoch
            t_end = time.time()
            for batch_idx, batch in enumerate(train_loader):
                if profiling and batch_idx == 2:
                    trace.start()
                elif profiling and batch_idx == 6:
                    trace.stop()
                data_time.update(time.time() - t_end)
                host = batch_to_host_dict(batch, cfg)
                images = apply_device_augment(host, cfg, device)
                generator.manual_seed(step_seed(cfg, state.step))
                state, metrics = train_step(
                    state, images, host["volumes"], generator,
                    enable_merger=enable_merger,
                    enable_refiner=enable_refiner)
                if (batch_idx % max(1, cfg.TRAIN.LOG_EVERY) == 0
                        or batch_idx == n_batches - 1):
                    ed_loss = float(metrics["encoder_loss"])
                    r_loss = float(metrics["refiner_loss"])
                    encoder_losses.update(ed_loss)
                    refiner_losses.update(r_loss)
                    n_itr = epoch_idx * n_batches + batch_idx
                    writer.add_scalar("EncoderDecoder/BatchLoss", ed_loss,
                                      n_itr)
                    writer.add_scalar("Refiner/BatchLoss", r_loss, n_itr)
                    batch_time.update(time.time() - t_end)
                    log.info("[Epoch %d/%d][Batch %d/%d] BatchTime = %.3f "
                             "(s) DataTime = %.3f (s) EDLoss = %.4f RLoss = "
                             "%.4f", epoch_idx + 1, cfg.TRAIN.NUM_EPOCHS,
                             batch_idx + 1, n_batches, batch_time.val,
                             data_time.val, ed_loss, r_loss)
                else:
                    batch_time.update(time.time() - t_end)
                t_end = time.time()
            trace.stop()  # an epoch shorter than the stop batch still writes
            writer.add_scalar("EncoderDecoder/EpochLoss", encoder_losses.avg,
                              epoch_idx + 1)
            writer.add_scalar("Refiner/EpochLoss", refiner_losses.avg,
                              epoch_idx + 1)
            log.info("[Epoch %d/%d] EpochTime = %.3f (s) EDLoss = %.4f "
                     "RLoss = %.4f", epoch_idx + 1, cfg.TRAIN.NUM_EPOCHS,
                     time.time() - epoch_start, encoder_losses.avg,
                     refiner_losses.avg)
            if cfg.TRAIN.UPDATE_N_VIEWS_RENDERING:
                n_views = int(np.random.default_rng(
                    np.random.SeedSequence([cfg.CONST.RNG_SEED, epoch_idx])
                ).integers(1, cfg.CONST.N_VIEWS_RENDERING + 1))
                train_loader.dataset.set_n_views(n_views)
                log.info("Updated #RenderingViews to %d", n_views)

            iou = evaluate(cfg, model, val_loader, taxonomies,
                           epoch_idx=epoch_idx + 1,
                           enable_merger=enable_merger,
                           enable_refiner=enable_refiner,
                           metrics_logger=val_writer)
            if (epoch_idx + 1) % cfg.TRAIN.SAVE_FREQ == 0 or iou > best_iou:
                file_name = f"checkpoint-epoch-{epoch_idx + 1:03d}.ckpt"
                if iou > best_iou:
                    best_iou, best_epoch = iou, epoch_idx
                    file_name = "checkpoint-best.ckpt"
                save_checkpoint(os.path.join(ckpt_dir, file_name), state,
                                epoch_idx, best_iou, best_epoch)
    finally:
        trace.stop()
        writer.close()
        val_writer.close()
    return best_iou


def test_net(cfg, epoch_idx: int = -1, weights: Optional[str] = None,
             device: Union[str, torch.device] = "cuda") -> float:
    """Evaluates the checkpoint on the test split; returns the max over
    thresholds of the mean IoU."""
    cfg.validate()
    require_one_device(cfg)
    model = SwinVoxModel.from_config(cfg)
    weights = weights or cfg.CONST.WEIGHTS
    if weights:
        load_checkpoint(weights, model)
    model.to(device)
    loader = build_loader(cfg, DatasetType.TEST)
    taxonomies = DATASET_INDEX_MAPPING[cfg.DATASET.TEST_DATASET](
        cfg).taxonomy_info()
    writer = MetricsLogger(os.path.join(_output_dir(cfg), "logs"), "test")
    try:
        return evaluate(cfg, model, loader, taxonomies, epoch_idx=epoch_idx,
                        enable_merger=cfg.NETWORK.USE_MERGER,
                        enable_refiner=cfg.NETWORK.USE_REFINER,
                        metrics_logger=writer)
    finally:
        writer.close()
        loader.close()
