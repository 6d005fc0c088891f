"""Learning-rate range test, the reference's find_lr (utils/lr_finder.py).

Counterpart of ``swinvox_tpu/train/lr_finder.py``: the learning rate
sweeps geometrically from ``LR_FINDER.START_LR`` to ``END_LR`` over at
most ``NUM_BATCHES_TO_TEST`` real training steps (the sweep is every
module's schedule, in float32 as the JAX schedule computes it); an EMA of
the total loss (``AVG_BETA``) with bias correction is kept, the sweep
stops when it exceeds 10x its best after step 10, and the suggestion is
the rate at the steepest fall of the smoothed loss against log10(lr)
before its minimum.  A loss-vs-rate plot is saved when matplotlib is
there (best effort, as in JAX).  The swept state is thrown away.

Dropout masks come from a generator seeded from ``(CONST.RNG_SEED + 7,
step)``; the model runs on ``cuda`` unless ``device`` names another.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Union

import numpy as np
import torch

from swinvox_tpu_torch.data.device_augment import (
    apply_device_augment,
    batch_to_host_dict,
)
from swinvox_tpu_torch.data.pipeline import build_loader
from swinvox_tpu_torch.data.taxonomy import DatasetType
from swinvox_tpu_torch.train.optim import MODULE_NAMES, ModuleOptimizer
from swinvox_tpu_torch.train.state import create_train_state, module_params
from swinvox_tpu_torch.train.steps import make_train_step

log = logging.getLogger(__name__)


def exponential_sweep(start: float, end: float, num_steps: int):
    """lr(step) = start * (end / start) ** min(step / (num_steps - 1), 1),
    in float32."""
    ratio = np.float32(end / start)
    denom = np.float32(max(num_steps - 1, 1))

    def schedule(step: int) -> float:
        frac = np.minimum(np.float32(step) / denom, np.float32(1.0))
        return float(np.float32(start) * ratio ** frac)

    return schedule


def _sweep_optimizers(cfg, num_steps: int):
    """The four modules' optimizers (clip, L2, Adam or SGD of
    ``cfg.TRAIN``) on the sweep, and the sweep."""
    schedule = exponential_sweep(cfg.LR_FINDER.START_LR, cfg.LR_FINDER.END_LR,
                                 num_steps)
    t = cfg.TRAIN
    return {name: ModuleOptimizer(t.POLICY, schedule, t.GRAD_CLIP_NORM,
                                  t.WEIGHT_DECAY, t.BETAS, t.MOMENTUM)
            for name in MODULE_NAMES}, schedule


def find_lr(cfg, plot_path: Optional[str] = None,
            device: Union[str, torch.device] = "cuda") -> float:
    """Runs the sweep on the train split; returns the suggested rate."""
    num_steps = cfg.LR_FINDER.NUM_BATCHES_TO_TEST
    beta = cfg.LR_FINDER.AVG_BETA
    device = torch.device(device)
    loader = build_loader(cfg, DatasetType.TRAIN)
    if len(loader) == 0:  # the sweep would wait for a batch forever
        raise ValueError("find_lr: the train split has no full batch")
    try:
        state, _ = create_train_state(cfg, steps_per_epoch=1, device=device)
        optimizers, schedule = _sweep_optimizers(cfg, num_steps)
        state.opt_states = {n: optimizers[n].init(module_params(state.model,
                                                                n))
                            for n in MODULE_NAMES}
        train_step = make_train_step(state.model, optimizers)
        generator = torch.Generator(device=device)
        lrs: List[float] = []
        losses: List[float] = []
        avg_loss, best_loss = 0.0, float("inf")
        step = 0
        stop = False
        while step < num_steps and not stop:
            loader.set_epoch(step // max(len(loader), 1))
            for batch in loader:
                lr = schedule(step)
                host = batch_to_host_dict(batch, cfg)
                images = apply_device_augment(host, cfg, device)
                generator.manual_seed(int(np.random.SeedSequence(
                    [cfg.CONST.RNG_SEED + 7, step]).generate_state(1)[0]))
                state, metrics = train_step(
                    state, images, host["volumes"], generator,
                    enable_merger=cfg.NETWORK.USE_MERGER,
                    enable_refiner=cfg.NETWORK.USE_REFINER)
                loss = float(metrics["total_loss"])
                avg_loss = beta * avg_loss + (1 - beta) * loss
                smoothed = avg_loss / (1 - beta ** (step + 1))
                lrs.append(lr)
                losses.append(smoothed)
                best_loss = min(best_loss, smoothed)
                if step > 10 and smoothed > 10 * best_loss:
                    log.info("Divergence at step %d (lr=%.2e); stopping.",
                             step, lr)
                    stop = True
                    break
                if step % 25 == 0:
                    log.info("lr_find step %d/%d lr=%.2e loss=%.4f", step,
                             num_steps, lr, smoothed)
                step += 1
                if step >= num_steps:
                    break
    finally:
        loader.close()

    suggestion = suggest_lr(lrs, losses)
    log.info("Suggested LR: %.3e", suggestion)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plot_path = plot_path or os.path.join(cfg.DIR.OUT_PATH,
                                              "lr_finder.png")
        os.makedirs(os.path.dirname(plot_path), exist_ok=True)
        fig, ax = plt.subplots()
        ax.plot(lrs, losses)
        ax.set_xscale("log")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("smoothed loss")
        ax.axvline(suggestion, color="r", linestyle="--",
                   label=f"suggested {suggestion:.2e}")
        ax.legend()
        fig.savefig(plot_path, dpi=120)
        plt.close(fig)
        log.info("Saved LR plot to %s", plot_path)
    except Exception as e:  # plotting is best-effort
        log.warning("Could not save LR plot: %s", e)
    return suggestion


def suggest_lr(lrs: List[float], losses: List[float]) -> float:
    """The rate at the steepest negative gradient of the smoothed loss
    against log10(lr), before the loss minimum (reference
    lr_finder.py:224-241)."""
    if len(lrs) < 3:
        return lrs[-1] if lrs else 1e-3
    losses_arr = np.asarray(losses)
    min_idx = int(np.argmin(losses_arr))
    if min_idx < 2:
        return lrs[min_idx]
    grads = np.gradient(losses_arr[:min_idx + 1],
                        np.log10(lrs[:min_idx + 1]))
    return lrs[int(np.argmin(grads))]
