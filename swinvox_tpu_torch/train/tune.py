"""Hyperparameter tuning, the reference's optuna_tune (utils/optuna_tune.py)
without optuna.

Counterpart of ``swinvox_tpu/train/tune.py``, the same study: each trial
copies the config, samples the search space (the reference's active
space is BATCH_SIZE in {32, 64}) with a TPE or random sampler on
``random.Random(seed)`` (the same draws as the JAX samplers), trains for
``n_epochs`` with validation each epoch, prunes against the median of the
completed trials at the same epoch, stops a hopeless trial (IoU < 0.2
after the grace epochs), and writes the best parameters to
``config_best.json``.  The default objective trains on ``cuda`` unless
``device`` names another.
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import math
import os
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

log = logging.getLogger(__name__)


# Search space: dotted config key -> a list of choices (categorical) or
# (low, high, "log" | "uniform").  The reference's shipped space: only
# BATCH_SIZE is active (optuna_tune.py:62-93).
DEFAULT_SEARCH_SPACE: Dict[str, Any] = {
    "CONST.BATCH_SIZE": [32, 64],
    # inactive in the reference; pass a space to tune() to search them:
    # "TRAIN.ENCODER_LEARNING_RATE": (1e-6, 1e-3, "log"),
    # "TRAIN.DECODER_LEARNING_RATE": (1e-6, 1e-3, "log"),
    # "TRAIN.REFINER_LEARNING_RATE": (1e-6, 1e-3, "log"),
    # "TRAIN.MERGER_LEARNING_RATE": (1e-6, 1e-3, "log"),
    # "TRAIN.GAMMA": (0.5, 0.99, "uniform"),
    # "TRAIN.WEIGHT_DECAY": (1e-6, 1e-3, "log"),
}


@dataclass
class Trial:
    number: int
    params: Dict[str, Any]
    values: List[float] = field(default_factory=list)  # IoU per epoch
    state: str = "RUNNING"  # COMPLETE | PRUNED | FAILED

    @property
    def best_value(self) -> float:
        return max(self.values) if self.values else -1.0


def _random_sample(space: Dict[str, Any],
                   rng: random.Random) -> Dict[str, Any]:
    params = {}
    for key, spec in space.items():
        if isinstance(spec, list):
            params[key] = rng.choice(spec)
        else:
            low, high, mode = spec
            if mode == "log":
                params[key] = math.exp(
                    rng.uniform(math.log(low), math.log(high)))
            else:
                params[key] = rng.uniform(low, high)
    return params


class TPESampler:
    """Tree-structured Parzen Estimator, the reference study's sampler
    (optuna's default, utils/optuna_tune.py:100-133): after ``n_startup``
    random trials, past trials split at the top ``gamma`` quantile of the
    objective (maximized) into good and bad; each dimension is modelled
    alone (a Gaussian KDE on a linear or log scale for floats,
    Laplace-smoothed frequencies for categoricals); ``n_ei_candidates``
    draws from the good model l(x), the one of largest l(x) / g(x) kept.
    """

    def __init__(self, seed: int = 0, n_startup: int = 3,
                 gamma: float = 0.25, n_ei_candidates: int = 24):
        self.rng = random.Random(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_ei = n_ei_candidates

    def _cat_weights(self, obs: List[Any], choices: List[Any]):
        counts = {c: 1.0 for c in choices}  # Laplace smoothing
        for o in obs:
            counts[o] = counts.get(o, 1.0) + 1.0
        total = sum(counts[c] for c in choices)
        return [counts[c] / total for c in choices]

    def _kde(self, obs: List[float], low: float, high: float):
        """A Gaussian mixture over the observations and a broad prior at
        the midpoint."""
        centers = list(obs) + [(low + high) / 2.0]  # prior at midpoint
        span = high - low
        n = len(centers)
        sigma = max(span / min(40.0, 2.0 + 2.0 * n), 1e-12)
        prior_sigma = span  # the midpoint component stays broad

        def pdf(x: float) -> float:
            acc = 0.0
            for i, c in enumerate(centers):
                s = prior_sigma if i == n - 1 else sigma
                z = (x - c) / s
                acc += math.exp(-0.5 * z * z) / s
            return acc / n

        def draw() -> float:
            i = self.rng.randrange(n)
            s = prior_sigma if i == n - 1 else sigma
            for _ in range(16):  # truncate to [low, high] by rejection
                x = self.rng.gauss(centers[i], s)
                if low <= x <= high:
                    return x
            return min(max(x, low), high)

        return pdf, draw

    def sample(self, space: Dict[str, Any], trials: List["Trial"]):
        scored = [t for t in trials if t.values]
        if len(scored) < self.n_startup:
            return _random_sample(space, self.rng)
        scored.sort(key=lambda t: t.best_value, reverse=True)  # maximize
        n_good = max(1, int(math.ceil(self.gamma * len(scored))))
        good, bad = scored[:n_good], scored[n_good:] or scored[-1:]

        params: Dict[str, Any] = {}
        for key, spec in space.items():
            g_obs = [t.params[key] for t in good if key in t.params]
            b_obs = [t.params[key] for t in bad if key in t.params]
            if isinstance(spec, list):
                wl = self._cat_weights(g_obs, spec)
                wg = self._cat_weights(b_obs, spec)
                cands = self.rng.choices(spec, weights=wl, k=self.n_ei)
                params[key] = max(
                    cands,
                    key=lambda c: wl[spec.index(c)] / wg[spec.index(c)],
                )
            else:
                low, high, mode = spec
                tr = math.log if mode == "log" else (lambda v: v)
                inv = math.exp if mode == "log" else (lambda v: v)
                lo, hi = tr(low), tr(high)
                l_pdf, l_draw = self._kde([tr(v) for v in g_obs], lo, hi)
                g_pdf, _ = self._kde([tr(v) for v in b_obs], lo, hi)
                cands = [l_draw() for _ in range(self.n_ei)]
                best = max(cands, key=lambda z: l_pdf(z) / (g_pdf(z) + 1e-300))
                params[key] = inv(best)
        return params


def _median_at_epoch(trials: List[Trial], epoch: int) -> Optional[float]:
    vals = [
        t.values[epoch]
        for t in trials
        if t.state == "COMPLETE" and len(t.values) > epoch
    ]
    if not vals:
        return None
    vals.sort()
    return vals[len(vals) // 2]


def tune(
    cfg,
    n_trials: int = 3,
    n_epochs: int = 20,
    search_space: Optional[Dict[str, Any]] = None,
    objective: Optional[Callable] = None,
    min_iou: float = 0.2,
    grace_epochs: int = 10,
    seed: int = 0,
    sampler: str = "tpe",
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Runs the study; returns {'best_params', 'best_value', 'trials'} and
    writes it to ``DIR.OUT_PATH/config_best.json``.

    ``objective(trial_cfg, n_epochs, report) -> best_iou`` defaults to a
    short real training run on ``device``; ``report(epoch, iou) ->
    should_prune`` prunes below the median of the completed trials at
    that epoch and stops a trial under ``min_iou`` after
    ``grace_epochs``.  sampler: "tpe" or "random".  A trial whose
    objective raises is marked FAILED and the study goes on.
    """
    space = search_space or DEFAULT_SEARCH_SPACE
    rng = random.Random(seed)
    tpe = TPESampler(seed=seed) if sampler == "tpe" else None
    trials: List[Trial] = []

    if objective is None:
        objective = functools.partial(_default_objective, device=device)

    for number in range(n_trials):
        params = (
            tpe.sample(space, trials) if tpe is not None
            else _random_sample(space, rng)
        )
        trial = Trial(number=number, params=params)
        trials.append(trial)
        trial_cfg = copy.deepcopy(cfg)
        trial_cfg.TRAIN.NUM_EPOCHS = n_epochs
        for key, value in params.items():
            trial_cfg.set(key, value)
        log.info("Trial %d params: %s", number, params)

        def report(epoch: int, iou: float) -> bool:
            trial.values.append(iou)
            median = _median_at_epoch(trials[:-1], epoch)
            if median is not None and iou < median:
                log.info(
                    "Trial %d pruned at epoch %d (iou %.4f < median %.4f)",
                    number, epoch, iou, median,
                )
                trial.state = "PRUNED"
                return True
            if epoch >= grace_epochs and iou < min_iou:
                log.info(
                    "Trial %d early-stopped at epoch %d (iou %.4f < %.2f)",
                    number, epoch, iou, min_iou,
                )
                trial.state = "PRUNED"
                return True
            return False

        try:
            objective(trial_cfg, n_epochs, report)
            if trial.state == "RUNNING":
                trial.state = "COMPLETE"
        except Exception:
            log.exception("Trial %d failed", number)
            trial.state = "FAILED"

    finished = [t for t in trials
                if t.state in ("COMPLETE", "PRUNED") and t.values]
    best = max(finished, key=lambda t: t.best_value) if finished else None
    result = {
        "best_params": best.params if best else {},
        "best_value": best.best_value if best else -1.0,
        "trials": [
            {"number": t.number, "params": t.params, "values": t.values,
             "state": t.state}
            for t in trials
        ],
    }
    out_dir = cfg.DIR.OUT_PATH
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "config_best.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    log.info("Best params %s (IoU %.4f) written to %s",
             result["best_params"], result["best_value"], out_path)
    return result


def _default_objective(trial_cfg, n_epochs: int, report,
                       device: Union[str, torch.device] = "cuda") -> float:
    """A short real training run validating each epoch (reference
    optuna_tune.py:292-363), with the merger and refiner gates of
    ``train_net``."""
    from swinvox_tpu_torch.data.device_augment import (
        apply_device_augment,
        batch_to_host_dict,
    )
    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import (
        DATASET_INDEX_MAPPING,
        DatasetType,
    )
    from swinvox_tpu_torch.train.evaluator import evaluate
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    device = torch.device(device)
    train_loader = build_loader(trial_cfg, DatasetType.TRAIN)
    val_loader = build_loader(trial_cfg, DatasetType.VAL)
    try:
        state, optimizers = create_train_state(
            trial_cfg, steps_per_epoch=max(1, len(train_loader)),
            device=device)
        model = state.model
        train_step = make_train_step(model, optimizers)
        taxonomies = DATASET_INDEX_MAPPING[trial_cfg.DATASET.TEST_DATASET](
            trial_cfg).taxonomy_info()
        generator = torch.Generator(device=device)
        best = -1.0
        for epoch in range(n_epochs):
            net, t = trial_cfg.NETWORK, trial_cfg.TRAIN
            enable_merger = (net.USE_MERGER
                             and epoch >= t.EPOCH_START_USE_MERGER)
            enable_refiner = (net.USE_REFINER
                              and epoch >= t.EPOCH_START_USE_REFINER)
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                host = batch_to_host_dict(batch, trial_cfg)
                images = apply_device_augment(host, trial_cfg, device)
                generator.manual_seed(int(np.random.SeedSequence(
                    [trial_cfg.CONST.RNG_SEED + 13, state.step]
                ).generate_state(1)[0]))
                state, _ = train_step(state, images, host["volumes"],
                                      generator, enable_merger=enable_merger,
                                      enable_refiner=enable_refiner)
            iou = evaluate(trial_cfg, model, val_loader, taxonomies,
                           epoch_idx=epoch, print_tables=False,
                           enable_merger=enable_merger,
                           enable_refiner=enable_refiner)
            best = max(best, iou)
            if report(epoch, iou):
                break
        return best
    finally:
        train_loader.close()
        val_loader.close()
