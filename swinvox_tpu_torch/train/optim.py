"""Per-module optimizers with the JAX package's math.

Counterpart of ``swinvox_tpu/train/optim.py``: each of the four modules
(encoder, decoder, merger, refiner) has its own optimizer, learning rate
and MultiStepLR schedule, and per update, in this order:

  1. clip by the module's global norm: g if norm < max else g / norm * max
     (optax ``clip_by_global_norm``: no +1e-6, so not ``clip_grad_norm_``);
  2. L2 on the gradient: u = g + weight_decay * p;
  3. Adam with the bias correction on the incremented count and eps 1e-8
     outside the square root (optax ``scale_by_adam``), or SGD with
     momentum t = u + momentum * t (optax ``trace``);
  4. p = p - lr * update, lr from the schedule at the GLOBAL step, so a
     module whose updates are gated off still decays at its milestones.

The update runs in place on the parameters and the state, with
``torch._foreach_*`` ops (one launch per op for all of a module's
tensors); the clip decision reads the norm on the host, once per module.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

MODULE_NAMES = ("encoder", "decoder", "merger", "refiner")


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 steps_per_epoch: int):
    """MultiStepLR: lr(step) = base * gamma^(milestones reached), a
    milestone reached at step >= epoch * steps_per_epoch (optax
    ``piecewise_constant_schedule``, milestones <= 0 ignored)."""
    bounds = [int(m) * int(steps_per_epoch) for m in milestones if m > 0]

    def schedule(step: int) -> float:
        lr = np.float32(base_lr)
        for b in bounds:
            if step >= b:
                lr = lr * np.float32(gamma)
        return float(lr)

    return schedule


class ModuleOptimizer:
    """One module's update: clip, L2, Adam or SGD, with its schedule."""

    def __init__(self, policy: str, schedule, clip_norm: float,
                 weight_decay: float, betas=(0.9, 0.999),
                 momentum: float = 0.9):
        if policy not in ("adam", "sgd"):
            raise ValueError(f"Unknown optimizer policy {policy!r}")
        self.policy, self.schedule = policy, schedule
        self.clip_norm, self.weight_decay = clip_norm, weight_decay
        self.betas, self.momentum = tuple(betas), momentum

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        if self.policy == "adam":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        return {"trace": zeros()}

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: dict, lr: float) -> None:
        """Updates ``params`` and ``state`` in place."""
        names = list(params)
        if not names:
            return
        p = [params[n] for n in names]
        g = [grads[n].float() for n in names]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(t) for t in g]))
        if not bool(norm < self.clip_norm):
            g = torch._foreach_div(g, norm)
            torch._foreach_mul_(g, self.clip_norm)
        u = torch._foreach_add(g, p, alpha=self.weight_decay)
        if self.policy == "sgd":
            t = [state["trace"][n] for n in names]
            torch._foreach_mul_(t, self.momentum)
            torch._foreach_add_(t, u)
            torch._foreach_add_(p, t, alpha=-lr)
            return
        b1, b2 = self.betas
        count = state["count"] + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, u, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, u, u, value=1.0 - b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        step = torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(p, step, alpha=-lr)
        state["count"] = count


def build_optimizers(cfg, steps_per_epoch: int) -> Dict[str, ModuleOptimizer]:
    """One optimizer per module, from ``cfg.TRAIN``."""
    t = cfg.TRAIN
    spec = {
        "encoder": (t.ENCODER_LEARNING_RATE, t.ENCODER_LR_MILESTONES),
        "decoder": (t.DECODER_LEARNING_RATE, t.DECODER_LR_MILESTONES),
        "merger": (t.MERGER_LEARNING_RATE, t.MERGER_LR_MILESTONES),
        "refiner": (t.REFINER_LEARNING_RATE, t.REFINER_LR_MILESTONES),
    }
    return {
        name: ModuleOptimizer(
            t.POLICY, multistep_lr(lr, ms, t.GAMMA, steps_per_epoch),
            t.GRAD_CLIP_NORM, t.WEIGHT_DECAY, t.BETAS, t.MOMENTUM)
        for name, (lr, ms) in spec.items()
    }
