"""The training and evaluation steps.

Counterpart of ``make_train_step`` and ``make_eval_step`` in
``swinvox_tpu/train/steps.py``.  The training step (the reference's
batch loop, core/train.py:216-314): clip the images to
[-1, 1], take binary volumes as uint8 or float, run the model in training
mode, loss = BCE(merged) + BCE(refined) (the refiner's term only while
the refiner's gate is open), one backward, then each active module's
optimizer update.  A module whose gate is closed is skipped exactly: its
moments, decay and parameters stay untouched.

With ``grad_accum_steps`` > 1 the batch is split into that many
micro-batches run in turn: gradients and losses are averaged, and the
BatchNorm statistics advance once per micro-batch, as in JAX.

Dropout and drop-path masks come from the ``generator`` the caller
passes (on the model's device); the JAX step folds the step number into
its key instead, and the two frameworks' draws never match.

The step repeats its own bits, as the JAX package's XLA step does: from
one state, batch and generator state, two steps give the same gradients,
moments and weights, so a resumed run continues what an uninterrupted
one would.  Each forward and backward runs with cuDNN restricted to its
deterministic algorithms (the backward of a conv otherwise picks
algorithms that sum in a varying order), and the relative-position bias
table's gradient is a fixed-order sum (``models/swin._TableGather``);
the port's kernels sum in fixed orders.  The cuDNN flags are set for the
step and restored after it.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from swinvox_tpu_torch.ops.losses import (
    bce_with_logits,
    bce_with_logits_per_sample,
    voxel_fscore,
    voxel_iou,
)
from swinvox_tpu_torch.train.optim import MODULE_NAMES, ModuleOptimizer
from swinvox_tpu_torch.train.state import TrainState, module_params
from swinvox_tpu_torch.utils.cudnn import cudnn_deterministic


def loss_and_grads(model, images: torch.Tensor, volumes: torch.Tensor,
                   generator: torch.Generator, enable_merger: bool,
                   enable_refiner: bool, scale: float = 1.0):
    """One forward in training mode (advancing the BatchNorm statistics)
    and one backward of ``scale`` x the loss, adding into the parameters'
    ``.grad``, both with cuDNN's deterministic algorithms (the caller's
    cuDNN flags restored after).  Returns the encoder and refiner losses
    (0-dim tensors)."""
    with cudnn_deterministic():
        out = model(images, train=True, enable_merger=enable_merger,
                    enable_refiner=enable_refiner, generator=generator)
        encoder_loss = bce_with_logits(out["merged_volumes"], volumes)
        if enable_refiner:
            refiner_loss = bce_with_logits(out["refined_volumes"], volumes)
            total = encoder_loss + refiner_loss
        else:
            refiner_loss = encoder_loss
            total = encoder_loss
        (total * scale).backward()
    return encoder_loss.detach(), refiner_loss.detach()


def gradients(model) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient by name; zeros where none flowed (an
    unused branch has an exactly zero gradient, as in JAX)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def make_train_step(model, optimizers: Dict[str, ModuleOptimizer],
                    grad_accum_steps: int = 1) -> Callable:
    """Returns ``train_step(state, images, volumes, generator,
    enable_merger=True, enable_refiner=True) -> (state, metrics)``.

    ``images`` [B, N, H, W, 3] float, ``volumes`` [B, 32, 32, 32] {0, 1}
    (uint8 or float), tensors or numpy arrays; they are moved to the
    model's device.  ``state`` is updated in place and returned; metrics
    are 0-dim float32 tensors on the device (``encoder_loss``,
    ``refiner_loss``, ``total_loss``).  Until the next step, the step's
    averaged gradients stay in the parameters' ``.grad``
    (``gradients(model)``).
    """

    def train_step(state: TrainState, images, volumes,
                   generator: torch.Generator, enable_merger: bool = True,
                   enable_refiner: bool = True
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        dev = next(model.parameters()).device
        images = torch.as_tensor(images).to(dev, torch.float32).clamp(-1, 1)
        volumes = torch.as_tensor(volumes).to(dev).float().clamp(0, 1)
        model.zero_grad(set_to_none=True)
        b = images.shape[0]
        if b % grad_accum_steps:
            raise ValueError(f"batch {b} not divisible by grad_accum_steps "
                             f"{grad_accum_steps}")
        micro = b // grad_accum_steps
        inv = 1.0 / grad_accum_steps
        enc = ref = 0.0
        for i in range(grad_accum_steps):
            sl = slice(i * micro, (i + 1) * micro)
            el, rl = loss_and_grads(model, images[sl], volumes[sl], generator,
                                    enable_merger, enable_refiner, inv)
            enc, ref = enc + el, ref + rl
        enc, ref = enc * inv, ref * inv
        grads = gradients(model)
        active = {
            "encoder": True,
            "decoder": True,
            "merger": enable_merger and model.use_merger,
            "refiner": enable_refiner and model.use_refiner,
        }
        for name in MODULE_NAMES:
            if not active[name]:
                continue  # exactly like the reference's skipped step
            params = module_params(model, name)
            optimizers[name].apply(params, {n: grads[n] for n in params},
                                   state.opt_states[name],
                                   optimizers[name].schedule(state.step))
        state.step += 1
        metrics = {"encoder_loss": enc, "refiner_loss": ref,
                   "total_loss": enc + (ref if enable_refiner else 0.0)}
        return state, metrics

    return train_step


def make_eval_step(model, thresholds: Tuple[float, ...] = (0.2, 0.3, 0.4,
                                                             0.5)
                   ) -> Callable:
    """Returns ``eval_step(images, volumes, enable_merger=True,
    enable_refiner=True) -> per-sample metrics`` (the reference's
    core/test.py:114-164): images clipped to [-1, 1] and volumes to
    [0, 1], the model in eval mode, per-sample BCE x 10 of the merged and
    (with the refiner) the refined logits, sigmoid, then at each
    threshold the IoU (1 where the union is empty) and the F-score.

    Inputs are tensors or numpy arrays, moved to the model's device;
    outputs are tensors there: ``encoder_loss``, ``refiner_loss`` [B],
    ``iou``, ``fscore`` [B, len(thresholds)] and ``probs`` [B, 32, 32, 32]
    float32.  cuDNN runs deterministic algorithms for the forward, as in
    ``Predictor``.
    """

    @torch.inference_mode()
    def eval_step(images, volumes, enable_merger: bool = True,
                  enable_refiner: bool = True) -> Dict[str, torch.Tensor]:
        dev = next(model.parameters()).device
        images = torch.as_tensor(images).to(dev, torch.float32).clamp(-1, 1)
        volumes = torch.as_tensor(volumes).to(dev).float().clamp(0, 1)
        with cudnn_deterministic():
            out = model(images, train=False, enable_merger=enable_merger,
                        enable_refiner=enable_refiner)
        encoder_loss = bce_with_logits_per_sample(out["merged_volumes"],
                                                  volumes) * 10.0
        if enable_refiner:
            final = out["refined_volumes"]
            refiner_loss = bce_with_logits_per_sample(final, volumes) * 10.0
        else:
            final = out["merged_volumes"]
            refiner_loss = encoder_loss
        probs = torch.sigmoid(final.float())
        return {
            "encoder_loss": encoder_loss,
            "refiner_loss": refiner_loss,
            "iou": voxel_iou(probs, volumes, thresholds),
            "fscore": voxel_fscore(probs, volumes, thresholds),
            "probs": probs,
        }

    return eval_step
