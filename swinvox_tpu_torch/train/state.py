"""Train state: the model (parameters and BatchNorm statistics), the four
modules' optimizer states and the global step.

Counterpart of ``swinvox_tpu/train/state.py``.  The JAX state is an
immutable tree; here the model's tensors and the optimizer states are
updated in place by each step (no second copy of 84 M parameters and
their moments), and the step returns the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from swinvox_tpu_torch.models.swinvox import SwinVoxModel
from swinvox_tpu_torch.train.optim import (
    MODULE_NAMES,
    ModuleOptimizer,
    build_optimizers,
)


def module_params(model: SwinVoxModel, name: str) -> Dict[str, torch.Tensor]:
    """The parameters of one module group, by their full model names
    (empty when the model has no such module)."""
    if not hasattr(model, name):
        return {}
    return {f"{name}.{n}": p
            for n, p in getattr(model, name).named_parameters()}


@dataclass
class TrainState:
    model: SwinVoxModel
    opt_states: Dict[str, dict]
    step: int = 0


def create_train_state(
    cfg,
    generator: Optional[torch.Generator] = None,
    steps_per_epoch: int = 1,
    device=None,
) -> Tuple[TrainState, Dict[str, ModuleOptimizer]]:
    """The model ``cfg`` describes, initialized from ``generator`` (a CPU
    generator; default seeded with ``cfg.CONST.RNG_SEED``), on ``device``
    (default ``cuda``), with zeroed optimizer states and step 0, and the
    four optimizers.  Every module exists whether or not its epoch gate is
    open, so the state keeps one layout through training.  With
    ``NETWORK.PRETRAINED_BACKBONE`` a directory, its ``resnet50.*`` and
    ``swin_tiny.*`` weights (``.npz``, ``.pth`` or ``.pt``) are grafted
    onto the encoder before the optimizer states are made, as in JAX
    (``models/pretrained.py``)."""
    device = torch.device("cuda" if device is None else device)
    model = SwinVoxModel.from_config(cfg, generator)
    if cfg.NETWORK.PRETRAINED_BACKBONE:
        from swinvox_tpu_torch.models.pretrained import (
            apply_pretrained_backbone,
            backbone_files,
            load_state_dict_file,
        )

        resnet, swin = backbone_files(cfg.NETWORK.PRETRAINED_BACKBONE)
        apply_pretrained_backbone(
            model, resnet_sd=resnet and load_state_dict_file(resnet),
            swin_sd=swin and load_state_dict_file(swin))
    model = model.to(device)
    optimizers = build_optimizers(cfg, steps_per_epoch)
    opt_states = {name: optimizers[name].init(module_params(model, name))
                  for name in MODULE_NAMES}
    return TrainState(model, opt_states, 0), optimizers
