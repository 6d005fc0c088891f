"""Checkpoint files: the JAX package's flax-msgpack format, read and
written without flax.

Counterpart of ``swinvox_tpu/train/checkpoint.py``.  A file is the msgpack
of ``{"meta": ..., "state": ...}``:

  * full training checkpoint: meta ``{epoch_idx, best_iou, best_epoch}``,
    state ``{params, batch_stats, opt_states, step}``;
  * params-only export: meta ``{"format": "params-only"}``, state
    ``{params, batch_stats}``.

``load_checkpoint`` copies the weights and BatchNorm statistics of either
into a port model through ``convert.load_jax_variables`` (bfloat16 leaves
widen exactly to the model's float32); the optimizer state and step of a
full checkpoint are left unread, as the JAX ``test_net`` leaves them
(``restore_optimizer=False``); resuming training from one comes with
``train_net``.  ``save_params_only`` writes the params-only format from a
port model, readable by the JAX package's ``load_checkpoint``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import torch
from torch import nn

from swinvox_tpu_torch.convert import jax_variables, load_jax_variables
from swinvox_tpu_torch.utils import flax_msgpack

log = logging.getLogger(__name__)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # bfloat16 leaves
        return tree.float().numpy()
    return tree


def load_checkpoint(path: str, model: nn.Module) -> Dict[str, Any]:
    """Loads a full or params-only JAX checkpoint's weights into ``model``;
    returns the file's meta."""
    with open(path, "rb") as f:
        blob = flax_msgpack.unpackb(f.read())
    state = blob["state"]
    load_jax_variables(model, {"params": _numpy(state["params"]),
                               "batch_stats": _numpy(state["batch_stats"])})
    meta = blob["meta"]
    if meta.get("format") == "params-only":
        log.info("Restored params-only checkpoint %s", path)
    else:
        log.info("Restored the weights of checkpoint %s: epoch %d, best IoU "
                 "%.4f @ epoch %d", path, meta["epoch_idx"], meta["best_iou"],
                 meta["best_epoch"])
    return meta


def save_params_only(path: str, model: nn.Module) -> None:
    """Writes the model's weights and BatchNorm statistics as a
    params-only checkpoint (atomically: a temporary, then a rename)."""
    blob = flax_msgpack.packb({"meta": {"format": "params-only"},
                          "state": jax_variables(model)})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    log.info("Saved params-only checkpoint to %s (%.1f MB)", path,
             len(blob) / 1e6)
