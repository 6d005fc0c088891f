"""Checkpoint files: the JAX package's flax-msgpack format, read and
written without flax.

Counterpart of ``swinvox_tpu/train/checkpoint.py``.  A file is the msgpack
of ``{"meta": ..., "state": ...}``:

  * full training checkpoint: meta ``{epoch_idx, best_iou, best_epoch}``,
    state ``{params, batch_stats, opt_states, step}``
    (``convert.jax_train_state`` has the layout);
  * params-only export: meta ``{"format": "params-only"}``, state
    ``{params, batch_stats}``.

``save_checkpoint`` writes the full form from the port's ``TrainState``
and ``save_params_only`` the export from a model, atomically (a
temporary, then a rename); the JAX ``load_checkpoint`` reads both.
``load_checkpoint`` reads either package's files: into a model, the
weights and BatchNorm statistics (bfloat16 leaves widen exactly to
float32); into a ``TrainState``, also the optimizer states and the step
of a full checkpoint (``restore_optimizer``), as the JAX one does, and
only the weights of a params-only file.  ``export_params_only`` turns a
full file into an export without a model:

    python -m swinvox_tpu_torch.train.checkpoint full.ckpt params.ckpt
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict

import torch
from torch import nn

from swinvox_tpu_torch.convert import (
    jax_train_state,
    jax_variables,
    load_jax_train_state,
    load_jax_variables,
)
from swinvox_tpu_torch.utils import flax_msgpack

log = logging.getLogger(__name__)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # bfloat16 leaves
        return tree.float().numpy()
    return tree


def _write(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _read(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return flax_msgpack.unpackb(f.read())


def load_checkpoint(path: str, target, restore_optimizer: bool = True
                    ) -> Dict[str, Any]:
    """Loads a full or params-only checkpoint of either package into
    ``target``, a model (weights and BatchNorm statistics) or a
    ``TrainState`` (also the optimizer states and step of a full file,
    unless ``restore_optimizer`` is false); returns the file's meta."""
    blob = _read(path)
    state, meta = _numpy(blob["state"]), blob["meta"]
    model = target if isinstance(target, nn.Module) else target.model
    full = meta.get("format") != "params-only"
    if full and restore_optimizer and not isinstance(target, nn.Module):
        load_jax_train_state(target, state)
    else:
        load_jax_variables(model, {"params": state["params"],
                                   "batch_stats": state["batch_stats"]})
        if full and not isinstance(target, nn.Module):
            target.step = int(state["step"])  # as the JAX one restores it
    if full:
        log.info("Restored checkpoint %s: epoch %d, best IoU %.4f @ epoch "
                 "%d", path, meta["epoch_idx"], meta["best_iou"],
                 meta["best_epoch"])
    else:
        log.info("Restored params-only checkpoint %s", path)
    return meta


def save_checkpoint(path: str, state, epoch_idx: int, best_iou: float,
                    best_epoch: int) -> None:
    """Writes the full training checkpoint of the port's ``TrainState``."""
    meta = {"epoch_idx": int(epoch_idx), "best_iou": float(best_iou),
            "best_epoch": int(best_epoch)}
    blob = flax_msgpack.packb({"meta": meta, "state": jax_train_state(state)})
    _write(path, blob)
    log.info("Saved checkpoint to %s (%.1f MB)", path, len(blob) / 1e6)


def save_params_only(path: str, model: nn.Module) -> None:
    """Writes the model's weights and BatchNorm statistics as a
    params-only checkpoint."""
    blob = flax_msgpack.packb({"meta": {"format": "params-only"},
                               "state": jax_variables(model)})
    _write(path, blob)
    log.info("Saved params-only checkpoint to %s (%.1f MB)", path,
             len(blob) / 1e6)


def export_params_only(src_path: str, dst_path: str) -> None:
    """Converts a full checkpoint file into a params-only export (drops the
    optimizer states and the step; no model needed)."""
    state = _read(src_path)["state"]
    blob = flax_msgpack.packb({
        "meta": {"format": "params-only"},
        "state": {"params": state["params"],
                  "batch_stats": state["batch_stats"]}})
    _write(dst_path, blob)
    log.info("Exported params-only checkpoint %s (%.1f MB) from %s",
             dst_path, len(blob) / 1e6, src_path)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print("usage: python -m swinvox_tpu_torch.train.checkpoint "
              "<full.ckpt> <params-only.ckpt>", file=sys.stderr)
        sys.exit(2)
    logging.basicConfig(level=logging.INFO)
    export_params_only(sys.argv[1], sys.argv[2])
