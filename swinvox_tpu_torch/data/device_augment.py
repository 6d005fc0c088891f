"""Training and evaluation augmentation on the card, from raw pixels.

Counterpart of ``swinvox_tpu/data/device_augment.py``.  Under
``TRAIN.DEVICE_AUGMENT`` the loader decodes only and ships each batch's
raw renders as uint8 (4x fewer bytes than float32) with the parameters
``transforms.draw_train_params`` (train split) or ``draw_eval_params``
(the others) drew from the sample's own generator, in the host
pipeline's order, so the card reproduces the host augmentation:

  * the center crop is a slice, and crop + bilinear resize become two
    separable float32 matmuls (``_resize_matrix``: the host resize's
    taps and weights), with TF32 off;
  * the background composite is one select where the resized alpha is 0;
  * jitter, noise, normalization and channel permutation are one affine
    map ``y = A x + B x_bar + v`` per sample (``fold_color_affine``);
  * the per-view left-right flip is one select.

Stock torch ops, as the JAX package computes it from stock ops (no
Pallas kernel).  ``apply_device_augment`` is the one place that knows
the parameters' order: the trainer, the evaluator, the LR finder and the
tuner call it on ``batch_to_host_dict``'s dict.  Sources with a bounding
box and ``DIR.RANDOM_BG_PATH`` stay on the host transform
(``data/pipeline.py``).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] half-pixel bilinear interpolation matrix (2 taps a row),
    the taps and weights of ``transforms.resize_bilinear``."""
    m = np.zeros((out_size, in_size), np.float32)
    xs = (np.arange(out_size, dtype=np.float32) + 0.5) * (
        in_size / out_size) - 0.5
    xs = np.clip(xs, 0.0, in_size - 1.0)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, in_size - 1)
    wx = xs - x0
    m[np.arange(out_size), x0] += 1.0 - wx
    m[np.arange(out_size), x1] += wx
    return m


@contextlib.contextmanager
def _full_f32():
    """float32 matmuls without TF32 (the caller's setting restored)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def device_train_augment(raw: torch.Tensor, bg_color: torch.Tensor,
                         color_A: torch.Tensor, color_B: torch.Tensor,
                         color_v: torch.Tensor, flips: torch.Tensor,
                         img_size: int = 224, crop_size: int = 128
                         ) -> torch.Tensor:
    """raw [B, N, H, W, 3|4] BGR(A), uint8 or float32 in [0, 1] ->
    [B, N, S, S, 3] float32, on raw's device.  Per-sample parameters
    stacked on the batch axis: bg_color [B, 3], color_A/B [B, 3, 3],
    color_v [B, 3], flips [B, N]."""
    b, n, h, w, c = raw.shape
    dev = raw.device
    x = raw.to(torch.float32)
    if raw.dtype == torch.uint8:
        # the loader's uint8 is round(x * 255) of 8-bit sources: this
        # recovers the decoder's floats exactly
        x = x * (1.0 / 255.0)
    if h > crop_size and w > crop_size:  # the reference crops only then
        t, left = (h - crop_size) // 2, (w - crop_size) // 2
        x = x[:, :, t:t + crop_size, left:left + crop_size]
    ch, cw = x.shape[2], x.shape[3]
    f32 = {"device": dev, "dtype": torch.float32}
    bg_color, color_A, color_B, color_v = (
        torch.as_tensor(t).to(**f32)
        for t in (bg_color, color_A, color_B, color_v))
    flips = torch.as_tensor(flips).to(dev)
    with _full_f32():
        if (ch, cw) != (img_size, img_size):
            wy = torch.from_numpy(_resize_matrix(ch, img_size)).to(**f32)
            wx = torch.from_numpy(_resize_matrix(cw, img_size)).to(**f32)
            x = torch.einsum("oh,bnhwc->bnowc", wy, x)
            x = torch.einsum("pw,bnowc->bnopc", wx, x)
        # the background where the RESIZED alpha is 0, as the host
        # pipeline composites after crop and resize
        if c == 4:
            alpha0 = (x[..., 3:4] == 0.0).to(torch.float32)
            x = (alpha0 * bg_color[:, None, None, None, :]
                 + (1.0 - alpha0) * x[..., :3])
        xbar = x.mean(dim=(2, 3))  # [B, N, 3]
        y = torch.einsum("bnhwc,bdc->bnhwd", x, color_A)
        y = y + torch.einsum("bnc,bdc->bnd", xbar,
                             color_B)[:, :, None, None, :]
        y = y + color_v[:, None, None, None, :]
    flip = (flips > 0)[:, :, None, None, None]
    return torch.where(flip, y.flip(3), y)


def apply_device_augment(batch: dict, cfg, device=None):
    """The model-ready images of a ``batch_to_host_dict`` dict: the
    augmentation on ``device`` (default ``cuda``) when the ``aug_*``
    parameters are there, else ``batch["images"]`` as it is."""
    if "aug_bg_color" not in batch:
        return batch["images"]
    dev = torch.device("cuda" if device is None else device)
    raw = torch.from_numpy(np.ascontiguousarray(batch["images"])).to(dev)
    return device_train_augment(
        raw, *(torch.from_numpy(np.ascontiguousarray(batch[f"aug_{k}"]))
               for k in ("bg_color", "color_A", "color_B", "color_v",
                         "flips")),
        cfg.CONST.IMG_H, cfg.CONST.CROP_IMG_H)


def batch_to_host_dict(b, cfg) -> dict:
    """A pipeline Batch as the dict every feeder ships: ``images``,
    ``volumes`` as uint8 (binary occupancy, 4x fewer bytes than float32;
    the steps cast back) and, when the loader augments on the card, the
    ``aug_*`` parameters (``Batch.aug`` is None when a source fell back to
    the host transform)."""
    vol = b.volumes
    if vol.dtype != np.uint8:
        vol = vol.astype(np.uint8)
    host = {"images": b.images, "volumes": vol}
    if b.aug is not None:
        for k, v in b.aug.items():
            host[f"aug_{k}"] = v
    return host
