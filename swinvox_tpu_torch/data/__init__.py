"""Host-side data: image files in (eval transform), binvox in and out,
and the ShapeNet test split.

Counterparts of ``swinvox_tpu.data.pipeline.load_image_bgr`` and
``swinvox_tpu.data.transforms.eval_transform`` (here), ``data/binvox.py``
(the binvox codec), ``data/taxonomy.py`` (the ShapeNet index),
``data/pipeline.py`` (the test loader) and ``data/synthetic.py`` (the
ShapeNet-format fixture), in plain numpy and PIL (the JAX package's
optional C codecs are not ported; the results are the same, see
``tests/test_torch_serve.py`` and ``tests/test_torch_eval.py``).
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np

from swinvox_tpu_torch.data.binvox import write_binvox

__all__ = ["eval_transform", "load_image_bgr", "write_binvox"]


def load_image_bgr(path: str) -> np.ndarray:
    """Decode an image file to float32 BGR(A) in [0, 1], as
    ``cv2.imread(IMREAD_UNCHANGED) / 255``: alpha kept, grayscale stacked
    to 3 channels."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    with Image.open(io.BytesIO(data)) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        elif im.mode == "LA":
            im = im.convert("RGBA")
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = arr.astype(np.float32) / 255.0
    if arr.shape[-1] == 4:
        return arr[..., [2, 1, 0, 3]]
    return arr[..., ::-1]


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize of an HWC array (cv2 INTER_LINEAR)."""
    in_h, in_w = img.shape[:2]
    img = img.astype(np.float32, copy=False)
    if (in_h, in_w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (in_h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (in_w / out_w) - 0.5
    ys = np.clip(ys, 0.0, in_h - 1.0)
    xs = np.clip(xs, 0.0, in_w - 1.0)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (ys - y0).astype(np.float32)[:, None, None]
    wx = (xs - x0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _crop_window(img: np.ndarray, bbox: Optional[Sequence[float]],
                 crop_h: int, crop_w: int) -> np.ndarray:
    """The center crop, or the square around a normalized bbox with edge
    padding where it leaves the image."""
    ih, iw = img.shape[:2]
    if bbox is None:
        if ih > crop_h and iw > crop_w:
            t, l = (ih - crop_h) // 2, (iw - crop_w) // 2
            return img[t:t + crop_h, l:l + crop_w]
        return img
    x0, y0, x1, y1 = bbox[0] * iw, bbox[1] * ih, bbox[2] * iw, bbox[3] * ih
    size = max(x1 - x0, y1 - y0)
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    left, right = int(cx - size * 0.5), int(cx + size * 0.5)
    top, bottom = int(cy - size * 0.5), int(cy + size * 0.5)
    pads = ((max(-top, 0), max(bottom - ih + 1, 0)),
            (max(-left, 0), max(right - iw + 1, 0)), (0, 0))
    out = img[max(top, 0):min(bottom, ih - 1) + 1,
              max(left, 0):min(right, iw - 1) + 1]
    if any(p for pair in pads for p in pair):
        out = np.pad(out, pads, mode="edge")
    return out


def eval_transform(images: np.ndarray, cfg,
                   bounding_box: Optional[Sequence[float]] = None
                   ) -> np.ndarray:
    """[N, H, W, 3|4] BGR(A) in [0, 1] -> [N, IMG_H, IMG_W, 3] normalized:
    crop and resize, composite the eval background color where alpha is
    0, then (x - MEAN) / STD."""
    c = cfg.CONST
    x = np.stack([
        _resize_bilinear(_crop_window(img, bounding_box, c.CROP_IMG_H,
                                      c.CROP_IMG_W), c.IMG_H, c.IMG_W)
        for img in images
    ])
    if x.shape[-1] == 4:
        ranges = cfg.TEST.RANDOM_BG_COLOR_RANGE
        if any(lo != hi for lo, hi in ranges):
            raise ValueError("eval background color range must be fixed, "
                             f"got {ranges}")
        color = np.array([lo for lo, _ in ranges], np.float32) / 255.0
        bg = (x[..., 3:4] == 0).astype(np.float32)
        x = bg * color + (1.0 - bg) * x[..., :3]
    mean = np.asarray(cfg.DATASET.MEAN, np.float32)
    std = np.asarray(cfg.DATASET.STD, np.float32)
    return np.ascontiguousarray((x - mean) / std, np.float32)
