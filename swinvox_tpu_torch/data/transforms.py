"""Host image transforms: the train pipeline and the eval transform.

Counterpart of ``swinvox_tpu/data/transforms.py`` (the numpy path; the JAX
package's optional C resize is not ported): every random draw comes from
the caller's ``np.random.Generator``, in the JAX package's order, so the
same generator gives the same batch bit for bit
(``tests/test_torch_train_net.py``).  Images are float32 BGR(A) in
[0, 1], [N, H, W, C] stacks of one sample's views.

The train pipeline (reference core/train.py:44-53): crop (a jittered
square around the bounding box when there is one, else the center crop)
and resize, a random background where alpha is 0 (one color for all
views, or per view a coin flip for the background image), color jitter
(brightness, contrast and saturation in a random order, one draw for all
views), PCA noise, normalization, a left-right flip per view, and one
channel permutation for all views.

``draw_train_params`` and ``draw_eval_params`` draw the same random
numbers as the train and eval pipelines, in the same order, without
touching a pixel: the parameters of ``data/device_augment.py``, which
applies the pipeline on the card.  ``fold_color_affine`` composes the
jitter, the noise, the normalization and the channel permutation into
one per-sample affine map of the pixel and its view's mean.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
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


# ---------------------------------------------------------------- crops


def _square_crop_bounds(bbox: Sequence[float], img_h: int, img_w: int,
                        rng: Optional[np.random.Generator]
                        ) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) of the square around a normalized bbox,
    jittered when ``rng`` is given."""
    x0, y0 = bbox[0] * img_w, bbox[1] * img_h
    x1, y1 = bbox[2] * img_w, bbox[3] * img_h
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    size = max(x1 - x0, y1 - y0)
    if rng is not None:
        size = size * rng.uniform(0.8, 1.2)
        left = int(cx - size * rng.uniform(0.4, 0.6))
        right = int(cx + size * rng.uniform(0.4, 0.6))
        top = int(cy - size * rng.uniform(0.4, 0.6))
        bottom = int(cy + size * rng.uniform(0.4, 0.6))
    else:
        left, right = int(cx - size * 0.5), int(cx + size * 0.5)
        top, bottom = int(cy - size * 0.5), int(cy + size * 0.5)
    return left, right, top, bottom


def _crop_with_edge_pad(img: np.ndarray, left: int, right: int, top: int,
                        bottom: int) -> np.ndarray:
    """img[top:bottom+1, left:right+1], edge-padded where the window
    leaves the image."""
    ih, iw = img.shape[:2]
    pads = ((max(-top, 0), max(bottom - ih + 1, 0)),
            (max(-left, 0), max(right - iw + 1, 0)), (0, 0))
    out = img[max(top, 0):min(bottom, ih - 1) + 1,
              max(left, 0):min(right, iw - 1) + 1]
    if any(p for pair in pads for p in pair):
        out = np.pad(out, pads, mode="edge")
    return out


def crop_images(images: np.ndarray, img_size: Tuple[int, int],
                crop_size: Tuple[int, int],
                bounding_box: Optional[Sequence[float]] = None,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Center crop (``rng`` None) or random crop of each view, resized to
    ``img_size``: without a bbox the center ``crop_size`` window (or the
    whole image when it is not larger); with one the square around it,
    jittered by ``rng``, with edge padding."""
    out_h, out_w = img_size
    crop_h, crop_w = crop_size
    outs = []
    for img in images:
        ih, iw = img.shape[:2]
        if bounding_box is not None:
            window = _crop_with_edge_pad(
                img, *_square_crop_bounds(bounding_box, ih, iw, rng))
        elif ih > crop_h and iw > crop_w:
            t, l = (ih - crop_h) // 2, (iw - crop_w) // 2
            window = img[t:t + crop_h, l:l + crop_w]
        else:
            window = img
        outs.append(resize_bilinear(window, out_h, out_w))
    return np.stack(outs).astype(np.float32)


# ------------------------------------------------------------- the draws


def random_background(images: np.ndarray,
                      color_range: Sequence[Sequence[int]],
                      rng: np.random.Generator,
                      bg_image: Optional[np.ndarray] = None) -> np.ndarray:
    """Composites a background where alpha == 0 (4 -> 3 channels; 3
    channels pass through): one color drawn for all views or, with a
    background image (resized to the view), a coin flip per view between
    the image and the color."""
    if images.shape[-1] != 4:
        return images
    color = np.array([rng.integers(lo, hi + 1) for lo, hi in color_range],
                     np.float32) / 255.0
    if bg_image is not None:
        h, w = images.shape[1:3]
        bg = resize_bilinear(bg_image[..., :3], h, w)
    alpha = (images[..., 3:4] == 0).astype(np.float32)
    rgb = images[..., :3]
    out = np.empty(images.shape[:-1] + (3,), np.float32)
    for i in range(images.shape[0]):
        use_img = bg_image is not None and rng.integers(0, 2)
        background = bg if use_img else color
        out[i] = alpha[i] * background + (1.0 - alpha[i]) * rgb[i]
    return out


def _bgr_to_gray(images: np.ndarray) -> np.ndarray:
    return (0.114 * images[..., 0] + 0.587 * images[..., 1]
            + 0.299 * images[..., 2])


def color_jitter(images: np.ndarray, brightness: float, contrast: float,
                 saturation: float, rng: np.random.Generator) -> np.ndarray:
    """Brightness (a * img), saturation (toward the gray image) and
    contrast (toward each view's mean gray level) in a random order, with
    one draw for all views."""
    values = {
        "brightness": 1.0 + rng.uniform(-brightness, brightness),
        "contrast": 1.0 + rng.uniform(-contrast, contrast),
        "saturation": 1.0 + rng.uniform(-saturation, saturation),
    }
    order = np.arange(3)
    rng.shuffle(order)
    names = ["brightness", "contrast", "saturation"]
    out = images.astype(np.float32, copy=True)
    for idx in order:
        a = values[names[idx]]
        if names[idx] == "brightness":
            out = a * out
        elif names[idx] == "saturation":
            out = a * out + (1.0 - a) * _bgr_to_gray(out)[..., None]
        else:
            mean = _bgr_to_gray(out).mean(axis=(1, 2))
            out = a * out + (1.0 - a) * mean[:, None, None, None]
    return out.astype(np.float32)


_NOISE_EIGVALS = np.array([0.2175, 0.0188, 0.0045], np.float32)
_NOISE_EIGVECS = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]], np.float32)


def random_noise(images: np.ndarray, noise_std: float,
                 rng: np.random.Generator) -> np.ndarray:
    """PCA noise in RGB, added to the BGR images reversed, one draw for
    all views."""
    alpha = rng.normal(0.0, noise_std, size=3).astype(np.float32)
    noise_rgb = np.sum(_NOISE_EIGVECS * alpha[None, :]
                       * _NOISE_EIGVALS[None, :], axis=1)
    return (images + noise_rgb[::-1][None, None, None, :]).astype(np.float32)


def normalize(images: np.ndarray, mean: Sequence[float],
              std: Sequence[float]) -> np.ndarray:
    return ((images - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)


def random_flip(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A left-right flip of each view with probability 1/2."""
    out = images.copy()
    for i in range(out.shape[0]):
        if rng.integers(0, 2):
            out[i] = out[i, :, ::-1]
    return out


def random_permute_channels(images: np.ndarray,
                            rng: np.random.Generator) -> np.ndarray:
    """One random permutation of the 3 channels for all views."""
    return images[..., rng.permutation(3)]


# ------------------------------------------------------------- pipelines


def train_transform(images: np.ndarray, cfg, rng: np.random.Generator,
                    bounding_box: Optional[Sequence[float]] = None,
                    bg_image: Optional[np.ndarray] = None) -> np.ndarray:
    """[N, H, W, 3|4] BGR(A) in [0, 1] -> [N, IMG_H, IMG_W, 3], the train
    pipeline."""
    c, t = cfg.CONST, cfg.TRAIN
    x = crop_images(images, (c.IMG_H, c.IMG_W), (c.CROP_IMG_H, c.CROP_IMG_W),
                    bounding_box, rng)
    if images.shape[-1] == 4:
        x = random_background(x, t.RANDOM_BG_COLOR_RANGE, rng,
                              bg_image=bg_image)
    x = color_jitter(x, t.BRIGHTNESS, t.CONTRAST, t.SATURATION, rng)
    x = random_noise(x, t.NOISE_STD, rng)
    x = normalize(x, cfg.DATASET.MEAN, cfg.DATASET.STD)
    x = random_flip(x, rng)
    x = random_permute_channels(x, rng)
    return np.ascontiguousarray(x, np.float32)


def eval_transform(images: np.ndarray, cfg,
                   bounding_box: Optional[Sequence[float]] = None
                   ) -> np.ndarray:
    """[N, H, W, 3|4] BGR(A) in [0, 1] -> [N, IMG_H, IMG_W, 3] normalized:
    crop and resize, composite the eval background color where alpha is
    0, then (x - MEAN) / STD."""
    c = cfg.CONST
    x = crop_images(images, (c.IMG_H, c.IMG_W), (c.CROP_IMG_H, c.CROP_IMG_W),
                    bounding_box)
    if x.shape[-1] == 4:
        ranges = cfg.TEST.RANDOM_BG_COLOR_RANGE
        if any(lo != hi for lo, hi in ranges):
            raise ValueError("eval background color range must be fixed, "
                             f"got {ranges}")
        color = np.array([lo for lo, _ in ranges], np.float32) / 255.0
        bg = (x[..., 3:4] == 0).astype(np.float32)
        x = bg * color + (1.0 - bg) * x[..., :3]
    return np.ascontiguousarray(normalize(x, cfg.DATASET.MEAN,
                                          cfg.DATASET.STD), np.float32)


# ----------------------------------------------- device-augment parameters

_GRAY_W = np.array([0.114, 0.587, 0.299], np.float32)  # BGR luma weights


def draw_train_params(cfg, rng: np.random.Generator, n_views: int,
                      has_alpha: bool) -> dict:
    """Every random parameter of the train pipeline (no bounding box, no
    background image), drawn in ``train_transform``'s order: the
    background color (4-channel input only), the jitter factors and their
    order, the noise, a flip per view, the channel permutation.  Returns
    ``bg_color`` [3], ``color_A``, ``color_B`` [3, 3], ``color_v`` [3]
    (``fold_color_affine``) and ``flips`` [n_views] int32."""
    t = cfg.TRAIN
    if has_alpha:
        bg = np.array([rng.integers(lo, hi + 1)
                       for lo, hi in t.RANDOM_BG_COLOR_RANGE],
                      np.float32) / 255.0
    else:
        bg = np.zeros((3,), np.float32)
    jitter_vals = np.array([
        1.0 + rng.uniform(-t.BRIGHTNESS, t.BRIGHTNESS),
        1.0 + rng.uniform(-t.CONTRAST, t.CONTRAST),
        1.0 + rng.uniform(-t.SATURATION, t.SATURATION),
    ], np.float32)
    order = np.arange(3)
    rng.shuffle(order)
    alpha = rng.normal(0.0, t.NOISE_STD, size=3).astype(np.float32)
    noise_rgb = np.sum(_NOISE_EIGVECS * alpha[None, :]
                       * _NOISE_EIGVALS[None, :], axis=1)
    flips = np.array([rng.integers(0, 2) for _ in range(n_views)], np.int32)
    perm = rng.permutation(3)
    A, B, v = fold_color_affine(
        jitter_vals, order, noise_rgb[::-1].copy(),
        np.asarray(cfg.DATASET.MEAN, np.float32),
        np.asarray(cfg.DATASET.STD, np.float32), perm)
    return {"bg_color": bg, "color_A": A, "color_B": B, "color_v": v,
            "flips": flips}


def fold_color_affine(jitter_vals: np.ndarray, order: np.ndarray,
                      noise_bgr: np.ndarray, mean: np.ndarray,
                      std: np.ndarray, perm: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The jitter (factors (brightness, contrast, saturation) applied in
    ``order``), the noise, the normalization and the channel permutation
    as one map ``y = A x + B x_bar + v`` of a pixel x (BGR) and its view's
    mean pixel x_bar.  Every stage is linear in (x, x_bar): brightness
    scales all terms; saturation applies M = aI + (1 - a) 1 w^T; contrast
    blends toward the current stage's mean gray w^T (A + B) x_bar + w^T v;
    noise and normalization are affine; the permutation reorders rows."""
    w = _GRAY_W
    ones = np.ones(3, np.float32)
    A = np.eye(3, dtype=np.float32)
    B = np.zeros((3, 3), np.float32)
    v = np.zeros(3, np.float32)
    names = ["brightness", "contrast", "saturation"]
    for idx in order:
        a = float(jitter_vals[idx])
        name = names[idx]
        if name == "brightness":
            A, B, v = a * A, a * B, a * v
        elif name == "saturation":
            M = a * np.eye(3, dtype=np.float32) + (1.0 - a) * np.outer(ones, w)
            A, B, v = M @ A, M @ B, M @ v
        else:  # contrast
            g_coeff = (A + B).T @ w  # the mean gray as a functional of x_bar
            B = a * B + (1.0 - a) * np.outer(ones, g_coeff)
            v = a * v + (1.0 - a) * float(w @ v) * ones
            A = a * A
    v = v + noise_bgr.astype(np.float32)
    D = (1.0 / std).astype(np.float32)
    A = D[:, None] * A
    B = D[:, None] * B
    v = D * (v - mean.astype(np.float32))
    return A[perm], B[perm], v[perm]


def draw_eval_params(cfg, rng: np.random.Generator, n_views: int,
                     has_alpha: bool) -> dict:
    """The eval pipeline's parameters (crop -> background -> normalize):
    the background color in the JAX ``eval_transform``'s draw order, the
    normalization as the affine map, no jitter, noise, flip or
    permutation."""
    if has_alpha:
        bg = np.array([rng.integers(lo, hi + 1)
                       for lo, hi in cfg.TEST.RANDOM_BG_COLOR_RANGE],
                      np.float32) / 255.0
    else:
        bg = np.zeros((3,), np.float32)
    std = np.asarray(cfg.DATASET.STD, np.float32)
    mean = np.asarray(cfg.DATASET.MEAN, np.float32)
    return {"bg_color": bg,
            "color_A": np.diag(1.0 / std).astype(np.float32),
            "color_B": np.zeros((3, 3), np.float32),
            "color_v": (-mean / std).astype(np.float32),
            "flips": np.zeros((n_views,), np.int32)}
