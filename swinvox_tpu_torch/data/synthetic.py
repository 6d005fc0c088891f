"""Synthetic ShapeNet-format fixture.

Counterpart of ``generate_dataset`` in ``swinvox_tpu/data/synthetic.py``
(the same files from the same seed): a taxonomy JSON, RGBA PNG renderings
and 32^3 binvox volumes in the reference's on-disk layout.  Shapes are
procedural solids (unions of boxes and ellipsoids) and each rendering is
a shaded orthographic projection of the volume from a rotated viewpoint,
so tests and the card can evaluate without the ShapeNet download.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from swinvox_tpu_torch.data.binvox import write_binvox


def _solid(rng: np.random.Generator, d: int = 32) -> np.ndarray:
    """A random procedural solid: union of 1-3 boxes/ellipsoids."""
    idx = np.arange(d)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    vol = np.zeros((d, d, d), bool)
    for _ in range(rng.integers(1, 4)):
        kind = rng.integers(0, 2)
        c = rng.uniform(d * 0.3, d * 0.7, size=3)
        r = rng.uniform(d * 0.12, d * 0.3, size=3)
        if kind == 0:  # ellipsoid
            vol |= (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                    + ((z - c[2]) / r[2]) ** 2) < 1.0
        else:  # box
            vol |= ((np.abs(x - c[0]) < r[0]) & (np.abs(y - c[1]) < r[1])
                    & (np.abs(z - c[2]) < r[2]))
    return vol


def _rotate_z(vol: np.ndarray, angle: float) -> np.ndarray:
    """Nearest-neighbor rotation of the volume about the z axis."""
    d = vol.shape[0]
    c = (d - 1) / 2
    idx = np.arange(d) - c
    x, y = np.meshgrid(idx, idx, indexing="ij")
    cos, sin = np.cos(angle), np.sin(angle)
    xs = np.clip(np.round(cos * x - sin * y + c), 0, d - 1).astype(int)
    ys = np.clip(np.round(sin * x + cos * y + c), 0, d - 1).astype(int)
    return vol[xs, ys]


def render_view(vol: np.ndarray, angle: float, size: int = 137) -> np.ndarray:
    """Shaded orthographic projection -> RGBA uint8 [size, size, 4]; the
    first occupied depth shades the pixel, empty pixels get alpha 0."""
    rotated = _rotate_z(vol, angle)
    d = vol.shape[0]
    hit = rotated.any(axis=2)
    first = np.where(hit, np.argmax(rotated, axis=2), d)
    shade = 1.0 - first / d  # nearer -> brighter
    img_small = np.zeros((d, d, 4), np.float32)
    img_small[..., 0] = shade * 0.9
    img_small[..., 1] = shade * 0.7
    img_small[..., 2] = shade * 0.5
    img_small[..., 3] = hit.astype(np.float32)
    reps = size // d + 1  # nearest upscale to the render size
    big = np.kron(img_small, np.ones((reps, reps, 1), np.float32))
    off = (big.shape[0] - size) // 2
    big = big[off:off + size, off:off + size]
    return (np.clip(big, 0, 1) * 255).astype(np.uint8)


def generate_dataset(
    root: str,
    n_samples_per_split: Tuple[int, int, int] = (8, 2, 2),
    n_views: int = 6,
    categories: Optional[List[Tuple[str, str]]] = None,
    seed: int = 0,
):
    """Writes a ShapeNet-format tree under ``root``; returns the port's
    default config with its ShapeNet paths pointing at it."""
    from PIL import Image

    from swinvox_tpu_torch.config import default_config

    categories = categories or [("02691156", "aeroplane")]
    rng = np.random.default_rng(seed)
    taxonomy = []
    rendering_tpl = os.path.join(
        root, "ShapeNetRendering/%s/%s/rendering/%02d.png")
    volume_tpl = os.path.join(root, "ShapeNetVox32/%s/%s/model.binvox")
    for tid, tname in categories:
        splits = {"train": [], "val": [], "test": []}
        for split, count in zip(("train", "val", "test"), n_samples_per_split):
            for i in range(count):
                sample = f"{split}_{i:04d}"
                splits[split].append(sample)
                vol = _solid(rng)
                vpath = volume_tpl % (tid, sample)
                os.makedirs(os.path.dirname(vpath), exist_ok=True)
                with open(vpath, "wb") as f:
                    write_binvox(vol, f)
                for v in range(n_views):
                    img = render_view(vol, 2 * np.pi * v / n_views)
                    ipath = rendering_tpl % (tid, sample, v)
                    os.makedirs(os.path.dirname(ipath), exist_ok=True)
                    Image.fromarray(img, "RGBA").save(ipath)
        taxonomy.append({
            "taxonomy_id": tid,
            "taxonomy_name": tname,
            "baseline": {"1-view": 0.513, "2-view": 0.536, "3-view": 0.549,
                         "4-view": 0.556, "5-view": 0.561},
            **splits,
        })
    tax_path = os.path.join(root, "taxonomy.json")
    with open(tax_path, "w") as f:
        json.dump(taxonomy, f)
    cfg = default_config()
    cfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH = tax_path
    cfg.DATASETS.SHAPENET.RENDERING_PATH = rendering_tpl
    cfg.DATASETS.SHAPENET.VOXEL_PATH = volume_tpl
    return cfg
