"""Synthetic dataset fixtures in the reference's on-disk layouts.

Counterpart of ``swinvox_tpu/data/synthetic.py`` (the same files from the
same seed): ``generate_dataset`` writes a ShapeNet-format tree (a taxonomy
JSON, RGBA PNG renderings and 32^3 binvox volumes),
``generate_pix3d_dataset`` a Pix3D-format one (RGB PNG photos,
``pix3d.json`` with bounding boxes, one binvox per model) and
``generate_pascal3d_dataset`` a Pascal3D-format one (JPEG images, .mat
annotations with a box and a CAD index, CAD binvox volumes).  Each
returns the port's default config pointed at its tree.  Shapes are
procedural solids (unions of boxes and ellipsoids) and each rendering is
a shaded orthographic projection of the volume from a rotated viewpoint,
so tests and the card can train and evaluate without the downloads.
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


def _write_volume(vol: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        write_binvox(vol, f)


def generate_pix3d_dataset(root: str, n_samples: int = 4, seed: int = 0):
    """Writes a Pix3D-format fixture: img/chair/<name>.png (240^2 RGB),
    pix3d.json with a bounding box each, model/chair/<model>/model.binvox
    and the split file Pix3D.json (every sample in ``test``)."""
    from PIL import Image

    from swinvox_tpu_torch.config import default_config

    rng = np.random.default_rng(seed)
    annotations = []
    taxonomy = [{"taxonomy_name": "chair", "train": [], "test": []}]
    for i in range(n_samples):
        name = f"{i:04d}"
        vol = _solid(rng)
        model_name = f"IKEA_{i:04d}"
        _write_volume(vol, os.path.join(
            root, f"model/chair/{model_name}/model.binvox"))
        img = render_view(vol, rng.uniform(0, 2 * np.pi), size=240)[..., :3]
        ipath = os.path.join(root, f"img/chair/{name}.png")
        os.makedirs(os.path.dirname(ipath), exist_ok=True)
        Image.fromarray(img, "RGB").save(ipath)
        annotations.append({
            "img": f"img/chair/{name}.png",
            "img_size": [240, 240],
            "bbox": [40, 40, 200, 200],
            "voxel": f"model/chair/{model_name}/voxel.mat",
        })
        taxonomy[0]["test"].append(name)
    with open(os.path.join(root, "pix3d.json"), "w") as f:
        json.dump(annotations, f)
    tax_path = os.path.join(root, "Pix3D.json")
    with open(tax_path, "w") as f:
        json.dump(taxonomy, f)
    cfg = default_config()
    cfg.DATASET.TEST_DATASET = "Pix3D"
    paths = cfg.DATASETS.PIX3D
    paths.TAXONOMY_FILE_PATH = tax_path
    paths.ANNOTATION_PATH = os.path.join(root, "pix3d.json")
    paths.RENDERING_PATH = os.path.join(root, "img/%s/%s.%s")
    paths.VOXEL_PATH = os.path.join(root, "model/%s/%s/%s.binvox")
    return cfg


def generate_pascal3d_dataset(root: str, n_samples: int = 4, seed: int = 0):
    """Writes a Pascal3D-format fixture: two CAD volumes
    CAD/aeroplane/{01,02}.binvox shared by the samples,
    Images/aeroplane_imagenet/<name>.JPEG (240 x 180 noise),
    Annotations/aeroplane_imagenet/<name>.mat (image size, one object's
    box and CAD index) and the split file Pascal3D.json (every sample in
    ``test``)."""
    import scipy.io
    from PIL import Image

    from swinvox_tpu_torch.config import default_config

    rng = np.random.default_rng(seed)
    taxonomy = [{"taxonomy_name": "aeroplane", "train": [], "test": []}]
    for cad in (1, 2):
        _write_volume(_solid(rng),
                      os.path.join(root, f"CAD/aeroplane/{cad:02d}.binvox"))
    for i in range(n_samples):
        name = f"n{i:08d}"
        img = (rng.random((180, 240, 3)) * 255).astype(np.uint8)
        ipath = os.path.join(root, f"Images/aeroplane_imagenet/{name}.JPEG")
        os.makedirs(os.path.dirname(ipath), exist_ok=True)
        Image.fromarray(img, "RGB").save(ipath)
        apath = os.path.join(root,
                             f"Annotations/aeroplane_imagenet/{name}.mat")
        os.makedirs(os.path.dirname(apath), exist_ok=True)
        record = {"imgsize": np.array([240, 180, 3]),
                  "objects": {"cad_index": 1 + (i % 2),
                              "bbox": np.array([30.0, 20.0, 210.0, 160.0])}}
        scipy.io.savemat(apath, {"record": record})
        taxonomy[0]["test"].append(name)
    tax_path = os.path.join(root, "Pascal3D.json")
    with open(tax_path, "w") as f:
        json.dump(taxonomy, f)
    cfg = default_config()
    cfg.DATASET.TEST_DATASET = "Pascal3D"
    paths = cfg.DATASETS.PASCAL3D
    paths.TAXONOMY_FILE_PATH = tax_path
    paths.ANNOTATION_PATH = os.path.join(
        root, "Annotations/%s_imagenet/%s.mat")
    paths.RENDERING_PATH = os.path.join(root, "Images/%s_imagenet/%s.JPEG")
    paths.VOXEL_PATH = os.path.join(root, "CAD/%s/%02d.binvox")
    return cfg


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
