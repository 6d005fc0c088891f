"""Data: image files in, transforms, binvox in and out, and the dataset
splits.

Counterparts of ``swinvox_tpu.data.pipeline.load_image_bgr`` (here),
``data/transforms.py`` (the train pipeline, the eval transform and their
parameter draws; the eval transform re-exported here),
``data/device_augment.py`` (the same augmentation on the card),
``data/binvox.py`` (the binvox codec), ``data/taxonomy.py`` (the
ShapeNet, Pascal3D and Pix3D indexes), ``data/pipeline.py`` (the train,
validation and test loaders) and ``data/synthetic.py`` (fixtures in the
three datasets' formats), in plain numpy and PIL on the host (the JAX
package's optional C codecs are not ported; the results are its numpy
path's, see ``tests/test_torch_serve.py``, ``tests/test_torch_eval.py``,
``tests/test_torch_train_net.py`` and ``tests/test_torch_cross_datasets.py``).
"""

from __future__ import annotations

import io

import numpy as np

from swinvox_tpu_torch.data.binvox import write_binvox
from swinvox_tpu_torch.data.transforms import eval_transform

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
