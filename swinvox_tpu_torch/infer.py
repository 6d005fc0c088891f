"""High-level inference API: images -> voxel probabilities.

Counterpart of ``swinvox_tpu/infer.py``:

    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.serve import BatchingServer

    cfg = default_config()
    p = Predictor(SwinVoxModel.from_config(cfg), "cuda", cfg)
    vol = p.predict_files(["view0.png", "view1.png"])   # [32, 32, 32] probs
    server = BatchingServer(p, batch_size=32)

Images go through the eval transform (center crop -> background
composite -> normalize).  ``Predictor.from_checkpoint`` builds the model a
config describes and loads a JAX checkpoint file into it
(``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from swinvox_tpu_torch.config import default_config
from swinvox_tpu_torch.data import eval_transform, load_image_bgr, write_binvox
from swinvox_tpu_torch.utils.cudnn import cudnn_deterministic


class Predictor:
    """Runs a ``SwinVoxModel`` in eval mode on ``device``.

    Each forward runs with cuDNN restricted to deterministic algorithms,
    so a request's result does not depend on the batch it is served in:
    otherwise the refiner's transposed convs may take a nondeterministic
    algorithm on a card.  The flag is process-wide in PyTorch: it holds
    while any thread's ``predict`` runs (two servers' dispatchers run at
    once) and comes back as it was when the last one is done.
    """

    def __init__(self, model: torch.nn.Module,
                 device: Union[str, torch.device], cfg=None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg or default_config()

    @classmethod
    def from_checkpoint(cls, path: str, cfg=None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> "Predictor":
        """The config's model with a JAX checkpoint's weights (full or
        params-only) on ``device``."""
        from swinvox_tpu_torch.models.swinvox import SwinVoxModel
        from swinvox_tpu_torch.train.checkpoint import load_checkpoint

        cfg = cfg or default_config()
        model = SwinVoxModel.from_config(cfg)
        load_checkpoint(path, model)
        return cls(model, device, cfg)

    @torch.inference_mode()
    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: [B, N, H, W, 3] normalized float32 -> [B, 32^3] probs."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        with cudnn_deterministic():
            out = self.model(x.to(self.device))["refined_volumes"]
        return torch.sigmoid(out.float()).cpu().numpy()

    def predict_files(
        self, image_paths: Sequence[str], bounding_box=None
    ) -> np.ndarray:
        """One object from its view image files -> [32, 32, 32] probs."""
        raw = np.stack([load_image_bgr(p) for p in image_paths])
        x = eval_transform(raw, self.cfg, bounding_box=bounding_box)
        return self.predict(x[None])[0]

    @staticmethod
    def export_binvox(
        probs: np.ndarray, path: str, threshold: float = 0.4
    ) -> None:
        with open(path, "wb") as f:
            write_binvox(probs >= threshold, f)
