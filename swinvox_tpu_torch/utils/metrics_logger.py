"""Scalar metrics log: one append-only JSON line per scalar.

Counterpart of ``swinvox_tpu/utils/metrics_logger.py``, with the
reference's tag names ('Refiner/IoU', 'EncoderDecoder/EpochLoss', ...).
The JAX logger also writes TensorBoard event files and the voxel renders;
the port writes the JSONL stream only.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step), "ts": time.time()})
                       + "\n")

    def close(self) -> None:
        self._fh.close()
