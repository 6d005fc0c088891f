"""Scalar metrics log: one append-only JSON line per scalar, and the same
scalars as TensorBoard events.

Counterpart of ``swinvox_tpu/utils/metrics_logger.py``, with the
reference's tag names ('Refiner/IoU', 'EncoderDecoder/EpochLoss', ...):
``<log_dir>/<name>.jsonl`` and, with ``tensorboard`` (the default), an
events directory ``<log_dir>/<name>/`` per stream (``utils/tb_writer.py``),
as the reference's train and test SummaryWriters.  The JAX logger's
``add_image`` (the voxel renders) is not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from swinvox_tpu_torch.utils.tb_writer import EventFileWriter


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "metrics",
                 tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._tb: Optional[EventFileWriter] = (
            EventFileWriter(os.path.join(log_dir, name)) if tensorboard
            else None)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                   "step": int(step), "ts": time.time()})
                       + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
