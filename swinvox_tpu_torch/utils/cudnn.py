"""cuDNN settings shared by the serving, evaluation and training steps."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms, chosen by its
    heuristics (benchmark off, so a run never picks by timing), and both
    process-wide flags back as they were after."""
    cudnn = torch.backends.cudnn
    previous = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = previous
