"""cuDNN settings shared by the serving and evaluation forwards."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms (a process-wide flag
    in PyTorch), and back as it was after."""
    cudnn = torch.backends.cudnn
    previous = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = previous
