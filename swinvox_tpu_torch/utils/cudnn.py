"""cuDNN settings shared by the serving, evaluation and training steps."""

from __future__ import annotations

import contextlib
import threading

import torch

# cuDNN's flags are process-wide, so the threads inside the context share
# one save and one restore: the first to enter saves and sets them, the
# last to leave puts them back (two servers' dispatchers run predicts at
# once, and one leaving must not clear the flags under the other)
_lock = threading.Lock()
_inside = 0
_saved = (False, False)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms, chosen by its
    heuristics (benchmark off, so a run never picks by timing), while any
    thread is inside; both process-wide flags back as they were when the
    last thread leaves."""
    global _inside, _saved
    cudnn = torch.backends.cudnn
    with _lock:
        if _inside == 0:
            _saved = cudnn.deterministic, cudnn.benchmark
            cudnn.deterministic, cudnn.benchmark = True, False
        _inside += 1
    try:
        yield
    finally:
        with _lock:
            _inside -= 1
            if _inside == 0:
                cudnn.deterministic, cudnn.benchmark = _saved
