"""Micro-batching server: concurrent requests -> fixed-shape device batches.

Counterpart of ``BatchingServer`` in ``swinvox_tpu/serve.py``, with the
same behavior and arguments:

    from swinvox_tpu_torch.serve import BatchingServer

    with BatchingServer(predictor, batch_size=32) as server:
        fut = server.submit(images)      # [N, H, W, 3] -> Future
        vol = fut.result()               # [32, 32, 32] probabilities

One dispatcher thread takes the first queued request, waits at most
``max_wait_ms`` for more (up to ``batch_size``), pads them into one
[batch_size, n_views, H, W, 3] batch and runs ``predictor.predict`` on
it.  Requests with another view count are tiled cyclically or truncated
to ``n_views``; the first request pins H and W.  The queue is bounded
(``submit`` raises ``ServerOverloadedError`` when it is full) and
``timeout_ms`` fails requests that waited longer.  An exception in
``predict`` fails that batch's futures.  The HTTP front end and the
multi-model router of the JAX package are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np


class ServerOverloadedError(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is full."""


class _Request:
    __slots__ = ("images", "future", "t_submit")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class BatchingServer:
    """Coalesces concurrent requests into batches of ``predictor.predict``
    (``[B, N, H, W, 3] -> [B, D, H, W]``)."""

    def __init__(self, predictor, batch_size: int = 32,
                 n_views: Optional[int] = None, max_wait_ms: float = 5.0,
                 max_queue: int = 1024, timeout_ms: Optional[float] = None):
        self.predictor = predictor
        self.batch_size = int(batch_size)
        cfg = getattr(predictor, "cfg", None)
        if n_views is None:
            n_views = cfg.CONST.N_VIEWS_RENDERING if cfg is not None else 1
        self.n_views = int(n_views)
        self.max_wait = max_wait_ms / 1000.0
        self.timeout = None if timeout_ms is None else timeout_ms / 1000.0
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._hw = None
        self._stats = {"requests": 0, "batches": 0, "batch_occupancy_sum": 0,
                       "latency_sum_s": 0.0, "rejected_overload": 0,
                       "timed_out": 0}
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="swinvox-serve", daemon=True)
        self._thread.start()

    def submit(self, images: np.ndarray) -> Future:
        """images: [N, H, W, 3] float32, eval-transformed.  Returns a
        Future of the [D, H, W] probability volume."""
        images = np.asarray(images, dtype=np.float32)
        if images.ndim != 4 or images.shape[-1] != 3 or images.shape[0] < 1:
            raise ValueError(
                f"expected [n_views >= 1, H, W, 3], got {images.shape}")
        req = _Request(images[np.arange(self.n_views) % images.shape[0]])
        # stop check, H/W pin and enqueue under one lock, which close()
        # also takes to set _stop: no request lands in a dead queue
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("server is closed")
            if self._hw is None:
                self._hw = images.shape[1:3]
            elif images.shape[1:3] != self._hw:
                raise ValueError(f"image H/W {images.shape[1:3]} != server's "
                                 f"{self._hw} (fixed by the first request)")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self._stats["rejected_overload"] += 1
                raise ServerOverloadedError(
                    f"request queue full ({self._queue.maxsize})") from None
        return req.future

    def predict(self, images: np.ndarray) -> np.ndarray:
        return self.submit(images).result()

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        if s["batches"]:
            s["mean_batch_occupancy"] = s["batch_occupancy_sum"] / s["batches"]
        if s["requests"]:
            s["mean_latency_ms"] = 1000.0 * s["latency_sum_s"] / s["requests"]
        return s

    def close(self) -> None:
        with self._lock:
            self._stop.set()
        self._thread.join(timeout=30)
        while True:  # only if the join timed out: fail what is left
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.future.set_exception(RuntimeError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _take_batch(self) -> list:
        try:
            reqs = [self._queue.get(timeout=0.1)]
        except queue.Empty:
            return []
        deadline = time.perf_counter() + self.max_wait
        while len(reqs) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0 and self._queue.empty():
                break
            try:
                reqs.append(self._queue.get(timeout=max(remaining, 0.0)))
            except queue.Empty:
                break
        return reqs

    def _expire(self, reqs: list) -> list:
        if self.timeout is None:
            return reqs
        now = time.perf_counter()
        live = []
        for r in reqs:
            age = now - r.t_submit
            if age <= self.timeout:
                live.append(r)
                continue
            with self._lock:
                self._stats["timed_out"] += 1
            r.future.set_exception(TimeoutError(
                f"request queued {1000 * age:.0f} ms > timeout "
                f"{1000 * self.timeout:.0f} ms"))
        return live

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set() or not self._queue.empty():
            reqs = self._expire(self._take_batch())
            if not reqs:
                continue
            # an exception escaping this loop would hang every future
            try:
                batch = np.zeros((self.batch_size, self.n_views)
                                 + reqs[0].images.shape[1:], np.float32)
                for i, r in enumerate(reqs):
                    batch[i] = r.images
                out = np.asarray(self.predictor.predict(batch))
            except Exception as e:
                for r in reqs:
                    r.future.set_exception(e)
                continue
            now = time.perf_counter()
            with self._lock:
                self._stats["requests"] += len(reqs)
                self._stats["batches"] += 1
                self._stats["batch_occupancy_sum"] += len(reqs)
                self._stats["latency_sum_s"] += sum(now - r.t_submit
                                                    for r in reqs)
            for i, r in enumerate(reqs):
                r.future.set_result(out[i])
