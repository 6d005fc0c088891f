"""Micro-batching server: concurrent requests -> fixed-shape device batches.

Counterpart of ``swinvox_tpu/serve.py`` (``BatchingServer``,
``MultiServer``, the HTTP front end and ``main``), with the same behavior
and arguments:

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
``predict`` fails that batch's futures.

``MultiServer`` routes requests to one ``BatchingServer`` per named
model; ``_make_http_server`` puts either behind stdlib HTTP, and

    python -m swinvox_tpu_torch.serve --checkpoint [NAME=]PATH ... \
        [--port 8000] [--host 0.0.0.0] [--batch-size 32] [--n-views N] \
        [--max-wait-ms 5] [--max-queue 1024] [--timeout-ms T] \
        [--platform cuda|cpu]

serves ``POST /predict`` and ``POST /predict/<model>`` (an npy body of
[N, H, W, 3] eval-transformed float32 images; the response is the npy
[32, 32, 32] probabilities), ``GET /stats`` and ``GET /models``.  An
unknown model answers 404, a full queue 503, a request that waited past
``--timeout-ms`` 504, anything else that fails 400; each failure is the
failing request's alone.  The checkpoints are either package's files
(``Predictor.from_checkpoint``); the models run on ``cuda`` unless
``--platform`` names another device.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


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


# ------------------------------------------------------------------ HTTP


class MultiServer:
    """Routes requests to one of several named ``BatchingServer``s (one
    checkpoint each) sharing the process and the device; each keeps its
    own queue and stats.  ``default`` names the model of a request that
    names none (the first registered otherwise)."""

    def __init__(self, servers, default: Optional[str] = None):
        if not servers:
            raise ValueError("MultiServer needs at least one model")
        self._servers = dict(servers)
        self.default = default if default is not None else next(iter(servers))
        if self.default not in self._servers:
            raise KeyError(self.default)

    def __getitem__(self, name: str) -> BatchingServer:
        return self._servers[name]

    @property
    def models(self):
        return tuple(self._servers)

    def _pick(self, model: Optional[str]) -> BatchingServer:
        name = model if model is not None else self.default
        try:
            return self._servers[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; available: "
                           f"{sorted(self._servers)}") from None

    def submit(self, images: np.ndarray, model: Optional[str] = None):
        return self._pick(model).submit(images)

    def predict(self, images: np.ndarray,
                model: Optional[str] = None) -> np.ndarray:
        return self._pick(model).predict(images)

    def stats(self) -> dict:
        return {name: srv.stats() for name, srv in self._servers.items()}

    def close(self) -> None:
        for srv in self._servers.values():
            srv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _make_http_server(server, port: int, host: str = "0.0.0.0"):
    """A ``ThreadingHTTPServer`` on (host, port) (port 0: any free port,
    ``httpd.server_address[1]``) in front of a BatchingServer or a
    MultiServer; its handler threads are daemons."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    multi = isinstance(server, MultiServer)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/stats":
                self._json(server.stats())
            elif self.path == "/models" and multi:
                self._json({"models": list(server.models),
                            "default": server.default})
            else:
                self.send_error(404)

        def do_POST(self):  # noqa: N802
            # /predict (the default model) or /predict/<model>
            model = None
            if self.path.startswith("/predict/"):
                model = self.path[len("/predict/"):]
            elif self.path != "/predict":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                images = np.load(io.BytesIO(self.rfile.read(length)),
                                 allow_pickle=False)
                if multi:
                    vol = server.predict(images, model=model)
                elif model is None:
                    vol = server.predict(images)
                else:
                    self.send_error(404, "single-model server")
                    return
            except KeyError as e:
                self.send_error(404, str(e))
                return
            except ServerOverloadedError as e:
                self.send_error(503, str(e))  # shed load, the client retries
                return
            except TimeoutError as e:
                self.send_error(504, str(e))
                return
            except Exception as e:
                self.send_error(400, str(e))
                return
            buf = io.BytesIO()
            np.save(buf, vol)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            self.wfile.write(buf.getvalue())

        def log_message(self, fmt, *args):
            log.info("http: " + fmt, *args)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[Sequence[str]] = None, on_ready=None) -> int:
    """Serves until interrupted, or until another thread calls
    ``shutdown()`` on the HTTP server, which ``on_ready(httpd)`` receives
    once it is bound; then closes the model servers."""
    parser = argparse.ArgumentParser(
        description="Serve SwinVox checkpoints over HTTP (PyTorch)")
    parser.add_argument(
        "--checkpoint", required=True, action="append",
        help="checkpoint path, or NAME=PATH (repeatable for multi-model "
             "serving; the first one is the default model)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--n-views", type=int, default=None)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--max-queue", type=int, default=1024)
    parser.add_argument("--timeout-ms", type=float, default=None)
    parser.add_argument("--platform", default="cuda",
                        help="torch device to run on (default cuda; 'cpu' "
                        "for a host-only run)")
    args = parser.parse_args(argv)

    from swinvox_tpu_torch.infer import Predictor

    logging.basicConfig(level=logging.INFO)

    def build(path):
        return BatchingServer(
            Predictor.from_checkpoint(path, device=args.platform),
            batch_size=args.batch_size, n_views=args.n_views,
            max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
            timeout_ms=args.timeout_ms)

    specs = [c.split("=", 1) if "=" in c else [None, c]
             for c in args.checkpoint]
    if len(specs) == 1 and specs[0][0] is None:
        server_cm = build(specs[0][1])
    else:
        server_cm = MultiServer({
            name if name is not None else f"model{i}": build(path)
            for i, (name, path) in enumerate(specs)})
    with server_cm as server:
        httpd = _make_http_server(server, args.port, args.host)
        log.info("serving on %s:%d (POST /predict[/model], GET /stats)",
                 args.host, httpd.server_address[1])
        if on_ready is not None:
            on_ready(httpd)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
