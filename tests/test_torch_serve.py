"""Serving with the port on the CPU: swinvox_tpu_torch's config, image
input, binvox output and BatchingServer against the JAX package's, the
port's Predictor behind the port's server at nano depths, and the port's
import surface (no jax, no flax, nothing of swinvox_tpu)."""

import io
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from swinvox_tpu_torch.config import default_config
from swinvox_tpu_torch.serve import BatchingServer, ServerOverloadedError

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def predictor():
    import torch

    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    model = SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(7))
    # every tensor drawn (params are allocated uninitialized)
    for name, t in model.state_dict().items():
        assert torch.isfinite(t).all() and t.abs().max() < 10, name
    return Predictor(model, "cpu", cfg)


def test_config_matches_the_jax_defaults():
    """Every field of the port's config has the name, section and default
    of the JAX package's, so one config drives both."""
    from swinvox_tpu.config import default_config as jax_default

    def leaves(tree, prefix=()):
        for name, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, prefix + (name,))
            else:
                yield prefix + (name,), value

    ref = jax_default().to_dict()
    n = 0
    for path, value in leaves(default_config().to_dict()):
        want = ref
        for name in path:
            want = want[name]
        assert value == want, ".".join(path)
        n += 1
    assert n == 98


def test_batching_server_serves_the_port(predictor):
    """Concurrent requests through BatchingServer come back as [32,32,32]
    probabilities equal to predictor.predict on the same images (f32 on
    the CPU: same math, another batch; atol 1e-5)."""
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
            for _ in range(3)]
    with BatchingServer(predictor, batch_size=4, max_wait_ms=50) as server:
        assert server.n_views == 1
        futs = [server.submit(r) for r in reqs]
        outs = [f.result(timeout=120) for f in futs]
        stats = server.stats()
    assert stats["requests"] == 3
    direct = predictor.predict(np.stack(reqs))
    for out, ref in zip(outs, direct):
        assert out.shape == (32, 32, 32)
        assert np.all(np.isfinite(out)) and out.min() >= 0 and out.max() <= 1
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode,size,bbox", [
    ("RGB", (137, 137), None),
    ("RGBA", (137, 151), None),
    ("L", (100, 90), None),
    ("RGBA", (120, 140), (0.1, 0.2, 0.95, 0.7)),
])
def test_image_input_matches_jax(tmp_path, mode, size, bbox):
    """load_image_bgr + eval_transform equal the JAX package's on the same
    file (color, alpha over the eval background, gray, bbox crop with edge
    padding); float32 with another resize implementation: atol 1e-5."""
    from PIL import Image

    from swinvox_tpu.config import default_config as jax_default
    from swinvox_tpu.data.pipeline import load_image_bgr as jax_load
    from swinvox_tpu.data.transforms import eval_transform as jax_eval
    from swinvox_tpu_torch.data import eval_transform, load_image_bgr

    rng = np.random.default_rng(3)
    chans = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 255, size + (chans,), np.uint8)
    if chans == 1:
        arr = arr[..., 0]
    if chans == 4:
        arr[..., 3] = np.where(rng.random(size) < 0.4, 0, arr[..., 3])
    path = tmp_path / "view.png"
    Image.fromarray(arr, mode).save(path)
    raw = load_image_bgr(str(path))
    # the JAX package may decode through its C codec: /255 rounds apart
    np.testing.assert_allclose(raw, jax_load(str(path)), atol=1e-6, rtol=0)
    got = eval_transform(raw[None], default_config(), bounding_box=bbox)
    ref = jax_eval(raw[None], jax_default(), bounding_box=bbox)
    assert got.shape == ref.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_predict_files_and_binvox(predictor, tmp_path):
    """predict_files runs the eval transform on image files; a prediction
    exports to binvox that the JAX package's reader reads back exactly,
    byte for byte what the JAX writer writes."""
    from PIL import Image

    from swinvox_tpu.data import binvox
    from swinvox_tpu_torch.data import (eval_transform, load_image_bgr,
                                        write_binvox)

    rng = np.random.default_rng(1)
    paths = []
    for i in range(2):
        p = tmp_path / f"view{i}.png"
        Image.fromarray(rng.integers(0, 255, (137, 137, 3), np.uint8)).save(p)
        paths.append(str(p))
    probs = predictor.predict_files(paths)
    x = eval_transform(np.stack([load_image_bgr(p) for p in paths]),
                       predictor.cfg)
    np.testing.assert_allclose(probs, predictor.predict(x[None])[0],
                               atol=1e-6, rtol=0)
    out = tmp_path / "out.binvox"
    predictor.export_binvox(probs, str(out), threshold=0.5)
    with open(out, "rb") as f:
        vox = binvox.read_as_3d_array(f)
    np.testing.assert_array_equal(vox.data, probs >= 0.5)
    # long runs (> 255) and both values
    grid = np.zeros((32, 32, 32), bool)
    grid[3:20, :, 5:30] = True
    ref = binvox.dumps(binvox.Voxels(grid, [32] * 3, [0.0] * 3, 1.0, "xyz"))
    buf = io.BytesIO()
    write_binvox(grid, buf)
    assert buf.getvalue() == ref


class FakePredictor:
    """Records the batches it sees; returns each sample's mean as a cube."""

    def __init__(self, delay_s=0.0):
        self.batches = []
        self.delay_s = delay_s

    def predict(self, images):
        self.batches.append(np.array(images))
        if self.delay_s:
            time.sleep(self.delay_s)
        means = images.reshape(images.shape[0], -1).mean(axis=1)
        return np.broadcast_to(means[:, None, None, None],
                               (images.shape[0], 4, 4, 4)).copy()


def _req(rng, n_views=1, value=1.0, hw=8):
    return np.full((n_views, hw, hw, 3), value, np.float32)


def test_server_coalesces_pads_and_fits_views(rng):
    """Queued requests share padded fixed-shape batches; a request's views
    are tiled cyclically up to n_views."""
    fake = FakePredictor(delay_s=0.05)
    with BatchingServer(fake, batch_size=4, n_views=3,
                        max_wait_ms=200.0) as server:
        x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
        first = server.submit(x).result(timeout=30)
        futs = [server.submit(_req(rng, value=i + 1.0)) for i in range(6)]
        outs = [f.result(timeout=30) for f in futs]
    np.testing.assert_array_equal(fake.batches[0][0], x[[0, 1, 0]])
    np.testing.assert_allclose(first, x[[0, 1, 0]].mean(), rtol=1e-6)
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out, i + 1.0, rtol=1e-6)
    assert 3 <= len(fake.batches) <= 4
    assert all(b.shape == (4, 3, 8, 8, 3) for b in fake.batches)
    stats = server.stats()
    assert stats["requests"] == 7 and stats["batches"] == len(fake.batches)
    assert "mean_latency_ms" in stats


def test_server_rejects_and_fails_cleanly(rng):
    """Bad shapes raise in the client thread, a predict error fails its
    futures, and the server keeps serving; after close, submit raises."""
    class Boom(FakePredictor):
        def predict(self, images):
            if images[0].max() > 5:
                raise ValueError("boom")
            return super().predict(images)

    with BatchingServer(Boom(), batch_size=2, n_views=1) as server:
        np.testing.assert_allclose(
            server.submit(_req(rng, value=1.0)).result(timeout=10), 1.0)
        with pytest.raises(ValueError, match="H/W"):
            server.submit(_req(rng, hw=16))
        with pytest.raises(ValueError, match="n_views"):
            server.submit(np.zeros((8, 8, 3), np.float32))
        with pytest.raises(ValueError, match="boom"):
            server.submit(_req(rng, value=9.0)).result(timeout=10)
        np.testing.assert_allclose(server.predict(_req(rng, value=2.0)), 2.0)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(_req(rng))


def test_server_backpressure_and_timeout(rng):
    """A full queue raises ServerOverloadedError; requests older than
    timeout_ms fail with TimeoutError; accepted ones are all answered."""
    with BatchingServer(FakePredictor(delay_s=0.2), batch_size=1, n_views=1,
                        max_queue=2, max_wait_ms=0.0) as server:
        futs, rejected = [], 0
        for _ in range(32):
            try:
                futs.append(server.submit(_req(rng)))
            except ServerOverloadedError:
                rejected += 1
        assert rejected > 0 and futs
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=60), 1.0)
    assert server.stats()["rejected_overload"] == rejected

    with BatchingServer(FakePredictor(delay_s=0.3), batch_size=1, n_views=1,
                        max_wait_ms=0.0, timeout_ms=100.0) as server:
        outcomes = []
        for f in [server.submit(_req(rng)) for _ in range(6)]:
            try:
                f.result(timeout=60)
                outcomes.append("ok")
            except TimeoutError:
                outcomes.append("timeout")
    assert outcomes[0] == "ok" and "timeout" in outcomes
    assert server.stats()["timed_out"] == outcomes.count("timeout")


def test_server_close_never_hangs_a_future(rng):
    """A submit racing close() either raises or gets a future that
    resolves."""
    for _ in range(5):
        server = BatchingServer(FakePredictor(delay_s=0.005), batch_size=2,
                                n_views=1, max_wait_ms=1.0)
        futs = []

        def hammer():
            for _ in range(50):
                try:
                    futs.append(server.submit(_req(rng)))
                except RuntimeError:
                    return

        t = threading.Thread(target=hammer)
        t.start()
        time.sleep(0.01)
        server.close()
        t.join(timeout=30)
        assert not t.is_alive()
        for f in futs:
            try:
                f.result(timeout=10)
            except RuntimeError:
                pass


def test_port_imports_no_jax():
    """Importing the port, serving a nano forward and taking a nano train
    step on the CPU leaves jax, flax and the JAX package out of
    sys.modules (a fresh interpreter: conftest imports jax into this
    one)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import swinvox_tpu_torch
        from swinvox_tpu_torch import convert
        from swinvox_tpu_torch.config import default_config
        from swinvox_tpu_torch.infer import Predictor
        from swinvox_tpu_torch.kernels import build
        from swinvox_tpu_torch.models.swinvox import SwinVoxModel
        from swinvox_tpu_torch.ops import losses, pallas_merger_stack
        from swinvox_tpu_torch.serve import BatchingServer
        from swinvox_tpu_torch.train.state import create_train_state
        from swinvox_tpu_torch.train.steps import make_train_step
        cfg = default_config()
        cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
        cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
        cfg.NETWORK.COMPUTE_DTYPE = "float32"
        p = Predictor(SwinVoxModel.from_config(cfg), "cpu", cfg)
        with BatchingServer(p, batch_size=2) as server:
            out = server.predict(np.zeros((1, 224, 224, 3), np.float32))
        assert out.shape == (32, 32, 32)
        state, opts = create_train_state(cfg, device="cpu")
        step = make_train_step(state.model, opts)
        state, metrics = step(state, np.zeros((1, 1, 224, 224, 3), np.float32),
                              np.ones((1, 32, 32, 32), np.uint8),
                              torch.Generator())
        assert state.step == 1 and bool(torch.isfinite(metrics["total_loss"]))
        bad = sorted(m for m in sys.modules if m.split(".")[0]
                     in ("jax", "jaxlib", "flax", "swinvox_tpu"))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
