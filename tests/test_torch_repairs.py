"""The port's deterministic backwards and its float32 routes, on the CPU:

  * the CVA's bilinear upsampling as two interpolation matrices
    (``models/layers.resize_bilinear``) against ``jax.image.resize``,
    forward and gradient;
  * the refiner's 2x2x2, stride-2 max pool with an elementwise backward
    (``models/layers.max_pool``) against the JAX package's ``max_pool``
    (``reduce_window``), with tied values in most windows, forward and
    gradient (a tie's gradient goes to the first maximum in both);
  * ``SwinVoxModel.from_config`` at float32: the five bf16-only kernel
    routes resolve to the plain path and a train step runs; with
    USE_PALLAS_MERGER (kernel I) an eval forward runs the plain merger.

Inputs are drawn with numpy from a seed.  Tolerances: the matrices'
weights are float32 roundings of JAX's, 1e-6 absolute on O(1) values;
the pool selects values, so it is exact.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu_torch.models import layers


@pytest.mark.parametrize("src,dst", [((4, 4), (7, 7)), ((3, 5), (6, 10))])
def test_upsample_matches_jax_resize(rng, src, dst):
    """resize_bilinear upsampling (R_h x R_w^T) == jax.image.resize
    (bilinear, half-pixel centres, clamped border), forward and the
    gradient of a random cotangent."""
    x = rng.standard_normal((2, 3, *src)).astype(np.float32)
    ct = rng.standard_normal((2, 3, *dst)).astype(np.float32)

    def jax_fn(a):  # NCHW through the JAX package's NHWC resize
        from swinvox_tpu.models.layers import resize_bilinear
        y = resize_bilinear(jnp.transpose(a, (0, 2, 3, 1)), dst)
        return jnp.transpose(y, (0, 3, 1, 2))

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = layers.resize_bilinear(tx, dst)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=0)
    out.backward(torch.tensor(ct))
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]),
                               atol=1e-5, rtol=0)


def test_refiner_pool_matches_jax_max_pool(rng):
    """max_pool(x, 2) on NCDHW 33^3 (the refiner's odd size: the last
    plane is dropped) == the JAX max_pool on NDHWC, values quantized so
    most windows hold ties; the gradient goes to the first maximum of
    each window in both, and the backward repeats bit for bit."""
    from swinvox_tpu.models.layers import max_pool as jax_max_pool

    x = np.round(rng.standard_normal((2, 3, 33, 33, 33)) * 1.5).astype(
        np.float32)
    ct = rng.standard_normal((2, 3, 16, 16, 16)).astype(np.float32)

    def jax_fn(a):
        y = jax_max_pool(jnp.transpose(a, (0, 2, 3, 4, 1)), 2)
        return jnp.transpose(y, (0, 4, 1, 2, 3))

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = layers.max_pool(tx, 2)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    (g,) = torch.autograd.grad(out, tx, torch.tensor(ct))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    np.testing.assert_array_equal(g.numpy(), want)
    assert (want != 0).sum() == ct.size  # one input a window
    (again,) = torch.autograd.grad(layers.max_pool(tx, 2), tx,
                                   torch.tensor(ct))
    assert torch.equal(g, again)


def test_from_config_float32_runs_the_plain_routes(caplog):
    """At COMPUTE_DTYPE float32 with the default flags (and
    USE_PALLAS_MERGER, the one bf16-only route off by default) from_config
    resolves USE_PALLAS_SWIN_BLOCK(_TRAIN), USE_PALLAS_WINDOW_ATTENTION,
    USE_MERGER_STACK and USE_PALLAS_MERGER to the plain path, says so in
    one log line, exposes the resolved flags, and a train step runs on the
    CPU; at bfloat16 the flags stay as configured."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.models.swinvox import BF16_ONLY_ROUTES, SwinVoxModel
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.USE_PALLAS_MERGER = True
    assert all(getattr(cfg.NETWORK, f) for f in BF16_ONLY_ROUTES)
    bf16 = SwinVoxModel.from_config(cfg)
    assert bf16.kernel_routes == dict.fromkeys(BF16_ONLY_ROUTES, True)
    assert bf16.encoder.swin.chain and bf16.encoder.swin.train_chain
    assert bf16.merger.use_pallas

    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    with caplog.at_level(logging.INFO):
        model = SwinVoxModel.from_config(cfg)
    lines = [r for r in caplog.records if "float32" in r.getMessage()]
    assert len(lines) == 1 and "USE_MERGER_STACK" in lines[0].getMessage()
    assert model.kernel_routes == dict.fromkeys(BF16_ONLY_ROUTES, False)
    swin = model.encoder.swin
    assert not (swin.chain or swin.train_chain)
    blk = swin.stage0_block0
    assert not (blk.use_pallas_block or blk.use_pallas_block_train
                or blk.use_pallas or model.merger.use_stack
                or model.merger.use_pallas)

    state, opts = create_train_state(cfg, device="cpu")
    assert state.model.kernel_routes == model.kernel_routes
    step = make_train_step(state.model, opts)
    rng = np.random.default_rng(0)
    images = rng.random((2, 2, 224, 224, 3)).astype(np.float32)
    volumes = (rng.random((2, 32, 32, 32)) > 0.5).astype(np.uint8)
    state, metrics = step(state, images, volumes,
                          torch.Generator().manual_seed(0))
    assert state.step == 1 and bool(torch.isfinite(metrics["total_loss"]))


def test_float32_eval_merger_runs_the_plain_merger():
    """USE_PALLAS_MERGER at COMPUTE_DTYPE float32, which the JAX package
    serves with its fused merger at float32: kernel I takes bfloat16
    volumes only (its wrapper raises on a float32 CUDA tensor), so
    from_config resolves the route to the plain merger (eval-mode
    BatchNorm from the running statistics: the function the fused merger
    folds), and an eval forward equals the one with the flag off, bit for
    bit; at bfloat16 the flag stays on."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.INIT_SCHEME = "standard"
    cfg.NETWORK.USE_PALLAS_MERGER = True
    assert SwinVoxModel.from_config(cfg).merger.use_pallas
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    fused = SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(0))
    assert not fused.merger.use_pallas
    assert fused.kernel_routes["USE_PALLAS_MERGER"] is False
    cfg.NETWORK.USE_PALLAS_MERGER = False
    plain = SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 2, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        got = fused.eval()(x)["refined_volumes"]
        want = plain.eval()(x)["refined_volumes"]
    assert torch.equal(got, want)
