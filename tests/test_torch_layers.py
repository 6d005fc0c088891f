"""swinvox_tpu_torch primitives (models/layers.py) against the JAX package's
on the same numpy-drawn weights and inputs, f32 on the CPU.  Layouts at
the boundary: JAX is channels-last, the port NCHW / NCDHW, so the test
moves the channel axis; weights go through convert.load_jax_variables.
Tolerance: atol 1e-5 (f32 convs summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu.models import layers as jl
from swinvox_tpu_torch.convert import load_jax_variables
from swinvox_tpu_torch.models import layers as tl

ATOL = 1e-5


def _cl(x):  # NC... -> N...C
    return np.moveaxis(x, 1, -1)


def _cf(x):  # N...C -> NC...
    return np.moveaxis(np.asarray(x), -1, 1)


def _random_vars(module, x, rng, train=False):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    out = {}
    for coll, tree in shapes.items():
        out[coll] = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.3
            + (1.0 if coll == "batch_stats" else 0.0),
            tree,
        )
    return out


def _port(mod, variables, x_cf):
    load_jax_variables(mod, variables)
    with torch.no_grad():
        return mod(torch.from_numpy(np.ascontiguousarray(x_cf))).numpy()


@pytest.mark.parametrize(
    "kernel,strides,padding,groups,cin,cout",
    [((3, 3), 2, 1, 1, 8, 16),          # strided down conv
     ((7, 7), 2, 3, 1, 3, 8),           # resnet stem
     ((2, 2), 2, 0, 8, 8, 8),           # CVA depthwise downsample
     ((3, 3, 3), 1, 1, 1, 9, 9),        # merger conv
     ((4, 4, 4), 1, 2, 1, 1, 4)],       # refiner down1 (32 -> 33)
)
def test_conv_parity(rng, kernel, strides, padding, groups, cin, cout):
    shape = (2,) + (9,) * len(kernel) + (cin,)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jl.Conv(cout, kernel, strides=strides, padding=padding,
                 feature_group_count=groups, dtype=jnp.float32)
    v = _random_vars(jm, x, rng)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = _port(tl.Conv(cin, cout, kernel, strides, padding,
                        feature_group_count=groups, dtype=torch.float32),
                v, _cf(x))
    np.testing.assert_allclose(_cl(got), ref, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize(
    "kernel,strides,padding,cin,cout,side",
    [((6, 4, 4), 2, (2, 1, 1), 16, 8, 2),   # decoder tconv1: 2^3 -> 4^3
     ((4, 4, 4), 2, (1, 1, 1), 8, 4, 4),    # decoder / refiner up
     ((1, 1, 1), 1, 0, 8, 1, 4)],           # decoder tconv5
)
def test_conv_transpose_parity(rng, kernel, strides, padding, cin, cout,
                               side):
    """The JAX transposed conv does not flip its kernel; the bridge flips
    it for F.conv_transpose3d."""
    x = rng.standard_normal((2, side, side, side, cin)).astype(np.float32)
    jm = jl.ConvTranspose(cout, kernel, strides=strides, padding=padding,
                          use_bias=True, dtype=jnp.float32)
    v = _random_vars(jm, x, rng)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = _port(tl.ConvTranspose(cin, cout, kernel, strides, padding,
                                 use_bias=True, dtype=torch.float32),
                v, _cf(x))
    assert _cl(got).shape == ref.shape
    np.testing.assert_allclose(_cl(got), ref, atol=ATOL, rtol=1e-5)


def test_dense_and_layernorm_parity(rng):
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    jm = jl.Dense(12, dtype=jnp.float32)
    v = _random_vars(jm, x, rng)
    np.testing.assert_allclose(
        _port(tl.Dense(24, 12, dtype=torch.float32), v, x),
        np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=1e-5)

    jm = jl.LayerNorm(dtype=jnp.float32)
    v = _random_vars(jm, x, rng)
    np.testing.assert_allclose(
        _port(tl.LayerNorm(24, torch.float32), v, x),
        np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=1e-5)

    # the encoder's per-stage LayerNorm([C, H, W]) (JAX: num_axes=3)
    x4 = rng.standard_normal((2, 7, 7, 16)).astype(np.float32) * 2 + 1
    jm = jl.LayerNorm(dtype=jnp.float32, num_axes=3)
    v = _random_vars(jm, x4, rng)
    got = _port(tl.LayerNorm((16, 7, 7), torch.float32), v, _cf(x4))
    np.testing.assert_allclose(_cl(got), np.asarray(jm.apply(v, jnp.asarray(
        x4))), atol=ATOL, rtol=1e-5)


def test_norm_eval_parity(rng):
    x = rng.standard_normal((2, 4, 4, 4, 6)).astype(np.float32)
    jm = jl.Norm(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    v = {"params": jax.tree.map(lambda s: rng.standard_normal(s.shape)
                                .astype(np.float32), shapes["params"]),
         "batch_stats": {"bn": {
             "mean": rng.standard_normal(6).astype(np.float32),
             "var": (0.5 + rng.random(6)).astype(np.float32)}}}
    ref = np.asarray(jm.apply(v, jnp.asarray(x), False))
    got = _port(tl.Norm(6, torch.float32), v, _cf(x))
    np.testing.assert_allclose(_cl(got), ref, atol=ATOL, rtol=1e-5)


def test_pools_and_resize_parity(rng):
    x = rng.standard_normal((2, 14, 14, 5)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(_cf(x)))
    # the trunk's max-pool: -inf pad 1, then VALID 3x3/2
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=-jnp.inf)
    cases = [
        (jl.max_pool(xp, 3, 2), tl.max_pool(xt, 3, 2, padding=1)),
        (jl.max_pool(jnp.asarray(x), 2), tl.max_pool(xt, 2)),
        (jl.avg_pool(jnp.asarray(x), 2), tl.avg_pool(xt, 2)),
    ]
    x7 = jnp.asarray(x[:, :7, :7])
    x7t = torch.from_numpy(np.ascontiguousarray(_cf(x[:, :7, :7])))
    cases.append((jl.adaptive_avg_pool_7_to_2(x7),
                  tl.adaptive_avg_pool_7_to_2(x7t)))
    # CVA upsample 3 -> 7 and the swin resize 14 -> 8 (JAX antialiases)
    x3 = x[:, :3, :3]
    cases.append((jl.resize_bilinear(jnp.asarray(x3), (7, 7)),
                  tl.resize_bilinear(torch.from_numpy(
                      np.ascontiguousarray(_cf(x3))), (7, 7))))
    cases.append((jl.resize_bilinear(jnp.asarray(x), (8, 8)),
                  tl.resize_bilinear(xt, (8, 8))))
    for ref, got in cases:
        np.testing.assert_allclose(_cl(got.numpy()), np.asarray(ref),
                                   atol=ATOL, rtol=1e-5)


def test_reference_init_statistics():
    """init_reference_ draws the JAX package's distributions from a
    torch.Generator: conv kaiming(fan_out) x0.1, dense N(0, 0.001),
    norms at ones/zeros, biases zero; the same seed gives the same draw."""
    def make():
        mod = torch.nn.Sequential(tl.Conv(64, 256, (3, 3)),
                                  tl.Dense(512, 256), tl.LayerNorm(8),
                                  tl.Norm(8))
        tl.init_reference_(mod, torch.Generator().manual_seed(3))
        return mod

    m = make()
    conv_std = tl._LEAKY_GAIN / np.sqrt(256 * 9) * 0.1
    assert abs(m[0].kernel.std().item() / conv_std - 1) < 0.02
    assert abs(m[1].kernel.std().item() / 0.001 - 1) < 0.02
    assert torch.all(m[0].bias == 0) and torch.all(m[1].bias == 0)
    assert torch.all(m[2].scale == 1) and torch.all(m[3].var == 1)
    assert torch.equal(make()[0].kernel, m[0].kernel)
    with pytest.raises(ValueError):
        tl.init_reference_(m, torch.Generator(), scheme="bogus")
