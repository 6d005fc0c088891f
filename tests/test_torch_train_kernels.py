"""swinvox_tpu_torch kernels J and K (one merger conv, forward and weight
gradient: ``band_conv3d`` and ``slab_conv3d``) and L (the refiner's fused
``down1`` backward: ``conv3d_down1``) against the JAX package, with inputs
drawn with numpy from a seed.

On the CPU the port's wrappers run their plain PyTorch versions.  The
JAX side runs each Pallas kernel once in interpret mode, as
tests/test_pallas.py does and with its tolerances, and its plain
``lax.conv_general_dilated`` for the other channel shapes.  Each route's
rounding of dW in bf16 is pinned against the JAX route: the banded
merger and ``down1`` take a bf16 kernel, so their dW is bf16; the slab
merger keeps the f32 kernel and an f32 dW.  The modules (``Merger`` on
the slab and banded routes, ``Refiner`` with ``down1_pallas``) are held
against the JAX modules on the CPU, whose routes fall back to XLA convs
there: output, BatchNorm statistics and gradients, at 2 x 3 volumes and
at 1 view.  The kernels themselves are held against their plain versions
on the card (``test_train_kernels_match_plain_on_card``, marked ``cuda``,
and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import COMPILE, random_variables

from swinvox_tpu_torch.convert import load_jax_variables, tree_to_torch
from swinvox_tpu_torch.ops import pallas_band_conv as port_band
from swinvox_tpu_torch.ops import pallas_down1 as port_down1
from swinvox_tpu_torch.ops.pallas_slab_conv import slab_conv3d


def _lax_conv(x, k, pad):
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    return jax.lax.conv_general_dilated(x, k, (1, 1, 1), [(pad, pad)] * 3,
                                        dimension_numbers=dn)


def _loss64(y, t):
    """The loss in float64 on the host: the two frameworks' f32 sums over
    millions of terms differ by ~2e-4 relative, which says nothing about
    the op (the gradients 2 (y - t) do not see the sum's order)."""
    return float(((np.asarray(y, np.float64) - np.asarray(t)) ** 2).sum())


def _port_grads(fn, x, k, t):
    """(loss, dx, dk) of sum((fn(x, k) - t)^2) through the port's op."""
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    kt = torch.from_numpy(np.array(k)).requires_grad_()
    y = fn(xt, kt)
    ((y - torch.from_numpy(np.array(t))) ** 2).sum().backward()
    return _loss64(y.detach(), t), xt.grad.numpy(), kt.grad.numpy()


def _jax_grads(fn, x, k, t):
    y, vjp = jax.vjp(fn, x, k)
    gx, gk = vjp(2.0 * (y - t))
    return _loss64(y, t), np.asarray(gx), np.asarray(gk)


def _merger_inputs(rng, v, ci, co):
    x = jnp.asarray(rng.standard_normal((v, 32, 32, 32, ci)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((3, 3, 3, ci, co)) * 0.1,
                    jnp.float32)
    t = jnp.asarray(rng.standard_normal((v, 32, 32, 32, co)), jnp.float32)
    return x, k, t


# ------------------------------------------------------- kernels J and K


@pytest.mark.parametrize("route,ci,co", [("band", 9, 9), ("slab", 36, 9)])
def test_merger_conv_matches_jax_interpret(rng, route, ci, co):
    """``band_conv3d`` (9 -> 9) and ``slab_conv3d`` (36 -> 9), value and
    both gradients, against the JAX route's Pallas kernel in interpret
    mode at 2 volumes: loss rtol 1e-5, dx 1e-4, dW rtol 1e-4 atol 1e-3
    (band) / 2e-3 (slab), tests/test_pallas.py's."""
    from swinvox_tpu.ops.pallas_band_conv import band_conv3d
    from swinvox_tpu.ops.pallas_slab_conv import slab_conv3d as jax_slab

    x, k, t = _merger_inputs(rng, 2, ci, co)
    jfn = (lambda x, k: band_conv3d(x, k, interpret=True)) if route == \
        "band" else (lambda x, k: jax_slab(x, k, interpret=True))
    pfn = port_band.band_conv3d if route == "band" else slab_conv3d
    l0, gx0, gk0 = _jax_grads(jfn, x, k, t)
    l1, gx1, gk1 = _port_grads(pfn, x, k, t)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(gx1, gx0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gk1, gk0, rtol=1e-4,
                               atol=1e-3 if route == "band" else 2e-3)


@pytest.mark.parametrize("route,ci,co", [("band", 36, 9), ("band", 9, 1),
                                         ("slab", 9, 9), ("slab", 9, 1)])
def test_merger_conv_matches_lax_conv(rng, route, ci, co):
    """The other channel shapes of both routes against JAX's plain SAME
    conv (f32): the same tolerances."""
    x, k, t = _merger_inputs(rng, 2, ci, co)
    pfn = port_band.band_conv3d if route == "band" else slab_conv3d
    l0, gx0, gk0 = _jax_grads(lambda x, k: _lax_conv(x, k, 1), x, k, t)
    l1, gx1, gk1 = _port_grads(pfn, x, k, t)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(gx1, gx0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gk1, gk0, rtol=1e-4, atol=2e-3)


def test_merger_conv_launch_counts_stay_on_cpu(rng):
    """On CPU tensors kernels J and K are not launched (their plain
    versions run), and a non-CPU, non-CUDA tensor is refused."""
    x, k, t = _merger_inputs(rng, 1, 9, 9)
    before = (port_band.merger_conv_forward.launches,
              port_band.merger_conv_wgrad.launches)
    _port_grads(port_band.band_conv3d, x, k, t)
    assert (port_band.merger_conv_forward.launches,
            port_band.merger_conv_wgrad.launches) == before
    with pytest.raises(RuntimeError):
        port_band.merger_conv_forward(torch.zeros(1, 32, 32, 32, 9,
                                                  device="meta"),
                                      torch.zeros(3, 3, 3, 9, 9))


# ------------------------------------------------------------- kernel L


def test_conv3d_down1_matches_jax_interpret(rng):
    """``conv3d_down1`` at N = 5 (not a multiple of 16: the 33^3 halo,
    cropped to 32^3 in dx) against the JAX op with its Pallas backward in
    interpret mode: loss rtol 1e-6, dx 1e-4, dW rtol 1e-4 atol 1e-4 x its
    scale, tests/test_pallas.py's."""
    from swinvox_tpu.ops.pallas_down1 import conv3d_down1

    n = 5
    x = jnp.asarray(rng.standard_normal((n, 32, 32, 32, 1)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((4, 4, 4, 1, 32)) * 0.1, jnp.float32)
    t = jnp.asarray(rng.standard_normal((n, 33, 33, 33, 32)), jnp.float32)
    l0, gx0, gk0 = _jax_grads(
        lambda x, k: conv3d_down1(x, k, interpret=True), x, k, t)
    l1, gx1, gk1 = _port_grads(port_down1.conv3d_down1, x, k, t)
    assert gx1.shape == (n, 32, 32, 32, 1)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    np.testing.assert_allclose(gx1, gx0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gk1, gk0, rtol=1e-4,
                               atol=1e-4 * float(np.abs(gk0).max()))


# ------------------------------------------------- bf16: dW's rounding


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("route", ["band", "slab", "down1"])
def test_bf16_weight_gradient_rounding(rng, route):
    """In bf16 the banded route and ``down1`` get the kernel cast to bf16
    by their caller, so dW reaches the f32 parameter rounded to bf16; the
    slab route keeps the f32 kernel and an f32 dW.  The port's parameter
    gradient against the JAX route's op in interpret mode, with the
    caller's cast, on bf16 inputs: band and down1 exactly bf16 values
    within one bf16 ulp of JAX's (the f32 sums run in another order, then
    round); slab f32 values within rtol 1e-4 of JAX's, not rounded."""
    from swinvox_tpu.ops.pallas_band_conv import band_conv3d
    from swinvox_tpu.ops.pallas_down1 import conv3d_down1
    from swinvox_tpu.ops.pallas_slab_conv import slab_conv3d as jax_slab

    if route == "down1":
        x = rng.standard_normal((2, 32, 32, 32, 1))
        k = rng.standard_normal((4, 4, 4, 1, 32)) * 0.1
        ct = rng.standard_normal((2, 33, 33, 33, 32))
        jax_op = lambda x, k: conv3d_down1(  # noqa: E731
            x, k.astype(jnp.bfloat16), interpret=True)
        port_op = lambda x, k: port_down1.conv3d_down1(  # noqa: E731
            x, k.to(torch.bfloat16))
    else:
        x = rng.standard_normal((1, 32, 32, 32, 9))
        k = rng.standard_normal((3, 3, 3, 9, 9)) * 0.1
        ct = rng.standard_normal((1, 32, 32, 32, 9))
        if route == "band":
            jax_op = lambda x, k: band_conv3d(  # noqa: E731
                x, k.astype(jnp.bfloat16), interpret=True)
            port_op = lambda x, k: port_band.band_conv3d(  # noqa: E731
                x, k.to(torch.bfloat16))
        else:
            jax_op = lambda x, k: jax_slab(x, k, interpret=True)  # noqa
            port_op = slab_conv3d
    xb = jnp.asarray(x, jnp.bfloat16)
    kf = jnp.asarray(k, jnp.float32)
    want = np.asarray(jax.grad(lambda kk: jnp.sum(
        jax_op(xb, kk).astype(jnp.float32) * ct))(kf))

    kt = torch.from_numpy(np.array(kf)).requires_grad_()
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    y = port_op(xt, kt)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(ct).float()).sum().backward()
    got = kt.grad.numpy()
    scale = float(np.abs(want).max())
    if route == "slab":
        assert not np.array_equal(_bf16(want), want)  # JAX: not rounded
        assert not np.array_equal(_bf16(got), got)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        np.testing.assert_array_equal(_bf16(want), want)  # JAX: bf16
        np.testing.assert_array_equal(_bf16(got), got)
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=1e-5 * scale)


# -------------------------------------------------------------- modules


def _rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_stats(model, jax_stats):
    """The updated running statistics against the JAX tree: rtol and atol
    1e-4."""
    ref = tree_to_torch(jax_stats, model)
    got = {n: t for n, t in model.state_dict().items()
           if n.endswith((".mean", ".var"))}
    assert set(ref) == set(got)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _jax_train_grads(module, *inputs, seed=0):
    """Random variables for a JAX module (``random_variables``: fan-in
    weights, statistics off their init; no init is run) and one
    training-mode application with the gradients of sum(out^2) in the
    parameters and the first input, compiled at the tests' XLA options:
    (variables, out, updated statistics, param grads, input grad)."""
    v = random_variables(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *inputs, True)), seed)

    def loss(p, x):
        out, mut = module.apply({"params": p,
                                 "batch_stats": v["batch_stats"]}, x,
                                *inputs[1:], True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True)).lower(
        v["params"], inputs[0]).compile(compiler_options=COMPILE)
    (_, (out, stats)), (gp, gx) = fn(v["params"], inputs[0])
    return v, out, stats, gp, gx


@pytest.fixture(scope="module")
def jax_merger_runs():
    """The JAX merger in training (f32, XLA convs on the CPU), at 2
    samples x 3 views and at 1 view: variables, inputs, output, updated
    statistics and gradients (parameters and raw features)."""
    from swinvox_tpu.models.merger import Merger

    rng = np.random.default_rng(1)
    runs = {}
    for n_views in (3, 1):
        raw = jnp.asarray(rng.standard_normal((2, n_views, 32, 32, 32, 9)),
                          jnp.float32)
        coarse = jnp.asarray(rng.standard_normal((2, n_views, 32, 32, 32)),
                             jnp.float32)
        v, out, stats, gp, graw = _jax_train_grads(
            Merger(dtype=jnp.float32), raw, coarse, seed=n_views)
        runs[n_views] = (v, raw, coarse, out, stats, gp, graw)
    return runs


@pytest.mark.parametrize("n_views", [3, 1])
@pytest.mark.parametrize("route", ["slab", "band"])
def test_merger_routes_match_jax(jax_merger_runs, route, n_views):
    """``Merger(use_slab)`` and ``Merger(use_pallas_train)`` in training
    (f32) against the JAX merger at 2 samples x n views, with the port's
    parity tolerances (tests/test_torch_train_ops.py): output and updated
    running statistics rtol and atol 1e-4 (the softmax over views and
    BatchNorm variances of O(10) magnify f32 rounding); the gradients of
    the parameters and the raw features per-tensor relative L2 <= 1e-2
    (the merger stack's: LeakyReLU branch flips from f32 statistics
    rounding).  Every conv bias feeds a train-mode BatchNorm, so its
    gradient is 0 in exact arithmetic and rounding noise in both
    packages: held to 1e-2 of the same layer's BatchNorm offset
    gradient.  At 1 view the merged volume is the coarse one, the stack
    runs for its statistics only and every gradient is exactly zero."""
    from swinvox_tpu_torch.models.merger import Merger

    v, raw, coarse, out, stats, gp, graw = jax_merger_runs[n_views]
    model = Merger(dtype=torch.float32, use_slab=route == "slab",
                   use_pallas_train=route == "band")
    load_jax_variables(model, v)
    b = raw.shape[0]
    raw_t = torch.from_numpy(np.array(raw)).reshape(b * n_views, 32, 32, 32,
                                                     9)
    raw_t = raw_t.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
    got = model(raw_t, torch.from_numpy(np.array(coarse)), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    _check_stats(model, stats)
    ref = {k: t.numpy() for k, t in tree_to_torch(gp, model).items()}
    if n_views == 1:
        assert not got.requires_grad  # nothing flows into the merger
        assert not any(r.any() for r in ref.values())
        assert not np.asarray(graw).any()
        return
    (got ** 2).sum().backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(ref)
    for name, want in ref.items():
        layer = name.split(".")[0]
        if layer.startswith("conv") and name.endswith(".bias"):
            dbeta = ref["bn" + layer[4:] + ".bias"]
            noise = np.linalg.norm(grads[name] - want)
            assert noise <= 1e-2 * np.linalg.norm(dbeta), name
            continue
        assert _rel_l2(grads[name], want) <= 1e-2, name
    want_raw = np.asarray(graw).reshape(b * n_views, 32, 32, 32, 9)
    assert _rel_l2(raw_t.grad.permute(0, 2, 3, 4, 1).numpy(),
                   want_raw) <= 1e-2


def test_refiner_down1_matches_jax():
    """``Refiner(down1_pallas)`` in training (f32) against the JAX refiner
    (whose fused down1 backward equals its XLA one in the JAX package's
    own test), with the port's parity tolerances: output atol 1e-4,
    updated running statistics rtol and atol 1e-4, the input's gradient
    per-tensor relative L2 <= 1e-3 and every parameter's <= 1e-2 (the
    max-pools' argmax near-ties, as in the ResNet trunk: ROADMAP.md
    "Faults"; they read up to 1.1e-3), except the biases of the three
    down convs: a train-mode BatchNorm follows each, so their gradient is
    0 in exact arithmetic and rounding noise in both packages, held to
    1e-2 of the BatchNorm offset's gradient."""
    from swinvox_tpu.models.refiner import Refiner as JaxRefiner

    from swinvox_tpu_torch.models.refiner import Refiner

    rng = np.random.default_rng(2)
    vol = jnp.asarray(rng.standard_normal((2, 32, 32, 32)), jnp.float32)
    v, out, stats, gp, gv = _jax_train_grads(JaxRefiner(dtype=jnp.float32),
                                             vol, seed=2)

    model = Refiner(dtype=torch.float32, down1_pallas=True)
    load_jax_variables(model, v)
    vol_t = torch.from_numpy(np.array(vol)).requires_grad_()
    got = model(vol_t, train=True)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-4)
    _check_stats(model, stats)
    assert _rel_l2(vol_t.grad.numpy(), gv) <= 1e-3
    params = dict(model.named_parameters())
    ref = {k: t.numpy() for k, t in tree_to_torch(gp, model).items()}
    for name, want in ref.items():
        got_g = params[name].grad.numpy()
        if name.startswith("down") and name.endswith("_conv.bias"):
            dbeta = ref[name.replace("_conv.bias", "_bn.bias")]
            noise = np.linalg.norm(got_g - want)
            assert noise <= 1e-2 * np.linalg.norm(dbeta), name
            continue
        assert _rel_l2(got_g, want) <= 1e-2, name


# ----------------------------------------------------------- on the card


@pytest.mark.cuda
def test_train_kernels_match_plain_on_card():
    """On a card: kernels J, K and L against their plain versions (f32
    operands, TF32 off): within 1e-3 of the largest entry in bf16 and
    1e-5 in f32 (sums of the same exact products in another order).  K
    at each of its three (ci, co), bf16 (tensor cores) and f32 (CUDA
    cores), also gives the same bits when launched twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the H100")
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * s

    def close(got, want, dtype):
        tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        want = want.float().cpu()
        err = (got.float().cpu() - want).abs().max().item()
        assert err <= tol * want.abs().max().item()

    for dtype in (torch.bfloat16, torch.float32):
        for ci, co in port_band.CONV_SHAPES:
            x, k = r(3, 32, 32, 32, ci).to(dtype), r(3, 3, 3, ci, co, s=0.2)
            close(port_band.merger_conv_forward(x, k),
                  port_band.merger_conv_reference(x.cpu(), k.cpu()), dtype)
            if (ci, co) in port_band.FORWARD_SHAPES:
                dy = r(3, 32, 32, 32, co).to(dtype)
                dw = port_band.merger_conv_wgrad(x, dy)
                close(dw, port_band.merger_conv_wgrad_reference(x.cpu(),
                                                                dy.cpu()),
                      dtype)
                assert torch.equal(port_band.merger_conv_wgrad(x, dy), dw)
        x, w = r(3, 32, 32, 32, 1).to(dtype), r(4, 4, 4, 1, 32, s=0.2)
        dy = r(3, 33, 33, 33, 32).to(dtype)
        got = port_down1.down1_backward(x, w, dy)
        want = port_down1.down1_backward_reference(x.cpu(), w.cpu(),
                                                   dy.cpu())
        for a, b in zip(got, want):
            close(a, b, dtype)
    torch.cuda.synchronize()
