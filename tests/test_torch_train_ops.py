"""The training slice's ops in swinvox_tpu_torch against the JAX package,
on the CPU, f32 on both sides, inputs drawn with numpy from a seed:

  * the training Swin block (kernels C/D's plain version) against JAX
    ``fused_swin_block_train`` in interpret mode, output, dx and every
    parameter gradient, with drop-path factors including 0;
  * ``rewindow``'s gradient against the JAX VJP (the inverse permutation,
    exactly);
  * the merger stack (kernels E/F's plain version) against JAX
    ``merger_stack_reference`` and its ``jax.vjp``;
  * train-mode ``Norm`` (batch statistics, biased running variance,
    external statistics) against flax;
  * losses and voxel metrics;
  * one optimizer update per module against the optax chain.

Tolerances: forward values atol 1e-4 (the repo's parity tolerance);
gradients and updated parameters per-tensor relative L2 <= 1e-3; the
merger conv stack's gradients <= 1e-2 (LeakyReLU branch flips from f32
statistics rounding, tests/test_pallas.py:723-731).  The card-side
comparison of kernels C-F with these plain versions is chip_smoke.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu_torch.ops import pallas_merger_stack as port_ms
from swinvox_tpu_torch.ops import pallas_swin_block as port_block
from swinvox_tpu_torch.ops import rewindow as port_rw

GRAD_RTOL = 1e-3
STACK_RTOL = 1e-2


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


# ------------------------------------------------- training Swin block


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_train_parity(rng, shift):
    """2 images of 14x14 tokens, C 64, 2 heads: output, dx and all 14
    parameter gradients of the plain training block == JAX
    ``fused_swin_block_train(interpret=True)``, with per-image drop-path
    factors (0, 1/0.9) and (1, 0)."""
    from swinvox_tpu.models.swin import shifted_window_mask
    from swinvox_tpu.ops.pallas_swin_block import fused_swin_block_train

    c, heads, nw, tok = 64, 2, 8, 49
    x = (rng.standard_normal((nw, tok, c)) * 0.5).astype(np.float32)
    params = [
        1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
        rng.standard_normal((c, 3 * c)) / np.sqrt(c),
        0.1 * rng.standard_normal(3 * c),
        rng.standard_normal((c, c)) / np.sqrt(c), 0.1 * rng.standard_normal(c),
        0.5 * rng.standard_normal((heads, tok, tok)),
        1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
        rng.standard_normal((c, 4 * c)) / np.sqrt(c),
        0.1 * rng.standard_normal(4 * c),
        rng.standard_normal((4 * c, c)) / np.sqrt(4 * c),
        0.1 * rng.standard_normal(c),
    ]
    params = [p.astype(np.float32) for p in params]
    mask = shifted_window_mask(14, 14, 7, 3) if shift else None
    dp1 = np.repeat(np.float32([0.0, 1 / 0.9]), 4)
    dp2 = np.repeat(np.float32([1.0, 0.0]), 4)
    ct = rng.standard_normal((nw, tok, c)).astype(np.float32)

    def jax_fn(xx, *ps):
        ps = list(ps)
        return fused_swin_block_train(
            xx, jnp.asarray(dp1), jnp.asarray(dp2), *ps[:7],
            None if mask is None else jnp.asarray(mask), *ps[7:],
            num_heads=heads, interpret=True)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(x), *map(jnp.asarray, params))
    ref_grads = vjp(jnp.asarray(ct))

    tx, tps = t(x, True), [t(p, True) for p in params]
    out = port_block.fused_swin_block_train(
        tx, t(dp1), t(dp2), *tps[:7],
        None if mask is None else t(mask), *tps[7:], num_heads=heads)
    out.backward(t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    for i, (got, want) in enumerate(zip([tx] + tps, ref_grads)):
        assert rel_l2(got.grad.numpy(), want) <= GRAD_RTOL, i
    # a zero factor keeps the residual path: dx is not zero there
    assert np.abs(tx.grad.numpy()[:4]).max() > 0.1


# ------------------------------------------------------------ rewindow


@pytest.mark.parametrize("sign", [-1, 1])
def test_rewindow_grad_is_inverse_permutation(rng, sign):
    """The port's rewindow gradient (autograd through the plain version)
    and the kernel's backward rule (rewindow with the opposite sign) both
    equal the JAX VJP exactly."""
    from swinvox_tpu.ops.rewindow import rewindow

    nwh = nww = 2
    x = rng.standard_normal((2 * nwh * nww, 49, 16)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a: rewindow(a, nwh, nww, 7, 3, sign, interpret=True),
        jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    tx = t(x, True)
    port_rw.rewindow(tx, nwh, nww, 7, 3, sign).backward(t(ct))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    back = port_rw.rewindow_reference(t(ct), nwh, nww, 7, 3, -sign)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


# -------------------------------------------------------- merger stack


def test_merger_stack_parity(rng):
    """N = 2: raw5, the six means and variances, and the gradients of x,
    the kernels, biases and BatchNorm affines against JAX
    ``merger_stack_reference`` + ``jax.vjp``.  The conv biases of layers
    0..4 feed a train-mode BatchNorm, so their gradient is 0 in exact
    arithmetic; both sides' values there are rounding noise, held to 1e-2
    of the layer's dbeta."""
    from swinvox_tpu.ops.pallas_merger_stack import merger_stack_reference

    n = 2
    x = rng.standard_normal((n, 32, 32, 32, 9)).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, 3, ci, co)) * (0.5 / np.sqrt(27 * ci))
           ).astype(np.float32) for ci, co in port_ms.CHANNELS]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32)
          for _, co in port_ms.CHANNELS]
    gs = [(1 + 0.1 * rng.standard_normal(9)).astype(np.float32)
          for _ in range(5)]
    bts = [(0.1 * rng.standard_normal(9)).astype(np.float32)
           for _ in range(5)]
    ct = rng.standard_normal((n, 32, 32, 32, 1)).astype(np.float32)

    def jax_fn(xx, k, b, g, bt):
        return merger_stack_reference(xx, k, b, g, bt)[0]

    args = (jnp.asarray(x), tuple(map(jnp.asarray, ks)),
            tuple(map(jnp.asarray, bs)), tuple(map(jnp.asarray, gs)),
            tuple(map(jnp.asarray, bts)))
    _, jm, jv = merger_stack_reference(*args)
    ref, vjp = jax.vjp(jax_fn, *args)
    gx, gk, gb, gg, gbt = vjp(jnp.asarray(ct))

    tx = t(x, True)
    tk, tb, tg, tbt = ([t(a, True) for a in group]
                       for group in (ks, bs, gs, bts))
    y, m, v = port_ms.merger_stack(tx, tk, tb, tg, tbt)
    y.backward(t(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=0)
    for i in range(6):
        np.testing.assert_allclose(m[i].detach().numpy(), np.asarray(jm[i]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(v[i].detach().numpy(), np.asarray(jv[i]),
                                   atol=1e-4, rtol=0)
    assert rel_l2(tx.grad.numpy(), gx) <= STACK_RTOL
    for i in range(6):
        assert rel_l2(tk[i].grad.numpy(), gk[i]) <= STACK_RTOL, f"dW{i}"
    for i in range(5):
        assert rel_l2(tg[i].grad.numpy(), gg[i]) <= STACK_RTOL, f"dgamma{i}"
        assert rel_l2(tbt[i].grad.numpy(), gbt[i]) <= STACK_RTOL, f"dbeta{i}"
        noise = np.linalg.norm(tb[i].grad.numpy() - np.asarray(gb[i]))
        assert noise <= STACK_RTOL * np.linalg.norm(np.asarray(gbt[i])), i
    assert rel_l2(tb[5].grad.numpy(), gb[5]) <= STACK_RTOL


# ---------------------------------------------------------------- Norm


@pytest.mark.parametrize("external", [False, True])
def test_train_norm_matches_flax(rng, external):
    """Train-mode Norm: output (atol 1e-4) and the running mean and
    *biased* variance after two updates, against the JAX ``Norm`` (flax
    BatchNorm, momentum 0.9); with external statistics too."""
    from swinvox_tpu.models.layers import Norm as JaxNorm
    from swinvox_tpu_torch.models.layers import Norm

    c = 6
    x = (2 + 3 * rng.standard_normal((4, 5, 5, c))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jn = JaxNorm(dtype=jnp.float32)
    stats = {"mean": jnp.asarray(0.1 * rng.standard_normal(c), jnp.float32),
             "var": jnp.asarray(1 + rng.random(c), jnp.float32)}
    variables = {"params": {"bn": {"scale": jnp.asarray(scale),
                                   "bias": jnp.asarray(bias)}},
                 "batch_stats": {"bn": dict(stats)}}
    pn = Norm(c, torch.float32)
    with torch.no_grad():
        pn.scale.copy_(t(scale))
        pn.bias.copy_(t(bias))
        pn.mean.copy_(t(stats["mean"]))
        pn.var.copy_(t(stats["var"]))
    xt = t(x).permute(0, 3, 1, 2)
    ext = None
    if external:
        m = x.reshape(-1, c).mean(0)
        v = (x.reshape(-1, c) ** 2).mean(0) - m * m
        ext = (jnp.asarray(m), jnp.asarray(v))
    for _ in range(2):
        y, upd = jn.apply(variables, jnp.asarray(x), True,
                          external_stats=ext, mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = pn(xt, True, None if ext is None else tuple(map(t, ext)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-4, rtol=0)
    bn = variables["batch_stats"]["bn"]
    np.testing.assert_allclose(pn.mean.numpy(), np.asarray(bn["mean"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pn.var.numpy(), np.asarray(bn["var"]),
                               atol=1e-5, rtol=1e-5)
    # biased: the unbiased variance would differ by n / (n - 1) = 100 / 99
    assert abs(pn.var.numpy() - np.asarray(stats["var"])).max() > 1e-2


# -------------------------------------------------------------- losses


def test_losses_match_jax(rng):
    """BCE (mean and per sample), IoU and F-score at the four thresholds,
    including an empty-union sample (IoU 1)."""
    from swinvox_tpu.ops import losses as jl
    from swinvox_tpu_torch.ops import losses as pl_

    logits = (3 * rng.standard_normal((3, 8, 8, 8))).astype(np.float32)
    labels = (rng.random((3, 8, 8, 8)) < 0.4).astype(np.float32)
    labels[2] = 0.0
    probs = 1 / (1 + np.exp(-logits))
    probs[2] = 0.05
    np.testing.assert_allclose(
        pl_.bce_with_logits(t(logits), t(labels)).numpy(),
        np.asarray(jl.bce_with_logits(jnp.asarray(logits),
                                      jnp.asarray(labels))), atol=1e-6)
    np.testing.assert_allclose(
        pl_.bce_with_logits_per_sample(t(logits), t(labels)).numpy(),
        np.asarray(jl.bce_with_logits_per_sample(jnp.asarray(logits),
                                                 jnp.asarray(labels))),
        atol=1e-6)
    iou = pl_.voxel_iou(t(probs), t(labels)).numpy()
    np.testing.assert_allclose(
        iou, np.asarray(jl.voxel_iou(jnp.asarray(probs), jnp.asarray(labels))),
        atol=1e-6)
    assert np.all(iou[2] == 1.0)
    np.testing.assert_allclose(
        pl_.voxel_fscore(t(probs), t(labels)).numpy(),
        np.asarray(jl.voxel_fscore(jnp.asarray(probs), jnp.asarray(labels))),
        atol=1e-6)


# ----------------------------------------------------------- optimizer


@pytest.mark.parametrize("policy,clipped", [("adam", False), ("adam", True),
                                            ("sgd", True)])
def test_optimizer_update_matches_optax(rng, policy, clipped):
    """Two updates of one module (non-zero moments in the second) against
    the JAX package's optax chain (clip -> L2 -> Adam or momentum) applied
    as its train step applies it, the learning rate read from the MultiStepLR
    schedule at a global step past a milestone: new parameters and moments
    within relative L2 1e-3."""
    from swinvox_tpu.config import default_config as jax_config
    from swinvox_tpu.train.optim import build_optimizers as jax_build
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.train.optim import build_optimizers

    cfgs = [jax_config(), default_config()]
    for cfg in cfgs:
        cfg.TRAIN.POLICY = policy
        cfg.TRAIN.DECODER_LR_MILESTONES = (2,)
        cfg.TRAIN.DECODER_LEARNING_RATE = 1e-2
    jopt = jax_build(cfgs[0], 3)["decoder"]
    popt = build_optimizers(cfgs[1], 3)["decoder"]
    for step in (0, 5, 6, 9):  # milestone epoch 2 x 3 steps = step 6
        assert popt.schedule(step) == pytest.approx(
            float(jopt.schedule(step)), rel=1e-7)
    assert popt.schedule(6) < popt.schedule(5)

    gscale = 10.0 if clipped else 1e-3  # global norm above / below 1.0
    shapes = {"a.kernel": (4, 5), "a.bias": (5,), "b.kernel": (3, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (gscale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    pp = {k: t(v) for k, v in params.items()}
    pstate = popt.init(pp)
    for step, g in zip((5, 6), grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, jstate = jopt.transform.update(jg, jstate, jp)
        lr = jopt.schedule(step)
        jp = jax.tree.map(lambda p, u: p - lr * u, jp, upd)
        popt.apply(pp, {k: t(v) for k, v in g.items()}, pstate,
                   popt.schedule(step))
    for k in shapes:
        assert rel_l2(pp[k].numpy(), jp[k]) <= GRAD_RTOL, k
        assert rel_l2(pp[k].numpy(), params[k]) > 1e-6, k  # it moved
    inner = jstate[-1]
    if policy == "adam":
        assert pstate["count"] == int(inner.count) == 2
        for k in shapes:
            assert rel_l2(pstate["mu"][k].numpy(), inner.mu[k]) <= GRAD_RTOL
            assert rel_l2(pstate["nu"][k].numpy(), inner.nu[k]) <= GRAD_RTOL
    else:
        for k in shapes:
            assert rel_l2(pstate["trace"][k].numpy(),
                          inner.trace[k]) <= GRAD_RTOL
