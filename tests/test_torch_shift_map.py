"""The aligned Swin chain of swinvox_tpu_torch against the JAX package's
rewindow chain, on the CPU, f32, inputs drawn with numpy from a seed.

The port keeps a stage's tokens in the aligned window-major layout: a
shifted block's kernels (B, C, D) read and write the shifted windows
through the roll's map, and their plain versions relayout qkv and the
attention's output with ``rewindow_reference``.  The JAX chain moves the
tokens themselves: ``rewindow(-1)`` -> fused block -> ``rewindow(+1)``.
Both compute the same function; these tests hold the plain versions (the
CPU side of the kernels) and the whole ``SwinTiny`` chain to it, forward
and gradients.  Tolerances: forward atol 2e-4 (tests/test_pallas.py's
for the JAX chain), gradients relative L2 1e-3 (test_torch_train_ops.py's
for the training block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu_torch.convert import jax_variables, load_jax_variables
from swinvox_tpu_torch.ops import pallas_swin_block as port_block

GRAD_RTOL = 1e-3


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_block_shift_map_matches_jax_rewindow_chain(rng, mode):
    """2 images of 14 x 14 tokens (2 x 2 windows), C 64, 2 heads, shift 3:
    the port's block on aligned tokens with (nwh, nww, shift) == JAX
    ``rewindow(-1)`` -> ``fused_swin_block(_train)`` (interpret) ->
    ``rewindow(+1)``; in training with per-image drop-path factors
    (0, 1/0.9) and (1, 0), output, dx and all 14 parameter gradients."""
    from swinvox_tpu.models.swin import shifted_window_mask
    from swinvox_tpu.ops.pallas_swin_block import (
        fused_swin_block,
        fused_swin_block_train,
    )
    from swinvox_tpu.ops.rewindow import rewindow

    c, heads, nw, tok, grid, shift = 64, 2, 8, 49, 2, 3
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
    mask = shifted_window_mask(14, 14, 7, shift)
    dp1 = np.repeat(np.float32([0.0, 1 / 0.9]), 4)
    dp2 = np.repeat(np.float32([1.0, 0.0]), 4)
    ct = rng.standard_normal((nw, tok, c)).astype(np.float32)
    train = mode == "train"

    def jax_fn(xx, *ps):
        ps = list(ps)
        y = rewindow(xx, grid, grid, 7, shift, -1, interpret=True)
        ops = (*ps[:7], jnp.asarray(mask), *ps[7:])
        if train:
            y = fused_swin_block_train(y, jnp.asarray(dp1), jnp.asarray(dp2),
                                       *ops, num_heads=heads, interpret=True)
        else:
            y = fused_swin_block(y, *ops, num_heads=heads, interpret=True)
        return rewindow(y, grid, grid, 7, shift, 1, interpret=True)

    jargs = (jnp.asarray(x), *map(jnp.asarray, params))
    if train:
        ref, vjp = jax.vjp(jax_fn, *jargs)
    else:  # the inference kernel has no VJP
        ref = jax_fn(*jargs)
    tx, tps = t(x, train), [t(p, train) for p in params]
    ops = (*tps[:7], t(mask), *tps[7:])
    kw = dict(num_heads=heads, nwh=grid, nww=grid, shift=shift)
    if train:
        out = port_block.fused_swin_block_train(tx, t(dp1), t(dp2), *ops,
                                                **kw)
    else:
        out = port_block.fused_swin_block(tx, *ops, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=2e-4, rtol=0)
    if train:
        out.backward(t(ct))
        for i, (got, want) in enumerate(zip([tx] + tps,
                                            vjp(jnp.asarray(ct)))):
            assert rel_l2(got.grad.numpy(), want) <= GRAD_RTOL, i


def test_swin_chain_matches_jax_forward_and_gradients(rng):
    """SwinTiny at 56^2, embed 16, one stage of depth 2 (an aligned and a
    shifted block), 2 heads, in training on the fused-block chain
    (use_pallas_block_train, drop-path rate 0): the port's aligned chain
    == the JAX rewindow chain (interpret), the stage output and the
    gradients of every parameter and of the image."""
    from swinvox_tpu.models.swin import SwinTiny
    from swinvox_tpu_torch.models.swin import SwinTiny as PortSwin

    kw = dict(embed_dim=16, depths=(2,), num_heads=(2,), img_size=56,
              drop_path_rate=0.0)
    x = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref = SwinTiny(dtype=jnp.float32, use_pallas_block_train=True,
                   pallas_interpret=True, **kw)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32),
        ref.init(jax.random.PRNGKey(1), jnp.asarray(x), False)["params"])
    outs = ref.apply({"params": params}, jnp.asarray(x), True)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]

    def loss(p, xx):
        ys = ref.apply({"params": p}, xx, True)
        return sum(jnp.sum(y * c) for y, c in zip(ys, cts))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    port = PortSwin(dtype=torch.float32, use_pallas_block_train=True, **kw)
    assert port.train_chain
    load_jax_variables(port, {"params": params})
    tx = t(x, True)
    got = port(tx, train=True, generator=torch.Generator().manual_seed(0))
    assert len(got) == len(outs)
    for a, b in zip(outs, got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=2e-4, atol=2e-4)
    sum((y * t(c)).sum() for y, c in zip(got, cts)).backward()
    assert rel_l2(tx.grad.numpy(), gx) <= GRAD_RTOL
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(p.grad)
    want = jax.tree_util.tree_leaves_with_path(gp)
    have = dict(jax.tree_util.tree_leaves_with_path(
        jax_variables(port)["params"]))
    assert len(want) == len(have)
    for path, g in want:
        assert rel_l2(have[path], g) <= GRAD_RTOL, jax.tree_util.keystr(path)
