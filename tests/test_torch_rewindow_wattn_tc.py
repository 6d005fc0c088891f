"""Kernels A (rewindow) and G (the window-attention core) as redesigned
for Hopper, and the train step's repeatable gradients, held on the CPU.

The port's wrappers run their plain PyTorch versions here; the JAX side
runs its Pallas kernels in interpret mode (or its XLA function), as the
JAX package's own tests do.  The kernels' host-side index math (A's
source rows, G's item order and block ranges, the multiply-shift
divisions of ``csrc/fast_div.cuh``) is held against the plain versions,
and G's arithmetic and schedule are modelled in torch (bias and mask
staged per run of items, base-2 softmax, P rounded to bf16) and held
against JAX.  Inputs are drawn with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu_torch.models import swin as port_swin
from swinvox_tpu_torch.ops import pallas_window_attention as port_attn
from swinvox_tpu_torch.ops import rewindow as port_rw
from swinvox_tpu_torch.train import steps as port_steps

# chip_smoke.py's REWINDOW_CALLS: (side, channels, sign) of the JAX
# chain's serving forward
REWINDOW_SHAPES = [(56, 96, -1), (28, 192, -1), (14, 384, -1), (14, 384, 1)]
# chip_smoke.py's STAGES: (side, heads)
STAGES = [(56, 3), (28, 6), (14, 12), (7, 24)]

# ------------------------------------------------------------- kernel A


@pytest.mark.parametrize("side,c,sign", REWINDOW_SHAPES)
def test_rewindow_matches_jax_at_chain_shapes(rng, side, c, sign):
    """The port's rewindow (plain on the CPU) equals the JAX kernel in
    interpret mode exactly, both signs, at every shape the chain runs
    (one image); sign +1 inverts sign -1."""
    from swinvox_tpu.ops.rewindow import rewindow

    nw = side // 7
    x = rng.standard_normal((nw * nw, 49, c)).astype(np.float32)
    xt = torch.from_numpy(x)
    for s in (sign, -sign):
        ref = np.asarray(rewindow(jnp.asarray(x), nw, nw, 7, 3, s,
                                  interpret=True))
        np.testing.assert_array_equal(
            port_rw.rewindow(xt, nw, nw, 7, 3, s).numpy(), ref)
    back = port_rw.rewindow(port_rw.rewindow(xt, nw, nw, 7, 3, sign),
                            nw, nw, 7, 3, -sign)
    assert torch.equal(back, xt)


@pytest.mark.parametrize("images,nwh,nww,shift", [
    (32, 8, 8, 3), (32, 4, 4, 3), (32, 2, 2, 3), (3, 3, 5, 1), (2, 1, 2, 6)])
def test_rewindow_source_rows_match_plain(images, nwh, nww, shift):
    """Kernel A's index math (``source_rows``: the output row's window and
    token, its pixel, the rolled pixel's window and token) is the
    permutation ``rewindow_reference`` applies, both signs, at the chain's
    batch-32 grids and at uneven ones."""
    n = images * nwh * nww
    rows = torch.arange(n * 49, dtype=torch.float64).view(n, 49, 1)
    for sign in (-1, 1):
        want = port_rw.rewindow_reference(rows, nwh, nww, 7, shift, sign)
        got = port_rw.source_rows(n, nwh, nww, 7, shift, sign)
        assert torch.equal(got, want.reshape(-1).long())


def _fast_div(d):
    """The magic number and shift of ``fast_div`` in csrc/fast_div.cuh."""
    if d == 1:
        return 0, -1
    ell = 0
    while (1 << ell) < d:
        ell += 1
    return ((1 << (31 + ell)) + d - 1) // d, ell - 1


def test_fast_div_is_exact():
    """The multiply-shift division kernels A and G use for divisors known
    at launch (A: nWw and nWh; G: images a run and window slots) is exact
    for the dividends below 2^31: at every divisor up to 1024 over the
    dividends below 20000 and the largest 2000, and at a few large
    divisors."""
    n = np.concatenate([np.arange(0, 20000),
                        np.array([2**31 - 1 - i for i in range(2000)])])
    n = n.astype(np.uint64)
    for d in list(range(1, 1025)) + [4095, 49 * 64 * 32, 2**20 + 7,
                                     2**30 + 1]:
        m, shift = _fast_div(d)
        assert m < 2**32
        q = n if shift < 0 else ((n * np.uint64(m)) >> np.uint64(32)) >> \
            np.uint64(shift)
        np.testing.assert_array_equal(q, n // np.uint64(d))


def test_rewindow_refuses():
    """Wrong signs, shifts and shapes raise; a tensor on neither the CPU
    nor a card never reaches the plain version."""
    x = torch.zeros(8, 49, 16)
    for args in ((2, 4, 7, 3, 0), (2, 4, 7, 7, -1), (3, 3, 7, 3, 1)):
        with pytest.raises(ValueError):
            port_rw.rewindow(x, *args)
    with pytest.raises(ValueError):
        port_rw.rewindow(torch.zeros(8, 48, 16), 2, 4, 7, 3, 1)
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_rw.rewindow(torch.empty(8, 49, 16, device="meta"), 2, 4, 7, 3, 1)
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_rw._rewindow_cuda(x, 2, 4, 7, 3, 1)


# ------------------------------------------------------------- kernel G


def _attn_inputs(rng, images, side, heads, masked):
    from swinvox_tpu.models.swin import shifted_window_mask

    nw = images * (side // 7) ** 2
    q, k, v = (rng.standard_normal((nw, heads, 49, 32), np.float32)
               for _ in range(3))
    bias = rng.standard_normal((heads, 49, 49), np.float32)
    mask = np.asarray(shifted_window_mask(side, side, 7, 3)) \
        if masked else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("side,heads", STAGES)
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax_at_stage_shapes(rng, side, heads,
                                                      masked):
    """Kernel G's wrapper (plain on the CPU) equals JAX at every stage
    shape, masked (nW_img 64, 16, 4, and 1 at 7^2, where no shift is
    taken) and unmasked, with 3 images: ``window_attention_xla`` and, at
    14^2 and 7^2, the Pallas kernel in interpret mode; rtol 2e-4, atol
    2e-5 (the JAX tests')."""
    from swinvox_tpu.ops.pallas_window_attention import (
        window_attention_pallas,
    )
    from swinvox_tpu.ops.window_attention import window_attention_xla

    if masked and side == 7:  # a 7^2 map has no shift: one window slot
        ins = list(_attn_inputs(rng, 3, side, heads, False))
        ins[4] = np.zeros((1, 49, 49), np.float32)
    else:
        ins = list(_attn_inputs(rng, 3, side, heads, masked))
    jx = [None if a is None else jnp.asarray(a) for a in ins]
    refs = [np.asarray(window_attention_xla(*jx))]
    if side <= 14:
        refs.append(np.asarray(window_attention_pallas(*jx, interpret=True)))
    got = port_attn.window_attention_pallas(
        *[None if a is None else torch.from_numpy(a) for a in ins])
    for ref in refs:
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


def _kernel_g_model(q, k, v, bias, mask, blocks, order=None):
    """Kernel G's arithmetic and schedule in torch: the items in the
    kernel's order (``item_order``), cut into ``blocks`` ranges
    (``block_items``); each run of items takes its bias (and mask) from
    the run, as the kernel stages them, never from the item's window; f32
    scores, (s scale + bias + mask) log2 e, p = 2^(x - max) / sum rounded
    to bf16, P V summed in f32 and rounded to bf16.  Returns the output
    and how often each item was computed."""
    nw, heads, t, d = q.shape
    slots = 1 if mask is None else mask.shape[0]
    order = port_attn.item_order(nw, heads, slots) if order is None else order
    bounds = port_attn.block_items(nw * heads, blocks)
    per_run = nw // slots
    out = torch.zeros(nw, heads, t, d, dtype=torch.bfloat16)
    seen = torch.zeros(nw, heads, dtype=torch.int64)
    log2e = 1.4426950408889634
    for b in range(blocks):
        e = torch.arange(int(bounds[b]), int(bounds[b + 1]))
        w, h = order[e, 0], order[e, 1]
        run = e // per_run
        bm = bias[run // slots]  # the run's head
        if mask is not None:
            bm = bm + mask[run % slots]  # the run's window slot
        qe, ke, ve = (a[w, h].bfloat16().float() for a in (q, k, v))
        s = qe @ ke.transpose(-1, -2)
        x = s * (d ** -0.5 * log2e) + bm * log2e
        p = torch.exp2(x - x.amax(-1, keepdim=True))
        p = (p / p.sum(-1, keepdim=True)).bfloat16().float()
        out[w, h] = (p @ ve).bfloat16()
        seen[w, h] += 1
    return out, seen


@pytest.mark.parametrize("side,heads,masked,blocks", [
    (28, 6, True, 13), (14, 12, True, 5), (14, 12, False, 7),
    (7, 24, False, 11)])
def test_kernel_g_schedule_matches_jax(rng, side, heads, masked, blocks):
    """Kernel G's item order and block ranges cover every (window, head)
    once, and its arithmetic on them (bias and mask from the run) lies
    within bf16 rounding of the JAX Pallas kernel in interpret mode on
    bf16-rounded inputs: max-abs 2e-2 (P and the output are rounded to
    bf16 in both, at points that differ by the base-2 softmax's last
    bits).  Block counts are primes, so ranges straddle runs."""
    from swinvox_tpu.ops.pallas_window_attention import (
        window_attention_pallas,
    )

    q, k, v, bias, mask = _attn_inputs(rng, 3, side, heads, masked)
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in (q, k, v))
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    tm = None if mask is None else torch.from_numpy(mask)
    got, seen = _kernel_g_model(tq, tk, tv, tb, tm, blocks)
    assert torch.equal(seen, torch.ones_like(seen))
    ref = np.asarray(window_attention_pallas(
        *[None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
          for a in (q, k, v)], jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask),
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=0)


def test_kernel_g_model_catches_a_wrong_slot():
    """A planted fault must fail the hold above: items ordered with the
    window taken as slot x images + image (the mask of another window)."""
    from swinvox_tpu.ops.pallas_window_attention import (
        window_attention_pallas,
    )

    rng = np.random.default_rng(3)
    q, k, v, bias, mask = _attn_inputs(rng, 3, 28, 6, True)
    ins = [torch.from_numpy(a) for a in (q, k, v, bias, mask)]
    nw, slots = q.shape[0], mask.shape[0]
    order = port_attn.item_order(nw, 6, slots)
    e = torch.arange(order.shape[0])
    n_img = nw // slots
    run, img = e // n_img, e % n_img
    order[:, 0] = (run % slots) * n_img + img  # the fault
    got, seen = _kernel_g_model(*ins, blocks=13, order=order)
    assert torch.equal(seen, torch.ones_like(seen))  # still every item once
    ref = np.asarray(window_attention_pallas(
        *[jnp.asarray(a) for a in (q, k, v, bias, mask)],
        interpret=True))
    assert np.abs(got.float().numpy() - ref).max() > 0.1


def test_window_attention_refuses():
    """Kernel G's wrapper refuses dtypes, shapes and layouts the kernel
    does not take, and a device that is neither the CPU nor a card."""
    bf = torch.bfloat16
    q = torch.zeros(8, 3, 49, 32, dtype=bf)
    bias = torch.zeros(3, 49, 49)
    mask = torch.zeros(4, 49, 49)
    port_attn._check(q, q, q, bias, mask)  # what the kernel takes
    bad = [
        (q.float(), q, q, bias, mask),                      # dtype
        (q, q[:4], q, bias, mask),                          # shapes differ
        (torch.zeros(8, 3, 49, 16, dtype=bf),) * 3 + (bias, None),
        (torch.zeros(8, 3, 65, 32, dtype=bf),) * 3 + (
            torch.zeros(3, 65, 65), None),                  # T > 64
        (q, q, q, torch.zeros(4, 49, 49), mask),            # bias heads
        (q, q, q, bias, torch.zeros(3, 49, 49)),            # 8 % 3 windows
        (q, q, q, bias, torch.zeros(4, 48, 49)),            # mask shape
        (q.transpose(2, 3).contiguous().transpose(2, 3), q, q, bias, mask),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            port_attn._check(*args)
    meta = torch.empty(8, 3, 49, 32, dtype=bf, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_attn.window_attention_pallas(meta, meta, meta, bias)


# ------------------------------------------------- the repeatable step


def test_bias_table_gradient_matches_jax_and_repeats(rng):
    """The relative-position bias's gradient into its table, a fixed-order
    gather-sum (``_TableGather``) where indexing's backward scatters,
    equals ``jax.grad`` of the same gather (``table[index]``) within f32
    summation order (rtol 1e-5, atol 1e-5: up to 49 terms a row), and two
    calls give the same bits."""
    heads = 6
    table = rng.standard_normal((169, heads)).astype(np.float32)
    cot = rng.standard_normal((6, heads, 49, 49)).astype(np.float32)
    idx = port_swin.relative_position_index(7).reshape(-1)

    def jax_loss(tab):
        b = tab[jnp.asarray(idx)].reshape(49, 49, heads).transpose(2, 0, 1)
        return jnp.sum(b[None] * jnp.asarray(cot))

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    msa = port_swin.WindowMSA(192, heads)
    with torch.no_grad():
        msa.rel_pos_bias_table.copy_(torch.from_numpy(table))
    grads = []
    for _ in range(2):
        msa.zero_grad(set_to_none=True)
        (msa.rel_bias()[None] * torch.from_numpy(cot)).sum().backward()
        grads.append(msa.rel_pos_bias_table.grad.clone())
    np.testing.assert_allclose(grads[0].numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(
        msa.rel_bias().detach(),
        torch.from_numpy(table)[torch.from_numpy(idx)].view(49, 49, heads)
        .permute(2, 0, 1))


def test_relative_position_sources_cover_each_position_once():
    """Each of the T * T positions feeds exactly the table row that
    ``relative_position_index`` names it by, once; the rest is padding."""
    idx = port_swin.relative_position_index(7).reshape(-1)
    src = port_swin.relative_position_sources(7)
    real = src < idx.size
    assert sorted(src[real].tolist()) == list(range(idx.size))
    rows = np.repeat(np.arange(src.shape[0])[:, None], src.shape[1], 1)
    np.testing.assert_array_equal(idx[src[real]], rows[real])


class _StubModel(torch.nn.Module):
    """A model whose forward records the cuDNN flags it ran under."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.seen, self.fail = [], False

    def forward(self, images, train, enable_merger, enable_refiner,
                generator):
        cudnn = torch.backends.cudnn
        self.seen.append((cudnn.deterministic, cudnn.benchmark))
        if self.fail:
            raise RuntimeError("a forward that fails")
        logits = self.w * images.mean(dim=(1, 2, 3, 4))[:, None, None, None]
        logits = logits.expand(-1, 32, 32, 32)
        return {"merged_volumes": logits, "refined_volumes": 2 * logits}


@pytest.mark.parametrize("det,bench", [(False, True), (True, False),
                                       (False, False)])
def test_train_step_restores_global_settings(det, bench):
    """The step's forward and backward run with cuDNN deterministic and
    benchmark off, and the caller's cuDNN and deterministic-algorithm
    settings come back as they were, after a step and after one that
    raises."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    try:
        cudnn.deterministic, cudnn.benchmark = det, bench
        model = _StubModel()
        images = torch.rand(2, 1, 8, 8, 3)
        volumes = (torch.rand(2, 32, 32, 32) > 0.5).float()
        gen = torch.Generator().manual_seed(0)
        port_steps.loss_and_grads(model, images, volumes, gen, True, True)
        assert model.seen == [(True, False)]
        assert (cudnn.deterministic, cudnn.benchmark) == (det, bench)
        assert not torch.are_deterministic_algorithms_enabled()
        model.fail = True
        with pytest.raises(RuntimeError, match="fails"):
            port_steps.loss_and_grads(model, images, volumes, gen, True,
                                      True)
        assert (cudnn.deterministic, cudnn.benchmark) == (det, bench)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2])
