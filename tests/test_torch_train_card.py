"""Kernel D (the training Swin block's backward, csrc/swin_block_train.cu)
on a card, at a small stage shape: 2 images of 8 x 8 windows at C = 96
(stage 0's width), aligned and shifted (aligned tokens, the attention
over the windows shifted by 3 through the roll's map), drop-path factors
0, 1 and 1/0.9 across the windows.  Its gradients against ``swin_block_train_reference``
(autograd through plain ops) by chip_smoke.py's phase 8 rule: each within
2 x the bf16 plain block's error from the f32 plain block + 1e-2 (dx by
max-abs, the parameters by relative L2).  The file imports no JAX, so
it runs on the card's machine; here the tests skip."""

import pytest
import torch

from swinvox_tpu_torch.models.swin import shifted_window_mask
from swinvox_tpu_torch.ops import pallas_swin_block as blk

GRAD = ("x", "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
        "rel_bias", "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
BF16 = ("x", "wqkv", "wproj", "w1", "w2")


def _operands(g, images, side, c, heads, shifted):
    def r(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * s

    per = (side // 7) ** 2
    fac = torch.tensor((0.0, 1.0, 1.0 / 0.9), device="cuda")
    win = torch.arange(images * per, device="cuda")
    ops = {"x": r(images * per, 49, c), "dp1": fac[win % 3],
           "dp2": fac[(win + 1) % 3], "ln1_scale": 1 + r(c, s=0.1),
           "ln1_bias": r(c, s=0.1), "wqkv": r(c, 3 * c, s=c**-0.5),
           "bqkv": r(3 * c, s=0.1), "wproj": r(c, c, s=c**-0.5),
           "bproj": r(c, s=0.1), "rel_bias": r(heads, 49, 49, s=0.5),
           "mask": (torch.from_numpy(shifted_window_mask(side, side, 7, 3))
                    .cuda() if shifted else None),
           "ln2_scale": 1 + r(c, s=0.1), "ln2_bias": r(c, s=0.1),
           "w1": r(c, 4 * c, s=c**-0.5), "b1": r(4 * c, s=0.1),
           "w2": r(4 * c, c, s=(4 * c)**-0.5), "b2": r(c, s=0.1)}
    return ops, r(images * per, 49, c).bfloat16()


def _grads(fn, ops, dout, heads, grid):
    leaves = {k: (v if v is None else
                  v.detach().clone().requires_grad_(k in GRAD))
              for k, v in ops.items()}
    out = fn(**leaves, num_heads=heads, **grid)
    grads = torch.autograd.grad(out, [leaves[k] for k in GRAD],
                                dout.to(out.dtype))
    return dict(zip(GRAD, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True],
                         ids=["aligned", "shifted"])
def test_swin_block_train_backward_matches_plain_on_card(shifted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs D on the H100")
    images, side, c, heads = 2, 56, 96, 3
    g = torch.Generator(device="cuda").manual_seed(1)
    f32, dout = _operands(g, images, side, c, heads, shifted)
    bf = {k: (v.bfloat16() if k in BF16 else v) for k, v in f32.items()}
    grid = dict(nwh=side // 7, nww=side // 7, shift=3) if shifted else {}
    launches = blk.swin_block_train_backward.launches
    kern = _grads(blk.fused_swin_block_train, bf, dout, heads, grid)
    assert blk.swin_block_train_backward.launches == launches + 1
    plain = _grads(blk.swin_block_train_reference, bf, dout, heads, grid)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = _grads(blk.swin_block_train_reference, f32, dout, heads, grid)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    torch.cuda.synchronize()

    def err(a, b, what):
        a, b = a.float(), b.float()
        if what == "x":
            return (a - b).abs().max().item()
        return ((a - b).norm() / b.norm()).item()

    for what in GRAD:
        ek, ep = err(kern[what], ref[what], what), err(plain[what], ref[what],
                                                      what)
        assert torch.isfinite(kern[what]).all(), what
        assert ek <= 2 * ep + 1e-2, (what, ek, ep)
