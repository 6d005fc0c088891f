"""Whole Swin block on window-major tokens: inference (kernel B) and
training (kernels C and D).

Counterpart of ``fused_swin_block`` and ``fused_swin_block_train`` in
``swinvox_tpu/ops/pallas_swin_block.py`` (the module keeps that path so a
reader finds it; nothing here is Pallas):

  x_win --LN1--> qkv --per-head attention(+rel bias, +shift mask)--> proj
        --(x dp1, +x_win)--> LN2 --> fc1 -> exact GELU -> fc2
        --(x dp2, +res)--> out_win

with dp1/dp2 per-window stochastic-depth factors in training (1 at
inference).  On a CUDA tensor ``fused_swin_block`` launches
``csrc/swin_block.cu`` (bf16 only) and ``fused_swin_block_train`` is an
autograd function over kernel C (the same launches with the factors and
the intermediates the backward needs saved) and kernel D
(``csrc/swin_block_train.cu``, the backward).  On a CPU tensor both run
``swin_block_reference`` / ``swin_block_train_reference``, the same
function in plain PyTorch (autograd through its ops for the gradient)
with the kernels' rounding points: LayerNorm statistics, softmax and
residual sums in float32, products of compute-dtype operands accumulated
in float32.

Tokens are unpadded, [nW, T, C] with T = window**2 = 49: the JAX kernel's
padding to 64 (with a -1e9 bias on pad keys) is a Mosaic tiling need and
changes nothing on the logical tokens.

Tokens come in the *aligned* window-major layout of an image grid of
``nwh`` x ``nww`` windows.  A shifted block (``shift`` > 0) attends over
the windows of the image rolled by ``-shift``: the JAX package moves the
tokens there and back with ``rewindow`` around its kernel, while the
kernels here fetch q, k, v of shifted window w, token t from the aligned
row the roll maps it to and write the attention's output back to that
row.  Everything else in the block is per token and the drop-path
factors are per image, so the layout change costs no pass and no
launch.  The plain versions relayout qkv and the attention's output with
``rewindow_reference``: with per-image factors, the JAX chain's
``rewindow`` -> block -> ``rewindow``, layout for layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from swinvox_tpu_torch.kernels import build
from swinvox_tpu_torch.models.layers import mm_f32
from swinvox_tpu_torch.ops.rewindow import rewindow_reference


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float) -> torch.Tensor:
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _shifted(x, nwh, nww, shift, sign):
    """[nW, T, C] tokens from the aligned windows to the shifted ones
    (sign -1) or back (+1), as ``rewindow_reference``; the identity at
    shift 0."""
    if not shift:
        return x
    win = round(x.shape[1] ** 0.5)
    return rewindow_reference(x, nwh, nww, win, shift, sign)


def _block(x, dp1, dp2, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
           rel_bias, mask, ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
           scale, eps, nwh=0, nww=0, shift=0):
    nw, t, c = x.shape
    hd = c // num_heads
    if scale is None:
        scale = hd**-0.5
    dtype = x.dtype
    x32 = x.float()
    h = _ln(x32, ln1_scale, ln1_bias, eps).to(dtype)
    qkv = _shifted((mm_f32(h, wqkv) + bqkv.float()).to(dtype), nwh, nww,
                   shift, -1)
    q, k, v = qkv.view(nw, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    s = mm_f32(q, k.transpose(-1, -2)) * scale + rel_bias.float()[None]
    if mask is not None:
        nwi = mask.shape[0]
        s = (s.view(nw // nwi, nwi, num_heads, t, t)
             + mask.float()[None, :, None])
        s = s.view(nw, num_heads, t, t)
    p = torch.softmax(s, dim=-1)
    ctx = mm_f32(p.to(dtype), v).to(dtype)  # [nW, heads, T, hd]
    ctx = _shifted(ctx.permute(0, 2, 1, 3).reshape(nw, t, c), nwh, nww,
                   shift, 1)
    attn = mm_f32(ctx, wproj) + bproj.float()
    x2 = x32 + (attn if dp1 is None else dp1.float().view(-1, 1, 1) * attn)
    h2 = _ln(x2, ln2_scale, ln2_bias, eps).to(dtype)
    m = F.gelu(mm_f32(h2, w1) + b1.float()).to(dtype)  # exact (erf)
    mlp = mm_f32(m, w2) + b2.float()
    out = x2 + (mlp if dp2 is None else dp2.float().view(-1, 1, 1) * mlp)
    return out.to(dtype)


def swin_block_reference(
    x: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    eps: float = 1e-5,
    nwh: int = 0, nww: int = 0, shift: int = 0,
) -> torch.Tensor:
    """Plain PyTorch Swin block: [nW, T, C] -> [nW, T, C] in x.dtype, the
    tokens aligned windows of an ``nwh`` x ``nww`` grid per image, the
    attention over the windows shifted by ``shift`` (0: aligned)."""
    return _block(x, None, None, ln1_scale, ln1_bias, wqkv, bqkv, wproj,
                  bproj, rel_bias, mask, ln2_scale, ln2_bias, w1, b1, w2, b2,
                  num_heads, scale, eps, nwh, nww, shift)


def swin_block_train_reference(
    x: torch.Tensor, dp1: torch.Tensor, dp2: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    eps: float = 1e-5,
    nwh: int = 0, nww: int = 0, shift: int = 0,
) -> torch.Tensor:
    """Plain PyTorch training Swin block (kernels C and D's plain
    version): ``swin_block_reference`` with the two residual branches
    scaled by the per-window factors dp1, dp2 [nW]; autograd through its
    ops gives the gradient."""
    return _block(x, dp1, dp2, ln1_scale, ln1_bias, wqkv, bqkv, wproj,
                  bproj, rel_bias, mask, ln2_scale, ln2_bias, w1, b1, w2, b2,
                  num_heads, scale, eps, nwh, nww, shift)


# the widths kernels B, C and D are built for (Swin-T's four stages)
WIDTHS = (96, 192, 384, 768)

_NAMES = ("x", "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
          "rel_bias", "mask", "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def _check_cuda(x, num_heads, tensors, nwh, nww, shift) -> None:
    nw, t, c = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_swin_block: the kernel takes bfloat16 "
                         f"tokens, got {x.dtype}")
    if c not in WIDTHS or c // num_heads != 32 or c % num_heads:
        raise ValueError(f"fused_swin_block: the kernel takes head_dim 32 "
                         f"and C in {WIDTHS}, got C={c}, heads={num_heads}")
    win = round(t**0.5)
    if t > 64 or win * win != t:
        raise ValueError(f"fused_swin_block: a square window of at most 64 "
                         f"tokens, got {t}")
    if shift and (not 0 < shift < win or nwh < 1 or nww < 1
                  or nw % (nwh * nww)):
        raise ValueError(f"fused_swin_block: shift {shift} needs 0 < shift "
                         f"< {win} and nW={nw} a multiple of the "
                         f"{nwh} x {nww} grid")
    want = {
        "wqkv": ((c, 3 * c), torch.bfloat16),
        "wproj": ((c, c), torch.bfloat16),
        "w1": ((c, 4 * c), torch.bfloat16),
        "w2": ((4 * c, c), torch.bfloat16),
        "bqkv": ((3 * c,), torch.float32),
        "bproj": ((c,), torch.float32),
        "b1": ((4 * c,), torch.float32),
        "b2": ((c,), torch.float32),
        "ln1_scale": ((c,), torch.float32), "ln1_bias": ((c,), torch.float32),
        "ln2_scale": ((c,), torch.float32), "ln2_bias": ((c,), torch.float32),
        "rel_bias": ((num_heads, t, t), torch.float32),
    }
    for name, (shape, dtype) in want.items():
        a = tensors[name]
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"fused_swin_block: {name} must be {shape} "
                             f"{dtype}, got {tuple(a.shape)} {a.dtype}")
    for name, a in tensors.items():
        if a is None:
            continue
        if a.device != x.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"fused_swin_block: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {x.device}")
    mask = tensors["mask"]
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape[1:]) != (t, t)
                             or nw % mask.shape[0]):
        raise ValueError("fused_swin_block: mask must be f32 [nW_img, T, T] "
                         "with nW a multiple of nW_img")


def _grid(t, nwh, nww, shift):
    """The window map's launch arguments: (nwh, nww, window, shift)."""
    return (nwh, nww, round(t**0.5), shift) if shift else (1, 1, 1, 0)


def fused_swin_block(
    x: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    eps: float = 1e-5,
    nwh: int = 0, nww: int = 0, shift: int = 0,
) -> torch.Tensor:
    """Whole Swin block on aligned window-major tokens: x [nW, T, C] ->
    [nW, T, C], the attention over the windows of the image rolled by
    ``-shift`` on a grid of ``nwh`` x ``nww`` windows per image.

    Weights come in the compute dtype as [in, out]; LayerNorm affines,
    biases, ``rel_bias`` [heads, T, T] and ``mask`` [nW_img, T, T] of the
    shifted windows (or None) in float32.  A CPU tensor runs the plain
    version; a CUDA tensor launches kernel B or raises.  ``launches``
    counts block calls on the card (each is six CUDA launches, see the
    source note).
    """
    args = (x, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, rel_bias, mask,
            ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_reference(*args, num_heads, scale, eps, nwh, nww,
                                    shift)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_swin_block: unsupported device {x.device}")
    _check_cuda(x, num_heads, dict(zip(_NAMES, args)), nwh, nww, shift)
    nw, t, c = x.shape
    if scale is None:
        scale = (c // num_heads) ** -0.5
    lib = build.library()
    rows = nw * t
    out = torch.empty_like(x)
    # scratch h1, qkv, ctx, x2, h2, hidden: one allocation, 256-byte parts
    sizes = [rows * c * 2, rows * 3 * c * 2, rows * c * 2, rows * c * 4,
             rows * c * 2, rows * 4 * c * 2]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + (n + 255) // 256 * 256)
    work = torch.empty(offs[-1] + sizes[-1], dtype=torch.uint8,
                       device=x.device)
    base = work.data_ptr()
    ptr = [None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(x.device):
        err = lib.swinvox_swin_block(
            *ptr[:9], 0 if mask is None else mask.shape[0], *ptr[9:],
            out.data_ptr(), *(base + o for o in offs), nw, t, c, num_heads,
            *_grid(t, nwh, nww, shift), float(scale), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "fused_swin_block")
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


# ---------------------------------------------------------------- training

_SAVED = ("h1", "stats1", "qkv", "ctx", "x2", "h2", "stats2", "pre", "hidden")


def swin_block_train_forward(x, dp1, dp2, ln1_scale, ln1_bias, wqkv, bqkv,
                             wproj, bproj, rel_bias, mask, ln2_scale,
                             ln2_bias, w1, b1, w2, b2, num_heads, scale,
                             eps, nwh=0, nww=0, shift=0):
    """Kernel C: the block's forward on the card with the factors dp1, dp2
    [nW] (float32) on its two residual branches.  Returns ``(out, saved)``,
    ``saved`` the intermediates kernel D reads, all in the aligned layout:
    LN1 and LN2 outputs (bf16) with their row mean and 1/std, qkv, ctx
    (bf16), x2 (f32), the f32 pre-GELU values and the bf16 GELU output."""
    args = (x, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, rel_bias, mask,
            ln2_scale, ln2_bias, w1, b1, w2, b2)
    _check_cuda(x, num_heads, dict(zip(_NAMES, args)), nwh, nww, shift)
    nw, t, c = x.shape
    for name, d in (("dp1", dp1), ("dp2", dp2)):
        if (d.dtype != torch.float32 or tuple(d.shape) != (nw,)
                or d.device != x.device or not d.is_contiguous()):
            raise ValueError(f"swin block train: {name} must be float32 "
                             f"[{nw}] on {x.device}")
    lib = build.library()
    rows = nw * t
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    out = torch.empty_like(x)
    saved = {
        "h1": torch.empty(rows, c, dtype=bf, device=dev),
        "stats1": torch.empty(rows, 2, dtype=f32, device=dev),
        "qkv": torch.empty(rows, 3 * c, dtype=bf, device=dev),
        "ctx": torch.empty(rows, c, dtype=bf, device=dev),
        "x2": torch.empty(rows, c, dtype=f32, device=dev),
        "h2": torch.empty(rows, c, dtype=bf, device=dev),
        "stats2": torch.empty(rows, 2, dtype=f32, device=dev),
        "pre": torch.empty(rows, 4 * c, dtype=f32, device=dev),
        "hidden": torch.empty(rows, 4 * c, dtype=bf, device=dev),
    }
    ptr = [None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(dev):
        err = lib.swinvox_swin_block_train_fwd(
            ptr[0], dp1.data_ptr(), dp2.data_ptr(), *ptr[1:9],
            0 if mask is None else mask.shape[0], *ptr[9:],
            out.data_ptr(), *(saved[k].data_ptr() for k in _SAVED),
            nw, t, c, num_heads, *_grid(t, nwh, nww, shift), float(scale),
            float(eps), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "swin block train forward")
    swin_block_train_forward.launches += 1
    return out, saved


swin_block_train_forward.launches = 0


def swin_block_train_backward(dout, x, dp1, dp2, saved, ln1_scale, wqkv,
                              wproj, rel_bias, mask, ln2_scale, w1, w2,
                              num_heads, scale, nwh=0, nww=0, shift=0):
    """Kernel D: the block's backward from ``dout`` and kernel C's saved
    intermediates.  Returns dx (bf16), the LayerNorm and bias gradients
    and ``rel_bias``'s (float32), and the four weight gradients in their
    operands' dtype (bf16: the model casts its f32 weights to bf16 before
    the block, and the cast's gradient widens them again)."""
    nw, t, c = x.shape
    if c not in WIDTHS:
        raise ValueError(f"swin block train backward: C={c} not in "
                         f"{WIDTHS}")
    dout = dout.to(torch.bfloat16).contiguous()
    if dout.data_ptr() % 16:  # the kernel copies 16-byte chunks
        dout = dout.clone()
    lib = build.library()
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    g = {
        "dx": torch.empty_like(x),
        "dln1_scale": torch.empty(c, dtype=f32, device=dev),
        "dln1_bias": torch.empty(c, dtype=f32, device=dev),
        "dwqkv": torch.empty(c, 3 * c, dtype=bf, device=dev),
        "dbqkv": torch.empty(3 * c, dtype=f32, device=dev),
        "dwproj": torch.empty(c, c, dtype=bf, device=dev),
        "dbproj": torch.empty(c, dtype=f32, device=dev),
        "drel_bias": torch.empty(num_heads, t, t, dtype=f32, device=dev),
        "dln2_scale": torch.empty(c, dtype=f32, device=dev),
        "dln2_bias": torch.empty(c, dtype=f32, device=dev),
        "dw1": torch.empty(c, 4 * c, dtype=bf, device=dev),
        "db1": torch.empty(4 * c, dtype=f32, device=dev),
        "dw2": torch.empty(4 * c, c, dtype=bf, device=dev),
        "db2": torch.empty(c, dtype=f32, device=dev),
    }
    ws = lib.swinvox_swin_block_train_bwd_workspace(nw, t, c, num_heads)
    work = torch.empty(ws, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.swinvox_swin_block_train_bwd(
            dout.data_ptr(), x.data_ptr(), dp1.data_ptr(), dp2.data_ptr(),
            *(saved[k].data_ptr() for k in _SAVED),
            ln1_scale.data_ptr(), wqkv.data_ptr(), wproj.data_ptr(),
            rel_bias.data_ptr(), None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], ln2_scale.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), *(v.data_ptr() for v in g.values()),
            work.data_ptr(), ws, nw, t, c, num_heads,
            *_grid(t, nwh, nww, shift), float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "swin block train backward")
    swin_block_train_backward.launches += 1
    return g


swin_block_train_backward.launches = 0


class _SwinBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp1, dp2, ln1_scale, ln1_bias, wqkv, bqkv, wproj,
                bproj, rel_bias, mask, ln2_scale, ln2_bias, w1, b1, w2, b2,
                num_heads, scale, eps, nwh, nww, shift):
        dp1 = dp1.float().contiguous()
        dp2 = dp2.float().contiguous()
        out, saved = swin_block_train_forward(
            x, dp1, dp2, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
            rel_bias, mask, ln2_scale, ln2_bias, w1, b1, w2, b2, num_heads,
            scale, eps, nwh, nww, shift)
        ctx.save_for_backward(x, dp1, dp2, ln1_scale, wqkv, wproj, rel_bias,
                              mask, ln2_scale, w1, w2,
                              *(saved[k] for k in _SAVED))
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.grid = (nwh, nww, shift)
        return out

    @staticmethod
    def backward(ctx, dout):
        (x, dp1, dp2, ln1_scale, wqkv, wproj, rel_bias, mask, ln2_scale, w1,
         w2, *rest) = ctx.saved_tensors
        g = swin_block_train_backward(
            dout, x, dp1, dp2, dict(zip(_SAVED, rest)), ln1_scale, wqkv,
            wproj, rel_bias, mask, ln2_scale, w1, w2, ctx.num_heads,
            ctx.scale, *ctx.grid)
        return (g["dx"], None, None, g["dln1_scale"], g["dln1_bias"],
                g["dwqkv"], g["dbqkv"], g["dwproj"], g["dbproj"],
                g["drel_bias"], None, g["dln2_scale"], g["dln2_bias"],
                g["dw1"], g["db1"], g["dw2"], g["db2"], None, None, None,
                None, None, None)


def fused_swin_block_train(
    x: torch.Tensor, dp1: torch.Tensor, dp2: torch.Tensor,
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    eps: float = 1e-5,
    nwh: int = 0, nww: int = 0, shift: int = 0,
) -> torch.Tensor:
    """Differentiable training Swin block on window-major tokens, with
    per-window stochastic-depth factors dp1, dp2 [nW] (1/keep or 0).

    Same operands as ``fused_swin_block``.  A CPU tensor runs the plain
    version (autograd through its ops); a CUDA tensor runs kernel C
    forward and kernel D backward, or raises.  ``dx`` carries the residual
    path even where a factor is 0.
    """
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    args = (x, dp1, dp2, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
            rel_bias, mask, ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_train_reference(*args, num_heads, scale, eps, nwh,
                                          nww, shift)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"fused_swin_block_train: unsupported device {x.device}")
    return _SwinBlockTrain.apply(*args, num_heads, float(scale), float(eps),
                                 nwh, nww, shift)
