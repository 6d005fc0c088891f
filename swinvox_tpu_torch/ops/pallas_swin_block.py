"""Whole inference Swin block on window-major tokens (kernel B).

Counterpart of ``fused_swin_block`` in ``swinvox_tpu/ops/pallas_swin_block.py``
(the module keeps that path so a reader finds it; nothing here is Pallas):

  x_win --LN1--> qkv --per-head attention(+rel bias, +shift mask)--> proj
        --(+x_win)--> LN2 --> fc1 -> exact GELU -> fc2 --(+res)--> out_win

On a CUDA tensor ``fused_swin_block`` launches ``csrc/swin_block.cu``
(bf16 only); on a CPU tensor it runs ``swin_block_reference``, the same
function in plain PyTorch with the kernel's rounding points: LayerNorm
statistics, softmax and residual sums in float32, products of
compute-dtype operands accumulated in float32.  Inference only.

Tokens are unpadded, [nW, T, C] with T = window**2 = 49: the JAX kernel's
padding to 64 (with a -1e9 bias on pad keys) is a Mosaic tiling need and
changes nothing on the logical tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from swinvox_tpu_torch.kernels import build
from swinvox_tpu_torch.models.layers import mm_f32


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float) -> torch.Tensor:
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


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
) -> torch.Tensor:
    """Plain PyTorch Swin block: [nW, T, C] -> [nW, T, C] in x.dtype."""
    nw, t, c = x.shape
    hd = c // num_heads
    if scale is None:
        scale = hd**-0.5
    dtype = x.dtype
    x32 = x.float()
    h = _ln(x32, ln1_scale, ln1_bias, eps).to(dtype)
    qkv = (mm_f32(h, wqkv) + bqkv.float()).to(dtype)
    q, k, v = qkv.view(nw, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    s = mm_f32(q, k.transpose(-1, -2)) * scale + rel_bias.float()[None]
    if mask is not None:
        nwi = mask.shape[0]
        s = s.view(nw // nwi, nwi, num_heads, t, t) + mask.float()[None, :, None]
        s = s.view(nw, num_heads, t, t)
    p = torch.softmax(s, dim=-1)
    ctx = mm_f32(p.to(dtype), v).to(dtype)  # [nW, heads, T, hd]
    ctx = ctx.permute(0, 2, 1, 3).reshape(nw, t, c)
    x2 = x32 + (mm_f32(ctx, wproj) + bproj.float())
    h2 = _ln(x2, ln2_scale, ln2_bias, eps).to(dtype)
    m = F.gelu(mm_f32(h2, w1) + b1.float()).to(dtype)  # exact (erf)
    return (x2 + (mm_f32(m, w2) + b2.float())).to(dtype)


def _check_cuda(x, num_heads, tensors) -> None:
    nw, t, c = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_swin_block: the kernel takes bfloat16 "
                         f"tokens, got {x.dtype}")
    if c % 32 or c // num_heads != 32 or c % num_heads:
        raise ValueError(f"fused_swin_block: the kernel takes head_dim 32 "
                         f"and C % 32 == 0, got C={c}, heads={num_heads}")
    if t > 64:
        raise ValueError(f"fused_swin_block: at most 64 tokens, got {t}")
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
) -> torch.Tensor:
    """Whole Swin block on window-major tokens: x [nW, T, C] -> [nW, T, C].

    Weights come in the compute dtype as [in, out]; LayerNorm affines,
    biases, ``rel_bias`` [heads, T, T] and ``mask`` [nW_img, T, T] (or
    None) in float32.  A CPU tensor runs the plain version; a CUDA tensor
    launches kernel B or raises.  ``launches`` counts block calls on the
    card (each is five CUDA launches, see the source note).
    """
    args = (x, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, rel_bias, mask,
            ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_reference(*args, num_heads, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_swin_block: unsupported device {x.device}")
    names = ("x", "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
             "rel_bias", "mask", "ln2_scale", "ln2_bias", "w1", "b1", "w2",
             "b2")
    _check_cuda(x, num_heads, dict(zip(names, args)))
    nw, t, c = x.shape
    if scale is None:
        scale = (c // num_heads) ** -0.5
    lib = build.library()
    rows = nw * t
    out = torch.empty_like(x)
    qkv = torch.empty(rows, 3 * c, dtype=torch.bfloat16, device=x.device)
    ctx = torch.empty(rows, c, dtype=torch.bfloat16, device=x.device)
    x2 = torch.empty(rows, c, dtype=torch.float32, device=x.device)
    hidden = torch.empty(rows, 4 * c, dtype=torch.bfloat16, device=x.device)
    ptr = [None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(x.device):
        err = lib.swinvox_swin_block(
            *ptr[:9], 0 if mask is None else mask.shape[0], *ptr[9:],
            out.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), x2.data_ptr(),
            hidden.data_ptr(), nw, t, c, num_heads, float(scale), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "fused_swin_block")
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0
