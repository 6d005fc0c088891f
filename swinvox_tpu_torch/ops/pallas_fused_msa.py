"""Fused W-MSA: qkv projection, window attention, output projection
(kernel H).

Counterpart of ``fused_window_msa`` in ``swinvox_tpu/ops/pallas_fused_msa.py``
(the module keeps that path so a reader finds it; nothing here is Pallas):

  x [nW, T, C] --(x @ Wqkv + bqkv, rounded to x's dtype)--> q, k, v
    --per head: softmax_f32(q k^T * scale + rel_bias (+ mask)) cast to
      v's dtype, @ v with float32 sums, rounded--> ctx [nW, T, C]
    --(ctx @ Wproj + bproj, float32 sums)--> out, in x's dtype

On a CUDA tensor ``fused_window_msa`` launches kernel H,
``swinvox_fused_msa`` in ``csrc/swin_block.cu`` (kernel B's QKV product,
its attention over aligned windows and the same product on ctx Wproj;
bf16, C in Swin-T's 96, 192, 384, 768, head_dim 32, at most 64 tokens:
the JAX kernel takes any such C, every model path runs these four) under
an autograd function whose
backward recomputes through the plain version, as the JAX custom VJP
recomputes in XLA from x and the weights; on a CPU tensor it runs
``fused_msa_reference``, the same function in plain PyTorch
(``_reference_fused_msa`` of the JAX module, same rounding points).

Windows are image-major (``ops/rewindow.window_partition``): the mask of
window w is ``mask[w % nW_per_image]``.  Tokens stay unpadded: the JAX
wrapper's padding of T to a multiple of 32 (a Mosaic tiling need, with a
-1e9 bias on the pad keys) changes nothing on the logical tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from swinvox_tpu_torch.kernels import build
from swinvox_tpu_torch.models.layers import mm_f32
from swinvox_tpu_torch.ops.window_attention import window_attention_xla

# the widths kernel H takes: Swin-T's four stages (its N tile is 96)
CHANNELS = (96, 192, 384, 768)


def fused_msa_reference(
    x: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor,
    rel_bias: torch.Tensor, mask: Optional[torch.Tensor],
    num_heads: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch fused W-MSA (kernel H's plain version):
    [nW, T, C] -> [nW, T, C] in x.dtype."""
    nw, t, c = x.shape
    hd = c // num_heads
    qkv = (mm_f32(x, wqkv) + bqkv.float()).to(x.dtype)
    q, k, v = qkv.view(nw, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    ctx = window_attention_xla(q, k, v, rel_bias, mask, scale)
    ctx = ctx.permute(0, 2, 1, 3).reshape(nw, t, c)
    return (mm_f32(ctx, wproj) + bproj.float()).to(x.dtype)


def _check(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, num_heads) -> None:
    nw, t, c = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_window_msa: the kernel takes bfloat16 "
                         f"tokens, got {x.dtype}")
    if c not in CHANNELS or c != 32 * num_heads or t > 64:
        raise ValueError(f"fused_window_msa: the kernel takes C in "
                         f"{CHANNELS}, head_dim 32 and at most 64 tokens, "
                         f"got C={c}, heads={num_heads}, T={t}")
    want = {
        "wqkv": (wqkv, (c, 3 * c), torch.bfloat16),
        "wproj": (wproj, (c, c), torch.bfloat16),
        "bqkv": (bqkv, (3 * c,), torch.float32),
        "bproj": (bproj, (c,), torch.float32),
        "rel_bias": (rel_bias, (num_heads, t, t), torch.float32),
    }
    for name, (a, shape, dtype) in want.items():
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"fused_window_msa: {name} must be {shape} "
                             f"{dtype}, got {tuple(a.shape)} {a.dtype}")
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape[1:]) != (t, t)
                             or nw % mask.shape[0]):
        raise ValueError("fused_window_msa: mask must be f32 [nW_img, T, T] "
                         "with nW a multiple of nW_img")
    for name, a in (("x", x), ("mask", mask), *((n, v[0])
                                                for n, v in want.items())):
        if a is None:
            continue
        if a.device != x.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"fused_window_msa: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {x.device}")


def fused_msa_forward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                      num_heads, scale):
    """Kernel H on the card: out [nW, T, C] bf16."""
    _check(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, num_heads)
    nw, t, c = x.shape
    lib = build.library()
    out = torch.empty_like(x)
    qkv = torch.empty(nw * t, 3 * c, dtype=torch.bfloat16, device=x.device)
    ctx = torch.empty(nw * t, c, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.swinvox_fused_msa(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), rel_bias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], out.data_ptr(),
            qkv.data_ptr(), ctx.data_ptr(), nw, t, c, num_heads,
            float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_window_msa")
    fused_msa_forward.launches += 1
    return out


fused_msa_forward.launches = 0


class _FusedMSA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, num_heads,
                scale):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
        ctx.num_heads, ctx.scale = num_heads, scale
        return fused_msa_forward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                 num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = ctx.saved_tensors
        with torch.enable_grad():
            ins = [a.detach().requires_grad_()
                   for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
            out = fused_msa_reference(*ins, mask, ctx.num_heads, ctx.scale)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None, None)


def fused_window_msa(
    x: torch.Tensor,
    wqkv: torch.Tensor, bqkv: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor,
    rel_bias: torch.Tensor, mask: Optional[torch.Tensor],
    num_heads: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused W-MSA: x [nW, T, C] -> attention output [nW, T, C].

    Weights come in the compute dtype as [in, out]; biases, ``rel_bias``
    [heads, T, T] and ``mask`` [nW_img, T, T] (or None) are taken in
    float32 by the kernel.  A CPU tensor runs the plain version; a CUDA
    tensor launches kernel H (``launches`` on ``fused_msa_forward`` counts
    it) or raises.  Differentiable: the backward recomputes through the
    plain version.
    """
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    if x.device.type == "cpu":
        return fused_msa_reference(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                   mask, num_heads, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_window_msa: unsupported device {x.device}")
    bqkv, bproj, rel_bias = (a.float().contiguous()
                             for a in (bqkv, bproj, rel_bias))
    mask = None if mask is None else mask.float().contiguous()
    return _FusedMSA.apply(x.contiguous(), wqkv.contiguous(), bqkv,
                           wproj.contiguous(), bproj, rel_bias, mask,
                           num_heads, float(scale))
