"""Windowed multi-head self-attention core.

Counterpart of ``swinvox_tpu/ops/window_attention.py``:
``window_attention_xla`` is the plain PyTorch core (scale,
relative-position bias, the shifted-window additive mask, float32
softmax); ``window_attention(..., use_pallas=True)`` dispatches a CUDA
tensor to kernel G (``ops/pallas_window_attention.py``) as the JAX
function dispatches to its Pallas kernel on a TPU.  The Swin block's
unfused path runs the plain core; the fused block (kernel B) and the
fused W-MSA (kernel H) run kernel B's own attention launch.

Shapes (windows flattened into the batch axis):
  q, k, v  : [nW, heads, T, head_dim]
  rel_bias : [heads, T, T]
  mask     : [nW_per_image, T, T] or None (additive, tiled over images)
Returns [nW, heads, T, head_dim] in q.dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from swinvox_tpu_torch.models.layers import mm_f32


def window_attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    nw, heads, tokens, head_dim = q.shape
    if scale is None:
        scale = head_dim**-0.5
    scores = mm_f32(q, k.transpose(-1, -2))
    scores = scores * scale + rel_bias[None].float()
    if mask is not None:
        nw_per_image = mask.shape[0]
        scores = scores.view(nw // nw_per_image, nw_per_image, heads,
                             tokens, tokens)
        scores = scores + mask.float()[None, :, None]
        scores = scores.view(nw, heads, tokens, tokens)
    probs = torch.softmax(scores, dim=-1)
    return mm_f32(probs.to(v.dtype), v).to(q.dtype)


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Kernel G on a CUDA tensor under ``use_pallas``, else the plain core."""
    if use_pallas and q.device.type == "cuda":
        from swinvox_tpu_torch.ops.pallas_window_attention import (
            window_attention_pallas,
        )

        return window_attention_pallas(q, k, v, rel_bias, mask, scale)
    return window_attention_xla(q, k, v, rel_bias, mask, scale)
