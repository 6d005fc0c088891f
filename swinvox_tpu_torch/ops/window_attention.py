"""Windowed multi-head self-attention core, plain PyTorch.

Counterpart of ``window_attention_xla`` in
``swinvox_tpu/ops/window_attention.py``: scale, relative-position bias,
the shifted-window additive mask, float32 softmax.  It serves the Swin
block's unfused path (``USE_PALLAS_SWIN_BLOCK`` off); the serving path
runs the fused block kernel (``ops/pallas_swin_block.py``) instead.

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
