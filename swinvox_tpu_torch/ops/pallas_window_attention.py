"""The window-attention core on head-major q/k/v (kernel G).

Counterpart of ``window_attention_pallas`` in
``swinvox_tpu/ops/pallas_window_attention.py`` (the module keeps that
path so a reader finds it; nothing here is Pallas):

  s   = (q k^T) * scale + rel_bias (+ mask[window % nW_img])   float32
  out = (softmax(s) cast to v's dtype) @ v, float32 sums, in q's dtype

On a CUDA tensor ``window_attention_pallas`` launches
``csrc/window_attention.cu`` (bf16, head_dim 32, at most 64 tokens),
under an autograd function whose backward recomputes through the plain
version (as the JAX VJP recomputes in XLA) when a gradient is wanted;
on a CPU tensor it runs ``window_attention_reference``, the plain
PyTorch function.  The kernel takes the (window, head) items in the
order (head, window slot ``w mod nW_img``, image) so that each block
stages a bias and a mask once for a run of items that share them
(``item_order`` is that order in PyTorch).

Shapes: q, k, v [nW, heads, T, head_dim] with windows image-major;
rel_bias [heads, T, T]; mask [nW_per_image, T, T] or None.
"""

from __future__ import annotations

from typing import Optional

import torch

from swinvox_tpu_torch.kernels import build
from swinvox_tpu_torch.ops.window_attention import window_attention_xla


def window_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    rel_bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch attention core (kernel G's plain version)."""
    return window_attention_xla(q, k, v, rel_bias, mask, scale)


def item_order(n_windows: int, heads: int, nw_img: int) -> torch.Tensor:
    """[n_windows * heads, 2] int64: the (window, head) of each item in the
    order kernel G walks them (``csrc/window_attention.cu``): item e is
    image e mod n_img of run e // n_img, run g = (head g // nw_img, window
    slot g mod nw_img), window = image * nw_img + slot, with n_img =
    n_windows / nw_img (``nw_img`` 1 when there is no mask)."""
    e = torch.arange(n_windows * heads)
    n_img = n_windows // nw_img
    run, img = e // n_img, e % n_img
    head, slot = run // nw_img, run % nw_img
    return torch.stack([img * nw_img + slot, head], 1)


def block_items(n_items: int, blocks: int) -> torch.Tensor:
    """[blocks + 1] int64: block b of kernel G's grid takes items
    [bounds[b], bounds[b + 1]) of ``item_order`` (the same number to one)."""
    return torch.arange(blocks + 1) * n_items // blocks


def _check(q, k, v, rel_bias, mask) -> None:
    shape = q.shape
    nw, heads, t, hd = shape
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and k.shape == shape and v.shape == shape):
        raise ValueError(f"window_attention: q, k, v must be bfloat16 of "
                         f"one shape, got {q.dtype} {tuple(shape)}, "
                         f"{k.dtype} {tuple(k.shape)}, {v.dtype} "
                         f"{tuple(v.shape)}")
    if hd != 32 or t > 64:
        raise ValueError(f"window_attention: the kernel takes head_dim 32 "
                         f"and at most 64 tokens, got {hd}, {t}")
    if rel_bias.shape != (heads, t, t):
        raise ValueError(f"window_attention: rel_bias must be "
                         f"{(heads, t, t)}, got {tuple(rel_bias.shape)}")
    if mask is not None and (mask.shape[1:] != (t, t) or nw % mask.shape[0]):
        raise ValueError("window_attention: mask must be [nW_img, T, T] "
                         "with nW a multiple of nW_img")
    dev = q.device
    for name, a in (("q", q), ("k", k), ("v", v), ("rel_bias", rel_bias),
                    ("mask", mask)):
        if a is not None and (a.device != dev or not a.is_contiguous()
                              or a.data_ptr() % 16):
            raise ValueError(f"window_attention: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {dev}")


def window_attention_forward(q, k, v, rel_bias, mask, scale):
    """Kernel G on the card: out [nW, heads, T, 32] bf16."""
    _check(q, k, v, rel_bias, mask)
    nw, heads, t, _ = q.shape
    lib = build.library()
    out = torch.empty_like(q)
    with build.on_device(q.device):
        err = lib.swinvox_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], out.data_ptr(), nw, heads,
            t, float(scale), build.stream(q.device))
    build.check(err, "window_attention")
    window_attention_forward.launches += 1
    return out


window_attention_forward.launches = 0


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_bias, mask, scale):
        ctx.save_for_backward(q, k, v, rel_bias, mask)
        ctx.scale = scale
        return window_attention_forward(q, k, v, rel_bias, mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_bias, mask = ctx.saved_tensors
        with torch.enable_grad():
            ins = [a.detach().requires_grad_() for a in (q, k, v, rel_bias)]
            out = window_attention_reference(*ins, mask, ctx.scale)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None)


def window_attention_pallas(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    rel_bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Same contract as ``window_attention_xla``.  A CPU tensor runs the
    plain version; a CUDA tensor launches kernel G (``launches`` on
    ``window_attention_forward`` counts it) or raises.  Differentiable:
    the backward recomputes through the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, rel_bias, mask, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"window_attention: unsupported device {q.device}")
    if rel_bias.dtype != torch.float32 or not rel_bias.is_contiguous():
        rel_bias = rel_bias.float().contiguous()
    if mask is not None and (mask.dtype != torch.float32
                             or not mask.is_contiguous()):
        mask = mask.float().contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad
                                    or rel_bias.requires_grad):
        return _WindowAttention.apply(q, k, v, rel_bias, mask, float(scale))
    return window_attention_forward(q, k, v, rel_bias, mask, float(scale))
