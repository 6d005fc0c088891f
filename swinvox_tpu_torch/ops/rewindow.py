"""Window-major relayout between Swin blocks in one pass (kernel A).

Counterpart of ``swinvox_tpu/ops/rewindow.py``.  ``rewindow(x, sign=-1)``
maps window-major tokens of the image to those of the image cyclically
rolled by ``-shift`` (what a shifted-window block wants); ``sign=+1`` is
the exact inverse.  On a CUDA tensor it launches ``csrc/rewindow.cu``, a
gather that reads and writes every byte once (``source_rows`` is its
index math in PyTorch); on a CPU tensor it runs ``rewindow_reference``,
the same permutation in plain PyTorch.

Tokens are stored unpadded, [B * nWh * nWw, window**2, C]: the JAX
package pads them to 64 for Mosaic's sublane tiling, which Hopper does
not need.  ``rewindow`` is differentiable: a permutation's gradient is
its inverse, the same kernel with the opposite sign (the JAX VJP,
``swinvox_tpu/ops/rewindow.py:142-157``), which counts its launches too.
"""

from __future__ import annotations

import torch

from swinvox_tpu_torch.kernels import build


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, T, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_unpartition(x: torch.Tensor, window: int, h: int,
                       w: int) -> torch.Tensor:
    """[B * nW, T, C] -> [B, H, W, C]."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def source_rows(n_windows: int, nwh: int, nww: int, window: int, shift: int,
                sign: int) -> torch.Tensor:
    """[n_windows * window**2] int64: the input row each output row of
    ``rewindow`` copies, by kernel A's index math (``csrc/rewindow.cu``:
    the output row's window and token, its pixel in the image, the pixel
    it reads through the roll, and that pixel's window and token)."""
    t = window * window
    row = torch.arange(n_windows * t)
    win, tok = row // t, row % t
    strip, wx = win // nww, win % nww
    img, wy = strip // nwh, strip % nwh
    ty, tx = tok // window, tok % window
    offset = -sign * shift
    ys = (wy * window + ty + offset) % (nwh * window)
    xs = (wx * window + tx + offset) % (nww * window)
    return (((img * nwh + ys // window) * nww + xs // window) * t
            + (ys % window) * window + xs % window)


def _check(x: torch.Tensor, nwh: int, nww: int, window: int, shift: int,
           sign: int) -> None:
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    if not 0 < shift < window:
        raise ValueError(f"need 0 < shift < window, got {shift}, {window}")
    if x.dim() != 3 or x.shape[1] != window * window:
        raise ValueError(
            f"expected [nW, {window * window}, C] tokens, got {tuple(x.shape)}"
        )
    if x.shape[0] % (nwh * nww):
        raise ValueError(f"{x.shape[0]} windows is not a multiple of "
                         f"{nwh} x {nww}")


def rewindow_reference(x: torch.Tensor, nwh: int, nww: int, window: int,
                       shift: int, sign: int) -> torch.Tensor:
    """Plain PyTorch: unpartition -> roll by sign*shift -> partition."""
    _check(x, nwh, nww, window, shift, sign)
    img = window_unpartition(x, window, nwh * window, nww * window)
    img = torch.roll(img, shifts=(sign * shift, sign * shift), dims=(1, 2))
    return window_partition(img, window)


def _rewindow_cuda(x: torch.Tensor, nwh: int, nww: int, window: int,
                   shift: int, sign: int) -> torch.Tensor:
    """Launches kernel A on a CUDA tensor (any dtype whose rows of C
    channels span a multiple of 16 bytes; window 7) or raises.  The host
    work a call does is kept small (one library handle, no device switch
    when the tensor is on the current device), so that back-to-back calls
    keep the card's queue ahead."""
    if x.device.type != "cuda":
        raise RuntimeError(f"rewindow: unsupported device {x.device}")
    _check(x, nwh, nww, window, shift, sign)
    if window != 7:
        raise ValueError(f"rewindow: the kernel takes window 7, got {window}")
    row_bytes = x.shape[2] * x.element_size()
    if not x.is_contiguous() or x.data_ptr() % 16 or row_bytes % 16:
        raise ValueError("rewindow: x must be contiguous and 16-byte "
                         "aligned, with C * itemsize a multiple of 16, got "
                         f"C={x.shape[2]} {x.dtype}")
    lib = build.library()
    out = torch.empty_like(x)
    with build.on_device(x.device):
        err = lib.swinvox_rewindow(
            x.data_ptr(), out.data_ptr(), x.shape[0], nwh, nww, window,
            shift, sign, row_bytes,
            build.stream(x.device),
        )
    build.check(err, "rewindow")
    rewindow.launches += 1
    return out


class _Rewindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nwh, nww, window, shift, sign):
        ctx.args = (nwh, nww, window, shift, -sign)
        return _rewindow_cuda(x, nwh, nww, window, shift, sign)

    @staticmethod
    def backward(ctx, grad):
        return (_rewindow_cuda(grad.contiguous(), *ctx.args),
                None, None, None, None, None)


def rewindow(x: torch.Tensor, nwh: int, nww: int, window: int, shift: int,
             sign: int) -> torch.Tensor:
    """Permutes window-major tokens between the aligned and shifted window
    layouts: equals ``rewindow_reference``, exactly, and so does its
    gradient (the inverse permutation).

    A CPU tensor runs the plain version (autograd through its ops); a
    CUDA tensor launches kernel A, forward and backward, or raises.  A
    call that needs no gradient launches without the autograd function.
    """
    if x.device.type == "cpu":
        return rewindow_reference(x, nwh, nww, window, shift, sign)
    if x.requires_grad and torch.is_grad_enabled():
        return _Rewindow.apply(x, nwh, nww, window, shift, sign)
    return _rewindow_cuda(x, nwh, nww, window, shift, sign)


rewindow.launches = 0
