"""The refiner's first conv with a fused backward (kernel L).

Counterpart of ``conv3d_down1`` in ``swinvox_tpu/ops/pallas_down1.py`` (the
module keeps that path so a reader finds it; nothing here is Pallas):
Conv3d(1 -> 32, k4, padding 2), bias-free, on x [N, 32, 32, 32, 1] with a
DHWIO kernel [4, 4, 4, 1, 32] -> [N, 33, 33, 33, 32] channels-last.

  * forward: the stock conv (``F.conv3d``), as the JAX forward is
    ``lax.conv_general_dilated`` outside Pallas;
  * backward, kernel L: from dy [N, 33, 33, 33, 32],
    dW[k, c] = sum_n sum_o x_pad[n, o + k] * dy[n, o, c] (float32) and
    dx[n, i] = sum_k sum_c dy[n, i + 2 - k, c] * W[k, c] (float32 sums,
    rounded once to x's dtype); dW is then cast to the kernel's dtype,
    which the refiner casts to its compute dtype first (so, in bf16, dW is
    rounded to bf16 and widened, as in JAX).

On CUDA tensors ``down1_backward`` launches kernel L (``csrc/down1.cu``:
in bf16 both gradients on the tensor cores from one staged copy of dy, in
f32 on the CUDA cores) and counts it; on CPU tensors it runs
``down1_backward_reference``, the same function in plain PyTorch (one
float32 product per tap).  Any N works (the TPU kernel pads to 16 volumes
for its layout).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from swinvox_tpu_torch.kernels import build

S = 32
SO = S + 1
K = 4
C = 32
DTYPES = (torch.bfloat16, torch.float32)


def down1_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stock conv: x [N, 32, 32, 32, 1], w [4, 4, 4, 1, 32] ->
    [N, 33, 33, 33, 32] (a channels-last view of cuDNN's output)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                 w.to(x.dtype).permute(4, 3, 0, 1, 2), padding=2)
    return y.permute(0, 2, 3, 4, 1)


def down1_backward_reference(x: torch.Tensor, w: torch.Tensor,
                             dy: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel L: (dx [N, 32, 32, 32, 1] in x.dtype,
    dW [4, 4, 4, 1, 32] float32) from x, w and dy [N, 33, 33, 33, 32]."""
    n = x.shape[0]
    xp = F.pad(x[..., 0].float(), (2, 2) * 3)          # [N, 36, 36, 36]
    g = dy.float().reshape(-1, C)
    wt = w.to(x.dtype).float().reshape(K * K * K, C)
    z = F.pad(dy.float() @ wt.t(), (0, 0) + (1, 1) * 3)  # [N, 35^3, 64]
    dw = torch.empty(K * K * K, C, dtype=torch.float32, device=x.device)
    dx = torch.zeros(n, S, S, S, dtype=torch.float32, device=x.device)
    for t in range(K * K * K):
        kd, kh, kw = t // 16, t // 4 % 4, t % 4
        dw[t] = xp[:, kd:kd + SO, kh:kh + SO, kw:kw + SO].reshape(-1) @ g
        # o = i + 2 - k, at index o + 1 of the padded z
        dx += z[:, 3 - kd:3 - kd + S, 3 - kh:3 - kh + S, 3 - kw:3 - kw + S, t]
    return dx[..., None].to(x.dtype), dw.reshape(K, K, K, 1, C)


def down1_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel L on CUDA tensors (w and dy cast to x.dtype), its plain
    version on CPU tensors: (dx in x.dtype, dW float32)."""
    if x.device.type == "cpu":
        return down1_backward_reference(x, w, dy)
    what = "refiner down1 backward (kernel L)"
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32, got "
                         f"{x.dtype}")
    n = x.shape[0]
    if (tuple(x.shape) != (n, S, S, S, 1) or tuple(w.shape) != (K, K, K, 1, C)
            or tuple(dy.shape) != (n, SO, SO, SO, C)):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, dy {tuple(dy.shape)}")
    if w.device != x.device or dy.device != x.device:
        raise ValueError(f"{what}: every operand must be on {x.device}")
    lib = build.library()
    x = x.contiguous()
    wk = w.detach().to(x.dtype).contiguous()
    dy = dy.to(x.dtype).contiguous()
    if any(a.data_ptr() % 16 for a in (x, wk, dy)):
        # the bf16 route reads dy with cp.async, 16 bytes at a time
        raise ValueError(f"{what}: x, w and dy must be 16-byte aligned")
    dx = torch.empty_like(x)
    dw = torch.empty(K, K, K, 1, C, dtype=torch.float32, device=x.device)
    ws = lib.swinvox_down1_bwd_workspace(n)
    work = torch.empty(ws, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.swinvox_down1_bwd(
            x.data_ptr(), wk.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), work.data_ptr(), ws, n,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, what)
    down1_backward.launches += 1
    return dx, dw


down1_backward.launches = 0


class _Down1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return down1_forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = down1_backward(x, w, dy)
        return dx, dw.to(w.dtype)


def conv3d_down1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Conv3d(1 -> 32, k4, p2) with the stock forward and kernel L's
    backward.  x: [N, 32, 32, 32, 1]; w: [4, 4, 4, 1, 32] (the refiner
    passes it in its compute dtype).  Bias is the caller's."""
    return _Down1.apply(x, w)
