"""One merger Conv3d, bias-free and differentiable (kernels J and K).

Counterpart of ``band_conv3d`` in ``swinvox_tpu/ops/pallas_band_conv.py``
(the module keeps that path so a reader finds it; nothing here is Pallas):
a SAME-padded, stride-1 3x3x3 conv of channels-last volumes
x [V, 32, 32, 32, ci] with a DHWIO kernel [3, 3, 3, ci, co], for the
merger's (ci, co) in {(9, 9), (36, 9), (9, 1)}:

  * forward, kernel J: y[v, p, co] = sum_tap sum_ci x[v, p + tap, ci] *
    W[tap, ci, co], products of x.dtype values summed in float32, rounded
    once to x.dtype;
  * input gradient: J on dy with the adjoint kernel (taps flipped, ci and
    co swapped), rounded once to x.dtype, as the TPU kernel computes it;
  * weight gradient, kernel K: dW[tap, ci, co] = sum_v sum_p x[v, p + tap,
    ci] * dy[v, p, co] in float32 (bf16 operands on the tensor cores, f32
    ones on the CUDA cores), then cast to the kernel's dtype: the
    banded route gets a bf16 kernel from its caller (``models/merger.py``
    casts it, as the JAX merger does), so its dW is rounded to bf16 there;
    the slab route (``ops/pallas_slab_conv.py``) passes the float32
    parameter and keeps dW in float32.

On a CUDA tensor ``merger_conv_forward`` launches kernel J and
``merger_conv_wgrad`` kernel K (``csrc/merger_conv.cu``; bf16 on the
tensor-core conv bodies of ``csrc/merger_mma.cuh``, f32 on the CUDA-core
bodies of ``csrc/merger_common.cuh``), each counting its launches; on a CPU tensor they run ``merger_conv_reference`` and
``merger_conv_wgrad_reference``, the same functions in plain PyTorch (a
float32 conv of the operands rounded to x's dtype, and one float32
product per tap).  The conv is a
``torch.autograd.Function``, so the merger's BatchNorm, bias and
LeakyReLU stay in autograd around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from swinvox_tpu_torch.kernels import build

SIDE = 32
# (ci, co) of the merger's convs, and of their input gradients' adjoints
FORWARD_SHAPES = ((9, 9), (36, 9), (9, 1))
CONV_SHAPES = FORWARD_SHAPES + ((9, 36), (1, 9))
DTYPES = (torch.bfloat16, torch.float32)


def adjoint_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The input gradient's kernel: taps flipped, ci and co swapped."""
    return kernel.flip((0, 1, 2)).transpose(3, 4)


def merger_conv_reference(x: torch.Tensor,
                          kernel: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel J: x [V, 32, 32, 32, ci], kernel
    [3, 3, 3, ci, co] -> [V, 32, 32, 32, co] in x.dtype (the kernel
    rounded to x.dtype, then a float32 conv of the rounded operands: exact
    products, float32 sums, one rounding)."""
    w = kernel.to(x.dtype).float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w, padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def merger_conv_wgrad_reference(x: torch.Tensor,
                                dy: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K: x [V, 32, 32, 32, ci], dy
    [V, 32, 32, 32, co] -> dW [3, 3, 3, ci, co] float32, one float32
    product x_tap^T dy per tap of the zero-padded x."""
    ci, co = x.shape[-1], dy.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    g = dy.float().reshape(-1, co)
    dw = torch.stack([
        xp[:, t // 9:t // 9 + SIDE, t // 3 % 3:t // 3 % 3 + SIDE,
           t % 3:t % 3 + SIDE].reshape(-1, ci).t() @ g for t in range(27)])
    return dw.reshape(3, 3, 3, ci, co)


def _check(what: str, x: torch.Tensor, ci: int, co: int, shapes) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32, got "
                         f"{x.dtype}")
    if (ci, co) not in shapes:
        raise ValueError(f"{what}: channels {(ci, co)} not in {shapes}")
    if x.dim() != 5 or tuple(x.shape[1:]) != (SIDE, SIDE, SIDE, ci):
        raise ValueError(f"{what}: x must be [V, 32, 32, 32, {ci}], got "
                         f"{tuple(x.shape)}")


def merger_conv_forward(x: torch.Tensor,
                        kernel: torch.Tensor) -> torch.Tensor:
    """Kernel J on a CUDA tensor (the kernel cast to x.dtype), its plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return merger_conv_reference(x, kernel)
    ci, co = kernel.shape[3], kernel.shape[4]
    _check("merger conv (kernel J)", x, ci, co, CONV_SHAPES)
    if tuple(kernel.shape) != (3, 3, 3, ci, co) or \
            kernel.device != x.device:
        raise ValueError("merger conv (kernel J): kernel must be "
                         f"[3, 3, 3, ci, co] on {x.device}")
    lib = build.library()
    x = x.contiguous()
    # the bf16 route copies whole rows with 16-byte cp.async
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    w = kernel.detach().to(x.dtype).contiguous()
    v = x.shape[0]
    y = torch.empty(v, SIDE, SIDE, SIDE, co, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.swinvox_merger_conv(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), v, ci, co,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "merger conv (kernel J)")
    merger_conv_forward.launches += 1
    return y


merger_conv_forward.launches = 0


def merger_conv_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel K on CUDA tensors (dy cast to x.dtype), its plain version on
    CPU tensors: dW [3, 3, 3, ci, co] float32."""
    if x.device.type == "cpu":
        return merger_conv_wgrad_reference(x, dy)
    ci, co = x.shape[-1], dy.shape[-1]
    _check("merger conv weight gradient (kernel K)", x, ci, co,
           FORWARD_SHAPES)
    if tuple(dy.shape) != tuple(x.shape[:4]) + (co,) or \
            dy.device != x.device:
        raise ValueError("merger conv weight gradient (kernel K): dy "
                         f"{tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    lib = build.library()
    x, dy = (t.contiguous() for t in (x, dy.to(x.dtype)))
    # the bf16 route reads whole rows with 16-byte loads
    x, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dy))
    v, is_bf16 = x.shape[0], int(x.dtype == torch.bfloat16)
    dw = torch.empty(3, 3, 3, ci, co, dtype=torch.float32, device=x.device)
    ws = lib.swinvox_merger_conv_wgrad_workspace(v, ci, co, is_bf16)
    work = torch.empty(ws, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.swinvox_merger_conv_wgrad(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), work.data_ptr(), ws,
            v, ci, co, is_bf16,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "merger conv weight gradient (kernel K)")
    merger_conv_wgrad.launches += 1
    return dw


merger_conv_wgrad.launches = 0


class _MergerConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return merger_conv_forward(x, kernel)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = merger_conv_forward(dy, adjoint_kernel(kernel))
        if ctx.needs_input_grad[1]:
            dw = merger_conv_wgrad(x, dy).to(kernel.dtype)
        return dx, dw


def merger_conv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The merger conv, differentiable in x and kernel: J forward, J on
    the adjoint kernel and K backward; dW comes back in the kernel's
    dtype."""
    return _MergerConv.apply(x, kernel)


def band_conv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 bias-free conv3d, the banded route.

    x: [V, 32, 32, 32, ci]; kernel: [3, 3, 3, ci, co], which the merger
    casts to its compute dtype first (so dW is rounded to it) ->
    [V, 32, 32, 32, co] in x.dtype.  Differentiable in both arguments.
    """
    return merger_conv3d(x, kernel)
