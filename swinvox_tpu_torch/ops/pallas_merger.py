"""The merger's six-layer conv stack at inference (kernel I).

Counterpart of ``merger_view_weights`` in ``swinvox_tpu/ops/pallas_merger.py``
(the module keeps that path so a reader finds it; nothing here is Pallas).
On V channels-last volumes x [V, 32, 32, 32, 9] in the compute dtype:

  a_l = leaky(conv3x3x3_l(a_{l-1}) * s_l + t_l)     (zero pad 1, f32 sums)
  rounded to the compute dtype for l = 0..4 (the TPU kernel's scratches),
  a_{-1} = x; conv5 reads concat(a_0..a_3); the f32 a_5 [V, 32, 32, 32]
  are the per-voxel view logits

with BatchNorm folded from the running statistics and the conv bias,
``s = gamma / sqrt(var + 1e-5)``, ``t = (bias - mean) * s + beta``
(``pallas_merger.py:237-241``).  The softmax over views stays with the
caller.  On a CUDA tensor it launches kernel I (``csrc/merger_stack.cu``,
``swinvox_merger_infer``: six convs on the tensor-core body of
``csrc/merger_mma.cuh``, the fold and LeakyReLU on each f32 sum); on a CPU
tensor ``merger_view_weights_reference``,
the same function in plain PyTorch.  Kernels are given in the JAX layout
[3, 3, 3, C_in, C_out] (DHWIO).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from swinvox_tpu_torch.kernels import build
from swinvox_tpu_torch.ops.pallas_merger_stack import (
    CHANNELS,
    SIDE,
    _pack_weights,
)

EPS = 1e-5


def fold_bn(scale, bias, mean, var, conv_bias, eps: float = EPS
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN(z + conv_bias) = z * s + t, in float32."""
    s = scale.float() / torch.sqrt(var.float() + eps)
    t = (conv_bias.float() - mean.float()) * s + bias.float()
    return s, t


def merger_view_weights_reference(x, kernels, biases, bn_params, *,
                                  leaky: float = 0.2) -> torch.Tensor:
    """Plain PyTorch inference merger stack (kernel I's plain version):
    products of compute-dtype values summed in float32 (an f32 conv of the
    rounded operands), each layer's activation rounded to x.dtype."""
    dtype = x.dtype
    acts = []
    y = x.permute(0, 4, 1, 2, 3)
    for layer in range(6):
        inp = (y if layer == 0 else
               (torch.cat(acts, 1) if layer == 4 else acts[-1]))
        k = kernels[layer].to(dtype).float().permute(4, 3, 0, 1, 2)
        z = F.conv3d(inp.float(), k, padding=1)
        s, t = fold_bn(*bn_params[layer], biases[layer])
        z = F.leaky_relu(z * s.view(1, -1, 1, 1, 1) + t.view(1, -1, 1, 1, 1),
                         leaky)
        if layer < 5:
            acts.append(z.to(dtype))
    return z[:, 0]


def _check(x, kernels, biases, bn_params) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"merger_view_weights: the kernel takes bfloat16 "
                         f"volumes, got {x.dtype}")
    if x.dim() != 5 or tuple(x.shape[1:]) != (SIDE, SIDE, SIDE, 9):
        raise ValueError(f"merger_view_weights: x must be [V, 32, 32, 32, 9],"
                         f" got {tuple(x.shape)}")
    if len(kernels) != 6 or len(biases) != 6 or len(bn_params) != 6:
        raise ValueError("merger_view_weights: six kernels, biases and "
                         "BatchNorm (scale, bias, mean, var)")
    for k, (ci, co) in zip(kernels, CHANNELS):
        if tuple(k.shape) != (3, 3, 3, ci, co):
            raise ValueError(f"merger_view_weights: kernel {tuple(k.shape)} "
                             f"is not [3, 3, 3, {ci}, {co}]")
    for t in (*kernels, *biases, *(p for bn in bn_params for p in bn)):
        if t.device != x.device:
            raise ValueError(f"merger_view_weights: every operand must be on "
                             f"{x.device}")


def merger_view_weights(
    x: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    bn_params: Sequence[Tuple[torch.Tensor, ...]],
    leaky: float = 0.2,
) -> torch.Tensor:
    """Per-voxel view-weight logits of the merger at inference.

    x [V, 32, 32, 32, 9] (raw decoder features, channels-last); kernels:
    six DHWIO Conv3d kernels; biases: six; bn_params: six (scale, bias,
    running mean, running var).  Returns [V, 32, 32, 32] float32.  A CPU
    tensor runs the plain version; a CUDA tensor launches kernel I (bf16
    volumes) or raises.
    """
    if x.device.type == "cpu":
        return merger_view_weights_reference(x, kernels, biases, bn_params,
                                             leaky=leaky)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"merger_view_weights: unsupported device {x.device}")
    _check(x, kernels, biases, bn_params)
    n = x.shape[0]
    dev = x.device
    x = x.contiguous()
    # the kernel copies whole rows with 16-byte cp.async
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    w = _pack_weights(kernels)
    fold = torch.zeros(6, 2, 9, dtype=torch.float32, device=dev)
    for layer, (bn, b) in enumerate(zip(bn_params, biases)):
        s, t = fold_bn(*bn, b)
        fold[layer, 0, : s.numel()] = s.detach()
        fold[layer, 1, : t.numel()] = t.detach()
    acts = torch.empty(5, n * SIDE**3 * 9, dtype=torch.bfloat16, device=dev)
    out = torch.empty(n, SIDE, SIDE, SIDE, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.swinvox_merger_infer(
            x.data_ptr(), w.data_ptr(), fold.data_ptr(), acts.data_ptr(),
            out.data_ptr(), n, float(leaky),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "merger_view_weights")
    merger_view_weights.launches += 1
    return out


merger_view_weights.launches = 0
