"""The merger's six-layer conv stack in training mode (kernels E and F).

Counterpart of ``merger_stack`` in ``swinvox_tpu/ops/pallas_merger_stack.py``
(the module keeps that path so a reader finds it; nothing here is Pallas).
On N channels-last volumes x [N, 32, 32, 32, 9]:

  r_l = conv3x3x3_l(a_{l-1}) + bias_l            (pad 1; bf16, f32 sums)
  a_l = bf16(leaky(BN_l(r_l)))   l = 0..4        (batch statistics of r_l)
  inputs: a_{-1} = x; layer 4 reads concat(a_0..a_3) (36 channels);
  layer 5 (9 -> 1) reads a_4 and returns raw5 = r_5

BatchNorm normalizes with the batch mean and biased variance of the
bf16-rounded conv output, computed in float32 (E[r^2] - E[r]^2, as the
TPU kernel sums it); layer 5's BatchNorm is applied by the caller from
raw5's own statistics.  ``merger_stack`` returns ``(raw5, means, vars)``,
the six layers' batch statistics for the running-average update only
(they carry no gradient).

On a CUDA tensor it runs kernel E (``csrc/merger_stack.cu``, forward) and
kernel F (its backward) under an autograd function; on a CPU tensor
``merger_stack_reference``, the same function in plain PyTorch (stock
conv3d), autograd through its ops.  Kernels are given in the JAX layout
[3, 3, 3, C_in, C_out] (DHWIO).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from swinvox_tpu_torch.kernels import build

CHANNELS = ((9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1))
SIDE = 32


def merger_stack_reference(x, kernels, biases, gammas, betas, *,
                           leaky: float = 0.2, eps: float = 1e-5):
    """Plain PyTorch merger stack (kernels E and F's plain version):
    conv in x.dtype with f32 statistics, as the JAX reference."""

    def conv(inp, k, b):
        y = F.conv3d(inp.permute(0, 4, 1, 2, 3),
                     k.to(inp.dtype).permute(4, 3, 0, 1, 2),
                     b.to(inp.dtype), padding=1)
        return y.permute(0, 2, 3, 4, 1)

    acts, means, vars_ = [], [], []
    y = x
    for layer in range(6):
        inp = (x if layer == 0 else
               (torch.cat(acts, -1) if layer == 4 else acts[-1]))
        r = conv(inp, kernels[layer], biases[layer])
        r32 = r.float()
        m = r32.mean((0, 1, 2, 3))
        v = (r32 * r32).mean((0, 1, 2, 3)) - m * m
        means.append(m)
        vars_.append(v)
        if layer < 5:
            z = ((r32 - m) * torch.rsqrt(v + eps) * gammas[layer].float()
                 + betas[layer].float())
            acts.append(F.leaky_relu(z, leaky).to(x.dtype))
        else:
            y = r
    return y, tuple(means), tuple(vars_)


def _pack_weights(kernels) -> torch.Tensor:
    """The six DHWIO kernels as one contiguous bf16 buffer, in order."""
    return torch.cat([k.detach().to(torch.bfloat16).reshape(-1)
                      for k in kernels])


def _rows(vals, width: int, n: int) -> torch.Tensor:
    """[n, width] f32: row l holds vals[l] zero-padded to width."""
    out = torch.zeros(n, width, dtype=torch.float32, device=vals[0].device)
    for i, v in enumerate(vals):
        out[i, : v.numel()] = v.detach().float().reshape(-1)
    return out


def _check(x, kernels, biases, gammas, betas) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"merger_stack: the kernel takes bfloat16 volumes, "
                         f"got {x.dtype}")
    if x.dim() != 5 or tuple(x.shape[1:]) != (SIDE, SIDE, SIDE, 9):
        raise ValueError(f"merger_stack: x must be [N, 32, 32, 32, 9], got "
                         f"{tuple(x.shape)}")
    if len(kernels) != 6 or len(biases) != 6 or len(gammas) != 5 \
            or len(betas) != 5:
        raise ValueError("merger_stack: six kernels and biases, five "
                         "BatchNorm scales and offsets")
    for k, (ci, co) in zip(kernels, CHANNELS):
        if tuple(k.shape) != (3, 3, 3, ci, co):
            raise ValueError(f"merger_stack: kernel {tuple(k.shape)} is not "
                             f"[3, 3, 3, {ci}, {co}]")
    for t in (*kernels, *biases, *gammas, *betas):
        if t.device != x.device:
            raise ValueError(f"merger_stack: every operand must be on "
                             f"{x.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned (the kernels load whole 16-byte
    chunks of each w-row)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def merger_stack_forward(x, kernels, biases, gammas, betas, leaky, eps):
    """Kernel E: returns raw5 [N, 32, 32, 32, 1] bf16, the stats buffer
    [6, 4, 9] f32 (per layer: mean, biased variance, and the normalize
    affine scale and shift of layers 0..4) and the raw outputs r_0..r_4
    [5, N, 32^3, 9] bf16 the backward reads."""
    n = x.shape[0]
    lib = build.library()
    dev = x.device
    x = _aligned(x)
    w = _pack_weights(kernels)
    bias = _rows(biases, 9, 6)
    gamma = _rows(gammas, 9, 5)
    beta = _rows(betas, 9, 5)
    raws = torch.empty(5, n, SIDE**3, 9, dtype=torch.bfloat16, device=dev)
    raw5 = torch.empty(n, SIDE, SIDE, SIDE, 1, dtype=torch.bfloat16,
                       device=dev)
    stats = torch.empty(6, 4, 9, dtype=torch.float32, device=dev)
    ws = lib.swinvox_merger_stack_fwd_workspace(n)
    work = torch.empty(ws, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.swinvox_merger_stack_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), raws.data_ptr(), raw5.data_ptr(),
            stats.data_ptr(), work.data_ptr(), ws, n, float(leaky),
            float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "merger stack forward")
    merger_stack_forward.launches += 1
    return raw5, stats, raws


merger_stack_forward.launches = 0


def merger_stack_backward(d_raw5, x, raws, stats, kernels, gammas, leaky,
                          eps):
    """Kernel F: from d(raw5) and kernel E's saved raw outputs and
    statistics, returns dx (bf16) and, in float32, the six kernels'
    gradients (DHWIO), the six biases', and BatchNorm 0..4's scale and
    offset gradients (batch-statistics terms included)."""
    n = x.shape[0]
    lib = build.library()
    dev = x.device
    w = _pack_weights(kernels)
    gamma = _rows(gammas, 9, 5)
    d_raw5 = _aligned(d_raw5.to(torch.bfloat16))
    dx = torch.empty_like(x)
    dw = torch.empty(w.numel(), dtype=torch.float32, device=dev)
    dbias = torch.empty(6, 9, dtype=torch.float32, device=dev)
    dgamma = torch.empty(5, 9, dtype=torch.float32, device=dev)
    dbeta = torch.empty(5, 9, dtype=torch.float32, device=dev)
    ws = lib.swinvox_merger_stack_bwd_workspace(n)
    work = torch.empty(ws, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.swinvox_merger_stack_bwd(
            x.data_ptr(), raws.data_ptr(), stats.data_ptr(), w.data_ptr(),
            gamma.data_ptr(), d_raw5.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), dbias.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), work.data_ptr(), ws, n, float(leaky),
            float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "merger stack backward")
    merger_stack_backward.launches += 1
    dks, off = [], 0
    for k in kernels:
        dks.append(dw[off:off + k.numel()].view(k.shape).to(k.dtype))
        off += k.numel()
    return dx, dks, dbias, dgamma, dbeta


merger_stack_backward.launches = 0


class _MergerStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, leaky, eps, *params):
        kernels, biases = params[:6], params[6:12]
        gammas, betas = params[12:17], params[17:22]
        raw5, stats, raws = merger_stack_forward(x, kernels, biases, gammas,
                                                 betas, leaky, eps)
        means = tuple(stats[i, 0, : CHANNELS[i][1]].clone() for i in range(6))
        vars_ = tuple(stats[i, 1, : CHANNELS[i][1]].clone() for i in range(6))
        ctx.mark_non_differentiable(*means, *vars_)
        ctx.save_for_backward(x, raws, stats, *kernels, *gammas)
        ctx.leaky, ctx.eps = leaky, eps
        ctx.dtypes = [p.dtype for p in params]
        return (raw5, *means, *vars_)

    @staticmethod
    def backward(ctx, d_raw5, *_):
        x, raws, stats, *rest = ctx.saved_tensors
        kernels, gammas = rest[:6], rest[6:]
        dx, dks, dbias, dgamma, dbeta = merger_stack_backward(
            d_raw5, x, raws, stats, kernels, gammas, ctx.leaky, ctx.eps)
        dt = ctx.dtypes
        dbs = [dbias[i, : CHANNELS[i][1]].to(dt[6 + i]) for i in range(6)]
        dgs = [dgamma[i].to(dt[12 + i]) for i in range(5)]
        dbts = [dbeta[i].to(dt[17 + i]) for i in range(5)]
        return (dx, None, None, *dks, *dbs, *dgs, *dbts)


def merger_stack(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor],
                 gammas: Sequence[torch.Tensor],
                 betas: Sequence[torch.Tensor], *, leaky: float = 0.2,
                 eps: float = 1e-5
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                            Tuple[torch.Tensor, ...]]:
    """The six-layer merger stack, training mode, differentiable.

    x: [N, 32, 32, 32, 9]; kernels: six DHWIO Conv3d kernels; biases: six;
    gammas/betas: BatchNorm 0..4's scale and offset.  Returns (raw5
    [N, 32, 32, 32, 1], means (6), vars (6)); the statistics are for the
    running-average update only.  A CPU tensor runs the plain version; a
    CUDA tensor runs kernel E forward and kernel F backward (bf16 volumes)
    or raises.
    """
    if x.device.type == "cpu":
        return merger_stack_reference(x, kernels, biases, gammas, betas,
                                      leaky=leaky, eps=eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"merger_stack: unsupported device {x.device}")
    _check(x, kernels, biases, gammas, betas)
    out = _MergerStack.apply(x, float(leaky), float(eps), *kernels, *biases,
                             *gammas, *betas)
    return out[0], tuple(out[1:7]), tuple(out[7:13])
