"""Shared building blocks: convs, dense, norms, pools, resize, init.

Counterpart of ``swinvox_tpu/models/layers.py``.  Parameters are float32
and are cast to the module's compute ``dtype`` at each use; normalization
statistics are float32 — the JAX package's cast points.  The convolutional
modules take NCHW / NCDHW tensors and hold their kernels in torch's layout
(``convert.py`` transposes the flax kernels); ``Dense`` keeps flax's
``[in, out]`` kernel, which is also the layout the Swin-block kernel reads.

Parameter and buffer names are the flax leaf names (``kernel``, ``bias``,
``scale``, ``mean``, ``var``) so the weight bridge maps paths mechanically.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# gain for kaiming-normal with leaky_relu nonlinearity, a=0.02
_LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.02**2))

IntOrTuple = Union[int, Sequence[int]]


def _tuple(v: IntOrTuple, rank: int) -> Tuple[int, ...]:
    return (v,) * rank if isinstance(v, int) else tuple(v)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul of operands in the compute dtype with a float32 result —
    ``preferred_element_type=float32`` in the JAX package: the products of
    bf16 values are exact in f32, so upcasting first is the same math."""
    return torch.matmul(a.float(), b.float())


class Conv(nn.Module):
    """Conv (2D or 3D by kernel rank); ``kernel`` is [out, in/groups, *k]."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: IntOrTuple = 1,
        padding: IntOrTuple = 0,
        use_bias: bool = True,
        feature_group_count: int = 1,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.rank = len(kernel_size)
        self.strides = _tuple(strides, self.rank)
        self.padding = _tuple(padding, self.rank)
        self.groups = feature_group_count
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(features, in_features // feature_group_count,
                        *kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if self.rank == 2 else F.conv3d
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv(
            x.to(self.dtype), self.kernel.to(self.dtype), bias,
            stride=self.strides, padding=self.padding, groups=self.groups,
        )


class ConvTranspose(nn.Module):
    """3D transposed conv, torch output geometry: out = (in-1)*s - 2p + k.

    The JAX module is an input-dilated correlation whose kernel is NOT
    flipped (``swinvox_tpu/models/layers.py`` ConvTranspose); torch's
    ``conv_transpose`` flips, so ``kernel`` here is the flax kernel
    spatially flipped and laid out [in, out, *k] (``convert.py`` does it).
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: IntOrTuple = 1,
        padding: IntOrTuple = 0,
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.strides = _tuple(strides, 3)
        self.padding = _tuple(padding, 3)
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, features, *kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(x.to(self.dtype), self.kernel.to(self.dtype),
                               stride=self.strides, padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(-1, 1, 1, 1)
        return y


class Dense(nn.Module):
    """Linear layer over the last axis; ``kernel`` is flax's [in, out]."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``len(shape)`` axes, float32 compute.

    ``shape`` of length 1 is the transformer LayerNorm over channels-last
    tokens; the encoder's per-stage norm is the reference's
    ``nn.LayerNorm([C, H, W])`` on NCHW maps (JAX: ``num_axes=3`` over
    [H, W, C]; the bridge transposes its affine).
    """

    def __init__(
        self,
        shape: Union[int, Sequence[int]],
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(self.shape))
        self.bias = nn.Parameter(torch.zeros(self.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.shape, self.scale, self.bias, 1e-5)
        return y.to(self.dtype)


class Norm(nn.Module):
    """BatchNorm on channel axis 1, float32 statistics, eps 1e-5.

    Counterpart of the JAX ``Norm`` (flax ``BatchNorm``, momentum 0.9):

      * ``train=False``: normalize with the running statistics;
      * ``train=True``: normalize with the batch mean and the *biased*
        batch variance, and update the running statistics to
        ``0.9 * running + 0.1 * batch`` with that biased variance, as
        flax does (``torch.nn.BatchNorm*`` would use the unbiased one);
      * ``external_stats=(mean, var)``: normalize with the given batch
        statistics (differentiable through them) and, in training, update
        the running statistics with them — the merger stack computes its
        statistics in its own kernel.

    The normalization is computed in float32 and rounded once to
    ``dtype``; ``F.batch_norm`` does that in one pass (in training it
    normalizes with the biased variance and, given no running buffers,
    updates nothing); the running update happens here, without gradient.
    Its variance is the two-pass one where flax computes E[x^2] - E[x]^2:
    the two agree to f32 rounding unless |mean| >> std, and the parity
    tests hold the whole training step to the JAX package's.
    """

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.mean.mul_(0.9).add_(0.1 * mean.detach().float())
            self.var.mul_(0.9).add_(0.1 * var.detach().float())

    def forward(self, x: torch.Tensor, train: bool = False,
                external_stats=None) -> torch.Tensor:
        if external_stats is None:
            if train:
                with torch.no_grad():
                    dims = [0] + list(range(2, x.dim()))
                    var, mean = torch.var_mean(x.float(), dim=dims,
                                               correction=0)
                self._update(mean, var)
            y = F.batch_norm(x, None if train else self.mean,
                             None if train else self.var, self.scale,
                             self.bias, training=train, eps=1e-5)
            return y.to(self.dtype)
        mean, var = (s.float() for s in external_stats)
        if train:
            self._update(mean, var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var + 1e-5) * self.scale
        y = ((x.float() - mean.view(shape)) * inv.view(shape)
             + self.bias.view(shape))
        return y.to(self.dtype)


class DropPath(nn.Module):
    """Stochastic depth: per-sample factors 1/keep or 0 for a residual
    branch (JAX ``DropPath``).  ``factors`` draws one float32 factor per
    sample from ``generator`` on ``device``; at rate 0, or outside
    training, it draws nothing and returns ones."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def factors(self, batch: int, train: bool,
                generator: Optional[torch.Generator],
                device: torch.device) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return torch.ones(batch, dtype=torch.float32, device=device)
        keep = 1.0 - self.rate
        draw = torch.rand(batch, generator=_need(generator), device=device)
        return (draw < keep).float() / keep

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        f = self.factors(x.shape[0], train, generator, x.device)
        shape = (-1,) + (1,) * (x.dim() - 1)
        return (x.float() * f.view(shape)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout (flax ``Dropout``) with its mask drawn from
    ``generator``: kept values are scaled by 1/keep.  ``F.dropout`` takes
    no generator, so the mask is drawn here."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=_need(generator), device=x.device)
    return (x.float() * ((draw < keep).float() / keep)).to(x.dtype)


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("training draws dropout and drop-path masks from an "
                         "explicit torch.Generator; none was given")
    return generator


class _MaxPool2(torch.autograd.Function):
    """2x2x2, stride-2 max pool of NCDHW input (odd edges dropped) whose
    gradient goes to the first maximum of each window, in window order
    (d, h, w): as ``F.max_pool3d`` and JAX's ``select_and_scatter_add``.
    The backward is elementwise (the incoming gradient times a one-hot of
    that maximum), so its bits repeat, unlike the scatter of
    ``max_pool3d_with_indices_backward``."""

    @staticmethod
    def forward(ctx, x):
        n, c, d, h, w = x.shape
        win = x[..., :d // 2 * 2, :h // 2 * 2, :w // 2 * 2].reshape(
            n, c, d // 2, 2, h // 2, 2, w // 2, 2)
        win = win.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(
            n, c, d // 2, h // 2, w // 2, 8)
        first = win.argmax(-1, keepdim=True)  # the first maximum
        ctx.save_for_backward(first)
        ctx.shape = x.shape
        return win.gather(-1, first)[..., 0]

    @staticmethod
    def backward(ctx, g):
        (first,) = ctx.saved_tensors
        n, c, d, h, w = ctx.shape
        onehot = first == torch.arange(8, device=g.device)
        gw = (g[..., None] * onehot).reshape(n, c, d // 2, h // 2, w // 2,
                                             2, 2, 2)
        gw = gw.permute(0, 1, 2, 5, 3, 6, 4, 7).reshape(
            n, c, d // 2 * 2, h // 2 * 2, w // 2 * 2)
        return F.pad(gw, (0, w % 2, 0, h % 2, 0, d % 2))


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Max pool over the spatial dims of NCHW / NCDHW input (padding is
    -inf, as the JAX trunk pads before its VALID pool).  The refiner's
    2x2x2 stride-2 pool has a deterministic backward (``_MaxPool2``);
    every other window or stride is the stock pool."""
    stride = stride or window
    if x.dim() == 5 and window == stride == 2 and padding == 0:
        return _MaxPool2.apply(x)
    pool = F.max_pool2d if x.dim() == 4 else F.max_pool3d
    return pool(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Average pool of NCHW input, stride = window (VALID)."""
    return F.avg_pool2d(x, window)


def adaptive_avg_pool_7_to_2(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((2, 2)) on 7x7 NCHW input: torch's bins for 7 -> 2
    are [0:4) and [3:7), i.e. window 4, stride 3."""
    return F.avg_pool2d(x, 4, 3)


_RESIZE_MATRICES = {}


def _interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] f32 weights of 1-D linear upsampling with half-pixel
    centres, the source clamped to the border; built once per size (a
    normal tensor even when first asked for under inference mode, since
    training reuses it)."""
    key = (n_in, n_out, str(device))
    if key not in _RESIZE_MATRICES:
        with torch.inference_mode(False):
            src = ((torch.arange(n_out, dtype=torch.float64) + 0.5)
                   * (n_in / n_out) - 0.5).clamp(0, n_in - 1)
            i0 = src.floor().long()
            i1 = (i0 + 1).clamp(max=n_in - 1)
            frac = src - i0
            r = torch.zeros(n_out, n_in, dtype=torch.float64)
            rows = torch.arange(n_out)
            r[rows, i0] += 1 - frac
            r[rows, i1] += frac
            _RESIZE_MATRICES[key] = r.float().to(device)
    return _RESIZE_MATRICES[key]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW input with half-pixel centers.

    Equals ``jax.image.resize(method="bilinear")``.  Upsampling (no side
    shrinks) is ``R_h x R_w^T`` in f32 with the interpolation matrices of
    ``_interp_matrix``: ``F.interpolate(align_corners=False)``'s function,
    whose forward and backward are products, so the gradient's bits repeat
    (the CVA's upsampling trains through it).  Downsampling antialiases in
    JAX, hence ``F.interpolate(antialias=True)``; no gradient goes through
    it on any path.
    """
    h, w = x.shape[-2:]
    if size[0] >= h and size[1] >= w:
        rh = _interp_matrix(h, size[0], x.device)
        rw = _interp_matrix(w, size[1], x.device)
        return torch.matmul(torch.matmul(rh, x.float()), rw.t()).to(x.dtype)
    y = F.interpolate(x.float(), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


# ------------------------------------------------------------------ init


def init_reference_(
    module: nn.Module, generator: torch.Generator, scheme: str = "reference"
) -> None:
    """Draw every parameter of ``module`` as the JAX package initializes it
    (``swinvox_tpu/models/layers.py:56-90``), from ``generator``:

      * Conv / ConvTranspose kernels: kaiming-normal(fan_out, leaky_relu
        a=0.02), x0.1 under the "reference" scheme; biases zero;
      * Dense kernels: normal(0, 0.01) x0.1 ("reference") or lecun-normal
        ("standard"); biases zero;
      * LayerNorm / BatchNorm affine ones / zeros, running stats 0 / 1;
      * Swin relative-position tables: truncated normal(0.02).

    The two frameworks draw different numbers from one seed, so the tests
    load identical weights through ``convert.py`` instead.
    """
    if scheme not in ("reference", "standard"):
        raise ValueError(f"unknown init scheme {scheme!r}")
    conv_scale = 0.1 if scheme == "reference" else 1.0

    def dense_(k: torch.Tensor) -> None:
        if scheme == "reference":
            k.normal_(0.0, 0.01 * 0.1, generator=generator)
        else:
            # flax lecun_normal: truncated normal at +-2 std, renormalized
            # to unit variance over fan_in
            std = math.sqrt(1.0 / k.shape[0]) / 0.8796256610342398
            nn.init.trunc_normal_(k, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (Conv, ConvTranspose)):
                k = mod.kernel
                out_axis = 0 if isinstance(mod, Conv) else 1
                fan_out = k.shape[out_axis] * math.prod(k.shape[2:])
                std = _LEAKY_GAIN / math.sqrt(fan_out) * conv_scale
                k.normal_(0.0, std, generator=generator)
            elif isinstance(mod, Dense):
                dense_(mod.kernel)
            elif hasattr(mod, "rel_pos_bias_table"):  # swin WindowMSA
                dense_(mod.qkv_kernel)
                dense_(mod.proj_kernel)
                nn.init.trunc_normal_(mod.rel_pos_bias_table, 0.0, 0.02,
                                      -0.04, 0.04, generator=generator)
