"""Swin-Tiny backbone, channels-last tokens.

Counterpart of ``swinvox_tpu/models/swin.py``: patch size 4, window 7,
embed dim 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), MLP ratio 4, qkv
bias, relative-position bias, alternating W-MSA / SW-MSA (shift 3, zeroed
on a map no larger than the window), patch merging, and in training
stochastic depth with rates ``np.linspace(0, 0.1, sum(depths))`` over the
blocks.  Stage outputs are NHWC, as in JAX.

Two paths over one parameter layout, gated like the JAX package:

  * the fused block: at inference under ``use_pallas_block``
    (``USE_PALLAS_SWIN_BLOCK``) each block runs
    ``ops/pallas_swin_block.fused_swin_block`` (kernel B), in training
    under ``use_pallas_block_train`` (``USE_PALLAS_SWIN_BLOCK_TRAIN``)
    ``fused_swin_block_train`` (kernels C and D) with per-image drop-path
    factors repeated per window; the plain versions on the CPU;
  * otherwise the unfused modules (LN, ``WindowMSA``, MLP, ``DropPath``),
    where at inference under ``use_pallas`` (``USE_PALLAS_WINDOW_ATTENTION``)
    ``WindowMSA`` runs ``ops/pallas_fused_msa.fused_window_msa`` (kernel
    H): the JAX gate ``use_pallas and deterministic and not
    use_fused_block``.

Both paths draw the drop-path factors from the caller's generator in the
same order (per block: the attention branch's, then the MLP's), so they
drop the same branches.  With ``use_rewindow_chain``
(``USE_REWINDOW_CHAIN``) on top of the fused path of the mode, a stage is
partitioned once and tokens stay window-major from block to block, in
the aligned layout throughout: a shifted block's kernel reads and writes
its shifted windows through the roll's map (where the JAX chain moves
the tokens with ``rewindow``, kernel A), so the chain makes no relayout
pass.  Unlike JAX, the chain runs on the CPU too, with the plain
versions.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from swinvox_tpu_torch.models.layers import (
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    mm_f32,
    resize_bilinear,
)
from swinvox_tpu_torch.ops.pallas_fused_msa import fused_window_msa
from swinvox_tpu_torch.ops.pallas_swin_block import (
    fused_swin_block,
    fused_swin_block_train,
)
from swinvox_tpu_torch.ops.rewindow import (
    window_partition,
    window_unpartition,
)
from swinvox_tpu_torch.ops.window_attention import window_attention_xla


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """[T, T] indices into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    )
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def relative_position_sources(window: int) -> np.ndarray:
    """[(2w-1)^2, w^2]: for each row of the bias table, the flat [T * T]
    positions that read it (``relative_position_index``), ascending, padded
    with T * T (a zero row appended to the gradient).  The zero offset is
    read T times, every other offset fewer."""
    idx = relative_position_index(window).reshape(-1)
    rows = (2 * window - 1) ** 2
    out = np.full((rows, window * window), idx.size, np.int64)
    for r in range(rows):
        pos = np.flatnonzero(idx == r)
        out[r, :pos.size] = pos
    return out


class _TableGather(torch.autograd.Function):
    """``table[index]`` for a [R, heads] table and a constant index whose
    gradient sums each table row's contributions in one fixed order: a
    gather of the incoming gradient's rows by ``sources``
    (``relative_position_sources``) and a sum over them, where indexing's
    own backward is a scatter-add (``index_put_`` with accumulate), whose
    order is the library's.  The sum's bits repeat from call to call."""

    @staticmethod
    def forward(ctx, table, index, sources):
        ctx.save_for_backward(sources)
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        (sources,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])
        return padded[sources].sum(1), None, None


@functools.lru_cache(maxsize=None)
def shifted_window_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Additive attention mask [nW, T, T] for SW-MSA (0 same-region, -100 else)."""
    img_mask = np.zeros((h, w), dtype=np.int32)
    region = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[hs, ws] = region
            region += 1
    windows = img_mask.reshape(h // window, window, w // window, window)
    windows = windows.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = windows[:, :, None] - windows[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


class WindowMSA(nn.Module):
    """Multi-head self-attention within windows, with rel-pos bias.

    Holds the raw flax-named weights (``qkv_kernel`` [C, 3C] etc.) that the
    fused block kernel also reads.  ``use_pallas`` runs the whole module as
    the fused W-MSA (kernel H) on the same weights, their biases rounded
    to the compute dtype as the JAX module passes them to its kernel.
    """

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.dtype = dtype
        self.qkv_kernel = nn.Parameter(torch.empty(dim, 3 * dim))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * dim))
        self.proj_kernel = nn.Parameter(torch.empty(dim, dim))
        self.proj_bias = nn.Parameter(torch.zeros(dim))
        self.rel_pos_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window).reshape(-1)),
            persistent=False,
        )
        self.register_buffer(
            "rel_sources",
            torch.from_numpy(relative_position_sources(window)),
            persistent=False,
        )

    def rel_bias(self) -> torch.Tensor:
        """[heads, T, T] float32 relative-position bias; its gradient into
        the table is a fixed-order sum (``_TableGather``)."""
        t = self.window * self.window
        return (_TableGather.apply(self.rel_pos_bias_table, self.rel_index,
                                   self.rel_sources)
                .view(t, t, self.num_heads).permute(2, 0, 1).contiguous())

    def forward(self, x_windows: torch.Tensor,
                mask: Optional[torch.Tensor],
                use_pallas: bool = False) -> torch.Tensor:
        if use_pallas:
            dt = self.dtype
            return fused_window_msa(
                x_windows, self.qkv_kernel.to(dt), self.qkv_bias.to(dt),
                self.proj_kernel.to(dt), self.proj_bias.to(dt),
                self.rel_bias(), mask, self.num_heads)
        nw, t, c = x_windows.shape
        hd = self.dim // self.num_heads
        w3 = self.qkv_kernel.to(self.dtype).view(c, 3, self.num_heads, hd)
        b3 = self.qkv_bias.float().view(3, self.num_heads, 1, hd)

        def head_major(i):  # [nW, heads, T, hd]
            y = mm_f32(x_windows[:, None], w3[:, i].permute(1, 0, 2)[None])
            return (y + b3[i]).to(self.dtype)

        out = window_attention_xla(head_major(0), head_major(1),
                                   head_major(2), self.rel_bias(), mask)
        out = out.permute(0, 2, 1, 3).reshape(nw, t, self.dim)
        y = mm_f32(out, self.proj_kernel.to(self.dtype)) + self.proj_bias.float()
        return y.to(self.dtype)


class SwinBlock(nn.Module):
    """LN -> (S)W-MSA -> residual -> LN -> MLP -> residual."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: int = 0, dtype=torch.bfloat16,
                 use_pallas_block: bool = False,
                 use_pallas_block_train: bool = False,
                 drop_path_rate: float = 0.0, use_pallas: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window, self.shift = window, shift
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.use_pallas_block = use_pallas_block
        self.use_pallas_block_train = use_pallas_block_train
        self.drop_path1 = DropPath(drop_path_rate)
        self.drop_path2 = DropPath(drop_path_rate)
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowMSA(dim, num_heads, window, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp_fc1 = Dense(dim, 4 * dim, dtype=dtype)
        self.mlp_fc2 = Dense(4 * dim, dim, dtype=dtype)
        self._mask_cache = {}

    def _mask(self, h: int, w: int, shift: int,
              device: torch.device) -> Optional[torch.Tensor]:
        if shift == 0:
            return None
        key = (h, w, shift, str(device))
        if key not in self._mask_cache:
            self._mask_cache[key] = torch.from_numpy(
                shifted_window_mask(h, w, self.window, shift)
            ).to(device)
        return self._mask_cache[key]

    def fused(self, train: bool) -> bool:
        """Whether this mode runs the fused block (kernel B, or C and D)."""
        return self.use_pallas_block_train if train else self.use_pallas_block

    def forward(
        self,
        x: torch.Tensor,
        win_shape: Optional[Tuple[int, int, int]] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x: [B, H, W, C], or aligned window-major [B*nW, T, C] tokens
        with ``win_shape=(B, H, W)`` (the stage chain); returns the same
        layout."""
        if win_shape is not None:
            b, h, w = win_shape
        else:
            b, h, w, _ = x.shape
        # canonical swin zeroes the shift on a map no larger than the window
        shift = 0 if (h <= self.window and w <= self.window) else self.shift
        mask = self._mask(h, w, shift, x.device)
        if win_shape is not None and not self.fused(train):
            raise ValueError("window-major SwinBlock input requires the "
                             "fused-block path of this mode")
        if self.fused(train):
            return self._fused(x, win_shape, b, h, w, shift, mask, train,
                               generator)

        shortcut = x
        y = self.norm1(x)
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        y = self.attn(window_partition(y, self.window), mask,
                      use_pallas=self.use_pallas and not train)
        y = window_unpartition(y, self.window, h, w)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        if train:
            y = self.drop_path1(y, train, generator)
        x = shortcut + y
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        if train:
            y = self.drop_path2(y, train, generator)
        return x + y

    def _fused(self, x, win_shape, b, h, w, shift, mask, train, generator):
        y = x if win_shape is not None else window_partition(x, self.window)
        grid = dict(nwh=h // self.window, nww=w // self.window, shift=shift)
        a, dt = self.attn, self.dtype
        weights = (
            self.norm1.scale, self.norm1.bias,
            a.qkv_kernel.to(dt), a.qkv_bias,
            a.proj_kernel.to(dt), a.proj_bias,
            a.rel_bias(), mask,
            self.norm2.scale, self.norm2.bias,
            self.mlp_fc1.kernel.to(dt), self.mlp_fc1.bias,
            self.mlp_fc2.kernel.to(dt), self.mlp_fc2.bias,
        )
        if train:
            # per-image factors, drawn as the unfused path draws them,
            # repeated over the image's windows
            per_img = (h // self.window) * (w // self.window)
            dp1 = self.drop_path1.factors(b, train, generator, x.device)
            dp2 = self.drop_path2.factors(b, train, generator, x.device)
            y = fused_swin_block_train(
                y.contiguous(), dp1.repeat_interleave(per_img),
                dp2.repeat_interleave(per_img), *weights,
                num_heads=self.num_heads, **grid)
        else:
            y = fused_swin_block(y.contiguous(), *weights,
                                 num_heads=self.num_heads, **grid)
        if win_shape is not None:
            return y
        return window_unpartition(y, self.window, h, w)


class PatchMerging(nn.Module):
    """Concat 2x2 neighbors -> LN(4C) -> Linear 4C -> 2C (no bias)."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # canonical swin order: (0,0), (1,0), (0,1), (1,1) along channels
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTiny(nn.Module):
    """Swin-Tiny feature extractor: [B, H, W, 3] -> four NHWC stage maps."""

    def __init__(
        self,
        embed_dim: int = 96,
        depths: Tuple[int, ...] = (2, 2, 6, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        window: int = 7,
        patch_size: int = 4,
        in_channels: int = 3,
        img_size: int = 224,
        dtype=torch.bfloat16,
        use_pallas_block: bool = False,
        use_pallas_block_train: bool = False,
        use_rewindow_chain: bool = True,
        drop_path_rate: float = 0.1,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.depths, self.window, self.img_size = tuple(depths), window, img_size
        self.dtype = dtype
        # stages run window-major on the fused path of the mode
        self.chain = use_rewindow_chain and use_pallas_block
        self.train_chain = use_rewindow_chain and use_pallas_block_train
        rates = np.linspace(0.0, drop_path_rate, sum(self.depths))
        self.patch_embed = Conv(in_channels, embed_dim,
                                (patch_size, patch_size), strides=patch_size,
                                dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, dtype)
        dim = embed_dim
        for stage_idx, (depth, heads) in enumerate(zip(depths, num_heads)):
            if stage_idx > 0:
                self.add_module(f"merge{stage_idx}", PatchMerging(dim, dtype))
                dim *= 2
            for d in range(depth):
                self.add_module(f"stage{stage_idx}_block{d}", SwinBlock(
                    dim, heads, window,
                    shift=0 if d % 2 == 0 else window // 2,
                    dtype=dtype, use_pallas_block=use_pallas_block,
                    use_pallas_block_train=use_pallas_block_train,
                    drop_path_rate=float(
                        rates[sum(self.depths[:stage_idx]) + d]),
                    use_pallas=use_pallas,
                ))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        b, h, w, c = x.shape
        if (h, w) != (self.img_size, self.img_size):
            x = resize_bilinear(x.permute(0, 3, 1, 2).float(),
                                (self.img_size, self.img_size))
            x = x.permute(0, 2, 3, 1).to(self.dtype)
        # patch embed: conv k4 s4 (NCHW) + LN over channels-last tokens
        x = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)

        features: List[torch.Tensor] = []
        win = self.window
        chain = self.train_chain if train else self.chain
        for stage_idx, depth in enumerate(self.depths):
            if stage_idx > 0:
                x = getattr(self, f"merge{stage_idx}")(x)
            bb, hh, ww, _ = x.shape
            if chain:
                xw = window_partition(x, win)
            for d in range(depth):
                blk = getattr(self, f"stage{stage_idx}_block{d}")
                if chain:
                    xw = blk(xw, win_shape=(bb, hh, ww), train=train,
                             generator=generator)
                else:
                    x = blk(x, train=train, generator=generator)
            if chain:
                x = window_unpartition(xw, win, hh, ww)
            features.append(x)
        return features
