"""The assembled SwinVox model: encoder -> decoder -> merger -> refiner.

Counterpart of ``swinvox_tpu/models/swinvox.py``, at inference and in
training (``train=True``: batch statistics and their running update,
dropout and drop-path masks drawn from the caller's generator);
submodules are named encoder/decoder/merger/refiner as in the flax tree.

  images [B, N, H, W, 3]
    -> encoder  -> [B*N, 256, 7, 7]
    -> decoder  -> raw [B*N, 9, 32^3], coarse logits [B, N, 32^3]
    -> merger (if enabled) weighted fusion, else mean over views
    -> refiner (if enabled) on the merged logits
  returns dict(coarse_volumes, merged_volumes, refined_volumes), all logits.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from swinvox_tpu_torch.config import Config
from swinvox_tpu_torch.models.decoder import Decoder
from swinvox_tpu_torch.models.encoder import Encoder
from swinvox_tpu_torch.models.layers import init_reference_
from swinvox_tpu_torch.models.merger import Merger
from swinvox_tpu_torch.models.refiner import Refiner

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# The routes whose kernels take bf16 tokens only: the Swin block (B; C
# and D), the fused W-MSA (H) and the merger stack (E, F).
BF16_ONLY_ROUTES = {
    "USE_PALLAS_SWIN_BLOCK": "B",
    "USE_PALLAS_SWIN_BLOCK_TRAIN": "C, D",
    "USE_PALLAS_WINDOW_ATTENTION": "H",
    "USE_MERGER_STACK": "E, F",
    "USE_PALLAS_MERGER": "I",
}

log = logging.getLogger(__name__)


class SwinVoxModel(nn.Module):
    """Build with ``SwinVoxModel.from_config(cfg)`` for the config's flags."""

    def __init__(
        self,
        use_swin_multi_stage: bool = True,
        swin_stages: Tuple[int, ...] = (0, 1, 2, 3),
        use_cross_view_attention: bool = True,
        cross_att_num_heads: int = 4,
        cross_att_reduction_ratio: int = 4,
        att_spatial_downsample_ratio: int = 2,
        use_merger: bool = True,
        use_refiner: bool = True,
        leaky_value: float = 0.2,
        tconv_use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        merger_single_view_identity: bool = True,
        use_pallas_swin_block: bool = False,
        use_pallas_swin_block_train: bool = False,
        use_rewindow_chain: bool = True,
        swin_depths: Tuple[int, ...] = (2, 2, 6, 2),
        resnet_stage_depths: Tuple[int, int, int] = (3, 4, 6),
        use_merger_stack: bool = False,
        merger_stack_max_volumes: int = 64,
        use_pallas: bool = False,
        use_pallas_merger: bool = False,
        use_slab_merger: bool = False,
        use_pallas_merger_train: bool = False,
        refiner_down1_pallas: bool = False,
    ):
        super().__init__()
        self.use_merger, self.use_refiner = use_merger, use_refiner
        self.dtype = dtype
        self.encoder = Encoder(
            use_swin_multi_stage=use_swin_multi_stage,
            swin_stages=swin_stages,
            use_cross_view_attention=use_cross_view_attention,
            cross_att_num_heads=cross_att_num_heads,
            cross_att_reduction_ratio=cross_att_reduction_ratio,
            att_spatial_downsample_ratio=att_spatial_downsample_ratio,
            dtype=dtype,
            use_pallas_swin_block=use_pallas_swin_block,
            use_pallas_swin_block_train=use_pallas_swin_block_train,
            use_rewindow_chain=use_rewindow_chain,
            swin_depths=swin_depths,
            resnet_stage_depths=resnet_stage_depths,
            use_pallas=use_pallas,
        )
        self.decoder = Decoder(tconv_use_bias, dtype)
        if use_merger:
            self.merger = Merger(leaky_value, dtype,
                                 merger_single_view_identity,
                                 use_merger_stack, merger_stack_max_volumes,
                                 use_pallas_merger, use_slab_merger,
                                 use_pallas_merger_train)
        if use_refiner:
            self.refiner = Refiner(leaky_value, tconv_use_bias, dtype,
                                   refiner_down1_pallas)

    @classmethod
    def from_config(
        cls, cfg: Config, generator: Optional[torch.Generator] = None
    ) -> "SwinVoxModel":
        """The model ``cfg.NETWORK`` describes, initialized as the JAX
        package initializes it from ``generator`` (default: seeded with
        ``cfg.CONST.RNG_SEED``).

        At ``COMPUTE_DTYPE`` float32 the routes of ``BF16_ONLY_ROUTES``
        resolve to their plain paths (their kernels take bf16 only; the
        wrappers still raise on f32 tokens).  ``model.kernel_routes``
        holds those five flags as resolved."""
        net = cfg.NETWORK
        flags = {f: bool(getattr(net, f)) for f in BF16_ONLY_ROUTES}
        if net.COMPUTE_DTYPE == "float32":
            off = [f for f, on in flags.items() if on]
            if off:
                log.info("float32 compute: %s run their plain paths "
                         "(kernels %s take bfloat16 only)", ", ".join(off),
                         "; ".join(BF16_ONLY_ROUTES[f] for f in off))
            flags = dict.fromkeys(flags, False)
        model = cls(
            use_swin_multi_stage=net.USE_SWIN_T_MULTI_STAGE,
            swin_stages=tuple(net.SWIN_T_STAGES),
            use_cross_view_attention=net.USE_CROSS_VIEW_ATTENTION,
            cross_att_num_heads=net.CROSS_ATT_NUM_HEADS,
            cross_att_reduction_ratio=net.CROSS_ATT_REDUCTION_RATIO,
            att_spatial_downsample_ratio=net.ATT_SPATIAL_DOWNSAMPLE_RATIO,
            use_merger=net.USE_MERGER,
            use_refiner=net.USE_REFINER,
            leaky_value=net.LEAKY_VALUE,
            tconv_use_bias=net.TCONV_USE_BIAS,
            dtype=_DTYPES[net.COMPUTE_DTYPE],
            merger_single_view_identity=net.MERGER_SINGLE_VIEW_IDENTITY,
            use_pallas_swin_block=flags["USE_PALLAS_SWIN_BLOCK"],
            use_pallas_swin_block_train=flags["USE_PALLAS_SWIN_BLOCK_TRAIN"],
            use_rewindow_chain=net.USE_REWINDOW_CHAIN,
            swin_depths=tuple(net.SWIN_DEPTHS),
            resnet_stage_depths=tuple(net.RESNET_STAGE_DEPTHS),
            use_merger_stack=flags["USE_MERGER_STACK"],
            merger_stack_max_volumes=net.MERGER_STACK_MAX_VOLUMES,
            use_pallas=flags["USE_PALLAS_WINDOW_ATTENTION"],
            use_pallas_merger=flags["USE_PALLAS_MERGER"],
            use_slab_merger=net.USE_SLAB_MERGER,
            use_pallas_merger_train=net.USE_PALLAS_MERGER_TRAIN,
            refiner_down1_pallas=net.REFINER_DOWN1_PALLAS,
        )
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.CONST.RNG_SEED)
        init_reference_(model, generator, net.INIT_SCHEME)
        model.kernel_routes = flags
        return model

    def forward(
        self,
        rendering_images: torch.Tensor,
        train: bool = False,
        enable_merger: bool = True,
        enable_refiner: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """``enable_merger`` / ``enable_refiner`` are the epoch gates of
        training (a gated merger is replaced by the mean over views, a
        gated refiner by the identity); ``generator`` draws the dropout
        and drop-path masks when ``train``."""
        n_views = rendering_images.shape[1]
        features = self.encoder(rendering_images, train, generator)
        raw_features, coarse = self.decoder(features, n_views, train)
        if self.use_merger and enable_merger:
            merged = self.merger(raw_features, coarse, train)
        else:
            merged = coarse.float().mean(1).to(self.dtype)
        if self.use_refiner and enable_refiner:
            refined = self.refiner(merged, train)
        else:
            refined = merged
        return {
            "coarse_volumes": coarse,
            "merged_volumes": merged,
            "refined_volumes": refined,
        }
