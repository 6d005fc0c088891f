"""Serving, training and evaluation configuration of the port.

The fields of ``swinvox_tpu.config.Config`` that the serving path, the
training entry point (``train_net``, the train and validation loaders and
transforms, the runner) and the evaluation entry point (``test_net``)
read, under the same names, in the same sections, with the same defaults
(``tests/test_torch_serve.py`` holds them equal), and the JAX
``Config``'s ``set``/``update``/``validate``.  Anything with these
attributes works where a ``Config`` is taken, the JAX package's own
``Config`` included, so one config can drive both packages.

The Pascal3D and Pix3D paths, LR-finder and mesh fields and
``DIR.PROFILE_DIR`` stay in the JAX package until the modules that read
them are ported, as do the flags that pick between XLA formulations of
one function (``USE_BAND2D_MERGER``, ``REFINER_UNROLLED_CONV``,
``TRAIN.FUSED_OPTIMIZER``: the port has one formulation each).
``TRAIN.DEVICE_AUGMENT`` is here so a config can name it, but the device
augmentation is not ported: ``train_net`` refuses it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class ShapeNetPaths:
    TAXONOMY_FILE_PATH: str = "./datasets/ShapeNet.json"
    RENDERING_PATH: str = "./data/ShapeNetRendering/%s/%s/rendering/%02d.png"
    VOXEL_PATH: str = "./data/ShapeNetVox32/%s/%s/model.binvox"


@dataclass
class DatasetsConfig:
    SHAPENET: ShapeNetPaths = field(default_factory=ShapeNetPaths)


@dataclass
class ConstConfig:
    RNG_SEED: int = 0
    IMG_W: int = 224
    IMG_H: int = 224
    BATCH_SIZE: int = 32
    N_VIEWS_RENDERING: int = 1
    CROP_IMG_W: int = 128
    CROP_IMG_H: int = 128
    NUM_WORKER: int = 16
    WEIGHTS: str = ""


@dataclass
class DirConfig:
    OUT_PATH: str = "./output"
    # a folder of background images for the train transform (optional)
    RANDOM_BG_PATH: str = ""


@dataclass
class DatasetConfig:
    MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    TRAIN_DATASET: str = "ShapeNet"
    TEST_DATASET: str = "ShapeNet"


@dataclass
class NetworkConfig:
    LEAKY_VALUE: float = 0.2
    TCONV_USE_BIAS: bool = False
    USE_REFINER: bool = True
    USE_MERGER: bool = True
    USE_SWIN_T_MULTI_STAGE: bool = True
    SWIN_T_STAGES: Tuple[int, ...] = (0, 1, 2, 3)
    USE_CROSS_VIEW_ATTENTION: bool = True
    CROSS_ATT_REDUCTION_RATIO: int = 4
    ATT_SPATIAL_DOWNSAMPLE_RATIO: int = 2
    CROSS_ATT_NUM_HEADS: int = 4
    # "bfloat16" or "float32"; parameters stay float32 either way
    COMPUTE_DTYPE: str = "bfloat16"
    # kernel H (csrc/fused_msa.cu) for W-MSA at inference when the
    # Swin-block kernel is off
    USE_PALLAS_WINDOW_ATTENTION: bool = True
    # kernel I (csrc/merger_stack.cu) for the merger stack at inference
    USE_PALLAS_MERGER: bool = False
    # kernels J and K (csrc/merger_conv.cu) for each merger conv: the
    # banded route in training, the slab route in training and inference
    USE_PALLAS_MERGER_TRAIN: bool = False
    USE_SLAB_MERGER: bool = False
    # kernels E and F (csrc/merger_stack.cu) for the training merger stack
    # when B*N is a multiple of 16 and at most MERGER_STACK_MAX_VOLUMES
    USE_MERGER_STACK: bool = True
    MERGER_STACK_MAX_VOLUMES: int = 64
    MERGER_SINGLE_VIEW_IDENTITY: bool = True
    # kernel L (csrc/down1.cu), the fused backward of the refiner's first
    # conv
    REFINER_DOWN1_PALLAS: bool = False
    # kernel B (csrc/swin_block.cu) for every Swin block
    USE_PALLAS_SWIN_BLOCK: bool = True
    # kernels C and D (csrc/swin_block.cu, csrc/swin_block_train.cu) for
    # every Swin block in training
    USE_PALLAS_SWIN_BLOCK_TRAIN: bool = True
    # kernel A (csrc/rewindow.cu) between window-major blocks
    USE_REWINDOW_CHAIN: bool = True
    SWIN_DEPTHS: Tuple[int, ...] = (2, 2, 6, 2)
    RESNET_STAGE_DEPTHS: Tuple[int, int, int] = (3, 4, 6)
    # "reference" (the original's init, x0.1 convs) or "standard"
    INIT_SCHEME: str = "reference"


@dataclass
class TrainConfig:
    RESUME_TRAIN: bool = False
    NUM_EPOCHS: int = 200
    BRIGHTNESS: float = 0.13746317606570424
    CONTRAST: float = 0.3365401951623921
    SATURATION: float = 0.20370660036548005
    NOISE_STD: float = 0.0850409938037522
    RANDOM_BG_COLOR_RANGE: Tuple[Tuple[int, int], ...] = (
        (225, 255),
        (225, 255),
        (225, 255),
    )
    POLICY: str = "adam"  # 'adam' | 'sgd'
    EPOCH_START_USE_REFINER: int = 0
    EPOCH_START_USE_MERGER: int = 0
    ENCODER_LEARNING_RATE: float = 3.834299021554089e-06
    DECODER_LEARNING_RATE: float = 2.4966084898328403e-05
    REFINER_LEARNING_RATE: float = 1.6418272442716922e-06
    MERGER_LEARNING_RATE: float = 0.00022177181973320365
    ENCODER_LR_MILESTONES: Tuple[int, ...] = (150,)
    DECODER_LR_MILESTONES: Tuple[int, ...] = (150,)
    REFINER_LR_MILESTONES: Tuple[int, ...] = (150,)
    MERGER_LR_MILESTONES: Tuple[int, ...] = (150,)
    BETAS: Tuple[float, float] = (0.8500000000000001, 0.993)
    MOMENTUM: float = 0.9
    GAMMA: float = 0.8830819189779433
    WEIGHT_DECAY: float = 0.0003370779562775397
    SAVE_FREQ: int = 10
    UPDATE_N_VIEWS_RENDERING: bool = False
    GRAD_CLIP_NORM: float = 1.0
    LOG_EVERY: int = 10
    # sequential micro-batches per step, gradients averaged
    GRAD_ACCUM_STEPS: int = 1
    # the JAX package's on-device augmentation: not ported, train_net
    # refuses it
    DEVICE_AUGMENT: bool = False


@dataclass
class TestConfig:
    RANDOM_BG_COLOR_RANGE: Tuple[Tuple[int, int], ...] = (
        (240, 240),
        (240, 240),
        (240, 240),
    )
    VOXEL_THRESH: Tuple[float, ...] = (0.2, 0.3, 0.4, 0.5)
    EVAL_BATCH_SIZE: int = 8


@dataclass
class Config:
    DATASETS: DatasetsConfig = field(default_factory=DatasetsConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    CONST: ConstConfig = field(default_factory=ConstConfig)
    DIR: DirConfig = field(default_factory=DirConfig)
    NETWORK: NetworkConfig = field(default_factory=NetworkConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kwargs)

    def update(self, overrides: dict) -> "Config":
        """Recursively applies a nested dict of overrides in place."""
        _apply_overrides(self, overrides)
        return self

    def set(self, dotted_key: str, value: Any) -> "Config":
        """Sets e.g. ``cfg.set('NETWORK.USE_MERGER', False)``; lists
        become tuples and numbers take the field's type, as in JAX."""
        parts = dotted_key.split(".")
        obj: Any = self
        for p in parts[:-1]:
            obj = getattr(obj, p)
        current = getattr(obj, parts[-1])
        if isinstance(current, tuple) and isinstance(value, (list, tuple)):
            value = tuple(
                tuple(v) if isinstance(v, (list, tuple)) else v for v in value
            )
        elif (current is not None and not isinstance(current, bool)
              and isinstance(current, (int, float))):
            value = type(current)(value)
        setattr(obj, parts[-1], value)
        return self

    def validate(self) -> None:
        """The JAX ``Config.validate`` checks of the fields kept here."""
        if self.TRAIN.POLICY not in ("adam", "sgd"):
            raise ValueError(f"Unknown optimizer policy {self.TRAIN.POLICY!r}")
        stages = tuple(self.NETWORK.SWIN_T_STAGES)
        if stages == (-1,):
            stages = (3,)
            self.NETWORK.SWIN_T_STAGES = stages
        if any(s < 0 or s > 3 for s in stages):
            raise ValueError(f"SWIN_T_STAGES must be within [0,3], got {stages}")
        reduced = 512 // self.NETWORK.CROSS_ATT_REDUCTION_RATIO
        if reduced % self.NETWORK.CROSS_ATT_NUM_HEADS != 0:
            raise ValueError(
                f"cross-view reduced channels ({reduced}) must be divisible "
                f"by num_heads ({self.NETWORK.CROSS_ATT_NUM_HEADS})")
        if self.CONST.N_VIEWS_RENDERING < 1:
            raise ValueError("N_VIEWS_RENDERING must be >= 1")


def _apply_overrides(obj: Any, overrides: dict) -> None:
    for k, v in overrides.items():
        if not hasattr(obj, k):
            raise KeyError(f"Unknown config key: {k} on {type(obj).__name__}")
        current = getattr(obj, k)
        if dataclasses.is_dataclass(current) and isinstance(v, dict):
            _apply_overrides(current, v)
        else:
            if isinstance(current, tuple) and isinstance(v, (list, tuple)):
                v = tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                          for x in v)
            setattr(obj, k, v)


def default_config() -> Config:
    return Config()
