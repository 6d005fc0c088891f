"""Serving and training configuration of the port.

The fields of ``swinvox_tpu.config.Config`` that the serving path and the
training step read, under the same names, in the same sections, with the
same defaults (``tests/test_torch_serve.py`` holds them equal).  Anything
with these attributes works where a ``Config`` is taken, the JAX
package's own ``Config`` included, so one config can drive both packages.

Data-set, directory, LR-finder and mesh fields stay in the JAX package
until the modules that read them are ported, as do the flags that pick
between XLA formulations of one function (``USE_BAND2D_MERGER``,
``REFINER_UNROLLED_CONV``, ``TRAIN.FUSED_OPTIMIZER``: the port has one
formulation each) and ``TRAIN.DEVICE_AUGMENT``, which the data pipeline
reads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class ConstConfig:
    RNG_SEED: int = 0
    IMG_W: int = 224
    IMG_H: int = 224
    BATCH_SIZE: int = 32
    N_VIEWS_RENDERING: int = 1
    CROP_IMG_W: int = 128
    CROP_IMG_H: int = 128


@dataclass
class DatasetConfig:
    MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)


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
    # selects the fused W-MSA kernel (not ported) when the Swin-block
    # kernel is off; from_config refuses that combination
    USE_PALLAS_WINDOW_ATTENTION: bool = True
    # fused merger kernel at inference (not ported; from_config refuses it)
    USE_PALLAS_MERGER: bool = False
    # training-path merger kernels of the JAX package not ported yet
    # (banded and slab convs); from_config refuses them
    USE_PALLAS_MERGER_TRAIN: bool = False
    USE_SLAB_MERGER: bool = False
    # kernels E and F (csrc/merger_stack.cu) for the training merger stack
    # when B*N is a multiple of 16 and at most MERGER_STACK_MAX_VOLUMES
    USE_MERGER_STACK: bool = True
    MERGER_STACK_MAX_VOLUMES: int = 64
    MERGER_SINGLE_VIEW_IDENTITY: bool = True
    # the fused backward of that conv (not ported; from_config refuses it)
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


@dataclass
class TestConfig:
    RANDOM_BG_COLOR_RANGE: Tuple[Tuple[int, int], ...] = (
        (240, 240),
        (240, 240),
        (240, 240),
    )


@dataclass
class Config:
    CONST: ConstConfig = field(default_factory=ConstConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    NETWORK: NetworkConfig = field(default_factory=NetworkConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_config() -> Config:
    return Config()
