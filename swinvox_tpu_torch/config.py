"""Serving configuration of the port.

The fields of ``swinvox_tpu.config.Config`` that the serving path reads,
under the same names, in the same sections, with the same defaults
(``tests/test_torch_serve.py`` holds them equal).  Anything with these
attributes works where a ``Config`` is taken, the JAX package's own
``Config`` included, so one config can drive both packages.

Training, data-set, mesh and TPU-only fields stay in the JAX package
until the modules that read them are ported.
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
    MERGER_SINGLE_VIEW_IDENTITY: bool = True
    # kernel B (csrc/swin_block.cu) for every Swin block
    USE_PALLAS_SWIN_BLOCK: bool = True
    # kernel A (csrc/rewindow.cu) between window-major blocks
    USE_REWINDOW_CHAIN: bool = True
    SWIN_DEPTHS: Tuple[int, ...] = (2, 2, 6, 2)
    RESNET_STAGE_DEPTHS: Tuple[int, int, int] = (3, 4, 6)
    # "reference" (the original's init, x0.1 convs) or "standard"
    INIT_SCHEME: str = "reference"


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
    TEST: TestConfig = field(default_factory=TestConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_config() -> Config:
    return Config()
