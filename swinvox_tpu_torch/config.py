"""Serving, training and evaluation configuration of the port.

Every field of ``swinvox_tpu.config.Config``, under the same names, in the
same sections, with the same defaults (``tests/test_torch_serve.py``
holds them equal), and the JAX ``Config``'s ``set``/``update``/
``validate``/``from_dict``/``from_json``.  So the ``config.json`` that
the JAX ``train_net`` writes beside every run loads here
(``runner --config``), and anything with these attributes works where a
``Config`` is taken, the JAX package's own ``Config`` included.

Fields the port reads but whose value changes nothing: the flags that
only pick between XLA formulations of one function
(``NETWORK.USE_BAND2D_MERGER``, ``NETWORK.REFINER_UNROLLED_CONV``,
``TRAIN.FUSED_OPTIMIZER``, ``NETWORK.PALLAS_INTERPRET``) are accepted
whatever their value, because the port computes the same function either
way; ``CONST.DEVICE`` is read by neither package.  Fields that name a
feature the port lacks are refused, when not at their default, where
that feature would be used: ``CONST.DEVICE_SELECT`` and ``PARALLEL.*``
beyond one device by ``train_net`` and ``test_net``.

``resolve_data_path`` finds the default split files
(``./datasets/*.json``) in the repository's own ``datasets/`` folder
when the process runs elsewhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Tuple

_DATASETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "datasets")


def resolve_data_path(path: str) -> str:
    """``path`` when it exists, else the same-named file of the
    repository's ``datasets/`` when there is one (the default taxonomy
    paths are relative to the working directory), else ``path``."""
    if os.path.exists(path):
        return path
    fallback = os.path.join(_DATASETS_DIR, os.path.basename(path))
    return fallback if os.path.isfile(fallback) else path


@dataclass
class ShapeNetPaths:
    TAXONOMY_FILE_PATH: str = "./datasets/ShapeNet.json"
    RENDERING_PATH: str = "./data/ShapeNetRendering/%s/%s/rendering/%02d.png"
    VOXEL_PATH: str = "./data/ShapeNetVox32/%s/%s/model.binvox"


@dataclass
class Pascal3DPaths:
    TAXONOMY_FILE_PATH: str = "./datasets/Pascal3D.json"
    ANNOTATION_PATH: str = "./data/PASCAL3D/Annotations/%s_imagenet/%s.mat"
    RENDERING_PATH: str = "./data/PASCAL3D/Images/%s_imagenet/%s.JPEG"
    VOXEL_PATH: str = "./data/PASCAL3D/CAD/%s/%02d.binvox"


@dataclass
class Pix3DPaths:
    TAXONOMY_FILE_PATH: str = "./datasets/Pix3D.json"
    ANNOTATION_PATH: str = "./data/pix3d.json"
    RENDERING_PATH: str = "./data/pix3d/img/%s/%s.%s"
    VOXEL_PATH: str = "./data/pix3d/model/%s/%s/%s.binvox"


@dataclass
class DatasetsConfig:
    SHAPENET: ShapeNetPaths = field(default_factory=ShapeNetPaths)
    PASCAL3D: Pascal3DPaths = field(default_factory=Pascal3DPaths)
    PIX3D: Pix3DPaths = field(default_factory=Pix3DPaths)


@dataclass
class ConstConfig:
    DEVICE: str = "0"
    # the JAX runner's --gpu device list; the port runs on one device
    DEVICE_SELECT: str = ""
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
    # train_net traces batches 2-6 of its first epoch here (--profile)
    PROFILE_DIR: str = ""


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
    # kernel H (csrc/swin_block.cu) for W-MSA at inference when the
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
    # the JAX package's XLA reformulations of the merger convs and the
    # refiner's first conv, and its Pallas interpreter switch: accepted
    # whatever their value (the port computes the same function)
    USE_BAND2D_MERGER: bool = False
    REFINER_UNROLLED_CONV: bool = False
    PALLAS_INTERPRET: bool = False
    # a directory of pretrained backbone weights (resnet50.{npz,pth,pt},
    # swin_tiny.*) that create_train_state grafts onto the encoder
    PRETRAINED_BACKBONE: str = ""
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
    # the train and eval augmentation on the card from raw pixels
    # (data/device_augment.py)
    DEVICE_AUGMENT: bool = False
    # optax's fused Adam in JAX: the same update, accepted either way
    FUSED_OPTIMIZER: bool = False


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
class LRFinderConfig:
    START_LR: float = 1e-7
    END_LR: float = 1e-2
    NUM_BATCHES_TO_TEST: int = 1000
    AVG_BETA: float = 0.98


@dataclass
class ParallelConfig:
    # the JAX mesh: the port runs on one device, so train_net and test_net
    # refuse more than one
    DATA_PARALLEL: int = -1
    MODEL_PARALLEL: int = 1
    MESH_AXIS_NAMES: Tuple[str, str] = ("data", "model")
    DISTRIBUTED: bool = False


@dataclass
class Config:
    DATASETS: DatasetsConfig = field(default_factory=DatasetsConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    CONST: ConstConfig = field(default_factory=ConstConfig)
    DIR: DirConfig = field(default_factory=DirConfig)
    NETWORK: NetworkConfig = field(default_factory=NetworkConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    LR_FINDER: LRFinderConfig = field(default_factory=LRFinderConfig)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """The defaults with ``d``'s nested overrides applied."""
        return cls().update(d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        """``from_dict`` of a JSON string, e.g. a run's ``config.json``."""
        return cls.from_dict(json.loads(s))

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


def require_one_device(cfg) -> None:
    """Refuses ``CONST.DEVICE_SELECT`` and ``PARALLEL.*`` asking for more
    than the one device the port runs on (the JAX mesh is not ported)."""
    par = cfg.PARALLEL
    if (cfg.CONST.DEVICE_SELECT or par.DATA_PARALLEL not in (-1, 1)
            or par.MODEL_PARALLEL != 1 or par.DISTRIBUTED):
        raise NotImplementedError(
            "CONST.DEVICE_SELECT / PARALLEL: the port runs on one device; "
            f"got DEVICE_SELECT={cfg.CONST.DEVICE_SELECT!r}, "
            f"DATA_PARALLEL={par.DATA_PARALLEL}, "
            f"MODEL_PARALLEL={par.MODEL_PARALLEL}, "
            f"DISTRIBUTED={par.DISTRIBUTED}")


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
