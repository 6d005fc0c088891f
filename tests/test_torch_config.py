"""The port's config against the JAX package's files, on the CPU: a
``config.json`` that the JAX package writes (``Config.to_json``, as its
``train_net`` writes one beside every run) loads through the port's
``runner --config`` and ``Config.from_json`` with every field equal, the
flags that only pick an XLA formulation are accepted, and the fields
that ask for more than the port's one device are refused where they
would be used."""

import json

import pytest
import torch

from swinvox_tpu.config import Config as JaxConfig
from swinvox_tpu_torch.cli import runner
from swinvox_tpu_torch.config import Config, default_config

NON_DEFAULT = {
    "TRAIN": {"NUM_EPOCHS": 7, "BETAS": [0.9, 0.999],
              "FUSED_OPTIMIZER": True, "SAVE_FREQ": 3},
    "NETWORK": {"USE_MERGER": False, "SWIN_DEPTHS": [1, 1, 1, 1],
                "USE_BAND2D_MERGER": True, "REFINER_UNROLLED_CONV": True,
                "PALLAS_INTERPRET": True},
    "DATASETS": {"PIX3D": {"ANNOTATION_PATH": "/data/pix3d.json"}},
    "LR_FINDER": {"END_LR": 0.5},
    "CONST": {"DEVICE": "3"},
    "TEST": {"VOXEL_THRESH": [0.3, 0.5]},
}


@pytest.mark.parametrize("overrides", [{}, NON_DEFAULT],
                         ids=["jax-defaults", "non-default"])
def test_jax_config_json_loads_in_the_port(tmp_path, overrides):
    """Every field of the JAX file comes back equal through both doors."""
    jax_cfg = JaxConfig.from_dict(overrides)
    path = tmp_path / "config.json"
    path.write_text(jax_cfg.to_json())
    want = jax_cfg.to_dict()

    from_runner = runner.build_config(
        runner.get_args_from_command_line(["--config", str(path)]))
    from_json = Config.from_json(path.read_text())
    for cfg in (from_runner, from_json):
        assert cfg.to_dict() == want
    # and back: the port's file is the JAX file
    assert json.loads(from_json.to_json()) == json.loads(jax_cfg.to_json())


def test_unknown_key_still_raises():
    with pytest.raises(KeyError, match="NOT_A_FIELD"):
        Config.from_dict({"NETWORK": {"NOT_A_FIELD": 1}})


def _nano():
    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    return cfg


def test_formulation_flags_are_accepted():
    """The XLA-formulation flags build the same model as their defaults."""
    from swinvox_tpu_torch.train.state import create_train_state

    base, _ = create_train_state(_nano(), torch.Generator().manual_seed(1),
                                 device="cpu")
    cfg = _nano()
    cfg.update({"NETWORK": {"USE_BAND2D_MERGER": True,
                            "REFINER_UNROLLED_CONV": True,
                            "PALLAS_INTERPRET": True},
                "TRAIN": {"FUSED_OPTIMIZER": True}})
    flagged, _ = create_train_state(cfg, torch.Generator().manual_seed(1),
                                    device="cpu")
    a, b = base.model.state_dict(), flagged.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("key,value", [
    ("CONST.DEVICE_SELECT", "0,1"),
    ("PARALLEL.DATA_PARALLEL", 4),
    ("PARALLEL.MODEL_PARALLEL", 2),
    ("PARALLEL.DISTRIBUTED", True),
])
def test_train_net_refuses_unported_features(key, value):
    from swinvox_tpu_torch.train.trainer import train_net

    cfg = _nano().set(key, value)
    with pytest.raises(NotImplementedError, match=key.split(".")[0]):
        train_net(cfg, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("CONST.DEVICE_SELECT", "1"),
    ("PARALLEL.DATA_PARALLEL", 2),
])
def test_test_net_refuses_more_than_one_device(key, value):
    from swinvox_tpu_torch.train.trainer import test_net

    cfg = _nano().set(key, value)
    with pytest.raises(NotImplementedError, match="one device"):
        test_net(cfg, device="cpu")
