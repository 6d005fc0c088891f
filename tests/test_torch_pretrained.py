"""The port's pretrained-weight graft (``models/pretrained.py`` and
``NETWORK.PRETRAINED_BACKBONE`` in ``create_train_state``) against the
JAX package's, on the CPU, on fake state dicts of the real shapes
(torchvision ResNet-50 and timm Swin-Tiny names, ``tests/test_pretrained.py``'s
generators; no weights are downloaded):

  * the port's graft onto a full-depth encoder equals the JAX graft of the
    same dicts onto the same weights (``convert.jax_variables`` out,
    ``load_jax_variables`` back), exactly, every tensor; each grafted
    tensor equals its source (transposed for linears);
  * a shape that does not fit raises ValueError, and a depth the dicts do
    not cover KeyError, in both packages, with the model left as it was;
  * ``convert_reference_{decoder,merger,refiner,cross_view}`` equal the
    JAX converters carried across by ``convert.py``, exactly;
  * ``create_train_state`` grafts ``resnet50.npz`` and ``swin_tiny.pth``
    from a ``NETWORK.PRETRAINED_BACKBONE`` directory.
"""

import copy

import numpy as np
import pytest
import torch
from test_pretrained import fake_resnet50_state_dict, fake_swin_tiny_state_dict

from swinvox_tpu_torch.convert import jax_variables, load_jax_variables


@pytest.fixture(scope="module")
def model():
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg = default_config()
    cfg.NETWORK.INIT_SCHEME = "standard"
    return SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def dicts():
    rng = np.random.default_rng(0)
    return fake_resnet50_state_dict(rng), fake_swin_tiny_state_dict(rng)


def _jax_graft(encoder, resnet_sd, swin_sd):
    """The JAX graft of the dicts onto ``encoder``'s weights, carried back
    into a copy of ``encoder``."""
    from swinvox_tpu.models.pretrained import apply_pretrained_backbone

    tree = jax_variables(encoder)
    params, stats = apply_pretrained_backbone(
        {"encoder": tree["params"]}, {"encoder": tree["batch_stats"]},
        resnet_sd=resnet_sd, swin_sd=swin_sd)
    out = copy.deepcopy(encoder)
    load_jax_variables(out, {"params": params["encoder"],
                             "batch_stats": stats["encoder"]})
    return out


def test_graft_matches_jax(model, dicts):
    from swinvox_tpu_torch.models.pretrained import apply_pretrained_backbone

    resnet_sd, swin_sd = dicts
    want = _jax_graft(model.encoder, resnet_sd, swin_sd).state_dict()
    ours = copy.deepcopy(model)
    before = {k: v.clone() for k, v in ours.encoder.state_dict().items()}
    apply_pretrained_backbone(ours, resnet_sd=resnet_sd, swin_sd=swin_sd)
    got = ours.encoder.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert sum(k.startswith(("resnet.", "swin.")) for k in changed) > 300
    assert not [k for k in changed if not k.startswith(("resnet.", "swin."))]
    enc = ours.encoder
    np.testing.assert_array_equal(enc.resnet.conv1.kernel.detach().numpy(),
                                  resnet_sd["conv1.weight"])
    np.testing.assert_array_equal(
        enc.resnet.layer3_block5.bn2.var.detach().numpy(),
        resnet_sd["layer3.5.bn2.running_var"])
    np.testing.assert_array_equal(
        enc.swin.stage2_block5.attn.qkv_kernel.detach().numpy(),
        swin_sd["layers.2.blocks.5.attn.qkv.weight"].T)
    np.testing.assert_array_equal(
        enc.swin.merge3.reduction.kernel.detach().numpy(),
        swin_sd["layers.3.downsample.reduction.weight"].T)


def test_graft_refuses_what_does_not_fit(model, dicts):
    from swinvox_tpu.models.pretrained import (
        apply_pretrained_backbone as jax_graft,
    )

    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.models.pretrained import apply_pretrained_backbone
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    resnet_sd, swin_sd = dicts
    bad = dict(resnet_sd)
    bad["layer2.0.conv2.weight"] = bad["layer2.0.conv2.weight"][:, :, :2]
    ours = copy.deepcopy(model)
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        apply_pretrained_backbone(ours, resnet_sd=bad)
    assert all(torch.equal(v, before[k])
               for k, v in ours.state_dict().items())
    tree = jax_variables(model.encoder)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_graft({"encoder": tree["params"]},
                  {"encoder": tree["batch_stats"]}, resnet_sd=bad)
    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    nano = SwinVoxModel.from_config(cfg)
    with pytest.raises(KeyError):
        apply_pretrained_backbone(nano, swin_sd=swin_sd)
    tree = jax_variables(nano.encoder)
    with pytest.raises(KeyError):
        jax_graft({"encoder": tree["params"]},
                  {"encoder": tree["batch_stats"]}, swin_sd=swin_sd)


def _bn_names(dst, src):
    return {f"{dst}.scale": f"{src}.weight", f"{dst}.bias": f"{src}.bias",
            f"{dst}.mean": f"{src}.running_mean",
            f"{dst}.var": f"{src}.running_var"}


def _reference_names(part, module):
    """port name -> the reference checkpoint's name, for every tensor of
    the port module ``part``."""
    names = {}
    for name in module.state_dict():
        owner, leaf = name.rsplit(".", 1)
        if part == "cross_view":
            src = {"ffn_fc1": "ffn.0", "ffn_fc2": "ffn.2"}.get(owner, owner)
            if owner == "batch_norm":
                names.update(_bn_names(owner, "batch_norm"))
            else:
                kind = "weight" if leaf == "kernel" else "bias"
                names[name] = f"{src}.{kind}"
            continue
        layer = {"decoder": lambda o: int(o[-1]),
                 "merger": lambda o: int(o[-1]),
                 "refiner": lambda o: {"down1": 1, "down2": 2, "down3": 3,
                                       "fc1": 4, "fc2": 5, "up1": 6,
                                       "up2": 7, "up3": 8}[o.split("_")[0]]
                 }[part](owner)
        if owner.startswith("bn") or owner.endswith("_bn"):
            names.update(_bn_names(owner, f"layer{layer}.1"))
        else:
            names[name] = (f"layer{layer}.0."
                           f"{'weight' if leaf == 'kernel' else 'bias'}")
    return names


@pytest.mark.parametrize("part", ["decoder", "merger", "refiner",
                                  "cross_view"])
def test_reference_converters_match_jax(model, part):
    from swinvox_tpu.models import pretrained as jax_pretrained

    from swinvox_tpu_torch.models import pretrained

    module = (model.encoder.cross_view_attention if part == "cross_view"
              else getattr(model, part))
    rng = np.random.default_rng(1)
    sd = {}
    for port_name, ref_name in _reference_names(part, module).items():
        shape = tuple(module.state_dict()[port_name].shape)
        if part == "refiner" and ref_name in ("layer4.0.weight",
                                              "layer5.0.weight"):
            shape = shape[::-1]  # the reference's [out, in]
        sd[ref_name] = rng.standard_normal(shape).astype(np.float32)
    params, stats = getattr(jax_pretrained, f"convert_reference_{part}")(sd)
    want = copy.deepcopy(module)
    load_jax_variables(want, {"params": params, "batch_stats": stats})
    got = copy.deepcopy(module)
    converted = getattr(pretrained, f"convert_reference_{part}")(sd)
    assert set(converted) == set(got.state_dict())
    pretrained.graft(got, converted, part)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want.state_dict()[k]), k


def test_create_train_state_grafts_the_backbone(tmp_path, dicts):
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.train.state import create_train_state

    resnet_sd, swin_sd = dicts
    np.savez(tmp_path / "resnet50.npz", **resnet_sd)
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in swin_sd.items()}},
               tmp_path / "swin_tiny.pth")
    cfg = default_config()
    cfg.NETWORK.PRETRAINED_BACKBONE = str(tmp_path)
    state, _ = create_train_state(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    enc = state.model.encoder
    np.testing.assert_array_equal(
        enc.resnet.layer1_block0.downsample_bn.mean.detach().numpy(),
        resnet_sd["layer1.0.downsample.1.running_mean"])
    np.testing.assert_array_equal(
        enc.swin.stage3_block1.mlp_fc2.kernel.detach().numpy(),
        swin_sd["layers.3.blocks.1.mlp.fc2.weight"].T)
    mu = state.opt_states["encoder"]["mu"]
    assert all(not t.any() for t in mu.values())
