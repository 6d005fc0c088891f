"""The whole serving slice: swinvox_tpu_torch's SwinVoxModel against the
JAX package's on identical weights, at nano depths (SWIN_DEPTHS=(1,1,1,1),
RESNET_STAGE_DEPTHS=(1,1,1)), full widths, f32, 224^2, batch 1, at one
view (merger identity, CVA skip) and at three (merger and CVA in full).

The JAX side runs its plain XLA path (no TPU here; the kernel path's parity
with it is pinned in tests/test_pallas.py); the port runs its kernel path
(USE_PALLAS_SWIN_BLOCK + USE_REWINDOW_CHAIN, the plain versions on the
CPU).  Every parameter and BatchNorm statistic is drawn with numpy from a
seed at fan-in scale, so no layer is an identity.  Target: sigmoid
probabilities within atol 1e-4 (the repo's reference-parity tolerance);
the logits are held to the same bound.

The JAX model is only shape-traced (jax.eval_shape), never initialized,
to keep the file cheap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu.config import default_config
from swinvox_tpu_torch.convert import load_jax_variables, torch_name


def nano_config():
    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    return cfg


def random_variables(shapes, seed=0):
    """numpy weights for a flax variables tree at fan-in scale; BatchNorm
    stats and every affine/bias jittered away from their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if "['batch_stats']" in name and "['var']" in name:
            return (1 + 0.2 * rng.random(shape)).astype(np.float32)
        if "['mean']" in name:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "['scale']" in name:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) < 2 or "rel_pos_bias_table" in name:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = float(np.prod(shape[:-1]))
        if "tconv" in name:  # input-dilated by the stride
            fan_in /= 4
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def models():
    from swinvox_tpu.models.swinvox import SwinVoxModel as JaxModel
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg = nano_config()
    jm = JaxModel.from_config(cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 224, 224, 3)), train=False))
    variables = random_variables(shapes)
    port = SwinVoxModel.from_config(cfg)
    load_jax_variables(port, variables)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    return cfg, fwd, variables, port


@pytest.mark.parametrize("n_views", [1, 3])
def test_slice_parity(models, n_views):
    _, fwd, variables, port = models
    x = np.random.default_rng(10 + n_views).standard_normal(
        (1, n_views, 224, 224, 3)).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in fwd(variables, jnp.asarray(x)).items()}
    with torch.no_grad():
        got = {k: v.numpy() for k, v in port(torch.from_numpy(x)).items()}
    assert got["coarse_volumes"].shape == (1, n_views, 32, 32, 32)
    for key in ("coarse_volumes", "merged_volumes", "refined_volumes"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], atol=1e-4, rtol=0,
                                   err_msg=key)
    # the comparison has something to compare: the volumes vary
    assert ref["refined_volumes"].std() > 1e-2
    p_ref = 1 / (1 + np.exp(-ref["refined_volumes"]))
    p_got = torch.sigmoid(torch.from_numpy(got["refined_volumes"])).numpy()
    np.testing.assert_allclose(p_got, p_ref, atol=1e-4, rtol=0)


def test_bridge_covers_every_leaf(models):
    """Every flax leaf lands on exactly one port tensor and every port
    tensor gets one; a leaf missing or left over raises."""
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg, _, variables, port = models
    flax_names = {
        torch_name(tuple(getattr(k, "key", k) for k in path[1:]))
        for path, _ in jax.tree_util.tree_flatten_with_path(variables)[0]
    }
    assert flax_names == set(port.state_dict())
    assert "encoder.swin.stage0_block0.attn.qkv_kernel" in flax_names

    fresh = SwinVoxModel.from_config(cfg)
    missing = jax.tree.map(lambda a: a, variables)
    del missing["params"]["refiner"]["fc1"]
    with pytest.raises(ValueError, match="without a flax leaf"):
        load_jax_variables(fresh, missing)
    extra = jax.tree.map(lambda a: a, variables)
    extra["batch_stats"]["decoder"]["bn9"] = {"bn": {"mean": np.zeros(8)}}
    with pytest.raises(ValueError, match="without a port tensor"):
        load_jax_variables(fresh, extra)
    bad = jax.tree.map(lambda a: a, variables)
    bad["params"]["decoder"]["tconv5"]["kernel"] = np.zeros((1, 1, 1, 8, 2))
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_variables(fresh, bad)


def test_from_config_flags(models):
    """The flags gate the kernel paths as in JAX: the Swin-block kernel,
    the rewindow chain, the W-MSA kernel (USE_PALLAS_WINDOW_ATTENTION,
    reached without the block kernel), the inference merger kernel, and
    the training routes of kernels J, K (the slab and banded merger
    convs) and L (the refiner's down1 backward).  At bfloat16: at
    float32 from_config resolves the bf16-only routes to the plain path
    (tests/test_torch_repairs.py)."""
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg = nano_config()
    cfg.NETWORK.COMPUTE_DTYPE = "bfloat16"
    m = SwinVoxModel.from_config(cfg)
    assert m.encoder.swin.chain
    blk = m.encoder.swin.stage0_block0
    assert blk.use_pallas_block and blk.use_pallas
    assert not m.merger.use_pallas
    cfg.NETWORK.USE_REWINDOW_CHAIN = False
    assert not SwinVoxModel.from_config(cfg).encoder.swin.chain
    cfg.NETWORK.USE_PALLAS_SWIN_BLOCK = False
    wmsa = SwinVoxModel.from_config(cfg).encoder.swin.stage0_block0
    assert not wmsa.use_pallas_block and wmsa.use_pallas
    cfg.NETWORK.USE_PALLAS_WINDOW_ATTENTION = False
    plain = SwinVoxModel.from_config(cfg)
    assert not plain.encoder.swin.stage0_block0.use_pallas_block
    assert not plain.encoder.swin.stage0_block0.use_pallas
    cfg.NETWORK.USE_PALLAS_MERGER = True
    assert SwinVoxModel.from_config(cfg).merger.use_pallas
    for flag, owner, attr in (
            ("USE_PALLAS_MERGER_TRAIN", "merger", "use_pallas_train"),
            ("USE_SLAB_MERGER", "merger", "use_slab"),
            ("REFINER_DOWN1_PALLAS", "refiner", "down1_pallas")):
        assert not getattr(getattr(plain, owner), attr)
        setattr(cfg.NETWORK, flag, True)
        assert getattr(getattr(SwinVoxModel.from_config(cfg), owner), attr)
        setattr(cfg.NETWORK, flag, False)


def test_unfused_path_matches_kernel_path(models):
    """USE_PALLAS_SWIN_BLOCK off (plain LN / WindowMSA / MLP modules) gives
    the kernel path's result on the same weights, f32, atol 1e-5.
    from_config resolves f32 to the plain modules, so the fused chain (kernel
    B's plain version on the CPU) is switched on here by hand."""
    from swinvox_tpu_torch.models.swin import SwinBlock
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg, _, variables, _ = models
    cfg = nano_config()
    port = SwinVoxModel.from_config(cfg)
    load_jax_variables(port, variables)
    port.encoder.swin.chain = True
    for blk in port.modules():
        if isinstance(blk, SwinBlock):
            blk.use_pallas_block = True
    cfg.NETWORK.USE_PALLAS_SWIN_BLOCK = False
    cfg.NETWORK.USE_PALLAS_WINDOW_ATTENTION = False
    plain = SwinVoxModel.from_config(cfg)
    load_jax_variables(plain, variables)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        a = port(x)["refined_volumes"]
        b = plain(x)["refined_volumes"]
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
