"""The training entry point's host side and checkpoints in
swinvox_tpu_torch against the JAX package, on the CPU:

  * the train and validation loaders against the JAX loaders' numpy path
    (its optional C codecs off), bit for bit, over two epochs: view
    choice, shuffle order, ``DIR.RANDOM_BG_PATH`` backgrounds and the
    whole train transform; and the loader's threads end when an
    iteration is closed, abandoned or the loader is closed;
  * ``SwinVoxModel.from_config`` with the kernel flags of the training
    routes;
  * full checkpoints both ways at nano depths (SWIN_DEPTHS (1,1,1,1),
    RESNET_STAGE_DEPTHS (1,1,1)), f32, 224^2, 1 view: a JAX file resumed
    by the port and a port file restored by the JAX ``load_checkpoint``
    (every leaf exactly, the optimizer states and step included), each
    followed by one step held against the other package's step with the
    tolerances of tests/test_torch_train_step.py (shared setup in
    tests/_torch_train_common.py); and ``export_params_only``.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch
from _torch_train_common import (batch, compare, compile_jax, jax_setup,
                                 port_state)
from PIL import Image

from swinvox_tpu_torch.convert import tree_to_torch

CATEGORIES = [("02691156", "aeroplane"), ("03001627", "chair")]


# -------------------------------------------------------------- loaders


@pytest.fixture(scope="module")
def fixture_cfgs(tmp_path_factory):
    """A 2-category fixture (3 train, 1 val sample each, 4 views), two
    background images, and the port's and the JAX package's configs on
    them: 2 of 4 views, batch 2."""
    from swinvox_tpu.config import default_config as jax_default

    from swinvox_tpu_torch.data.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("train_data")
    cfg = generate_dataset(str(root), (3, 1, 0), 4, CATEGORIES)
    bg = root / "backgrounds"
    bg.mkdir()
    rng = np.random.default_rng(5)
    for i, size in enumerate(((180, 240), (97, 131))):
        Image.fromarray(rng.integers(0, 256, size + (3,), np.uint8),
                        "RGB").save(bg / f"bg{i}.png")
    jcfg = jax_default()
    for c in (cfg, jcfg):
        s = c.DATASETS.SHAPENET
        s.TAXONOMY_FILE_PATH = cfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH
        s.RENDERING_PATH = cfg.DATASETS.SHAPENET.RENDERING_PATH
        s.VOXEL_PATH = cfg.DATASETS.SHAPENET.VOXEL_PATH
        c.DIR.RANDOM_BG_PATH = str(bg)
        c.CONST.N_VIEWS_RENDERING = 2
        c.CONST.BATCH_SIZE = 2
        c.CONST.NUM_WORKER = 2
    return cfg, jcfg


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "BatchLoader"]


def test_train_loader_matches_jax_bit_for_bit(fixture_cfgs, monkeypatch):
    """Two epochs of the train split (seeded shuffle, last partial batch
    dropped, 2 of 4 views drawn per sample, background images, the train
    transform) and the validation split equal the JAX loaders' numpy
    path exactly."""
    from swinvox_tpu.data.pipeline import build_loader as jax_loader
    from swinvox_tpu.data.taxonomy import DatasetType as JaxSplit
    from swinvox_tpu.native import runtime

    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import DatasetType

    monkeypatch.setattr(runtime, "decode_image_native", lambda data: None)
    monkeypatch.setattr(runtime, "resize_bilinear_native", lambda *a: None)
    cfg, jcfg = fixture_cfgs
    ours = build_loader(cfg, DatasetType.TRAIN)
    ref = jax_loader(jcfg, JaxSplit.TRAIN)
    assert len(ours) == len(ref) == 3  # 6 samples, batch 2
    orders = []
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.sample_names == b.sample_names
            assert a.taxonomy_ids == b.taxonomy_ids
            assert a.images.shape == (2, 2, 224, 224, 3)
            assert a.images.dtype == b.images.dtype == np.float32
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.volumes, b.volumes)
        orders.append([n for a in got for n in a.sample_names])
    assert orders[0] != orders[1]  # reshuffled by epoch
    val = list(build_loader(cfg, DatasetType.VAL))
    jval = list(jax_loader(jcfg, JaxSplit.VAL))
    assert len(val) == len(jval) == 2
    for a, b in zip(val, jval):
        assert a.sample_names == b.sample_names
        np.testing.assert_array_equal(a.images, b.images)
    ours.close()
    assert not _loader_threads()


def test_loader_threads_end(fixture_cfgs):
    """An iteration's producer thread ends when the iterator is closed
    early, when it is dropped, and when the loader is closed."""
    import gc

    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import DatasetType

    cfg, _ = fixture_cfgs
    loader = build_loader(cfg, DatasetType.TRAIN)

    def wait_gone():
        for t in _loader_threads():
            t.join(timeout=30)
        assert not _loader_threads()

    it = iter(loader)
    next(it)
    it.close()
    wait_gone()
    it = iter(loader)
    next(it)
    del it
    gc.collect()
    wait_gone()
    it = iter(loader)
    next(it)
    loader.close()
    assert not _loader_threads()


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("flag", ["USE_SLAB_MERGER",
                                  "USE_PALLAS_MERGER_TRAIN",
                                  "REFINER_DOWN1_PALLAS"])
def test_from_config_takes_the_training_kernel_flags(flag):
    """The three flags build the model with their routes (no longer
    refused)."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    cfg = default_config()
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    setattr(cfg.NETWORK, flag, True)
    model = SwinVoxModel.from_config(cfg)
    assert model.merger.use_slab == (flag == "USE_SLAB_MERGER")
    assert model.merger.use_pallas_train == (
        flag == "USE_PALLAS_MERGER_TRAIN")
    assert model.refiner.down1_pallas == (flag == "REFINER_DOWN1_PALLAS")


# ---------------------------------------------------------- checkpoints


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    from flax import serialization

    la = dict(_leaves(serialization.to_state_dict(jax.device_get(a))))
    lb = dict(_leaves(serialization.to_state_dict(jax.device_get(b))))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


def test_full_checkpoints_both_ways(tmp_path):
    """A JAX full checkpoint (non-zero Adam moments, step 1) resumed by
    the port's ``load_checkpoint`` restores every leaf exactly; the
    port's ``save_checkpoint`` of that state is restored by the JAX
    ``load_checkpoint`` to the same tree exactly; one step after each
    resume matches the other package's step (loss atol 1e-4, parameters
    and BatchNorm statistics relative L2 1e-3); the port's
    ``export_params_only`` of its file loads in both packages."""
    from swinvox_tpu.train import checkpoint as jax_ckpt

    from swinvox_tpu_torch.train import checkpoint as port_ckpt

    _, _, state0, step_with_grads, mp = jax_setup()
    try:
        rng = np.random.default_rng(13)
        first = batch(rng, 2, 1)
        step = compile_jax(step_with_grads, state0, *first)
        state1, _, _ = step(state0, *first)
        images, volumes = batch(rng, 2, 1)
        jax_new, jax_loss, _ = step(state1, images, volumes)

        # JAX writes, the port resumes and steps
        jfile = str(tmp_path / "jax.ckpt")
        jax_ckpt.save_checkpoint(jfile, state1, 3, 0.25, 2)
        state, train_step = port_state(state0)  # moved off state1 first
        meta = port_ckpt.load_checkpoint(jfile, state)
        assert meta == {"epoch_idx": 3, "best_iou": 0.25, "best_epoch": 2}
        assert state.step == 1
        model = state.model
        for name, want in tree_to_torch(state1.params, model).items():
            assert torch.equal(model.get_parameter(name), want), name
        for module, opt in state1.opt_states.items():
            inner = opt[2]
            assert state.opt_states[module]["count"] == int(inner.count)
            for kind in ("mu", "nu"):
                want = tree_to_torch(getattr(inner, kind), model, (module,))
                for name, t in state.opt_states[module][kind].items():
                    assert torch.equal(t, want[name]), (kind, name)

        # the port writes that state; JAX restores it exactly
        pfile = str(tmp_path / "port.ckpt")
        port_ckpt.save_checkpoint(pfile, state, 4, 0.5, 3)
        restored, jmeta = jax_ckpt.load_checkpoint(pfile, state1)
        assert jmeta == {"epoch_idx": 4, "best_iou": 0.5, "best_epoch": 3}
        _assert_trees_equal(
            {"p": restored.params, "b": restored.batch_stats,
             "o": restored.opt_states, "s": restored.step},
            {"p": state1.params, "b": state1.batch_stats,
             "o": state1.opt_states, "s": state1.step})
        new2, loss2, _ = step(restored, images, volumes)
        assert float(loss2) == float(jax_loss)

        # one port step from the resumed state against JAX's
        state, metrics = train_step(state, images, volumes,
                                    torch.Generator())
        assert state.step == 2
        compare(state, jax_new, jax_loss, metrics["total_loss"])
        compare(state, new2, loss2, metrics["total_loss"])

        slim = str(tmp_path / "slim.ckpt")
        port_ckpt.export_params_only(pfile, slim)
        assert os.path.getsize(slim) < 0.5 * os.path.getsize(pfile)
        jslim, smeta = jax_ckpt.load_checkpoint(slim, state1)
        assert smeta == {"format": "params-only"}
        _assert_trees_equal(jslim.params, state1.params)
        again, _ = port_state(state0)
        assert port_ckpt.load_checkpoint(slim, again) == smeta
        assert again.step == 0  # the template's: a params-only file has none
        for name, want in tree_to_torch(state1.params, model).items():
            assert torch.equal(again.model.get_parameter(name), want), name
    finally:
        mp.undo()
