"""The port's augmentation on the card (``data/device_augment.py``, the
parameter draws of ``data/transforms.py`` and the loader's raw batches)
against the JAX package's, on the CPU.

  * ``device_train_augment`` against the JAX function on the same raw
    pixels (uint8 and float32, RGBA and RGB, 137^2 renders and an image
    not larger than the crop) and parameters: atol 1e-5;
  * ``draw_train_params`` / ``draw_eval_params`` equal to the JAX draws
    from the same generator, bit for bit;
  * under ``TRAIN.DEVICE_AUGMENT`` the loaders' raw uint8 images, volumes
    and ``aug_*`` arrays equal the JAX loaders', bit for bit (train and
    validation splits, its numpy image path);
  * the device path against the port's host ``train_transform`` /
    ``eval_transform`` for the same seed (atol 3e-4, rtol 1e-4, the JAX
    package's own tolerance for the resize as matmuls and the folded
    color map), and the device-augment loader batch against the host
    loader batch;
  * a source with ``DIR.RANDOM_BG_PATH`` falls back to the host transform,
    and ``load_raw`` refuses a bounding box, as in JAX;
  * ``train_net`` under ``TRAIN.DEVICE_AUGMENT`` (nano, one epoch) logs
    the host-augmented run's losses within rtol 1e-3.
"""

import json

import numpy as np
import pytest
import torch

CATEGORIES = [("02691156", "aeroplane"), ("03001627", "chair")]


def _jax_augment(raw, p, *static):
    import jax.numpy as jnp
    from swinvox_tpu.data.device_augment import device_train_augment

    return np.asarray(device_train_augment(
        jnp.asarray(raw), *(jnp.asarray(p[k]) for k in
                            ("bg_color", "color_A", "color_B", "color_v",
                             "flips")), *static))


def _port_augment(raw, p, *static):
    from swinvox_tpu_torch.data.device_augment import device_train_augment

    return device_train_augment(
        torch.from_numpy(raw), *(torch.from_numpy(np.asarray(p[k])) for k in
                                 ("bg_color", "color_A", "color_B",
                                  "color_v", "flips")), *static).numpy()


def _stacked(draw, cfg, seeds, n_views, has_alpha):
    params = [draw(cfg, np.random.default_rng(s), n_views, has_alpha)
              for s in seeds]
    return {k: np.stack([p[k] for p in params]) for k in params[0]}


@pytest.mark.parametrize("case", ["uint8-rgba", "float-rgba", "uint8-rgb",
                                  "float-small"])
def test_device_train_augment_matches_jax(case):
    from swinvox_tpu.config import default_config as jax_default
    from swinvox_tpu.data import transforms as jtr

    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.data import transforms as tr

    rng = np.random.default_rng(7)
    side = 100 if case == "float-small" else 137
    c = 3 if case == "uint8-rgb" else 4
    raw = rng.random((2, 3, side, side, c)).astype(np.float32)
    if c == 4:
        raw[..., 3] *= raw[..., 3] > 0.4
    if case.startswith("uint8"):
        raw = np.round(raw * 255).astype(np.uint8)
    for k, draw in enumerate((tr.draw_train_params, tr.draw_eval_params)):
        jdraw = (jtr.draw_train_params, jtr.draw_eval_params)[k]
        p = _stacked(draw, default_config(), (3, 4), 3, c == 4)
        jp = _stacked(jdraw, jax_default(), (3, 4), 3, c == 4)
        for key in p:
            np.testing.assert_array_equal(p[key], jp[key], err_msg=key)
        got = _port_augment(raw, p)
        want = _jax_augment(raw, jp)
        assert got.shape == want.shape == (2, 3, 224, 224, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_device_path_matches_host_transform():
    """The same generator through the port's host transforms and through
    the parameter draws and the device path."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.data import transforms as tr

    cfg = default_config()
    rng = np.random.default_rng(0)
    for seed in range(4):
        imgs = rng.random((3, 137, 137, 4)).astype(np.float32)
        imgs[..., 3] = (imgs[..., 3] > 0.4) * rng.random((3, 137, 137))
        for host_fn, draw in (
                (lambda x, r: tr.train_transform(x, cfg, r),
                 tr.draw_train_params),
                (lambda x, r: tr.eval_transform(x, cfg),
                 tr.draw_eval_params)):
            host = host_fn(imgs.copy(), np.random.default_rng(seed))
            p = draw(cfg, np.random.default_rng(seed), 3, True)
            dev = _port_augment(imgs[None], {k: v[None]
                                             for k, v in p.items()})
            np.testing.assert_allclose(dev[0], host, atol=3e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def fixture_cfgs(tmp_path_factory):
    """A 2-category fixture (3 train, 1 val sample each, 4 views) and the
    port's and the JAX package's configs on it (2 views, batch 2,
    TRAIN.DEVICE_AUGMENT)."""
    from swinvox_tpu.config import default_config as jax_default

    from swinvox_tpu_torch.data.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("augment_data")
    cfg = generate_dataset(str(root), (3, 1, 0), 4, CATEGORIES)
    jcfg = jax_default()
    for c in (cfg, jcfg):
        s = c.DATASETS.SHAPENET
        s.TAXONOMY_FILE_PATH = cfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH
        s.RENDERING_PATH = cfg.DATASETS.SHAPENET.RENDERING_PATH
        s.VOXEL_PATH = cfg.DATASETS.SHAPENET.VOXEL_PATH
        c.CONST.N_VIEWS_RENDERING = 2
        c.CONST.BATCH_SIZE = 2
        c.CONST.NUM_WORKER = 2
        c.TRAIN.DEVICE_AUGMENT = True
    return cfg, jcfg, root


def test_raw_loaders_match_jax_bit_for_bit(fixture_cfgs, monkeypatch):
    from swinvox_tpu.data.pipeline import build_loader as jax_loader
    from swinvox_tpu.data.taxonomy import DatasetType as JaxSplit
    from swinvox_tpu.native import runtime

    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import DatasetType

    monkeypatch.setattr(runtime, "decode_image_native", lambda data: None)
    cfg, jcfg, _ = fixture_cfgs
    for split, jsplit in ((DatasetType.TRAIN, JaxSplit.TRAIN),
                          (DatasetType.VAL, JaxSplit.VAL)):
        ours, ref = build_loader(cfg, split), jax_loader(jcfg, jsplit)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(ours), list(ref)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.sample_names == b.sample_names
                assert a.images.dtype == b.images.dtype == np.uint8
                assert a.images.shape[-3:] == (137, 137, 4)
                np.testing.assert_array_equal(a.images, b.images)
                np.testing.assert_array_equal(a.volumes, b.volumes)
                assert a.aug.keys() == b.aug.keys()
                for k in a.aug:
                    assert a.aug[k].dtype == b.aug[k].dtype, k
                    np.testing.assert_array_equal(a.aug[k], b.aug[k],
                                                  err_msg=k)
        ours.close()


def test_device_loader_batch_matches_host_loader(fixture_cfgs):
    """A device-augment batch made into images on the device equals the
    host loader's batch of the same seed and epoch (atol 3e-4, rtol
    1e-4); ``batch_to_host_dict`` ships volumes as uint8."""
    import copy

    from swinvox_tpu_torch.data.device_augment import (
        apply_device_augment,
        batch_to_host_dict,
    )
    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import DatasetType

    cfg, _, _ = fixture_cfgs
    host_cfg = copy.deepcopy(cfg)
    host_cfg.TRAIN.DEVICE_AUGMENT = False
    for split in (DatasetType.TRAIN, DatasetType.VAL):
        raw_loader = build_loader(cfg, split)
        host_loader = build_loader(host_cfg, split)
        for rb, hb in zip(raw_loader, host_loader):
            assert rb.sample_names == hb.sample_names
            host = batch_to_host_dict(rb, cfg)
            assert host["volumes"].dtype == np.uint8
            images = apply_device_augment(host, cfg, "cpu")
            np.testing.assert_allclose(images.numpy(), hb.images, atol=3e-4,
                                       rtol=1e-4)
            assert "aug_bg_color" not in batch_to_host_dict(hb, host_cfg)
            assert apply_device_augment(batch_to_host_dict(hb, host_cfg),
                                        host_cfg) is hb.images


def test_host_only_sources_fall_back(fixture_cfgs, tmp_path):
    """DIR.RANDOM_BG_PATH keeps the host transform under
    TRAIN.DEVICE_AUGMENT, and ``load_raw`` refuses a bounding box."""
    import copy

    from PIL import Image

    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import DatasetType

    cfg, _, _ = fixture_cfgs
    cfg = copy.deepcopy(cfg)
    bg = tmp_path / "bgs"
    bg.mkdir()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(bg / "bg.png")
    cfg.DIR.RANDOM_BG_PATH = str(bg)
    loader = build_loader(cfg, DatasetType.TRAIN)
    b = next(iter(loader))
    loader.close()
    assert b.aug is None and b.images.dtype == np.float32
    assert b.images.shape[2:] == (224, 224, 3)
    ds = build_loader(fixture_cfgs[0], DatasetType.TRAIN).dataset
    ds.records[0].bounding_box = [0.1, 0.1, 0.9, 0.9]
    with pytest.raises(ValueError, match="bbox"):
        ds.load_raw(0)


def test_train_net_with_device_augment(fixture_cfgs, tmp_path):
    """One nano epoch of the runner with and without TRAIN.DEVICE_AUGMENT:
    the same batch losses within rtol 1e-3 (the images agree to 3e-4;
    dropout masks come from one seeded generator in both)."""
    from swinvox_tpu_torch.cli import runner

    cfg, _, root = fixture_cfgs
    logs = {}
    for on in (True, False):
        out = tmp_path / str(on)
        argv = ["--batch-size", "2", "--epoch", "1", "--n-views", "2",
                "--dataset-root", str(root), "--out", str(out),
                "--platform", "cpu"]
        for kv in ("NETWORK.SWIN_DEPTHS=[1,1,1,1]",
                   "NETWORK.RESNET_STAGE_DEPTHS=[1,1,1]",
                   "NETWORK.COMPUTE_DTYPE=float32", "TRAIN.LOG_EVERY=1",
                   "CONST.NUM_WORKER=2", "TEST.EVAL_BATCH_SIZE=2",
                   f"TRAIN.DEVICE_AUGMENT={str(on).lower()}"):
            argv += ["--set", kv]
        assert runner.main(argv) == 0
        (run,) = out.iterdir()
        logs[on] = [json.loads(line) for line in
                    (run / "logs" / "train.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in logs[True]] == [r["tag"] for r in logs[False]]
    assert len(logs[True]) == 3 * 2 + 2  # 3 steps x 2 losses, 2 epoch
    for a, b in zip(logs[True], logs[False]):
        np.testing.assert_allclose(a["value"], b["value"], rtol=1e-3,
                                   err_msg=a["tag"])
