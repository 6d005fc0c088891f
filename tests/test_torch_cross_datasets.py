"""The port's Pix3D and Pascal3D sources against the JAX package's, on
the CPU: ``generate_pix3d_dataset`` and ``generate_pascal3d_dataset``
write the JAX generators' trees byte for byte (the .mat header's clock
fixed: scipy stamps the time of writing), ``Pix3DIndex`` and
``Pascal3DIndex`` give the JAX records (paths, normalized bounding boxes,
the CAD index of the largest object), and the test loaders' batches
(bbox crop, eval transform) equal the JAX loaders' numpy path bit for
bit.  Then ``runner --test`` evaluates each fixture with a nano model on
the CPU through its ``DATASET.TEST_DATASET``; and the default split
files of the port's config are the repository's ``datasets/``.
"""

import filecmp
import os
import time

import numpy as np
import pytest
import scipy.io

GENERATORS = ("generate_pix3d_dataset", "generate_pascal3d_dataset")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: (port root, JAX root, port cfg, JAX cfg)} for both
    generators at 5 samples, seed 3."""
    from swinvox_tpu.data import synthetic as jax_synthetic

    from swinvox_tpu_torch.data import synthetic

    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(time, "asctime", lambda *a: "Thu Jan  1 00:00:00 1970")
    try:
        for name in GENERATORS:
            root = tmp_path_factory.mktemp(name + "_port")
            jroot = tmp_path_factory.mktemp(name + "_jax")
            cfg = getattr(synthetic, name)(str(root), 5, seed=3)
            jcfg = getattr(jax_synthetic, name)(str(jroot), 5, seed=3)
            out[name] = (root, jroot, cfg, jcfg)
    finally:
        mp.undo()
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", GENERATORS)
def test_fixture_trees_match_jax_byte_for_byte(trees, name):
    root, jroot, cfg, jcfg = trees[name]
    files = _files(root)
    assert files == _files(jroot)
    assert len(files) == {"generate_pix3d_dataset": 12,
                          "generate_pascal3d_dataset": 13}[name]
    for rel in files:
        assert filecmp.cmp(root / rel, jroot / rel, shallow=False), rel
    assert cfg.DATASET.TEST_DATASET == jcfg.DATASET.TEST_DATASET
    key = "PIX3D" if "pix3d" in name else "PASCAL3D"
    for field in ("ANNOTATION_PATH", "RENDERING_PATH", "VOXEL_PATH",
                  "TAXONOMY_FILE_PATH"):
        got = getattr(getattr(cfg.DATASETS, key), field)
        want = getattr(getattr(jcfg.DATASETS, key), field)
        assert got.replace(str(root), "") == want.replace(str(jroot), "")


def _point_at(jcfg, cfg, key):
    for field in ("ANNOTATION_PATH", "RENDERING_PATH", "VOXEL_PATH",
                  "TAXONOMY_FILE_PATH"):
        setattr(getattr(jcfg.DATASETS, key), field,
                getattr(getattr(cfg.DATASETS, key), field))


@pytest.mark.parametrize("name", GENERATORS)
def test_indexes_and_loaders_match_jax(trees, name, monkeypatch):
    from swinvox_tpu.data.pipeline import build_loader as jax_loader
    from swinvox_tpu.data.taxonomy import DATASET_INDEX_MAPPING as JAX_MAP
    from swinvox_tpu.data.taxonomy import DatasetType as JaxSplit
    from swinvox_tpu.native import runtime

    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import (
        DATASET_INDEX_MAPPING,
        DatasetType,
    )

    monkeypatch.setattr(runtime, "decode_image_native", lambda data: None)
    monkeypatch.setattr(runtime, "resize_bilinear_native", lambda *a: None)
    root, _, cfg, jcfg = trees[name]
    key = "PIX3D" if "pix3d" in name else "PASCAL3D"
    _point_at(jcfg, cfg, key)  # both read the port's tree
    dataset = cfg.DATASET.TEST_DATASET
    index, jindex = DATASET_INDEX_MAPPING[dataset](cfg), JAX_MAP[dataset](jcfg)
    got, want = index.samples(DatasetType.TEST), jindex.samples(JaxSplit.TEST)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.__dict__ == b.__dict__
        assert a.bounding_box is not None
    assert index.samples(DatasetType.TRAIN) == []
    assert {k: v.__dict__ for k, v in index.taxonomy_info().items()} == \
        {k: v.__dict__ for k, v in jindex.taxonomy_info().items()}
    for c in (cfg, jcfg):
        c.CONST.NUM_WORKER = 2
        c.TRAIN.DEVICE_AUGMENT = True  # bbox sources stay on the host
    ours = list(build_loader(cfg, DatasetType.TEST))
    ref = list(jax_loader(jcfg, JaxSplit.TEST))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.aug is None and b.aug is None
        assert a.sample_names == b.sample_names
        assert a.images.shape == (1, 1, 224, 224, 3)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.volumes, b.volumes)


def test_pascal3d_takes_the_largest_object(tmp_path):
    """An annotation with several objects: the record takes the box and
    CAD index of the largest, as the JAX index does."""
    from swinvox_tpu.data.taxonomy import Pascal3DIndex as JaxIndex
    from swinvox_tpu.data.taxonomy import DatasetType as JaxSplit

    from swinvox_tpu_torch.data.synthetic import generate_pascal3d_dataset
    from swinvox_tpu_torch.data.taxonomy import DatasetType, Pascal3DIndex

    cfg = generate_pascal3d_dataset(str(tmp_path), 2, seed=1)
    objects = np.zeros((3,), dtype=[("cad_index", "O"), ("bbox", "O")])
    for i, (box, cad) in enumerate((([0.0, 0, 10, 10], 1),
                                    ([20.0, 10, 200, 170], 2),
                                    ([5.0, 5, 60, 90], 1))):
        objects[i] = (cad, np.array(box))
    scipy.io.savemat(
        cfg.DATASETS.PASCAL3D.ANNOTATION_PATH % ("aeroplane", "n00000000"),
        {"record": {"imgsize": np.array([240, 180, 3]), "objects": objects}})
    got = Pascal3DIndex(cfg).samples(DatasetType.TEST)
    want = JaxIndex(cfg).samples(JaxSplit.TEST)
    assert [r.__dict__ for r in got] == [r.__dict__ for r in want]
    assert got[0].bounding_box == [20 / 240, 10 / 180, 200 / 240, 170 / 180]
    assert got[0].volume_path.endswith("02.binvox")


@pytest.mark.parametrize("name", GENERATORS)
def test_runner_evaluates_the_fixture(trees, name, tmp_path):
    """``runner --test --config <fixture config> --platform cpu`` with a
    nano checkpoint: every sample evaluated, the IoU logged."""
    import json

    import torch

    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.train.checkpoint import save_params_only

    _, _, cfg, _ = trees[name]
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    cfg.NETWORK.INIT_SCHEME = "standard"
    cfg.CONST.NUM_WORKER = 2
    cfg.TEST.EVAL_BATCH_SIZE = 2
    weights = str(tmp_path / "w.ckpt")
    save_params_only(weights, SwinVoxModel.from_config(
        cfg, torch.Generator().manual_seed(0)))
    (tmp_path / "config.json").write_text(cfg.to_json())
    assert runner.main(["--test", "--weights", weights, "--config",
                        str(tmp_path / "config.json"), "--out",
                        str(tmp_path / "out"), "--platform", "cpu"]) == 0
    (run,) = (tmp_path / "out").iterdir()
    rows = [json.loads(line) for line in
            (run / "logs" / "test.jsonl").read_text().splitlines()]
    iou = [r["value"] for r in rows if r["tag"] == "Refiner/IoU"]
    assert len(iou) == 1 and 0.0 <= iou[0] <= 1.0


def test_default_split_files_are_the_repository_datasets(tmp_path,
                                                          monkeypatch):
    """Run from another directory, the default ``./datasets/*.json``
    paths resolve to the repository's ``datasets/`` (never the JAX
    package's copy)."""
    from swinvox_tpu_torch.config import default_config, resolve_data_path

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)
    cfg = default_config()
    for paths in (cfg.DATASETS.SHAPENET, cfg.DATASETS.PASCAL3D,
                  cfg.DATASETS.PIX3D):
        got = resolve_data_path(paths.TAXONOMY_FILE_PATH)
        assert got == os.path.join(repo, "datasets",
                                   os.path.basename(paths.TAXONOMY_FILE_PATH))
        assert os.path.isfile(got)
    assert resolve_data_path("./nope/x.json") == "./nope/x.json"
