"""The evaluation entry point of swinvox_tpu_torch against the JAX
package's, on the CPU, at nano depths (SWIN_DEPTHS (1,1,1,1),
RESNET_STAGE_DEPTHS (1,1,1)), full widths, f32, 224^2, 3 views.

One ShapeNet-format fixture (``generate_dataset``: 2 categories, one
test sample each, 3 views) and one set of random numpy weights
(``_torch_train_common.random_variables``) serve every test.  The JAX
side runs its own ``test_net`` once per module, with three test-only
shortcuts that leave its numbers alone: shape-only initialization
(the checkpoint replaces every weight), its eval step compiled at XLA
optimization level 1, and no voxel renders.  That one run records each
eval-step call's inputs and outputs for the step-level comparison.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_common import COMPILE, random_variables
from flax import serialization

from swinvox_tpu_torch.convert import jax_variables
from swinvox_tpu_torch.models.swinvox import SwinVoxModel
from swinvox_tpu_torch.train import checkpoint as port_ckpt
from swinvox_tpu_torch.utils import flax_msgpack

CATEGORIES = [("02691156", "aeroplane"), ("03001627", "chair")]
N_VIEWS = 3
CONFIGS = {
    "eval-merger": {"USE_PALLAS_MERGER": True},
    "eval-wmsa": {"USE_PALLAS_MERGER": True, "USE_PALLAS_SWIN_BLOCK": False},
}


def _nano(cfg, root, flags=()):
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.COMPUTE_DTYPE = "float32"
    cfg.CONST.N_VIEWS_RENDERING = N_VIEWS
    cfg.CONST.NUM_WORKER = 2
    cfg.DIR.OUT_PATH = os.path.join(root, "out")
    for name, value in dict(flags).items():
        setattr(cfg.NETWORK, name, value)
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The fixture trees (port and JAX generators), the JAX checkpoints
    (full with one bf16 leaf, params-only) and the JAX ``test_net`` run."""
    from swinvox_tpu.data.synthetic import generate_dataset as jax_generate
    from swinvox_tpu.train import checkpoint as jax_ckpt
    from swinvox_tpu.train import evaluator as jax_evaluator
    from swinvox_tpu.train import state as jax_state
    from swinvox_tpu.train import trainer as jax_trainer

    from swinvox_tpu_torch.data.synthetic import generate_dataset

    base = tmp_path_factory.mktemp("eval")
    root, jroot = str(base / "port"), str(base / "jax")
    flags = CONFIGS["eval-merger"]
    cfg = _nano(generate_dataset(root, (0, 0, 1), N_VIEWS, CATEGORIES), root,
                flags)
    jcfg = _nano(jax_generate(jroot, (0, 0, 1), N_VIEWS, CATEGORIES), jroot,
                 flags)
    jcfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH = \
        cfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH
    jcfg.DATASETS.SHAPENET.RENDERING_PATH = cfg.DATASETS.SHAPENET.RENDERING_PATH
    jcfg.DATASETS.SHAPENET.VOXEL_PATH = cfg.DATASETS.SHAPENET.VOXEL_PATH
    jcfg.PARALLEL.DATA_PARALLEL = 1

    _, state, _ = jax_state.create_train_state(
        jcfg, jax.random.PRNGKey(0), jit_init="shape")
    v = random_variables(jax.eval_shape(
        lambda: {"params": state.params, "batch_stats": state.batch_stats}))
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    params_only = str(base / "params.ckpt")
    jax_ckpt.save_params_only(params_only, state)
    bf16 = jax.tree.map(lambda a: a, v["params"])
    leaf = bf16["decoder"]["tconv1"]
    leaf["kernel"] = jnp.asarray(leaf["kernel"], jnp.bfloat16)
    full = str(base / "full.ckpt")
    jax_ckpt.save_checkpoint(full, state.replace(params=bf16), 3, 0.25, 2)

    calls = []
    real_step = jax_evaluator.make_eval_step

    def make_eval_step(model, thresholds):
        step = jax.jit(real_step(model, thresholds).__wrapped__,
                       static_argnames=("enable_merger", "enable_refiner"),
                       compiler_options=COMPILE)

        def recorded(params, batch_stats, images, volumes, **kw):
            out = step(params, batch_stats, images, volumes, **kw)
            calls.append((np.array(images), np.array(volumes),
                          jax.device_get(out)))
            return out

        return recorded

    real_evaluate = jax_trainer.evaluate
    real_create = jax_state.create_train_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_evaluator, "make_eval_step", make_eval_step)
        mp.setattr(jax_trainer, "evaluate", lambda *a, **k: real_evaluate(
            *a, **{**k, "render_dir": None}))
        mp.setattr(jax_trainer, "create_train_state",
                   lambda c, key: real_create(c, key, jit_init="shape"))
        iou = jax_trainer.test_net(jcfg, weights=params_only)
    return {"root": root, "jroot": jroot, "cfg": cfg, "jcfg": jcfg,
            "state": state, "variables": v, "bf16_params": bf16,
            "params_only": params_only, "full": full, "iou": iou,
            "calls": calls}


def _leaves(tree, prefix=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (k,))
        else:
            yield prefix + (k,), val


def _bits(a):
    """A leaf's raw bytes and dtype name (bf16 from either framework)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().tobytes(), str(a.dtype)[6:]
    a = np.asarray(a)
    return a.tobytes(), a.dtype.name


def _port_model(cfg):
    return SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(0))


def test_fixture_binvox_and_loader_match_jax(world, monkeypatch):
    """The port's generator writes the JAX generator's files byte for
    byte; the port's binvox reader and test loader give the JAX package's
    volumes and batches bit for bit: against the JAX package's numpy
    decode and resize, which the port's are.  Its optional C codecs round
    1/255 and the resize weights apart (1 float32 ulp): atol 1e-6 there."""
    from swinvox_tpu.data import binvox as jax_binvox
    from swinvox_tpu.data.pipeline import build_loader as jax_loader
    from swinvox_tpu.data.taxonomy import DatasetType as JaxSplit
    from swinvox_tpu.native import runtime

    from swinvox_tpu_torch.data import binvox
    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.taxonomy import DatasetType

    root, jroot = world["root"], world["jroot"]
    n_files = 0
    for dirpath, _, files in os.walk(jroot):
        for name in files:
            if name.endswith((".png", ".binvox", ".json")):
                rel = os.path.relpath(os.path.join(dirpath, name), jroot)
                assert filecmp.cmp(os.path.join(jroot, rel),
                                   os.path.join(root, rel), shallow=False), rel
                n_files += 1
                if name.endswith(".binvox"):
                    with open(os.path.join(root, rel), "rb") as f:
                        got = binvox.read_as_3d_array(f)
                    with open(os.path.join(root, rel), "rb") as f:
                        ref = jax_binvox.read_as_3d_array(f)
                    np.testing.assert_array_equal(got.data, ref.data)
                    assert (got.dims, got.translate, got.scale) == (
                        ref.dims, ref.translate, ref.scale)
    assert n_files == 2 * (N_VIEWS + 1) + 1
    got = list(build_loader(world["cfg"], DatasetType.TEST))
    native = list(jax_loader(world["jcfg"], JaxSplit.TEST))
    monkeypatch.setattr(runtime, "decode_image_native", lambda data: None)
    monkeypatch.setattr(runtime, "resize_bilinear_native", lambda *a: None)
    ref = list(jax_loader(world["jcfg"], JaxSplit.TEST))
    assert len(got) == len(ref) == len(native) == 2
    for a, b, c in zip(got, ref, native):
        assert (a.taxonomy_ids, a.sample_names) == (b.taxonomy_ids,
                                                    b.sample_names)
        assert a.images.shape == (1, N_VIEWS, 224, 224, 3)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.volumes, b.volumes)
        np.testing.assert_allclose(a.images, c.images, rtol=0, atol=1e-6)


def test_msgpack_codec_matches_flax(world):
    """The port's decoder reads a JAX full checkpoint (bf16 leaf, numpy
    scalars, meta) as ``flax.serialization.msgpack_restore`` does, and its
    encoder gives back flax's bytes."""
    with open(world["full"], "rb") as f:
        blob = f.read()
    got = flax_msgpack.unpackb(blob)
    ref = serialization.msgpack_restore(blob)
    assert got["meta"] == ref["meta"] == {"epoch_idx": 3, "best_iou": 0.25,
                                          "best_epoch": 2}
    g, r = dict(_leaves(got["state"])), dict(_leaves(ref["state"]))
    assert g.keys() == r.keys()
    kinds = set()
    for path, leaf in r.items():
        assert _bits(g[path]) == _bits(leaf), path
        kinds.add(_bits(leaf)[1])
    assert "bfloat16" in kinds
    assert flax_msgpack.packb(got) == blob


def test_msgpack_codec_refuses_chunked_arrays(monkeypatch):
    """flax splits an array over ``MAX_CHUNK_SIZE`` bytes into a chunked
    map; the port's decoder refuses that form loudly instead of handing
    back a map where an array belongs."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    blob = serialization.msgpack_serialize(
        {"w": np.arange(12, dtype=np.float32)})
    np.testing.assert_array_equal(
        serialization.msgpack_restore(blob)["w"], np.arange(12))
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.unpackb(blob)


@pytest.mark.parametrize("kind", ["full", "params_only"])
def test_jax_checkpoint_loads_into_port(world, kind):
    """A JAX ``save_checkpoint`` file (one bf16 leaf) and a JAX
    ``save_params_only`` file load into the port bit for bit (the bf16
    leaf widened exactly), through ``load_checkpoint`` and
    ``Predictor.from_checkpoint``."""
    from swinvox_tpu_torch.infer import Predictor

    path = world[kind]
    if kind == "full":
        model = _port_model(world["cfg"])
        meta = port_ckpt.load_checkpoint(path, model)
        assert meta["epoch_idx"] == 3
        params = world["bf16_params"]
    else:
        model = Predictor.from_checkpoint(path, world["cfg"], "cpu").model
        params = world["variables"]["params"]
    want = {"params": params,
            "batch_stats": world["variables"]["batch_stats"]}
    got = jax_variables(model)
    for coll in ("params", "batch_stats"):
        g, w = dict(_leaves(got[coll])), dict(_leaves(want[coll]))
        assert g.keys() == w.keys()
        for path_, leaf in w.items():
            np.testing.assert_array_equal(
                g[path_], np.asarray(leaf).astype(np.float32), str(path_))


def test_port_export_loads_into_jax(world, tmp_path):
    """``save_params_only`` of a port model is a file the JAX package's
    ``load_checkpoint`` restores, with the port's weights exactly."""
    from swinvox_tpu.train.checkpoint import load_checkpoint

    model = _port_model(world["cfg"])
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_params_only(path, model)
    state, meta = load_checkpoint(path, world["state"],
                                  restore_optimizer=False)
    assert meta == {"format": "params-only"}
    want = jax_variables(model)
    for coll, tree in (("params", state.params),
                       ("batch_stats", state.batch_stats)):
        w = dict(_leaves(want[coll]))
        got = dict(_leaves(jax.device_get(tree)))
        assert got.keys() == w.keys()
        for path_, leaf in w.items():
            np.testing.assert_array_equal(np.asarray(got[path_]), leaf)


def test_eval_step_matches_jax(world):
    """The port's ``make_eval_step`` on the JAX run's own eval batches and
    weights gives its per-sample losses, IoU, F-score and probabilities
    within 1e-4."""
    from swinvox_tpu_torch.train.steps import make_eval_step

    model = _port_model(world["cfg"])
    port_ckpt.load_checkpoint(world["params_only"], model)
    step = make_eval_step(model, tuple(world["cfg"].TEST.VOXEL_THRESH))
    assert world["calls"]
    for images, volumes, ref in world["calls"]:
        got = step(images, volumes)
        for key in ("encoder_loss", "refiner_loss", "iou", "fscore",
                    "probs"):
            np.testing.assert_allclose(got[key].numpy(), ref[key],
                                       rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_runner_test_matches_jax_test_net(world, config, monkeypatch):
    """``runner --test --platform cpu`` (through the port's ``test_net``)
    on the JAX checkpoint returns the JAX ``test_net``'s max IoU within
    1e-4, in the ``eval-merger`` and ``eval-wmsa`` configurations."""
    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.train import trainer

    results = []
    real = trainer.test_net

    def recording(*a, **k):
        results.append(real(*a, **k))
        return results[-1]

    monkeypatch.setattr(trainer, "test_net", recording)
    flags = [f"NETWORK.{k}={str(v).lower()}" for k, v in
             {"SWIN_DEPTHS": [1, 1, 1, 1], "RESNET_STAGE_DEPTHS": [1, 1, 1],
              "COMPUTE_DTYPE": "float32", **CONFIGS[config]}.items()]
    flags.append("CONST.NUM_WORKER=2")
    argv = ["--test", "--weights", world["params_only"], "--n-views",
            str(N_VIEWS), "--dataset-root", world["root"], "--out",
            os.path.join(world["root"], "out"), "--platform", "cpu"]
    assert runner.main(argv + [x for f in flags for x in ("--set", f)]) == 0
    assert len(results) == 1
    assert abs(results[0] - world["iou"]) <= 1e-4
    assert 0.0 <= world["iou"] <= 1.0
