"""``runner`` train mode of swinvox_tpu_torch end to end against the JAX
package's ``train_net``, on the CPU.

Both resume from one JAX full checkpoint of a nano initial state (SWIN
(1,1,1,1), ResNet (1,1,1), f32, 224^2; random weights on the shape
trace, epoch_idx 0, so both run epochs 1 and 2) and train 2 epochs of 2
steps (4 training samples, batch 2, 1 of 3 views drawn per sample) with
per-epoch validation on 2 samples, on the same ShapeNet-format fixture.
Dropout and drop-path are off on both sides (flax ``Dropout`` and the JAX
``DropPath`` patched to identity, the port's rates set to 0): their
masks cannot match across frameworks.  The JAX side runs with four
test-only shortcuts that leave its numbers alone: shape-only
initialization (the checkpoint replaces every weight), its train and
eval steps compiled at XLA optimization level 1, no voxel renders, and
its numpy image path (the optional C codecs off, which the port
matches bit for bit).

Held: every logged batch loss (LOG_EVERY 1) within 1e-3 relative, the
validation IoU of each epoch within 1e-4, ``best_iou``, ``best_epoch``
and the checkpoint files written, and the files of the run (both write
a TensorBoard event file per stream, named by the clock, the host and
the process).
"""

import json
import os

import jax
from _torch_train_common import COMPILE, random_variables

CATEGORIES = [("02691156", "aeroplane"), ("03001627", "chair")]
NANO = {"SWIN_DEPTHS": [1, 1, 1, 1], "RESNET_STAGE_DEPTHS": [1, 1, 1],
        "COMPUTE_DTYPE": "float32"}


def _files(run_dir):
    """The run's files, each TensorBoard event file as ``<dir>/events``."""
    out = set()
    for base, _, names in os.walk(run_dir):
        for n in names:
            if n.startswith("events.out.tfevents."):
                n = "events"
            out.add(os.path.relpath(os.path.join(base, n), run_dir))
    return out


def _meta(path):
    """A checkpoint's meta, read from the head of the file (msgpack map
    keys are sorted, so "meta" comes before the state)."""
    import msgpack

    with open(path, "rb") as f:
        unpacker = msgpack.Unpacker(f, raw=False)
        assert unpacker.read_map_header() == 2
        assert unpacker.unpack() == "meta"
        return unpacker.unpack()


def _scalars(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["tag"], r["step"], r["value"]) for r in rows]


def test_runner_train_matches_jax_train_net(tmp_path, monkeypatch):
    """The port's ``runner`` (train mode, ``--weights`` resumes) against
    the JAX ``train_net`` from one checkpoint: losses, validation IoU,
    best IoU and epoch, checkpoints and run files agree."""
    import flax.linen as fnn
    from swinvox_tpu.config import default_config as jax_default
    from swinvox_tpu.models import layers as jax_layers
    from swinvox_tpu.native import runtime
    from swinvox_tpu.train import checkpoint as jax_ckpt
    from swinvox_tpu.train import evaluator as jax_evaluator
    from swinvox_tpu.train import state as jax_state
    from swinvox_tpu.train import trainer as jax_trainer
    from swinvox_tpu.train.optim import MODULE_NAMES

    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.data.synthetic import generate_dataset
    from swinvox_tpu_torch.train import trainer

    root = str(tmp_path / "data")
    cfg = generate_dataset(root, (2, 1, 0), 3, CATEGORIES)

    # the JAX configuration and the shared initial checkpoint
    jcfg = jax_default()
    s = jcfg.DATASETS.SHAPENET
    s.TAXONOMY_FILE_PATH = cfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH
    s.RENDERING_PATH = cfg.DATASETS.SHAPENET.RENDERING_PATH
    s.VOXEL_PATH = cfg.DATASETS.SHAPENET.VOXEL_PATH
    for k, v in NANO.items():
        setattr(jcfg.NETWORK, k, tuple(v) if isinstance(v, list) else v)
    jcfg.CONST.BATCH_SIZE = 2
    jcfg.CONST.N_VIEWS_RENDERING = 1
    jcfg.CONST.NUM_WORKER = 2
    jcfg.TRAIN.NUM_EPOCHS = 2
    jcfg.TRAIN.LOG_EVERY = 1
    jcfg.TRAIN.DECODER_LEARNING_RATE = 1e-3  # steps large enough to see
    jcfg.TEST.EVAL_BATCH_SIZE = 2
    jcfg.PARALLEL.DATA_PARALLEL = 1

    _, state, _ = jax_state.create_train_state(
        jcfg, jax.random.PRNGKey(0), jit_init="shape")
    v = random_variables(jax.eval_shape(
        lambda: {"params": state.params, "batch_stats": state.batch_stats}),
        seed=4)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    ckpt = str(tmp_path / "init.ckpt")
    jax_ckpt.save_checkpoint(ckpt, state, 0, -1.0, -1)
    assert set(state.opt_states) == set(MODULE_NAMES)

    # the JAX run
    real_step, real_eval = jax_trainer.make_train_step, \
        jax_evaluator.make_eval_step
    real_create, real_evaluate = jax_state.create_train_state, \
        jax_trainer.evaluate
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jax_layers.DropPath, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(runtime, "decode_image_native", lambda data: None)
    monkeypatch.setattr(runtime, "resize_bilinear_native", lambda *a: None)
    monkeypatch.setattr(jax_trainer, "make_train_step", lambda *a, **k: (
        jax.jit(real_step(*a, **k).__wrapped__,
                static_argnames=("enable_merger", "enable_refiner"),
                compiler_options=COMPILE)))
    monkeypatch.setattr(jax_evaluator, "make_eval_step", lambda *a, **k: (
        jax.jit(real_eval(*a, **k).__wrapped__,
                static_argnames=("enable_merger", "enable_refiner"),
                compiler_options=COMPILE)))
    monkeypatch.setattr(jax_trainer, "create_train_state", lambda c, key, n: (
        real_create(c, key, n, jit_init="shape")))
    monkeypatch.setattr(jax_trainer, "evaluate", lambda *a, **k: (
        real_evaluate(*a, **{**k, "render_dir": None})))
    jcfg.CONST.WEIGHTS = ckpt
    jcfg.TRAIN.RESUME_TRAIN = True
    jcfg.DIR.OUT_PATH = str(tmp_path / "jax_out")
    jax_best = jax_trainer.train_net(jcfg)

    # the port's run, through the runner
    real_port_create = trainer.create_train_state

    def no_dropout(*a, **k):
        st, opts = real_port_create(*a, **k)
        m = st.model
        m.encoder.stage_dropout = 0.0
        m.encoder.cross_view_attention.dropout_rate = 0.0
        for mod in m.modules():
            if hasattr(mod, "drop_path1"):
                mod.drop_path1.rate = mod.drop_path2.rate = 0.0
        return st, opts

    results = []
    real_train_net = trainer.train_net
    monkeypatch.setattr(trainer, "create_train_state", no_dropout)
    monkeypatch.setattr(trainer, "train_net", lambda *a, **k: results.append(
        real_train_net(*a, **k)))
    sets = [f"NETWORK.{k}={json.dumps(v)}" for k, v in NANO.items()]
    sets += ["CONST.NUM_WORKER=2", "TRAIN.LOG_EVERY=1",
             "TRAIN.DECODER_LEARNING_RATE=1e-3", "TEST.EVAL_BATCH_SIZE=2"]
    argv = ["--weights", ckpt, "--batch-size", "2", "--epoch", "2",
            "--n-views", "1", "--dataset-root", root, "--out",
            str(tmp_path / "port_out"), "--platform", "cpu"]
    assert runner.main(argv + [x for s_ in sets for x in ("--set", s_)]) == 0
    assert len(results) == 1

    (jrun,), (prun,) = (os.listdir(tmp_path / d)
                        for d in ("jax_out", "port_out"))
    jdir, pdir = tmp_path / "jax_out" / jrun, tmp_path / "port_out" / prun
    jlog, plog = (_scalars(d / "logs" / "train.jsonl") for d in (jdir, pdir))
    batch_losses = [r for r in jlog if r[0].endswith("BatchLoss")]
    assert len(batch_losses) == 8  # 2 epochs x 2 steps x 2 losses
    assert [r[:2] for r in plog] == [r[:2] for r in jlog]
    for (tag, step, want), (_, _, got) in zip(jlog, plog):
        assert abs(got - want) <= 1e-3 * abs(want), (tag, step, got, want)
    jval, pval = (_scalars(d / "logs" / "val.jsonl") for d in (jdir, pdir))
    assert [r[:2] for r in pval] == [r[:2] for r in jval]
    for (tag, step, want), (_, _, got) in zip(jval, pval):
        if tag == "Refiner/IoU":
            assert abs(got - want) <= 1e-4, (step, got, want)
    assert abs(results[0] - jax_best) <= 1e-4
    jfiles, pfiles = _files(jdir), _files(pdir)
    assert pfiles == jfiles
    assert {"logs/train/events", "logs/val/events"} <= pfiles
    for name in sorted(os.listdir(pdir / "checkpoints")):
        jmeta, pmeta = (_meta(d / "checkpoints" / name) for d in (jdir, pdir))
        assert pmeta["epoch_idx"] == jmeta["epoch_idx"]
        assert pmeta["best_epoch"] == jmeta["best_epoch"]
        assert abs(pmeta["best_iou"] - jmeta["best_iou"]) <= 1e-4
