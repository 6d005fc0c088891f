"""The port runner's ``--lr_find``, ``--tune`` and ``--profile`` modes on
the CPU (``--platform cpu``, nano depths, a small ShapeNet-format
fixture), and its TensorBoard event files against the JAX package's:

  * ``--lr_find`` runs ``LR_FINDER.NUM_BATCHES_TO_TEST`` sweep steps and
    suggests one of the swept rates; ``--weights`` does not resume there;
  * ``--tune --tune-trials 2 --tune-epochs 1`` writes ``config_best.json``
    with two trials, none FAILED (the default space: batch 32 or 64);
  * ``--profile`` writes a ``torch.profiler`` Chrome trace of the first
    epoch's batches from 2 into ``DIR.OUT_PATH/profile``;
  * ``utils/tb_writer.py`` writes the JAX writer's bytes (the clock
    fixed), and ``MetricsLogger`` an events directory per stream beside
    its JSONL.
"""

import json
import os
import time

import numpy as np
import pytest

NANO = ["NETWORK.SWIN_DEPTHS=[1,1,1,1]", "NETWORK.RESNET_STAGE_DEPTHS=[1,1,1]",
        "NETWORK.COMPUTE_DTYPE=float32", "CONST.NUM_WORKER=2",
        "TEST.EVAL_BATCH_SIZE=2"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from swinvox_tpu_torch.data.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("modes_data")
    generate_dataset(str(root), (6, 2, 0), 2)
    return str(root)


def _argv(root, out, *extra):
    argv = ["--dataset-root", root, "--out", str(out), "--platform", "cpu",
            *extra]
    for kv in NANO:
        argv += ["--set", kv]
    return argv


def test_runner_lr_find(root, tmp_path, monkeypatch):
    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.train import lr_finder

    seen = []
    real = lr_finder.suggest_lr
    monkeypatch.setattr(lr_finder, "suggest_lr", lambda lrs, losses: (
        seen.append((lrs, losses)), real(lrs, losses))[1])
    args = runner.get_args_from_command_line(
        ["--lr_find", "--weights", "w.ckpt"])
    assert args.lr_find and not runner.build_config(args).TRAIN.RESUME_TRAIN
    assert runner.main(_argv(root, tmp_path, "--lr_find", "--batch-size",
                             "2", "--set",
                             "LR_FINDER.NUM_BATCHES_TO_TEST=4")) == 0
    ((lrs, losses),) = seen
    assert len(lrs) == len(losses) == 4
    assert lrs == sorted(lrs) and lrs[0] == pytest.approx(1e-7)
    assert all(np.isfinite(losses))


def test_runner_tune(root, tmp_path):
    from swinvox_tpu_torch.cli import runner

    assert runner.main(_argv(root, tmp_path, "--tune", "--tune-trials", "2",
                             "--tune-epochs", "1")) == 0
    result = json.loads((tmp_path / "config_best.json").read_text())
    assert [t["number"] for t in result["trials"]] == [0, 1]
    for t in result["trials"]:
        assert t["state"] == "COMPLETE", t
        assert t["params"]["CONST.BATCH_SIZE"] in (32, 64)
        assert len(t["values"]) == 1
    assert result["best_value"] == max(t["values"][0]
                                       for t in result["trials"])


def test_runner_profile(root, tmp_path):
    from swinvox_tpu_torch.cli import runner

    args = runner.get_args_from_command_line(["--profile", "--out", "o"])
    assert runner.build_config(args).DIR.PROFILE_DIR == os.path.join(
        "o", "profile")
    assert runner.main(_argv(root, tmp_path, "--profile", "--batch-size",
                             "2", "--epoch", "1")) == 0
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    trace = json.loads((tmp_path / "profile" / traces[0]).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    (run,) = [d for d in os.listdir(tmp_path) if d != "profile"]
    assert sorted(os.listdir(tmp_path / run / "logs")) == [
        "train", "train.jsonl", "val", "val.jsonl"]


def test_event_files_match_jax_bytes(tmp_path, monkeypatch):
    from swinvox_tpu.utils import tb_writer as jax_tb

    from swinvox_tpu_torch.utils import tb_writer

    files = {}
    for name, mod in (("jax", jax_tb), ("port", tb_writer)):
        clock = iter(np.arange(1000.0, 1100.0, 0.25))  # the same clock
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        w = mod.EventFileWriter(str(tmp_path / name))
        for step, (tag, value) in enumerate([("Refiner/IoU", 0.25),
                                             ("EncoderDecoder/BatchLoss",
                                              1.5e-3), ("a/b", -7.0)]):
            w.add_scalar(tag, value, step * 37)
        w.add_image_png("Model00/GroundTruth", b"\x89PNG\r\n\x1a\n" + bytes(
            range(40)), 3, 16, 24)
        w.close()
        files[name] = w.path
    with open(files["jax"], "rb") as a, open(files["port"], "rb") as b:
        assert a.read() == b.read()
    assert os.path.basename(files["port"]).startswith("events.out.tfevents.")
    assert tb_writer._crc32c(b"123456789") == 0xE3069283  # CRC-32C check


def test_metrics_logger_writes_events_per_stream(tmp_path):
    from swinvox_tpu_torch.utils.metrics_logger import MetricsLogger

    for name in ("train", "val"):
        log = MetricsLogger(str(tmp_path), name)
        log.add_scalar("Refiner/IoU", 0.5, 3)
        log.close()
    assert sorted(os.listdir(tmp_path)) == ["train", "train.jsonl", "val",
                                            "val.jsonl"]
    (events,) = os.listdir(tmp_path / "train")
    data = (tmp_path / "train" / events).read_bytes()
    assert b"Refiner/IoU" in data and b"brain.Event:2" in data
    off = MetricsLogger(str(tmp_path / "off"), "test", tensorboard=False)
    off.close()
    assert os.listdir(tmp_path / "off") == ["test.jsonl"]


def test_every_port_module_imports_without_jax():
    """Every module of the port, the new entry points included, imports
    in a fresh interpreter with nothing of jax, flax or the JAX package
    loaded (conftest imports jax into this one)."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import swinvox_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            swinvox_tpu_torch.__path__, "swinvox_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"swinvox_tpu_torch.serve", "swinvox_tpu_torch.train.tune",
                "swinvox_tpu_torch.train.lr_finder",
                "swinvox_tpu_torch.models.pretrained",
                "swinvox_tpu_torch.data.device_augment",
                "swinvox_tpu_torch.utils.tb_writer"} <= set(names)
        bad = sorted(m for m in sys.modules if m.split(".")[0]
                     in ("jax", "jaxlib", "flax", "swinvox_tpu"))
        print("LOADED", len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
