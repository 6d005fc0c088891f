"""CLI entry point of the port, counterpart of ``swinvox_tpu/cli/runner.py``:

  python -m swinvox_tpu_torch.cli.runner [--batch-size B] [--epoch E] \
      [--n-views N] [--weights W.ckpt] [--rand] [--profile] \
      [--set KEY=VALUE ...] [--config JSON] [--dataset-root DIR] \
      [--out DIR] [--platform cpu|cuda]
  python -m swinvox_tpu_torch.cli.runner --test --weights W.ckpt \
      [--n-views N] [--set KEY=VALUE ...] [--config JSON] \
      [--dataset-root DIR] [--out DIR] [--platform cpu|cuda]
  python -m swinvox_tpu_torch.cli.runner --lr_find [--batch-size B] ...
  python -m swinvox_tpu_torch.cli.runner --tune [--tune-trials 3] \
      [--tune-epochs 20] ...

Without ``--test`` it trains (``train_net``): ``--batch-size`` sets the
training batch ``CONST.BATCH_SIZE``, ``--epoch`` ``TRAIN.NUM_EPOCHS``,
``--rand`` draws ``CONST.RNG_SEED`` from the clock, and ``--weights``
resumes from a checkpoint (it sets ``TRAIN.RESUME_TRAIN``, as the JAX
runner does).  With ``--test`` it evaluates the checkpoint ``--weights``
(``test_net``) in batches of ``TEST.EVAL_BATCH_SIZE`` (``--set
TEST.EVAL_BATCH_SIZE=N``); ``--batch-size`` is refused there, so it is
never silently ignored.  Checkpoints are either package's files (full or
params-only).  ``--profile`` traces batches 2-6 of the first training
epoch into ``DIR.OUT_PATH/profile``.  ``--lr_find`` runs the learning-rate
range test (``train/lr_finder.py``: ``LR_FINDER.*``, the plot and the
suggestion); ``--tune`` (alias ``--optuna_tune``) the hyperparameter
study (``train/tune.py``: ``--tune-trials`` trials of ``--tune-epochs``
epochs, ``DIR.OUT_PATH/config_best.json``); under either, ``--weights``
does not resume.  The model runs on ``cuda`` unless ``--platform`` names
another device (``--platform cpu`` for a host-only run); there is no
silent fallback.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def get_args_from_command_line(argv=None):
    parser = argparse.ArgumentParser(description="SwinVox runner (PyTorch)")
    parser.add_argument("--test", dest="test", action="store_true",
                        help="test neural networks")
    parser.add_argument("--rand", dest="randomize", action="store_true",
                        help="randomize seed")
    parser.add_argument("--batch-size", dest="batch_size", default=None,
                        type=int, help="training batch (CONST.BATCH_SIZE)")
    parser.add_argument("--epoch", dest="epoch", default=None, type=int,
                        help="number of epochs")
    parser.add_argument("--lr_find", dest="lr_find", action="store_true",
                        help="run the learning-rate finder")
    parser.add_argument("--optuna_tune", "--tune", dest="tune",
                        action="store_true",
                        help="run hyperparameter tuning")
    parser.add_argument("--tune-trials", dest="tune_trials", default=3,
                        type=int, help="trials of --tune")
    parser.add_argument("--tune-epochs", dest="tune_epochs", default=20,
                        type=int, help="epochs of each --tune trial")
    parser.add_argument("--profile", dest="profile", action="store_true",
                        help="trace a few train steps with torch.profiler "
                        "into DIR.OUT_PATH/profile")
    parser.add_argument("--weights", dest="weights", default=None,
                        help="initialize network from a checkpoint")
    parser.add_argument("--out", dest="out_path", default=None,
                        help="output path")
    parser.add_argument("--n-views", dest="n_views", default=None, type=int,
                        help="number of rendering views")
    parser.add_argument("--config", dest="config_json", default=None,
                        help="JSON file of config overrides")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="dotted config override, e.g. "
                        "NETWORK.USE_MERGER=false")
    parser.add_argument("--dataset-root", dest="dataset_root", default=None,
                        help="root containing ShapeNetRendering/ "
                        "ShapeNetVox32/ and a taxonomy .json")
    parser.add_argument("--platform", dest="platform", default="cuda",
                        help="torch device to run on (default cuda; "
                        "'cpu' for a host-only run)")
    return parser.parse_args(argv)


def build_config(args):
    from swinvox_tpu_torch.config import default_config

    cfg = default_config()
    if args.config_json:
        with open(args.config_json) as f:
            cfg.update(json.load(f))
    if args.dataset_root:
        root = args.dataset_root
        tax = next((os.path.join(root, c) for c in ("taxonomy.json",
                                                     "ShapeNet.json")
                    if os.path.exists(os.path.join(root, c))), None)
        if tax is None:
            raise SystemExit(f"No taxonomy json found under {root}")
        paths = cfg.DATASETS.SHAPENET
        paths.TAXONOMY_FILE_PATH = tax
        paths.RENDERING_PATH = os.path.join(
            root, "ShapeNetRendering/%s/%s/rendering/%02d.png")
        paths.VOXEL_PATH = os.path.join(root,
                                        "ShapeNetVox32/%s/%s/model.binvox")
    if args.batch_size is not None:
        if args.test:
            raise SystemExit("--batch-size sets the training batch; the "
                             "evaluation batch is --set "
                             "TEST.EVAL_BATCH_SIZE=N")
        cfg.CONST.BATCH_SIZE = args.batch_size
    if args.epoch is not None:
        cfg.TRAIN.NUM_EPOCHS = args.epoch
    if args.n_views is not None:
        cfg.CONST.N_VIEWS_RENDERING = args.n_views
    if args.out_path is not None:
        cfg.DIR.OUT_PATH = args.out_path
    if args.weights is not None:
        cfg.CONST.WEIGHTS = args.weights
        if not (args.test or args.lr_find or args.tune):
            cfg.TRAIN.RESUME_TRAIN = True
    if args.profile:
        cfg.DIR.PROFILE_DIR = os.path.join(cfg.DIR.OUT_PATH, "profile")
    if args.randomize:
        cfg.CONST.RNG_SEED = int(time.time()) % (2**31)
    for ov in args.overrides:
        if "=" not in ov:
            raise SystemExit(f"--set expects KEY=VALUE, got {ov!r}")
        key, value = ov.split("=", 1)
        if value.lower() in ("true", "false"):
            parsed = value.lower() == "true"
        else:
            try:
                parsed = json.loads(value)  # ints, floats, lists
            except ValueError:
                parsed = value
        cfg.set(key, parsed)
    return cfg


def main(argv=None) -> int:
    logging.basicConfig(format="[%(levelname)s] %(asctime)s %(message)s",
                        level=logging.INFO)
    args = get_args_from_command_line(argv)
    cfg = build_config(args)
    cfg.validate()
    if args.lr_find:
        from swinvox_tpu_torch.train.lr_finder import find_lr

        find_lr(cfg, device=args.platform)
        return 0
    if args.tune:
        from swinvox_tpu_torch.train.tune import tune

        tune(cfg, n_trials=args.tune_trials, n_epochs=args.tune_epochs,
             device=args.platform)
        return 0
    if args.test:
        if not cfg.CONST.WEIGHTS:
            logging.error("Please specify the file path of checkpoint!")
            return 2
        from swinvox_tpu_torch.train.trainer import test_net

        test_net(cfg, device=args.platform)
        return 0
    from swinvox_tpu_torch.train.trainer import train_net

    train_net(cfg, device=args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
