"""The port's counterpart of ``examples/quickstart.py``: a synthetic
ShapeNet-format dataset, then ``runner`` in train mode on it with the
quickstart's overrides, then the validation IoU by epoch.

    python -m swinvox_tpu_torch.cli.quickstart --root DIR [--epochs 30] \
        [--train-samples 512] [--views 6] [--batch-size 16] [--n-views 3] \
        [--dtype bfloat16|float32] [--summary OUT.json] [--platform cuda] \
        [--nano]

The overrides are the quickstart's (docs/convergence/README.md, round 4):
``train-samples`` train and ``max(4, train-samples // 6)`` val and test
samples of one category, ``views`` renders each, LR 1e-4 for the encoder,
decoder and refiner and 3e-4 for the merger, the reference init, 8 loader
workers, seed 0.  At ``--dtype float32`` ``SwinVoxModel.from_config``
runs the plain paths of the kernels that take bf16 only (the Swin-block
kernels B, C, D and H, the merger stack E, F).  Only the best-IoU
checkpoint (about 1 GB) is written, under ``DIR/output``: give a ``DIR``
outside the repository.
The summary JSON holds the per-epoch train and validation losses, the
validation IoU, the epoch wall times and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time


def _scalars(path: str, tag: str, key: str = "value") -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if row["tag"] == tag:
                out[row["step"]] = row[key]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--n-views", type=int, default=3)
    parser.add_argument("--train-samples", type=int, default=512)
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16")
    parser.add_argument("--nano", action="store_true",
                        help="tiny backbone (Swin 1-1-1-1, ResNet 1-1-1) for "
                        "a CPU smoke run")
    parser.add_argument("--platform", default="cuda")
    parser.add_argument("--summary", default=None,
                        help="write the per-epoch readings here as JSON")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(levelname)s] %(asctime)s %(message)s")

    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.data.synthetic import generate_dataset

    data = os.path.join(args.root, "data")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(data, "taxonomy.json")):
        holdout = max(4, args.train_samples // 6)
        generate_dataset(data, (args.train_samples, holdout, holdout),
                         args.views)
    data_s = time.perf_counter() - t0
    out = os.path.join(args.root, "output", args.dtype)
    argv = ["--dataset-root", data, "--out", out, "--epoch",
            str(args.epochs), "--batch-size", str(args.batch_size),
            "--n-views", str(args.n_views), "--platform", args.platform]
    # SAVE_FREQ beyond the run: only the best-IoU checkpoint is written
    sets = {"CONST.NUM_WORKER": 8, "TRAIN.SAVE_FREQ": 10**6,
            "TRAIN.ENCODER_LEARNING_RATE": 1e-4,
            "TRAIN.DECODER_LEARNING_RATE": 1e-4,
            "TRAIN.REFINER_LEARNING_RATE": 1e-4,
            "TRAIN.MERGER_LEARNING_RATE": 3e-4,
            "NETWORK.INIT_SCHEME": "reference",
            "NETWORK.COMPUTE_DTYPE": args.dtype}
    if args.nano:
        sets["NETWORK.SWIN_DEPTHS"] = "[1,1,1,1]"
        sets["NETWORK.RESNET_STAGE_DEPTHS"] = "[1,1,1]"
    for key, value in sets.items():
        argv += ["--set", f"{key}={value}"]
    t0 = time.perf_counter()
    rc = runner.main(argv)
    train_s = time.perf_counter() - t0
    if rc != 0:
        return rc
    (run_dir,) = os.listdir(out)
    logs = os.path.join(out, run_dir, "logs")
    val = os.path.join(logs, "val.jsonl")
    iou = _scalars(val, "Refiner/IoU")
    ends = [t for _, t in sorted(_scalars(val, "Refiner/IoU", "ts").items())]
    summary = {
        "dtype": args.dtype, "epochs": args.epochs,
        "train_samples": args.train_samples, "views": args.views,
        "n_views": args.n_views, "batch_size": args.batch_size,
        "data_s": data_s, "train_s": train_s,
        # wall time from one validation's end to the next (train + val)
        "epoch_s": [b - a for a, b in zip(ends, ends[1:])],
        "val_iou": [iou[e] for e in sorted(iou)],
        "val_ed_loss": [v for _, v in sorted(_scalars(
            val, "EncoderDecoder/EpochLoss").items())],
        "train_ed_loss": [v for _, v in sorted(_scalars(
            os.path.join(logs, "train.jsonl"),
            "EncoderDecoder/EpochLoss").items())],
    }
    if args.platform.startswith("cuda"):
        import subprocess

        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    best = max(summary["val_iou"])
    logging.info("val IoU by epoch: %s; best %.4f at epoch %d",
                 ", ".join(f"{v:.4f}" for v in summary["val_iou"]), best,
                 summary["val_iou"].index(best) + 1)
    if args.summary:
        os.makedirs(os.path.dirname(os.path.abspath(args.summary)),
                    exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
