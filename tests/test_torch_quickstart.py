"""The port's quickstart (``swinvox_tpu_torch.cli.quickstart``) end to end
on the CPU at nano depths: a synthetic dataset, one epoch of ``runner`` in
train mode, and the per-epoch summary it writes."""

import json

from swinvox_tpu_torch.cli import quickstart


def test_quickstart_trains_and_summarises(tmp_path):
    out = tmp_path / "summary.json"
    rc = quickstart.main([
        "--root", str(tmp_path / "run"), "--epochs", "1", "--batch-size",
        "2", "--n-views", "2", "--train-samples", "4", "--views", "2",
        "--dtype", "float32", "--nano", "--platform", "cpu", "--summary",
        str(out)])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["epochs"] == 1 and s["dtype"] == "float32"
    assert len(s["val_iou"]) == 1 and 0.0 <= s["val_iou"][0] <= 1.0
    assert len(s["train_ed_loss"]) == 1 and s["train_ed_loss"][0] > 0
    # only the best-IoU checkpoint: SAVE_FREQ is larger than the run
    (ckpts,) = [p for p in (tmp_path / "run").rglob("checkpoints")]
    assert [p.name for p in ckpts.iterdir()] == ["checkpoint-best.ckpt"]
