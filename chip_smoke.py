#!/usr/bin/env python3
"""Drives the PyTorch + CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

It imports torch and swinvox_tpu_torch only.  Phases (any failure
raises, so the exit code is nonzero):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from ``swinvox_tpu_torch/csrc`` with nvcc (timed);
  3. kernel A (rewindow) against its plain version at every stage shape of
     serving batch 32, both signs: exact;
  4. kernel B (fused Swin block) against its plain version at the four
     stage shapes, aligned and shifted, bf16: its max-abs error against the
     f32 plain version must be <= 2 x the bf16 plain version's + 1e-2;
  5. build the full-width default-config SwinVoxModel (Swin-Tiny,
     ResNet-50, bf16) from a seed, wrap it in the port's Predictor and
     BatchingServer(batch_size=32), serve 32 concurrent 224^2 requests
     from 8 threads; each result is a finite [32,32,32] in [0, 1] equal to
     predictor.predict on the same images (exactly: the Predictor runs
     cuDNN deterministic); the launch counters advance by
     exactly 12 (B) and 7 (A) per served batch;
  6. one 3-view forward (CVA and merger in full) against the f32 plain
     path (USE_PALLAS_SWIN_BLOCK off, TF32 off) on the same weights:
     probabilities within max 0.1 and mean 5e-3 (bf16 drift through ~60
     layers measured 0.031 max, 0.0017 mean on an H100 80GB HBM3 at a
     700 W power limit);
  7. speed, at batch 32, 1 view: ``predict`` wall time over 20 calls;
     device time per forward with cuDNN deterministic (as ``Predictor``
     runs it) and with its default algorithms; device time per layer
     (CUDA events around the model's submodules) and a torch.profiler
     breakdown of one ``predict``; sustained serving throughput: 640
     requests queued at once, 20 full batches, 3 runs.

The weights use the "standard" init scheme: the reference scheme's x0.1
convs and N(0, 0.001) linears make every output exactly 0.5, which would
compare nothing.  The last two lines of stdout are the kernels' JSON and
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda:0"
SEED = 0
BATCH = 32
STAGES = [  # (side, channels, heads, blocks per forward: aligned, shifted)
    (56, 96, 3, 1, 1),
    (28, 192, 6, 1, 1),
    (14, 384, 12, 3, 3),
    (7, 768, 24, 2, 0),
]
# rewindow calls per forward: (side, channels, sign, count)
REWINDOW_CALLS = [(56, 96, -1, 1), (28, 192, -1, 1), (14, 384, -1, 3),
                  (14, 384, 1, 2)]
B_FLOOR = 1e-2
VIEW3_MAX = 0.1
VIEW3_MEAN = 5e-3
SERVE_REQUESTS = 640  # 20 full batches per sustained run


def log(*args) -> None:
    print(*args, flush=True)


def time_pair(torch, plain, kernel, iters=10):
    """ms per call of plain and kernel, measured plain, kernel, kernel,
    plain with CUDA events after a warm-up; each the mean of its two."""
    def one(fn):
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    p1, k1, k2, p2 = one(plain), one(kernel), one(kernel), one(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


@contextlib.contextmanager
def exact_f32(torch):
    """TF32 off for the float32 references, and back as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def predict_times(predictor, batch, calls):
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        predictor.predict(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def summary(values):
    """median, min and max, unrounded."""
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values)}


LAYERS = ("encoder.resnet", "encoder.swin", "encoder", "decoder", "merger",
          "refiner")


def layer_times(torch, model, x, repeats=5):
    """Device ms per forward of the whole model and of LAYERS (CUDA events
    from each submodule's pre-hook to its hook), median of ``repeats``
    after a warm-up, with the input already on the card."""
    events, hooks = {}, []

    def record(name, i):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.setdefault(name, [[], []])[i].append(ev)

    for name in ("",) + LAYERS:
        mod = model.get_submodule(name)
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, n=name or "model": record(n, 0)))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, n=name or "model": record(n, 1)))
    try:
        with torch.inference_mode():
            for _ in range(repeats + 1):
                model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {name: statistics.median(
        a.elapsed_time(b) for a, b in list(zip(starts, ends))[1:])
        for name, (starts, ends) in events.items()}


KERNEL_GROUPS = (  # (group, substring), first match wins
    ("kernel A (rewindow)", "rewindow_kernel"),
    ("kernel B attention", "attention_kernel"),
    ("kernel B GEMMs", "gemm_kernel<"),
    ("host-to-device copy", "Memcpy HtoD"),
    ("device-to-host copy", "Memcpy DtoH"),
    ("cuDNN convolutions", "conv"),
    ("cuDNN convolutions", "cudnn"),
    ("cuBLAS GEMMs", "gemm"),
)


def profile_predict(torch, predictor, batch):
    """Device time by kernel group over one ``predict`` and the busy share
    (device time / wall time).  Returns None if the profiler recorded no
    device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(batch)
        wall = (time.perf_counter() - t0) * 1e3
    groups = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name
        group = next((g for g, sub in KERNEL_GROUPS
                      if sub.lower() in name.lower()),
                     "other (elementwise, norms, copies)")
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
    if not groups:
        return None
    device = sum(groups.values())
    return {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


class _TimedPredictor:
    """Passes ``predict`` through and keeps each call's start and end."""

    def __init__(self, predictor):
        self.predictor, self.cfg, self.spans = predictor, predictor.cfg, []

    def predict(self, batch):
        t0 = time.perf_counter()
        out = self.predictor.predict(batch)
        self.spans.append((t0, time.perf_counter()))
        return out


def serve_sustained(server_cls, predictor, reqs, n_requests):
    """Throughput with a full queue: ``n_requests`` requests (the given
    ones, cyclically) queued at once from this thread, img/s from the
    first submit to the last result.  Also the dispatcher's split: ms
    inside ``predict`` per batch and ms between two batches' ``predict``
    calls (assembling the batch, handing out results), medians."""
    timed = _TimedPredictor(predictor)
    with server_cls(timed, batch_size=BATCH, max_wait_ms=5,
                    max_queue=n_requests) as server:
        t0 = time.perf_counter()
        futs = [server.submit(reqs[i % len(reqs)]) for i in range(n_requests)]
        submit_s = time.perf_counter() - t0
        for f in futs:
            f.result(timeout=600)
        seconds = time.perf_counter() - t0
        stats = server.stats()
    if stats["requests"] != n_requests:
        raise AssertionError(f"sustained run served {stats}")
    spans = timed.spans
    return {"img_per_s": n_requests / seconds, "seconds": seconds,
            "submit_s": submit_s, "batches": stats["batches"],
            "mean_batch_occupancy": stats["mean_batch_occupancy"],
            "predict_ms": statistics.median(
                (b - a) * 1e3 for a, b in spans),
            "between_ms": statistics.median(
                (spans[i + 1][0] - spans[i][1]) * 1e3
                for i in range(len(spans) - 1))}

def check_rewindow(torch, rw, dev, report):
    g = torch.Generator(device=dev).manual_seed(SEED)
    ms = plain_ms = worst = 0.0
    shapes = {}
    for side, c, sign, count in REWINDOW_CALLS:
        nw = side // 7
        x = torch.randn(BATCH * nw * nw, 49, c, device=dev, generator=g)
        x = x.bfloat16()
        for s in (-1, 1):
            got = rw.rewindow(x, nw, nw, 7, 3, s)
            ref = rw.rewindow_reference(x, nw, nw, 7, 3, s)
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
            if not torch.equal(got, ref):
                raise AssertionError(f"rewindow {side}^2 C{c} sign {s}: "
                                     "kernel != plain")
        p, k = time_pair(torch, lambda: rw.rewindow_reference(
            x, nw, nw, 7, 3, sign), lambda: rw.rewindow(x, nw, nw, 7, 3, sign))
        shapes[f"{side}x{side}xC{c} sign{sign:+d}"] = {
            "ms": k, "plain_ms": p, "calls_per_forward": count,
            "bytes_moved": 2 * x.numel() * x.element_size()}
        ms += count * k
        plain_ms += count * p
        log(f"rewindow {side}^2 C{c} sign {sign:+d}: exact; kernel {k:.4f} ms"
            f", plain {p:.4f} ms ({count}x per forward)")
    report["rewindow"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                          "shapes": shapes}


def check_swin_block(torch, blk, mask_fn, dev, report):
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    ms = plain_ms = 0.0
    worst = 0.0
    shapes = {}
    for side, c, heads, n_aligned, n_shifted in STAGES:
        nw = BATCH * (side // 7) ** 2

        def r(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        base = [r(nw, 49, c), 1 + r(c, s=0.1), r(c, s=0.1),
                r(c, 3 * c, s=c**-0.5), r(3 * c, s=0.1),
                r(c, c, s=c**-0.5), r(c, s=0.1), r(heads, 49, 49, s=0.5),
                None, 1 + r(c, s=0.1), r(c, s=0.1),
                r(c, 4 * c, s=c**-0.5), r(4 * c, s=0.1),
                r(4 * c, c, s=(4 * c)**-0.5), r(c, s=0.1)]
        for shifted, count in ((False, n_aligned), (True, n_shifted)):
            f32 = list(base)
            if shifted:
                f32[8] = torch.from_numpy(mask_fn(side, side, 7, 3)).to(dev)
            bf = list(f32)
            for i in (0, 3, 5, 11, 13):  # tokens and the four weights
                bf[i] = f32[i].bfloat16()
            with exact_f32(torch):
                ref = blk.swin_block_reference(*f32, num_heads=heads)
            plain = blk.swin_block_reference(*bf, num_heads=heads)
            got = blk.fused_swin_block(*bf, num_heads=heads)
            torch.cuda.synchronize()
            err_k = (got.float() - ref).abs().max().item()
            err_p = (plain.float() - ref).abs().max().item()
            kb = (got.float() - plain.float()).abs().max().item()
            name = f"{side}x{side}xC{c} {'shifted' if shifted else 'aligned'}"
            log(f"swin block {name}: |kernel-f32| {err_k:.6g}, "
                f"|bf16 plain-f32| {err_p:.6g}, |kernel-bf16 plain| {kb:.6g},"
                f" bound {2 * err_p + B_FLOOR:.6g}")
            if not np.isfinite(err_k) or err_k > 2 * err_p + B_FLOOR:
                raise AssertionError(f"swin block {name}: kernel error "
                                     f"{err_k} > 2 x {err_p} + {B_FLOOR}")
            worst = max(worst, err_k)
            p, k = time_pair(
                torch, lambda: blk.swin_block_reference(*bf, num_heads=heads),
                lambda: blk.fused_swin_block(*bf, num_heads=heads), iters=5)
            tokens = nw * 49
            flop = tokens * (24 * c * c + 4 * 49 * c)
            shapes[name] = {"ms": k, "plain_ms": p, "calls_per_forward": count,
                            "err_kernel_vs_f32": err_k,
                            "err_bf16_plain_vs_f32": err_p,
                            "gflop": flop / 1e9,
                            "kernel_tflops": flop / k / 1e9}
            log(f"  kernel {k:.4f} ms ({flop / k / 1e9:.1f} TFLOP/s), "
                f"plain {p:.4f} ms ({count}x per forward)")
            ms += count * k
            plain_ms += count * p
            del ref, plain, got
    report["fused_swin_block"] = {"max_abs_err": worst, "ms": ms,
                                  "plain_ms": plain_ms, "shapes": shapes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.kernels import build
    from swinvox_tpu_torch.models.swin import shifted_window_mask
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.ops import pallas_swin_block as blk
    from swinvox_tpu_torch.ops import rewindow as rw
    from swinvox_tpu_torch.serve import BatchingServer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")
    report = {"card": card, "kind": kind}

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {so.name} in {report['build_s']:.1f} s")
    ptxas = so.with_suffix(".log").read_text()
    log("\n".join(ln for ln in ptxas.splitlines()
                  if "registers" in ln or "spill" in ln))

    # ---- 3./4. kernels against their plain versions ----------------------
    check_rewindow(torch, rw, dev, report)
    check_swin_block(torch, blk, shifted_window_mask, dev, report)

    # ---- 5. serve ----------------------------------------------------------
    cfg = default_config()
    cfg.NETWORK.INIT_SCHEME = "standard"
    net = cfg.NETWORK
    if not (net.COMPUTE_DTYPE == "bfloat16" and net.USE_PALLAS_SWIN_BLOCK
            and net.USE_REWINDOW_CHAIN):
        raise AssertionError("the default config no longer serves bf16 "
                             "through both kernels")
    model = SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, dev, cfg)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    warm = predictor.predict(
        rng.standard_normal((BATCH, 1, 224, 224, 3)).astype(np.float32))
    report["first_batch_s"] = time.perf_counter() - t0
    if not np.all(np.isfinite(warm)):
        raise AssertionError("warm-up batch is not finite")
    log(f"model: {n_params} params; first batch {report['first_batch_s']:.2f}"
        " s")

    reqs = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
            for _ in range(BATCH)]
    rw.rewindow.launches = 0
    blk.fused_swin_block.launches = 0
    with BatchingServer(predictor, batch_size=BATCH, max_wait_ms=50) as server:
        with ThreadPoolExecutor(8) as pool:
            futs = list(pool.map(server.submit, reqs))
        outs = [f.result(timeout=600) for f in futs]
        stats = server.stats()
    launches = {"rewindow": rw.rewindow.launches,
                "fused_swin_block": blk.fused_swin_block.launches}
    batches = stats["batches"]
    log(f"served {stats['requests']} requests in {batches} batch(es); "
        f"launches {launches}")
    if stats["requests"] != len(reqs) or batches < 1:
        raise AssertionError(f"server stats {stats}")
    if launches != {"rewindow": 7 * batches,
                    "fused_swin_block": 12 * batches}:
        raise AssertionError(f"launch counts {launches} for {batches} "
                             "batch(es): want 7 and 12 per batch")
    batch = np.stack(reqs)
    direct = predictor.predict(batch)
    for out in outs:
        if out.shape != (32, 32, 32) or not np.all(np.isfinite(out)):
            raise AssertionError(f"bad result {out.shape}")
        if out.min() < 0 or out.max() > 1:
            raise AssertionError("probabilities outside [0, 1]")
    serve_err = max(float(np.abs(o - d).max()) for o, d in zip(outs, direct))
    log(f"served == predictor.predict: max abs diff {serve_err:.6g}")
    if serve_err != 0.0:
        raise AssertionError("served results differ from predictor.predict")
    report["serve"] = {"batches": batches, "launches": launches,
                       "max_abs_diff_vs_predict": serve_err,
                       "prob_std": float(np.std(direct))}

    # ---- 6. three views: CVA and merger in full, against f32 plain --------
    x3 = rng.standard_normal((2, 3, 224, 224, 3)).astype(np.float32)
    p3 = predictor.predict(x3)
    cfg32 = default_config()
    cfg32.NETWORK.COMPUTE_DTYPE = "float32"
    cfg32.NETWORK.USE_PALLAS_SWIN_BLOCK = False
    cfg32.NETWORK.USE_PALLAS_WINDOW_ATTENTION = False
    cfg32.NETWORK.INIT_SCHEME = "standard"
    ref_model = SwinVoxModel.from_config(cfg32)
    ref_model.load_state_dict(model.state_dict())
    with exact_f32(torch):
        r3 = Predictor(ref_model, dev, cfg32).predict(x3)
    err3 = float(np.abs(p3 - r3).max())
    mean3 = float(np.abs(p3 - r3).mean())
    log(f"3-view forward {p3.shape}: |bf16 kernels - f32 plain| max "
        f"{err3:.6g} (bound {VIEW3_MAX}), mean {mean3:.6g} (bound "
        f"{VIEW3_MEAN}); prob std {float(r3.std()):.4f}")
    if p3.shape != (2, 32, 32, 32) or not np.all(np.isfinite(p3)):
        raise AssertionError("3-view result malformed")
    if err3 > VIEW3_MAX or mean3 > VIEW3_MEAN or r3.std() < 1e-2:
        raise AssertionError("3-view result disagrees with the f32 path")
    report["view3"] = {"max_abs_diff_vs_f32_plain": err3,
                       "mean_abs_diff_vs_f32_plain": mean3,
                       "prob_std": float(r3.std())}
    del ref_model

    # ---- 7. speed at batch 32, 1 view --------------------------------------
    wall = predict_times(predictor, batch, 20)
    speed = {"predict_ms": summary(wall)}
    log(f"predict batch {BATCH} wall ms (median, min-max of {len(wall)}): "
        f"{speed['predict_ms']['median']:.3f} ({min(wall):.3f}-"
        f"{max(wall):.3f}); on {card}")

    x_dev = torch.from_numpy(batch).to(dev)

    def forward(deterministic):
        torch.backends.cudnn.deterministic = deterministic
        with torch.inference_mode():
            model(x_dev)

    cudnn_det = torch.backends.cudnn.deterministic
    try:
        default_ms, det_ms = time_pair(torch, lambda: forward(False),
                                       lambda: forward(True))
        torch.backends.cudnn.deterministic = True
        speed["layer_device_ms"] = layer_times(torch, model, x_dev)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    speed["forward_device_ms"] = {"cudnn_deterministic": det_ms,
                                  "cudnn_default": default_ms}
    log(f"forward device ms, cuDNN deterministic (as Predictor runs it) "
        f"{det_ms:.3f}, default algorithms {default_ms:.3f}")
    log("device ms per forward (CUDA events, median of 5): " + ", ".join(
        f"{k} {v:.3f}" for k, v in speed["layer_device_ms"].items()))
    prof = profile_predict(torch, predictor, batch)
    speed["profile_one_predict"] = prof
    if prof is None:
        log("profiler: no device events recorded; breakdown not measured")
    else:
        log(f"profiler over one predict: wall {prof['wall_ms']:.3f} ms, "
            f"device {prof['device_ms']:.3f} ms, busy share "
            f"{prof['busy_share']:.3f}; " + ", ".join(
                f"{k} {v:.3f}" for k, v in prof["groups_ms"].items()))

    runs = [serve_sustained(BatchingServer, predictor, reqs, SERVE_REQUESTS)
            for _ in range(3)]
    rates = [r["img_per_s"] for r in runs]
    speed["served_img_per_s"] = summary(rates)
    speed["served_runs"] = runs
    speed["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["speed"] = speed
    log(f"served {SERVE_REQUESTS} requests queued at once, 3 runs: "
        f"{', '.join(f'{r:.1f}' for r in rates)} img/s (median "
        f"{statistics.median(rates):.1f}); per run: batches, occupancy, "
        "dispatcher ms inside predict / between predicts (medians): "
        + "; ".join(f"{r['batches']}, {r['mean_batch_occupancy']:.2f}, "
                    f"{r['predict_ms']:.2f} / {r['between_ms']:.2f}"
                    for r in runs) + f"; on {card}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernels = []
    for name, src, replaces in (
        ("rewindow", "swinvox_tpu_torch/csrc/rewindow.cu",
         "swinvox_tpu/ops/rewindow.py:71"),
        ("fused_swin_block", "swinvox_tpu_torch/csrc/swin_block.cu",
         "swinvox_tpu/ops/pallas_swin_block.py:58"),
    ):
        r = report[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
