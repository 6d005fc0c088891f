#!/usr/bin/env python3
"""Drives the PyTorch + CUDA port's serving path, training step,
evaluation entry point, training entry point and front ends on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card
    python3 chip_smoke.py --eval-only   # phases 1, 2 and 14 only
    python3 chip_smoke.py --front-ends  # phases 1, 2 and 17 only
    python3 chip_smoke.py --merger-stack  # phases 1, 2, 9 and two steps
    python3 chip_smoke.py --merger-conv   # phases 1, 2, I, J and two runs
    python3 chip_smoke.py --wmsa-down1    # phases 1, 2, H, L and two runs
    python3 chip_smoke.py --rewindow-wattn  # phases 1, 2, A, G and the step

``--eval-only`` re-reads the evaluation gates alone, e.g. on a copy of
the sources with a fault planted in a kernel, in a third of the time.
``--merger-stack`` runs phase 9 and the profiler's device time of one
kernel-path training step at batch 32 / 1 view and batch 16 / 3 views,
the readings of kernels E and F alone (about a minute).
``--merger-conv`` runs kernel I's check of phase 13 and kernel J's part
of phase 15 (each with its device time by the profiler beside its events
time, and two calls on the same inputs bit for bit), then the
profiler's device time of one ``train-slab`` step (3 views, batch 8:
J 12, K 6, L 1) and one ``eval-merger`` forward (24 images: I 1), the
readings of kernels I and J alone.  ``--wmsa-down1`` runs kernel H's
check of phase 13 and kernel L's part of phase 15 (each with its device
time by launch group or launch beside its events time, its library
yardstick and two calls bit for bit), then the profiler's device time
of one ``train-slab`` step (L 1) and one ``eval-wmsa`` forward (H 12),
the readings of kernels H and L alone.  ``--rewindow-wattn`` runs kernel
A's check of phase 3 and kernel G's of phase 13, each with the
profiler's device time of a forward's calls (A's 7, G's 12) beside its
events time and its library yardstick (``index_select``, SDPA), then
``gradient_repeats`` in the default mode for the default flags and for
``train-slab``'s (where a gradient differs, again under each global
mode of DET_MODES, which names the setting that makes it repeat), and
the batch-32 1-view step run in turns as it is and under
``torch.use_deterministic_algorithms(True)`` with cuDNN's deterministic
algorithms: wall medians, and one profiled step of each by op (self host
and device ms, calls) and by kernel, with the ops whose time grows; it
sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before cuBLAS starts, which that
mode requires.  ``--front-ends`` runs phase 17 alone (about 1.5 minutes).

It imports torch and swinvox_tpu_torch only.  Phases (any failure
raises, so the exit code is nonzero):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from ``swinvox_tpu_torch/csrc`` with nvcc (timed);
  3. kernel A (rewindow) against its plain version at every shape the JAX
     chain relayouts at serving batch 32, both signs, forward and
     backward: exact; ms of a forward's 7 calls by events and their
     device ms (profiler).  No model
     path launches A: the port's chain stays in the aligned layout, and a
     shifted block's kernels (B, C, D) read and write its windows through
     the roll's map;
  4. kernel B (fused Swin block) against its plain version at the four
     stage shapes, aligned and shifted (aligned tokens, the attention over
     the shifted windows through the map), bf16: its max-abs error against
     the f32 plain version must be <= 2 x the bf16 plain version's + 1e-2;
  5. build the full-width default-config SwinVoxModel (Swin-Tiny,
     ResNet-50, bf16) from a seed, wrap it in the port's Predictor and
     BatchingServer(batch_size=32), serve 32 concurrent 224^2 requests
     from 8 threads; each result is a finite [32,32,32] in [0, 1] equal to
     predictor.predict on the same images (exactly: the Predictor runs
     cuDNN deterministic); the launch counters advance by
     exactly 12 (B) and 0 (A) per served batch;
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
     requests queued at once, 20 full batches, 3 runs;
  8. kernels C and D (training Swin block forward and backward) against
     their plain version (autograd through plain ops) at the four stage
     shapes of batch 32, aligned and shifted, with drop-path factors 0, 1
     and 1/0.9: output and dx by max-abs error against the f32 plain
     version, each parameter gradient by relative L2, each within 2 x the
     bf16 plain version's error + 1e-2; ms per call beside the plain's,
     and D's achieved TFLOP/s and GB/s (of its own bytes) per stage shape
     and its device time by kernel group (KERNEL_GROUPS) over one call;
  9. kernels E and F (merger stack forward and backward) against their
     plain version at N = 32 and N = 48, forward and backward, by the
     same rule: raw5, means and variances by max-abs; dx, dW, db, dgamma
     and dbeta by relative L2 (the conv biases of layers 0..4 feed a
     train-mode BatchNorm, so their true gradient is 0: their error is
     taken relative to the same layer's dbeta); E and F called twice on
     the same inputs give the same bits; the device time of one E and
     one F call by launch group (MERGER_GROUPS, profiler);
 10. the training step of the full-width default config at batch 32, 1
     view, through create_train_state / make_train_step: from one state
     and one dropout seed, one step on three paths — bf16 with kernels,
     bf16 plain (train kernels off), f32 plain (TF32 off); the kernel
     path's loss within 2 x the bf16 plain path's distance from f32 +
     LOSS_FLOOR, each module's gradient (relative L2) within 2 x +
     GRAD_FLOOR; launch counts per step C 12, D 12, A 0, E 1, F 0.  Each
     of the kernel path's 12 Swin-block calls is recorded (inputs, drop-
     path factors, the gradient reaching its output, and what kernel D
     sent back to each input) and held against the bf16 and f32 plain
     blocks run on those same inputs: phase 8's rule, and each of the
     step's gradients within STEP_VS_PLAIN (relative L2) of the bf16
     plain block's.  A fourth path, f32 plain on images perturbed by
     1e-3 relative noise, reads how far the gradients move with their
     input alone (the network's sensitivity, which sets the bf16 paths'
     distance from f32 in the encoder).  Then ten more steps on the
     same batch and dropout masks: every loss finite, the last below the
     first;
 11. one step at batch 16, 3 views (merger stack engaged: E 1, F 1), held
     as in phase 10; the step's merger-stack call is recorded and held
     against the plain stack on its inputs by phase 9's rule; then the
     kernel path's device time of one such step (profiler, by kernel
     group, after two warm-up steps);
 12. training speed at batch 32, 1 view: step wall time over 20 steps, a
     profiler breakdown of one step by kernel group (KERNEL_GROUPS: D's
     GEMMs, GEMMs with the LayerNorm backward, LayerNorm and sums, and
     attention apart; K's weight gradient apart from F's) with the busy
     share, peak device memory;
 13. kernels G (window-attention core) and H (fused W-MSA) against their
     plain versions at the four stage shapes of one evaluation forward (24
     images: TEST.EVAL_BATCH_SIZE 8 x 3 views), masked and unmasked, and
     kernel I (inference merger) at 24 volumes, by phase 4's rule (max-abs
     error against the f32 plain version <= 2 x the bf16 plain version's
     + 1e-2); ms per forward beside the plain's (G's 12 calls also by
     their device ms, profiler), and the library
     yardsticks, for G ``F.scaled_dot_product_attention`` with the bias
     and mask as ``attn_mask``, for H ``F.multi_head_attention_forward``
     with the bias and mask summed into a float ``attn_mask``; H and I
     also called twice on the same inputs (the same bits), H's device
     time per call split into its GEMMs and its attention and I's per
     layer launch (profiler);
 14. the evaluation entry point: a synthetic ShapeNet-format fixture (48
     test samples of 2 categories, 3 views), the full-width default
     model's standard-init weights written by ``save_params_only``, then
     ``runner --test --weights W --n-views 3`` in-process in five
     configurations: ``default`` (kernels A and B, merger as plain convs),
     ``eval-merger`` (+ kernel I), ``eval-wmsa`` (kernels H and I, no
     block kernel), and the bf16 and f32 plain configurations (no kernel;
     f32 is COMPUTE_DTYPE float32 with the default flags, which
     ``SwinVoxModel.from_config`` resolves to the plain paths; TF32
     off).  Launch counts per forward: A 0, B 12 (default, eval-merger),
     I 1 (eval-merger, eval-wmsa), H 12 (eval-wmsa), none in the plain
     ones.  Each kernel configuration's per-sample
     probability volumes lie within 2 x the bf16 plain configuration's
     max-abs distance from the f32 plain one and EVAL_MEAN_RATIO x its
     mean-abs distance, and every kernel call of each run is held
     against the plain version on its own inputs (phase 4's rule); the
     checkpoint's merger running statistics are moved off their init so
     kernel I's folded BatchNorm is exercised.  Each run's IoU,
     ``evaluate`` wall, samples/s (a smoke reading: 48 samples) and
     forward stream ms are printed; every failure is reported at the
     end of the phase;
 15. kernels J and K (one merger conv forward and its weight gradient,
     ``ops/pallas_band_conv.py``) at the 24 volumes of a 3-view batch-8
     step, for every (ci, co) that step runs: (9, 9), (36, 9), (9, 1) and
     J's adjoints (9, 36), (1, 9); kernel L (the refiner's down1
     backward, ``ops/pallas_down1.py``) at 8 volumes; each in bf16 and
     f32 against its plain version on the same inputs (TF32 off):
     relative L2 <= REL_TOL (1e-2 for a bf16 output, 1e-4 for f32) and,
     for J and L's dx, phase 4's rule against the f32 plain version; K
     and L launched twice on the same inputs give the same bits (their
     sums are fixed-order partials, no atomics), and J too (each output
     voxel has one writer); ms (CUDA events), and for J in bf16 and L in
     both types the device ms of one call (profiler; L's by launch), per
     call of the kernel, the plain version and one library call
     (``F.conv3d``, ``torch.nn.grad.conv3d_weight``,
     ``aten.convolution_backward``, bf16, unused by the port), summed over
     a step's 12 J, 6 K and 1 L calls; K and L also in f32 (their
     CUDA-core routes) beside ``conv3d_weight`` and
     ``convolution_backward`` in f32 with TF32 off and their f32 bounds;
 16. the training entry point, ``runner`` in train mode in-process, at
     full width on a synthetic fixture (48 train and 16 val samples, 2
     categories, 3 views), 2 epochs with validation each epoch and
     SAVE_FREQ 1, in three configurations: ``train-slab``
     (USE_SLAB_MERGER, REFINER_DOWN1_PALLAS) and ``train-band``
     (USE_PALLAS_MERGER_TRAIN, REFINER_DOWN1_PALLAS) at batch 8 (24
     volumes: not the merger stack), ``train-default`` at batch 16 (48
     volumes: kernels E and F).  Launch counts per run from the config
     (per step C 12, D 12, and J 12, K 6 on the two kernel routes, L 1
     with REFINER_DOWN1_PALLAS, E 1 and F 1 on the stack; per validation
     forward B 12, and J 6 on the slab route; A 0 everywhere); batch
     losses finite; every J, K and L call of the slab and band runs held
     against the plain version on its own inputs (phase 15's rules), and
     every E and F call of ``train-default`` against the plain stack on
     its own inputs and output gradient (phase 9's rule).
     Then ``train-slab`` resumes from its epoch-1 checkpoint (its
     epoch_idx set to 1: the JAX package's resume starts again at the
     epoch a checkpoint was saved after) and runs epoch 2 again, with the
     default train step (which repeats its own bits): its batch losses
     within RESUME_LOSS_RTOL, its epoch-2 weights and BatchNorm
     statistics within RESUME_STATE_RTOL and every module's Adam moments
     within DET_MOMENTS_RTOL (per module, relative L2) of the
     uninterrupted run's, and its epoch-2 checkpoint read back by the
     port's ``load_checkpoint`` into a TrainState exactly.  The bisection
     beside it: two default forward-backward passes of one full-width
     state on one batch (``train-slab``'s flags), every parameter's
     gradient compared bit for bit; none may differ, and the first
     module that does is named.  CUBLAS_WORKSPACE_CONFIG is not set, as
     in a user's run.  Last, the
     quickstart (``cli/quickstart.py``: runner train mode, one epoch with
     validation) at COMPUTE_DTYPE float32 with the default flags: the
     resolved kernel routes (all plain) and the launches (none).  Step
     wall (median after the first), epoch and ``evaluate`` walls are
     smoke readings;
 17. the front ends, each through its entry point at full width on a
     synthetic fixture (64 train and 16 val samples, 2 categories, 3
     views), every B, C, D, E and F call of each held against its plain
     version on its own inputs (phase 4's, 10's and 9's rules; a call
     recorded for each launch) and the launches of each equal to what
     its config gives: HTTP serving (``serve.main`` in-process: a
     MultiServer of two checkpoints written by the port on 127.0.0.1,
     port 0, batch 8 at 3 views; HTTP_REQUESTS requests of 1 and 3 views
     from HTTP_THREADS threads of a client process (``http_client``)
     after a warm-up request a model; each response exactly its row of a
     batch its model ran, ``Predictor.predict`` of each such batch
     repeating its bits, the request in another batch and slot within
     VIEW3_MAX, the other model's result more than HTTP_MODELS_APART
     away; 404 for an unknown model, 503 under a full queue and 504 past
     ``timeout_ms`` from gated servers around the same predictor;
     latency median and p99, requests/s, the dispatchers' ``predict``
     ms); ``runner --lr_find`` (LR_STEPS steps at batch 16, 1 view:
     finite smoothed losses, the suggestion, steps/s recorded and, in a
     second run, unrecorded);
     ``runner --tune`` (2 trials of 1 epoch, 1 view: no trial FAILED,
     ``config_best.json``); ``runner`` training one epoch at batch 16, 3
     views under ``TRAIN.DEVICE_AUGMENT`` with ``--profile`` (the first
     batch's augmented images against the host transform of the same
     draws within atol 3e-4, rtol 1e-4; the trace written), then the
     same epoch unrecorded with the augmentation on the card and with the
     host transform (iteration walls); ``create_train_state`` with
     ``NETWORK.PRETRAINED_BACKBONE`` on fake backbone files of the real
     shapes (every grafted tensor equal to its source) and one step from
     it; ``runner --test`` on generated Pix3D and Pascal3D fixtures.

Phases 14, 16 and 17 write their fixtures and checkpoints under a fresh
temporary directory outside the repo (``tempfile.mkdtemp``), removed at
the end even on failure; the script leaves nothing in the repo but
``chiprun_out/chip_smoke.json``.  Phase 16 writes seven full checkpoints
of about 1 GB (two per uninterrupted run at SAVE_FREQ 1, one for the
resumed epoch) and the resume copy, at most two on disk at once: each
run's are deleted before the next.

Kernel G is reached only through ``window_attention(use_pallas=True)``,
as its TPU kernel is in the JAX package: no model path launches it, so
its row reports 0 launches; kernel H runs three of kernel B's launches
(``swinvox_fused_msa`` in ``csrc/swin_block.cu``).

The weights use the "standard" init scheme: the reference scheme's x0.1
convs and N(0, 0.001) linears make every output exactly 0.5, which would
compare nothing.  The last two lines of stdout are the kernels' JSON and
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.

Each kernel's ``bound_ms`` is the larger of its FLOPs over the card's
989 TFLOP/s (bf16 operands) and its bytes over 3.35 TB/s, at the calls of
one main-path step: per serving forward for A and B, per 1-view train
step for C, D and E, per 3-view train step for F, per 3-view batch-8
train step for J, K and L; ``ms`` and
``plain_ms`` cover the same calls.  Bytes are the function's own: each
input read once and each output written once (weights included, vectors
of C elements left out).  What one kernel saves for another (kernel C's
intermediates for D) is not counted: that is the cost of saving instead
of recomputing, reported beside the bound.  ``max_abs_err`` is the
kernel's largest max-abs error against the f32 plain version (for the
backward kernels, that of dx); ``rel_l2_err`` the largest relative L2
error of its gradients, where it has any.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# the JAX chain's rewindow calls per forward, kernel A's shapes: (side,
# channels, sign, count)
REWINDOW_CALLS = [(56, 96, -1, 1), (28, 192, -1, 1), (14, 384, -1, 3),
                  (14, 384, 1, 2)]
B_FLOOR = 1e-2
VIEW3_MAX = 0.1
VIEW3_MEAN = 5e-3
SERVE_REQUESTS = 640  # 20 full batches per sustained run
PEAK_BF16 = 989e12    # H100 SXM dense bf16, FLOP/s
PEAK_F32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
HBM = 3.35e12         # H100 SXM bytes/s
DP_FACTORS = (0.0, 1.0, 1.0 / 0.9)  # drop-path factors of one image
# |loss - f32 loss| allowed beyond 2 x the bf16 plain path's: the bf16
# paths' loss distances from f32 read 2.80e-4 and 2.87e-4 at 1 view,
# 3.6e-5 and 1.4e-5 at 3 views (H100, 700 W), so a bf16 plain path that
# lands near f32 by chance still leaves room for the kernel path's own
LOSS_FLOOR = 3e-4
GRAD_FLOOR = 1e-2     # relative L2 allowed beyond 2 x bf16 plain's
# a step's Swin-block gradients (relative L2) from the bf16 plain block's
# on the same inputs: they read at most 5.65e-3 in the step and 4.78e-3
# in phase 8 (H100, 700 W); a zero or sign-flipped gradient reads 1 or 2
STEP_VS_PLAIN = 1.5e-2
PERTURB = 1e-3        # relative noise on the images of the sensitivity path
TRAIN_STEPS = 10
SPEED_STEPS = 20
TRAIN3 = (16, 3)      # (batch, views) of the merger-stack step: 48 volumes
EVAL_VIEWS = 3
EVAL_IMAGES = 8 * EVAL_VIEWS   # TEST.EVAL_BATCH_SIZE 8 x 3 views per forward
EVAL_SAMPLES = 48              # test samples of the fixture, 2 categories
EVAL_CATEGORIES = (("02691156", "aeroplane"), ("03001627", "chair"))
# per-sample probabilities of a kernel configuration against the f32 plain
# configuration: max-abs within 2 x the bf16 plain configuration's, mean-abs
# within EVAL_MEAN_RATIO x its.  Readings (H100, 700 W): kernel
# configurations 0.70-0.78 x its max-abs and 0.97-1.00 x its mean-abs; the
# attention mask taken from the next window, planted in kernels B and H,
# read 1.73-1.76 x and 1.53-1.54 x (passes the max-abs gate, fails this one)
EVAL_MEAN_RATIO = 1.25
# phases 15-16: a 3-view training step at batch 8 gives the merger 24
# volumes (not a multiple of 16, so not the stack) and the refiner 8
TRAIN_VIEWS = 3
TRAIN_VOLUMES = 8 * TRAIN_VIEWS
DOWN1_VOLUMES = 8
# kernel J's calls per step, (ci, co): the six convs forward and their
# input gradients (the adjoint kernels); kernel K's: the six weight grads
J_STEP = ((9, 9),) * 4 + ((36, 9), (9, 1)) + ((9, 9),) * 4 + ((9, 36), (1, 9))
K_STEP = ((9, 9),) * 4 + ((36, 9), (9, 1))
# relative L2 of a kernel output to its plain version on the same inputs:
# the same exact products summed in another order, rounded once to the
# output type (bf16: one-ulp differences)
REL_TOL = {"bf16": 1e-2, "f32": 1e-4}
TRAIN_SAMPLES = 48             # train fixture samples, 2 categories
VAL_SAMPLES = 16
TRAIN_EPOCHS = 2
TRAIN_CONFIGS = {  # (batch, NETWORK flags beyond the defaults)
    "train-slab": (8, {"USE_SLAB_MERGER": True,
                       "REFINER_DOWN1_PALLAS": True}),
    "train-band": (8, {"USE_PALLAS_MERGER_TRAIN": True,
                       "REFINER_DOWN1_PALLAS": True}),
    "train-default": (16, {}),
}
# train-slab resumed at epoch 2 against its uninterrupted run: the batch
# losses within RESUME_LOSS_RTOL (relative), the epoch-2 weights and
# BatchNorm statistics within RESUME_STATE_RTOL (relative L2 per module),
# and every module's Adam moments within DET_MOMENTS_RTOL.  The train
# step repeats its own bits (cuDNN's deterministic algorithms, the bias
# table's fixed-order gradient), so all three read 0 on an H100; before
# it did, a nondeterministic conv backward moved the encoder's first
# moment 0.85 relative L2 apart while losses and weights stayed within
# 6.6e-4 and 7.8e-4, so the moments are the reading that catches a step
# that stops repeating
RESUME_LOSS_RTOL = 5e-3
RESUME_STATE_RTOL = 1e-2
DET_MOMENTS_RTOL = 1e-6
EVAL_CONFIGS = {  # NETWORK flags beyond the defaults
    "default": {},
    "eval-merger": {"USE_PALLAS_MERGER": True},
    "eval-wmsa": {"USE_PALLAS_MERGER": True, "USE_PALLAS_SWIN_BLOCK": False},
    "bf16 plain": {"USE_PALLAS_SWIN_BLOCK": False,
                   "USE_PALLAS_WINDOW_ATTENTION": False},
    # the default flags: SwinVoxModel.from_config resolves float32 to the
    # plain paths of the bf16-only kernels
    "f32 plain": {"COMPUTE_DTYPE": "float32"},
}


def log(*args) -> None:
    print(*args, flush=True)


def time_pair(torch, plain, kernel, iters=10, loops=3):
    """ms per call of plain and kernel, measured plain, kernel, kernel,
    plain after a warm-up: CUDA events around each of ``loops`` loops of
    ``iters`` back-to-back calls (which keep the card's queue ahead of the
    host), and the median of each one's 2 x ``loops`` loop means.  A host
    stall inside one loop moves that loop's mean; the median leaves it
    out."""
    def one(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(loops)]
        for start, end in events:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
        torch.cuda.synchronize()
        return [start.elapsed_time(end) / iters for start, end in events]

    p1, k1, k2, p2 = one(plain), one(kernel), one(kernel), one(plain)
    return statistics.median(p1 + p2), statistics.median(k1 + k2)


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
    ("kernel D GEMMs with LayerNorm", "swin_bwd_gemm_ln"),
    ("kernel D GEMMs", "swin_bwd_gemm"),
    ("kernel D attention", "swin_bwd_attn"),
    ("kernel D LayerNorm, sums", "swin_bwd_"),
    ("kernel B/C GEMMs with LayerNorm", "swin_fwd_proj_ln"),
    ("kernel B/C/H GEMMs", "swin_fwd_gemm"),
    ("kernel B/C/H attention", "swin_fwd_attn"),
    ("kernel B/C LayerNorm", "swin_fwd_ln"),
    ("kernel G attention", "attention_kernel"),
    ("kernel L (down1 backward)", "down1_"),
    ("merger convs, tensor cores (E, F, I, J)", "mstack_tc_conv"),
    ("merger convs, CUDA-core direct conv (J f32)", "mstack_conv"),
    ("merger weight grads, tensor cores (F, K)", "wgrad_mma"),
    ("merger weight grads, tensor cores (F, K)", "wgrad_reduce"),
    ("merger weight grads, CUDA cores (K f32)", "mstack_wgrad"),
    ("merger statistics, BatchNorm passes, reduces (E, F)", "mstack_"),
    ("host-to-device copy", "Memcpy HtoD"),
    ("device-to-host copy", "Memcpy DtoH"),
    ("cuDNN convolutions", "conv"),
    ("cuDNN convolutions", "cudnn"),
    ("cuBLAS GEMMs", "gemm"),
    ("cuBLAS GEMMs", "nvjet"),  # cuBLASLt's kernels under CUDA 12.8
)


# one merger-stack call (kernel E, or kernel F) by launch group, first
# match wins; the wrapper's own torch ops (weight packing, casts) are
# "other".  "mstack_reduce" groups a tree whose F sums its weight and
# bias gradients with one CUDA-core reduce (``--merger-stack`` run on a
# parent tree, for a before-and-after in one call).
MERGER_GROUPS = (
    ("weight-grad reduces", "wgrad_reduce"),
    ("weight-grad partials", "wgrad"),
    ("BatchNorm sums/finalize/apply", "mstack_bn_"),
    ("bias reduces", "bias_sum"),
    ("bias reduces", "sum1"),
    ("weight-grad and bias reduces", "mstack_reduce"),
    ("statistics", "stats"),
    ("convs", "conv"),
)


# FLOPs a voxel of the merger stack's six convs: their own (35,478 for
# the forward, the same for the input gradients and for the weight
# gradients) and the padded work the tensor-core bodies run
# (csrc/merger_mma.cuh): E's 16-channel groups (layer 4: one per source)
# and n padded to 8 or 16; F's input gradients (layer 4: n 40, layer 5:
# the 27 taps in a depth of 32) and weight gradients (c_in to 16 or 48,
# c_out to 16 or 8)
MERGER_FLOP = 35478.0
MERGER_PADDED_FLOP = {("E", "convs"): 117504.0, ("F", "convs"): 90880.0,
                      ("F", "weight-grad partials"): 103680.0}


# tiny kernels launched at the start of each profiled window and left
# out of its readings: late in a long process (this script's phase 15) a
# window lost the first device records it should have recorded (two of
# six on an H100 with torch 2.11 and CUDA 12.8, none early in the
# process), so a window of one short kernel call recorded no device
# event at all
PROFILE_WARMUP = 16


def profile_call(torch, fn, by=None, ordered=False):
    """Device time by kernel group (``by``, default KERNEL_GROUPS) over
    one call of ``fn`` (which ends in a synchronize) and the busy share
    (device time / wall time); with ``ordered`` also every device event
    as (short name, ms) in the order they started.  A session that
    recorded no device event is run once more (``fn`` called again);
    returns None if that one recorded none either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # a second session if the first recorded nothing
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_WARMUP):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t0) * 1e3
        if any(e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name for e in prof.events()):
            break
    groups, kernels, events = {}, {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "spin_kernel" in e.name:
            continue
        name = e.name
        events.append((e.time_range.start, short_name(name),
                       e.time_range.elapsed_us() / 1e3))
        group = next((g for g, sub in by or KERNEL_GROUPS
                      if sub.lower() in name.lower()),
                     "other (elementwise, norms, copies)")
        ms = e.time_range.elapsed_us() / 1e3
        groups[group] = groups.get(group, 0.0) + ms
        kernels[name] = kernels.get(name, 0.0) + ms
    if not groups:
        return None
    device = sum(groups.values())
    out = {"wall_ms": wall, "device_ms": device, "busy_share": device / wall,
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
           "kernels_ms": dict(sorted(kernels.items(),
                                     key=lambda kv: -kv[1])[:12])}
    if ordered:
        out["launches_ms"] = [(n, ms) for _, n, ms in sorted(events)]
    return out


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

def swin_calls(cfg):
    """Fused block calls of one forward under ``cfg``: 12 for Swin-Tiny.
    No model path launches kernel A: the chain stays in the aligned
    layout, a shifted block's kernels reading its windows through the
    roll's map."""
    return sum(cfg.NETWORK.SWIN_DEPTHS)


def profile_step(torch, st, step, images, volumes, dev, card):
    """Device time of one training step by kernel group (profiler), after
    two warm-up steps, on the card's copies of ``images`` and
    ``volumes``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    img, vol = torch.from_numpy(images).to(dev), torch.from_numpy(volumes).to(
        dev)
    for _ in range(2):
        step(st, img, vol, gen)
    torch.cuda.synchronize()
    prof = profile_call(torch, lambda: (step(st, img, vol, gen),
                                        torch.cuda.synchronize()))
    tag = f"train step batch {images.shape[0]}, {images.shape[1]} view(s)"
    if prof is None:
        log(f"{tag}: profiler recorded no device event; not measured")
    else:
        log(f"{tag}, profiler over one step: wall {prof['wall_ms']:.3f} ms, "
            f"device {prof['device_ms']:.3f} ms, busy share "
            f"{prof['busy_share']:.3f}; " + ", ".join(
                f"{k} {v:.3f}" for k, v in prof["groups_ms"].items())
            + f"; on {card}")
    return prof


def merger_stack_phase(torch, dev, card, report):
    """``--merger-stack``: phase 9 (kernels E and F against the plain stack
    at N = 32 and 48, their repeat and launch-group breakdown), then the
    device time of one kernel-path training step at batch 32 / 1 view and
    at batch 16 / 3 views (profiler, default config, full width)."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.ops import pallas_merger_stack as ms
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    check_merger_stack(torch, ms, dev, report,
                       ((BATCH, True), (TRAIN3[0] * TRAIN3[1], True)))
    cfg = default_config()
    cfg.NETWORK.INIT_SCHEME = "standard"
    st, opts = create_train_state(cfg, torch.Generator().manual_seed(SEED),
                                  device=dev)
    step = make_train_step(st.model, opts)
    rng = np.random.default_rng(SEED)
    steps = {}
    for batch, views in ((BATCH, 1), TRAIN3):
        img = rng.standard_normal((batch, views, 224, 224, 3)).astype(
            np.float32)
        vol = (rng.random((batch, 32, 32, 32)) < 0.3).astype(np.uint8)
        steps[f"{batch}x{views}"] = profile_step(torch, st, step, img, vol,
                                                 dev, card)
    report["train_step_profiles"] = steps


def flag_config(flags):
    """The full-width default config, standard init, with ``flags`` set on
    its NETWORK."""
    from swinvox_tpu_torch.config import default_config

    cfg = default_config()
    cfg.NETWORK.INIT_SCHEME = "standard"
    for key, val in flags.items():
        setattr(cfg.NETWORK, key, val)
    return cfg


def profile_train_config(torch, dev, card, name, counter, per_step):
    """The device time of one step of the training configuration ``name``
    (TRAIN_CONFIGS: its batch and flags, 3 views) by kernel group
    (profiler), after two warm-up steps; ``counter`` (a kernel wrapper)
    must count ``per_step`` launches a step."""
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    batch, flags = TRAIN_CONFIGS[name]
    st, opts = create_train_state(flag_config(flags),
                                  torch.Generator().manual_seed(SEED),
                                  device=dev)
    step = make_train_step(st.model, opts)
    rng = np.random.default_rng(SEED)
    img = rng.standard_normal((batch, TRAIN_VIEWS, 224, 224, 3)).astype(
        np.float32)
    vol = (rng.random((batch, 32, 32, 32)) < 0.3).astype(np.uint8)
    counter.launches = 0
    prof = profile_step(torch, st, step, img, vol, dev, card)
    if counter.launches != 3 * per_step:  # two warm-up steps and one
        raise AssertionError(f"{name}: {counter.launches} launches of "
                             f"{counter.__name__} in 3 steps, want "
                             f"{3 * per_step}")
    return prof


def profile_eval_config(torch, dev, card, name, counter, per_forward):
    """The device time of one evaluation forward of ``EVAL_IMAGES`` images
    under the configuration ``name`` (EVAL_CONFIGS) by kernel group
    (profiler), after two warm-up forwards, with cuDNN deterministic as
    the eval step runs it; ``counter`` must count ``per_forward``
    launches a forward."""
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel

    model = SwinVoxModel.from_config(
        flag_config(EVAL_CONFIGS[name]),
        torch.Generator().manual_seed(SEED)).to(dev).eval()
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.standard_normal(
        (EVAL_IMAGES // EVAL_VIEWS, EVAL_VIEWS, 224, 224, 3)).astype(
        np.float32)).to(dev).clamp(-1, 1)

    def forward():
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counter.launches = 0
        forward()
        forward()
        prof = profile_call(torch, forward)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    if counter.launches != 3 * per_forward:
        raise AssertionError(f"{name}: {counter.launches} launches of "
                             f"{counter.__name__} in 3 forwards, want "
                             f"{3 * per_forward}")
    if prof is None:
        log(f"{name} forward: profiler recorded no device event; not "
            "measured")
    else:
        log(f"{name} forward, {EVAL_IMAGES} images, profiler over one "
            f"forward: wall {prof['wall_ms']:.3f} ms, device "
            f"{prof['device_ms']:.3f} ms, busy share "
            f"{prof['busy_share']:.3f}; " + ", ".join(
                f"{k} {v:.3f}" for k, v in prof["groups_ms"].items())
            + f"; on {card}")
    return prof


def merger_conv_phase(torch, dev, card, report):
    """``--merger-conv``: kernel I's check (phase 13's) and kernel J's part
    of phase 15, each with device times (profiler), then the device time
    of one ``train-slab`` step at batch 8 / 3 views and one
    ``eval-merger`` forward of 24 images (profiler, full width)."""
    from swinvox_tpu_torch.ops import pallas_band_conv as bc
    from swinvox_tpu_torch.ops import pallas_down1 as d1
    from swinvox_tpu_torch.ops import pallas_merger as mi

    check_merger_infer(torch, mi, dev, report)
    check_train_kernels(torch, bc, d1, dev, report, only_j=True)
    report["train_slab_step_profile"] = profile_train_config(
        torch, dev, card, "train-slab", bc.merger_conv_forward, len(J_STEP))
    report["eval_merger_forward_profile"] = profile_eval_config(
        torch, dev, card, "eval-merger", mi.merger_view_weights, 1)


def wmsa_down1_phase(torch, dev, card, report):
    """``--wmsa-down1``: kernel H's check (phase 13's) and kernel L's part
    of phase 15, each with device times (profiler) and two calls bit for
    bit, then the device time of one ``train-slab`` step at batch 8 / 3
    views (L 1) and one ``eval-wmsa`` forward of 24 images (H 12)."""
    from swinvox_tpu_torch.models.swin import shifted_window_mask
    from swinvox_tpu_torch.ops import pallas_down1 as d1
    from swinvox_tpu_torch.ops import pallas_fused_msa as fm

    check_fused_msa(torch, fm, shifted_window_mask, dev, report)
    _, _, _, failed = check_down1(torch, d1, dev, report)
    if failed:
        raise AssertionError("kernel L: " + "; ".join(failed))
    report["train_slab_step_profile"] = profile_train_config(
        torch, dev, card, "train-slab", d1.down1_backward, 1)
    report["eval_wmsa_forward_profile"] = profile_eval_config(
        torch, dev, card, "eval-wmsa", fm.fused_msa_forward,
        swin_calls(flag_config({})))


def train_launches(cfg, batch, views):
    """Launches of kernels A, C, D, E, F in one train step."""
    blocks = swin_calls(cfg)
    vols = batch * views
    stack = vols % 16 == 0 and vols <= cfg.NETWORK.MERGER_STACK_MAX_VOLUMES
    return {"rewindow": 0, "swin_block_train_forward": blocks,
            "swin_block_train_backward": blocks,
            "merger_stack_forward": int(stack),
            "merger_stack_backward": int(stack and views > 1)}


def check_rewindow(torch, rw, dev, report):
    """Kernel A against its plain version at every shape and sign of the
    JAX chain's serving forward (batch 32), forward and backward, exactly;
    ms per forward (the 7 calls by CUDA events) and the device ms of those
    7 calls (profiler)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    ms = plain_ms = worst = 0.0
    shapes, calls = {}, []
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
            # the backward is the inverse permutation, the kernel again
            xg = x.detach().requires_grad_()
            xr = x.detach().requires_grad_()
            dy = torch.randn(x.shape, device=dev, generator=g).bfloat16()
            rw.rewindow(xg, nw, nw, 7, 3, s).backward(dy)
            rw.rewindow_reference(xr, nw, nw, 7, 3, s).backward(dy)
            if not torch.equal(xg.grad, xr.grad):
                raise AssertionError(f"rewindow {side}^2 C{c} sign {s}: "
                                     "kernel backward != plain")
        calls.append((x, nw, sign, count))
        p, k = time_pair(torch, lambda: rw.rewindow_reference(
            x, nw, nw, 7, 3, sign), lambda: rw.rewindow(x, nw, nw, 7, 3, sign))
        shapes[f"{side}x{side}xC{c} sign{sign:+d}"] = {
            "ms": k, "plain_ms": p, "calls_per_forward": count,
            "bytes_moved": 2 * x.numel() * x.element_size()}
        ms += count * k
        plain_ms += count * p
        log(f"rewindow {side}^2 C{c} sign {sign:+d}: exact, forward and "
            f"backward; kernel {k:.4f} ms, plain {p:.4f} ms ({count}x per "
            "forward)")

    def forward_calls():
        for x, nw, sign, count in calls:
            for _ in range(count):
                rw.rewindow(x, nw, nw, 7, 3, sign)
        torch.cuda.synchronize()

    prof = profile_call(torch, forward_calls, ordered=True)
    device = None if prof is None else prof["device_ms"]
    log(f"rewindow, the 7 calls of a forward: {ms:.4f} ms by events, "
        f"device {'not measured' if device is None else f'{device:.4f}'} ms"
        + ("" if prof is None else " (" + ", ".join(
            f"{n} {t:.4f}" for n, t in prof["launches_ms"]) + ")"))
    report["rewindow"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                          "device_ms": device, "shapes": shapes,
                          "profile": prof}


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
            kw = {"num_heads": heads}
            if shifted:  # aligned tokens, the attention's shifted windows
                f32[8] = torch.from_numpy(mask_fn(side, side, 7, 3)).to(dev)
                kw.update(nwh=side // 7, nww=side // 7, shift=3)
            bf = list(f32)
            for i in (0, 3, 5, 11, 13):  # tokens and the four weights
                bf[i] = f32[i].bfloat16()
            with exact_f32(torch):
                ref = blk.swin_block_reference(*f32, **kw)
            plain = blk.swin_block_reference(*bf, **kw)
            got = blk.fused_swin_block(*bf, **kw)
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
                torch, lambda: blk.swin_block_reference(*bf, **kw),
                lambda: blk.fused_swin_block(*bf, **kw), iters=5)
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



def bound(flop, nbytes, peak=PEAK_BF16):
    """(ms, "operations" or "bytes"): the least time for the work."""
    t_ops, t_bytes = flop / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_l2(a, b):
    """||a - b|| / ||b|| in float32 (0 when both are 0)."""
    a, b = a.float(), b.float()
    den = b.norm().item()
    num = (a - b).norm().item()
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def time_grad(torch, out, inputs, dout):
    """A callable running the backward of ``out`` (graph kept)."""
    return lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)


# fused_swin_block_train's positional operands, and those with a gradient
SWIN_ARGS = ("x", "dp1", "dp2", "ln1_scale", "ln1_bias", "wqkv", "bqkv",
             "wproj", "bproj", "rel_bias", "mask", "ln2_scale", "ln2_bias",
             "w1", "b1", "w2", "b2")
SWIN_GRAD_ARGS = [i for i, n in enumerate(SWIN_ARGS)
                  if n not in ("dp1", "dp2", "mask")]


def swin_plain(torch, blk, args, heads, dout, f32, **grid):
    """(output, gradients of SWIN_GRAD_ARGS) of the plain training block on
    copies of ``args``, with the window map ``grid`` (nwh, nww, shift):
    as given (bf16 plain), or all in float32 with TF32 off (f32 plain)."""
    leaves = []
    for i, a in enumerate(args):
        if a is not None:
            a = a.detach().clone()
            a = a.float() if f32 else a
            if i in SWIN_GRAD_ARGS:
                a.requires_grad_(True)
        leaves.append(a)
    with exact_f32(torch) if f32 else contextlib.nullcontext():
        out = blk.swin_block_train_reference(*leaves, num_heads=heads, **grid)
        grads = torch.autograd.grad(out, [leaves[i] for i in SWIN_GRAD_ARGS],
                                    dout.to(out.dtype))
    return out.detach(), [g.detach() for g in grads]


def hold_swin(name, kernel, plain, f32, worst, step_limit=None):
    """Holds a training block's (output, gradients) from the kernels
    against the bf16 plain and f32 plain blocks' on the same inputs, each
    within 2 x the bf16 plain version's error + B_FLOOR: the output and
    dx by max-abs, dx also by relative L2 ("dx rel", which does not
    depend on the gradient's scale), every other gradient by relative
    L2.  With ``step_limit``, every gradient also within that relative L2
    of the bf16 plain block's.  Returns {what: (kernel vs f32, bf16 plain
    vs f32, kernel vs bf16 plain)}."""
    names = [SWIN_ARGS[i] for i in SWIN_GRAD_ARGS[1:]]
    rows = ([("out", kernel[0], plain[0], f32[0]),
             ("dx", kernel[1][0], plain[1][0], f32[1][0]),
             ("dx rel", kernel[1][0], plain[1][0], f32[1][0])]
            + list(zip(names, kernel[1][1:], plain[1][1:], f32[1][1:])))
    errs = {}
    for what, k, pl, rf in rows:
        if what in ("out", "dx"):
            ek = (k.float() - rf.float()).abs().max().item()
            ep = (pl.float() - rf.float()).abs().max().item()
            worst[what] = max(worst[what], ek)
        else:
            ek, ep = rel_l2(k, rf), rel_l2(pl, rf)
            worst["grad_rel_l2"] = max(worst["grad_rel_l2"], ek)
        kp = rel_l2(k, pl)
        errs[what] = (ek, ep, kp)
        if not np.isfinite(ek) or ek > 2 * ep + B_FLOOR:
            raise AssertionError(f"train block {name} {what}: "
                                 f"{ek} > 2 x {ep} + {B_FLOOR}")
        if step_limit is not None and what != "out" and not kp <= step_limit:
            raise AssertionError(f"train block {name} {what}: {kp} from "
                                 f"the bf16 plain block's > {step_limit}")
    return errs


def check_swin_train(torch, blk, mask_fn, dev, report):
    """Kernels C and D against the plain training block (phase 8)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    fac = torch.tensor(DP_FACTORS, device=dev)
    tot = {"fwd_ms": 0.0, "fwd_plain_ms": 0.0, "bwd_ms": 0.0,
           "bwd_plain_ms": 0.0, "fwd_flop": 0.0, "fwd_bytes": 0.0,
           "bwd_flop": 0.0, "bwd_bytes": 0.0, "saved_bytes": 0.0}
    worst = {"out": 0.0, "dx": 0.0, "grad_rel_l2": 0.0}
    shapes = {}
    for side, c, heads, n_aligned, n_shifted in STAGES:
        per = (side // 7) ** 2
        nw = BATCH * per

        def r(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        img = torch.arange(BATCH, device=dev)
        f32 = [r(nw, 49, c), fac[img % 3].repeat_interleave(per),
               fac[(img + 1) % 3].repeat_interleave(per),
               1 + r(c, s=0.1), r(c, s=0.1),
               r(c, 3 * c, s=c**-0.5), r(3 * c, s=0.1),
               r(c, c, s=c**-0.5), r(c, s=0.1), r(heads, 49, 49, s=0.5),
               None, 1 + r(c, s=0.1), r(c, s=0.1),
               r(c, 4 * c, s=c**-0.5), r(4 * c, s=0.1),
               r(4 * c, c, s=(4 * c)**-0.5), r(c, s=0.1)]
        dout = r(nw, 49, c).bfloat16()
        for shifted, count in ((False, n_aligned), (True, n_shifted)):
            if count == 0:
                continue
            f32[10] = (torch.from_numpy(mask_fn(side, side, 7, 3)).to(dev)
                       if shifted else None)
            grid = (dict(nwh=side // 7, nww=side // 7, shift=3) if shifted
                    else {})
            bf = [a.bfloat16() if i in (0, 5, 7, 13, 15) else a
                  for i, a in enumerate(f32)]
            akn = [a if a is None else a.detach().clone().requires_grad_(
                i in SWIN_GRAD_ARGS) for i, a in enumerate(bf)]
            got = blk.fused_swin_block_train(*akn, num_heads=heads, **grid)
            ins_k = [akn[i] for i in SWIN_GRAD_ARGS]
            gkn = torch.autograd.grad(got, ins_k, dout, retain_graph=True)
            plain = swin_plain(torch, blk, bf, heads, dout, False, **grid)
            ref = swin_plain(torch, blk, f32, heads, dout, True, **grid)
            torch.cuda.synchronize()
            name = f"{side}x{side}xC{c} {'shifted' if shifted else 'aligned'}"
            errs = hold_swin(name, (got, list(gkn)), plain, ref, worst)
            log(f"train block {name}: (kernel, bf16 plain) error vs f32, "
                "kernel vs bf16 plain: " + ", ".join(
                    f"{k} {a:.4g}/{b:.4g}/{d:.3g}"
                    for k, (a, b, d) in errs.items()))
            # timing: forward, and backward of a kept graph
            apl = [a if a is None else a.detach().clone().requires_grad_(
                i in SWIN_GRAD_ARGS) for i, a in enumerate(bf)]
            fp, fk = time_pair(
                torch,
                lambda: blk.swin_block_train_reference(*apl, num_heads=heads,
                                                       **grid),
                lambda: blk.fused_swin_block_train(*akn, num_heads=heads,
                                                   **grid),
                iters=5)
            out_p = blk.swin_block_train_reference(*apl, num_heads=heads,
                                                   **grid)
            bp, bk = time_pair(
                torch, time_grad(torch, out_p,
                                 [apl[i] for i in SWIN_GRAD_ARGS], dout),
                time_grad(torch, got, ins_k, dout), iters=5)
            # D's device time by kernel group over one backward
            prof = profile_call(torch, lambda: (
                time_grad(torch, got, ins_k, dout)(),
                torch.cuda.synchronize()))
            split = {k: v for k, v in (prof or {"groups_ms": {}})[
                "groups_ms"].items() if k.startswith("kernel D")}
            tokens = nw * 49
            # the function's own work: x in and out (bf16), the four bf16
            # weights; backward: x and dout in, dx out, the weights in and
            # their bf16 gradients out
            ffl = tokens * (24 * c * c + 4 * 49 * c)
            fby = tokens * 4 * c + 24 * c * c
            bfl = tokens * (48 * c * c + 8 * 49 * c)
            bby = tokens * 6 * c + 48 * c * c
            shapes[name] = {"calls_per_step": count, "fwd_ms": fk,
                            "fwd_plain_ms": fp, "bwd_ms": bk,
                            "bwd_plain_ms": bp, "errors": errs,
                            "fwd_bound_ms": bound(ffl, fby)[0],
                            "bwd_bound_ms": bound(bfl, bby)[0],
                            "bwd_tflop_s": bfl / bk / 1e9,
                            "bwd_gb_s": bby / bk / 1e6,
                            "bwd_profile_ms": split}
            log(f"  C {fk:.4f} ms (plain {fp:.4f}), D {bk:.4f} ms (plain "
                f"{bp:.4f}; {bfl / bk / 1e9:.1f} TFLOP/s, {bby / bk / 1e6:.0f}"
                f" GB/s of its own bytes, bound {bound(bfl, bby)[0]:.4f} ms);"
                f" {count}x per step; D's device ms by group (profiler, one "
                "call): " + (", ".join(f"{k} {v:.4f}"
                                       for k, v in split.items())
                             or "not measured"))
            # kernel C's saved intermediates (h1, qkv, ctx, h2, the GELU
            # output in bf16; x2 and the pre-GELU values in f32; two LN
            # statistics pairs): 40 bytes per token-channel + 16 per token
            for key, v in (("fwd_ms", fk), ("fwd_plain_ms", fp),
                           ("bwd_ms", bk), ("bwd_plain_ms", bp),
                           ("fwd_flop", ffl), ("fwd_bytes", fby),
                           ("bwd_flop", bfl), ("bwd_bytes", bby),
                           ("saved_bytes", tokens * (40 * c + 16))):
                tot[key] += count * v
            del ref, plain, got, gkn, out_p, akn, apl
    tot["fwd_bound_ms"], tot["fwd_bound_by"] = bound(tot["fwd_flop"],
                                                      tot["fwd_bytes"])
    tot["bwd_bound_ms"], tot["bwd_bound_by"] = bound(tot["bwd_flop"],
                                                      tot["bwd_bytes"])
    # saving (written by C, read by D) against recomputing the forward in D
    tot["save_ms_at_hbm"] = 2 * tot["saved_bytes"] / HBM * 1e3
    tot["recompute_ms_at_peak"] = tot["fwd_flop"] / PEAK_BF16 * 1e3
    log(f"kernel C bound {tot['fwd_bound_ms']:.4f} ms ({tot['fwd_bound_by']})"
        f", kernel D bound {tot['bwd_bound_ms']:.4f} ms "
        f"({tot['bwd_bound_by']}) per step; C's saved intermediates "
        f"{tot['saved_bytes'] / 1e9:.4f} GB per step: "
        f"{tot['save_ms_at_hbm']:.4f} ms to write and read at the HBM rate, "
        f"against {tot['recompute_ms_at_peak']:.4f} ms to recompute the "
        "forward at the bf16 peak")
    report["swin_block_train"] = {**tot, "worst": worst, "shapes": shapes}


MERGER_GRADS = (["dx"] + [f"dW{i}" for i in range(6)]
                + [f"db{i}" for i in range(6)]
                + [f"dgamma{i}" for i in range(5)]
                + [f"dbeta{i}" for i in range(5)])


def merger_plain(torch, ms, x, params, dy, f32, backward=True):
    """((raw5, means, vars), gradients of x and the 22 parameters or None)
    of the plain stack on copies of its inputs: as given (bf16 plain) or
    all float32 with TF32 off (f32 plain)."""
    dt = torch.float32 if f32 else x.dtype
    xx = x.detach().to(dt).clone().requires_grad_(backward)
    ps = [q.detach().float().clone().requires_grad_(backward)
          for q in params]
    with exact_f32(torch) if f32 else contextlib.nullcontext():
        y, m, v = ms.merger_stack_reference(xx, ps[:6], ps[6:12], ps[12:17],
                                            ps[17:22])
        grads = (torch.autograd.grad(y, [xx] + ps, dy.to(y.dtype))
                 if backward else None)
    return ((y.detach(), torch.cat(m).detach(), torch.cat(v).detach()),
            None if grads is None else [g.detach() for g in grads])


def hold_merger(name, kn, gkn, pl, gpl, f32, g32, worst):
    """Holds the merger stack's (raw5, means, vars) by max-abs and its
    gradients by relative L2 against the f32 plain stack's, each within
    2 x the bf16 plain stack's error + B_FLOOR (a conv bias of layers
    0..4 feeds a train-mode BatchNorm, so its true gradient is 0: its
    error is taken relative to the same layer's dbeta)."""
    errs = {}
    for i, what in enumerate(("raw5", "means", "vars")):
        ek = (kn[i].float() - f32[i].float()).abs().max().item()
        ep = (pl[i].float() - f32[i].float()).abs().max().item()
        errs[what] = (ek, ep)
        worst["fwd_max_abs"] = max(worst["fwd_max_abs"], ek)
        if not np.isfinite(ek) or ek > 2 * ep + B_FLOOR:
            raise AssertionError(f"merger stack {name} {what}: "
                                 f"{ek} > 2 x {ep} + {B_FLOOR}")
    for i, what in enumerate(MERGER_GRADS if gkn is not None else ()):
        k, p_, f = gkn[i], gpl[i], g32[i]
        if what in ("db0", "db1", "db2", "db3", "db4"):
            den = g32[18 + int(what[2:])].float().norm().item()
            ek = (k.float() - f.float()).norm().item() / den
            ep = (p_.float() - f.float()).norm().item() / den
        else:
            ek, ep = rel_l2(k, f), rel_l2(p_, f)
        errs[what] = (ek, ep)
        worst["bwd_rel_l2"] = max(worst["bwd_rel_l2"], ek)
        if what == "dx":
            worst["dx_max_abs"] = max(worst["dx_max_abs"], (
                k.float() - f.float()).abs().max().item())
        if not np.isfinite(ek) or ek > 2 * ep + B_FLOOR:
            raise AssertionError(f"merger stack {name} {what}: "
                                 f"{ek} > 2 x {ep} + {B_FLOOR}")
    return errs


def check_merger_stack(torch, ms, dev, report, sizes):
    """Kernels E and F against the plain merger stack (phase 9) at
    ``sizes``, (volumes, with backward) pairs."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    out = {}
    worst = {"fwd_max_abs": 0.0, "bwd_rel_l2": 0.0, "dx_max_abs": 0.0}
    for n, backward in sizes:
        x = r(n, 32, 32, 32, 9).bfloat16()
        params = ([r(3, 3, 3, ci, co, s=(27 * ci)**-0.5)
                   for ci, co in ms.CHANNELS]
                  + [r(co, s=0.1) for _, co in ms.CHANNELS]
                  + [1 + r(9, s=0.1) for _ in range(5)]
                  + [r(9, s=0.1) for _ in range(5)])
        dy = r(n, 32, 32, 32, 1).bfloat16()
        xk = x.clone().requires_grad_(backward)
        psk = [q.clone().requires_grad_(backward) for q in params]
        yk, mk, vk = ms.merger_stack(xk, psk[:6], psk[6:12], psk[12:17],
                                     psk[17:22])
        gkn = (torch.autograd.grad(yk, [xk] + psk, dy, retain_graph=True)
               if backward else None)
        pl, gpl = merger_plain(torch, ms, x, params, dy, False, backward)
        f32, g32 = merger_plain(torch, ms, x.float(), params, dy, True,
                                backward)
        torch.cuda.synchronize()
        errs = hold_merger(f"N={n}", (yk, torch.cat(mk), torch.cat(vk)),
                           gkn, pl, gpl, f32, g32, worst)
        log(f"merger stack N={n}: (kernel, bf16 plain) error vs f32: " +
            ", ".join(f"{k} {a:.4g}/{b:.4g}" for k, (a, b) in errs.items()))
        fp, fk = time_pair(
            torch,
            lambda: ms.merger_stack_reference(x, params[:6], params[6:12],
                                              params[12:17], params[17:22]),
            lambda: ms.merger_stack(x, params[:6], params[6:12],
                                    params[12:17], params[17:22]), iters=5)
        vox = n * 32**3
        # the function's own bytes: x in (9 bf16 channels), raw5 out, the
        # weights (17,739 values); backward: x and dy in, dx out, the
        # weights in and their gradients out
        entry = {"fwd_ms": fk, "fwd_plain_ms": fp, "errors": errs}
        entry["fwd_bound_ms"], entry["fwd_bound_by"] = bound(
            vox * MERGER_FLOP, vox * 20.0 + 17739 * 4)
        if backward:
            xp = x.clone().requires_grad_(True)
            psp = [q.clone().requires_grad_(True) for q in params]
            yp = ms.merger_stack_reference(xp, psp[:6], psp[6:12],
                                           psp[12:17], psp[17:22])[0]
            bp, bk = time_pair(
                torch, time_grad(torch, yp, [xp] + psp, dy),
                time_grad(torch, yk, [xk] + psk, dy), iters=3)
            entry.update({"bwd_ms": bk, "bwd_plain_ms": bp})
            entry["bwd_bound_ms"], entry["bwd_bound_by"] = bound(
                vox * 2 * MERGER_FLOP, vox * 38.0 + 17739 * 8)
            log(f"  E {fk:.4f} ms (plain {fp:.4f}), F {bk:.4f} ms (plain "
                f"{bp:.4f})")
            del xp, psp, yp
        else:
            log(f"  E {fk:.4f} ms (plain {fp:.4f})")
        entry.update(merger_repeat_and_profile(torch, ms, x, params, dy,
                                               backward))
        out[n] = entry
        del f32, g32, pl, gpl, gkn, xk, psk, yk
    report["merger_stack"] = {"worst": worst, "by_volumes": out}


def short_name(kernel):
    """A profiler kernel name without its namespace and argument list."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


def merger_repeat_and_profile(torch, ms, x, params, dy, backward):
    """Kernel E (and F) called twice on the same inputs must give the same
    bits (fixed-order sums, no atomics); then the device time of one E
    call (and one F call) by launch group (MERGER_GROUPS)."""
    ks, bs, gs, bts = params[:6], params[6:12], params[12:17], params[17:22]

    def fwd():
        return ms.merger_stack_forward(x, ks, bs, gs, bts, 0.2, 1e-5)

    def defined(e):  # the stats rows layer 5 has: its mean and variance
        raw5, stats, raws = e
        return raw5, stats[:5], stats[5, :2, :1], raws

    e1, e2 = fwd(), fwd()
    outs = [(f"E output {i}", a, b)
            for i, (a, b) in enumerate(zip(defined(e1), defined(e2)))]
    if backward:
        def bwd():
            dx, dks, db, dg, dbt = ms.merger_stack_backward(
                dy, x, e1[2], e1[1], ks, gs, 0.2, 1e-5)
            return [dx, *dks, db, dg, dbt]

        f1, f2 = bwd(), bwd()
        outs += [(f"F output {i}", a, b) for i, (a, b) in enumerate(zip(f1,
                                                                        f2))]
    torch.cuda.synchronize()
    differ = [w for w, a, b in outs if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"merger stack N={x.shape[0]}: two calls on the "
                             f"same inputs differ in {differ}")
    res = {"repeat_bit_equal": True}
    for what, fn in (("E", fwd), ("F", bwd if backward else None)):
        if fn is None:
            continue
        fn()
        prof = profile_call(torch, lambda: (fn(), torch.cuda.synchronize()),
                            MERGER_GROUPS)
        res[f"profile_{what}"] = prof
        if prof is not None:
            vox = x.shape[0] * 32**3
            rates = {grp: {"ms": prof["groups_ms"][grp],
                           "own_tflops": vox * MERGER_FLOP
                           / prof["groups_ms"][grp] / 1e9,
                           "padded_tflops": vox * pad
                           / prof["groups_ms"][grp] / 1e9}
                     for (w, grp), pad in MERGER_PADDED_FLOP.items()
                     if w == what and grp in prof["groups_ms"]}
            res[f"tflops_{what}"] = rates
            log(f"  {what} N={x.shape[0]}: " + "; ".join(
                f"{grp} {r['own_tflops']:.1f} TFLOP/s of their own FLOPs, "
                f"{r['padded_tflops']:.1f} of the padded"
                for grp, r in rates.items()))
        if prof is None:
            log(f"  {what} N={x.shape[0]}: profiler recorded no device "
                "event; breakdown not measured")
        else:
            log(f"  {what} N={x.shape[0]} one call by launch group: device "
                f"{prof['device_ms']:.4f} ms; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in prof["groups_ms"].items()))
            log("    by kernel: " + ", ".join(
                f"{short_name(k)} {v:.4f}"
                for k, v in prof["kernels_ms"].items()))
    log(f"  N={x.shape[0]}: two calls on the same inputs are bit-equal "
        f"({len(outs)} outputs)")
    return res


class Recorder:
    """While active, replaces ``module.<attr>`` (a kernel wrapper that a
    model module imported by name) with a pass-through that keeps each
    call: copies of its tensor arguments and outputs, and the
    gradients the step's backward sends into that output ("dout") and
    out to each argument ("grads", keyed by argument position, or
    (position, index) inside a list).  The wrapper runs and counts its
    launches as before."""

    def __init__(self, torch, module, attr):
        self.torch, self.module, self.attr = torch, module, attr
        self.fn = getattr(module, attr)
        self.calls, self.handles = [], []

    def __enter__(self):
        def copy(a):
            if isinstance(a, (list, tuple)):
                return [copy(t) for t in a]
            return a.detach().clone() if self.torch.is_tensor(a) else a

        def keep(rec, key):
            # a parameter is the same leaf at every step, so its hook fires
            # again in later steps' backward: a call keeps its own, the
            # first
            def hook(grad):
                rec["grads"].setdefault(key, grad.detach().clone())
            return hook

        def wrapped(*args, **kw):
            out = self.fn(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            rec = {"kw": kw, "out": copy(out), "dout": None, "grads": {},
                   "args": []}
            for i, a in enumerate(args):
                items = a if isinstance(a, (list, tuple)) else [a]
                for j, t in enumerate(items):
                    key = (i, j) if isinstance(a, (list, tuple)) else i
                    if self.torch.is_tensor(t) and t.requires_grad:
                        self.handles.append(t.register_hook(keep(rec, key)))
                rec["args"].append(copy(a))
            if first.requires_grad:
                self.handles.append(first.register_hook(
                    lambda g: rec.__setitem__("dout", g.detach().clone())))
            self.calls.append(rec)
            return out

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)
        for h in self.handles:
            h.remove()


def hold_step_swin(torch, blk, calls, tag):
    """Each of a step's recorded Swin-block calls (kernels C and D)
    against the bf16 and f32 plain blocks on its own inputs, drop-path
    factors and output gradient (``hold_swin`` with STEP_VS_PLAIN)."""
    worst = {"out": 0.0, "dx": 0.0, "grad_rel_l2": 0.0}
    vs_plain = []
    for n, rec in enumerate(calls):
        args, heads = rec["args"], rec["kw"]["num_heads"]
        grid = {k: rec["kw"][k] for k in ("nwh", "nww", "shift")}
        missing = [SWIN_ARGS[i] for i in SWIN_GRAD_ARGS
                   if i not in rec["grads"]]
        if rec["dout"] is None or missing:
            raise AssertionError(f"{tag} block call {n}: no gradient "
                                 f"reached {missing or 'its output'}")
        step = (rec["out"], [rec["grads"][i] for i in SWIN_GRAD_ARGS])
        plain = swin_plain(torch, blk, args, heads, rec["dout"], False,
                           **grid)
        ref = swin_plain(torch, blk, args, heads, rec["dout"], True, **grid)
        errs = hold_swin(f"{tag} call {n}", step, plain, ref, worst,
                         STEP_VS_PLAIN)
        grads = {w: v for w, v in errs.items() if w != "out"}
        vs_plain += [d for w, (_, _, d) in grads.items() if w != "dx"]
        far = max((w for w in grads if w != "dx"),
                  key=lambda w: grads[w][2])
        dropped = float((args[1] == 0).float().mean()
                        + (args[2] == 0).float().mean()) / 2
        log(f"  {tag} Swin call {n} ({args[0].shape[0]} windows, C "
            f"{args[0].shape[2]}, dropped-branch share {dropped:.3f}): "
            f"out {errs['out'][0]:.4g}/{errs['out'][1]:.4g} and dx "
            f"{errs['dx'][0]:.4g}/{errs['dx'][1]:.4g} (step, bf16 plain: "
            f"max-abs vs f32); farthest from the bf16 plain block: {far} "
            f"{grads[far][2]:.4g} (vs f32 {grads[far][0]:.4g}/"
            f"{grads[far][1]:.4g})")
    return {"calls": len(calls), "worst": worst,
            "step_vs_bf16_plain_max": max(vs_plain),
            "step_vs_bf16_plain_median": statistics.median(vs_plain)}


def hold_step_merger(torch, ms, calls, tag):
    """The step's recorded merger-stack call (kernel E, and F when a
    gradient reached it) against the plain stack on its inputs and output
    gradient, by phase 9's rule."""
    worst = {"fwd_max_abs": 0.0, "bwd_rel_l2": 0.0, "dx_max_abs": 0.0}
    if len(calls) != 1:
        raise AssertionError(f"{tag}: {len(calls)} merger-stack calls "
                             "recorded, want 1")
    rec = calls[0]
    x, lists = rec["args"][0], rec["args"][1:5]
    params = [t for lst in lists for t in lst]
    keys = [0] + [(i, j) for i in range(1, 5)
                  for j in range(len(lists[i - 1]))]
    backward = rec["dout"] is not None  # the 1-view stack runs no_grad
    missing = [k for k in keys if k not in rec["grads"]]
    if backward and missing:
        raise AssertionError(f"{tag}: no gradient reached {missing}")
    dy = rec["dout"] if backward else rec["out"][0]
    pl, gpl = merger_plain(torch, ms, x, params, dy, False, backward)
    f32, g32 = merger_plain(torch, ms, x, params, dy, True, backward)
    raw5, means, vars_ = rec["out"]
    step = (raw5, torch.cat(means), torch.cat(vars_))
    errs = hold_merger(tag, step, [rec["grads"][k] for k in keys]
                       if backward else None, pl, gpl, f32, g32, worst)
    log(f"  {tag} merger-stack call ({x.shape[0]} volumes): (step, bf16 "
        "plain) error vs f32: " + ", ".join(
            f"{k} {a:.4g}/{b:.4g}" for k, (a, b) in errs.items()))
    return {"worst": worst, "errors": errs}


def library_rewindow(torch, rw, dev):
    """ms per serving forward of one ``index_select`` of the token rows by
    a precomputed permutation (kernel A's library yardstick)."""
    total = 0.0
    g = torch.Generator(device=dev).manual_seed(SEED)
    for side, c, sign, count in REWINDOW_CALLS:
        nw = side // 7
        x = torch.randn(BATCH * nw * nw, 49, c, device=dev,
                        generator=g).bfloat16()
        perm = rw.source_rows(x.shape[0], nw, nw, 7, 3, sign).to(dev)
        flat = x.view(-1, c)
        if not torch.equal(torch.index_select(flat, 0, perm).view_as(x),
                           rw.rewindow(x, nw, nw, 7, 3, sign)):
            raise AssertionError("index_select yardstick != rewindow")
        ms_, _ = time_pair(torch, lambda: torch.index_select(flat, 0, perm),
                           lambda: torch.index_select(flat, 0, perm))
        total += count * ms_
    return total


def hold_kernel(name, got, plain, ref):
    """Phase 4's rule: the kernel's max-abs error against the f32 plain
    version within 2 x the bf16 plain version's + B_FLOOR."""
    err_k = (got.float() - ref.float()).abs().max().item()
    err_p = (plain.float() - ref.float()).abs().max().item()
    log(f"{name}: |kernel-f32| {err_k:.6g}, |bf16 plain-f32| {err_p:.6g}, "
        f"bound {2 * err_p + B_FLOOR:.6g}")
    if not np.isfinite(err_k) or err_k > 2 * err_p + B_FLOOR:
        raise AssertionError(f"{name}: kernel error {err_k} > 2 x {err_p} "
                             f"+ {B_FLOOR}")
    return err_k, err_p


def check_window_attention(torch, wa, mask_fn, dev, report):
    """Kernel G against its plain version at the four stage shapes of one
    evaluation forward, unmasked and masked; sums per forward over the
    12 blocks' calls (counts from STAGES), and the SDPA yardstick."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0.0,
           "bytes": 0.0}
    worst, shapes, calls = 0.0, {}, []
    for side, c, heads, n_aligned, n_shifted in STAGES:
        nw = EVAL_IMAGES * (side // 7) ** 2
        q, k, v = (torch.randn(nw, heads, 49, 32, device=dev, generator=g)
                   for _ in range(3))
        bias = torch.randn(heads, 49, 49, device=dev, generator=g) * 0.5
        for masked, count in ((False, n_aligned), (True, n_shifted)):
            mask = (torch.from_numpy(mask_fn(side, side, 7, 3)).to(dev)
                    if masked else None)
            bf = [a.bfloat16() for a in (q, k, v)]
            with exact_f32(torch):
                ref = wa.window_attention_reference(q, k, v, bias, mask)
            plain = wa.window_attention_reference(*bf, bias, mask)
            got = wa.window_attention_pallas(*bf, bias, mask)
            torch.cuda.synchronize()
            name = f"{side}x{side}xH{heads} {'masked' if masked else 'unmasked'}"
            err_k, err_p = hold_kernel(f"window attention {name}", got,
                                       plain, ref)
            worst = max(worst, err_k)
            if count:
                calls.append((bf, bias, mask, count))
            p, kk = time_pair(
                torch, lambda: wa.window_attention_reference(*bf, bias, mask),
                lambda: wa.window_attention_pallas(*bf, bias, mask))
            full = bias[None].expand(nw, heads, 49, 49)
            if masked:
                nwi = mask.shape[0]
                full = full + mask.repeat(nw // nwi, 1, 1)[:, None]
            attn_mask = full.bfloat16().contiguous()
            lib = F.scaled_dot_product_attention(*bf, attn_mask=attn_mask)
            lib_err = (lib.float() - ref).abs().max().item()
            lib_ms, _ = time_pair(
                torch,
                lambda: F.scaled_dot_product_attention(*bf,
                                                       attn_mask=attn_mask),
                lambda: F.scaled_dot_product_attention(*bf,
                                                       attn_mask=attn_mask))
            flop = nw * heads * 4 * 49 * 49 * 32
            nbytes = 4 * nw * heads * 49 * 32 * 2 + (
                mask.numel() * 4 if masked else 0)
            shapes[name] = {"ms": kk, "plain_ms": p, "library_ms": lib_ms,
                            "library_max_abs_err": lib_err,
                            "calls_per_forward": count,
                            "err_kernel_vs_f32": err_k,
                            "err_bf16_plain_vs_f32": err_p}
            log(f"  kernel {kk:.4f} ms, plain {p:.4f} ms, SDPA {lib_ms:.4f} "
                f"ms (|SDPA-f32| {lib_err:.4g}; {count}x per forward)")
            for key, val in (("ms", kk), ("plain_ms", p),
                             ("library_ms", lib_ms), ("flop", flop),
                             ("bytes", nbytes)):
                tot[key] += count * val

    def forward_calls():
        for bf, bias, mask, count in calls:
            for _ in range(count):
                wa.window_attention_pallas(*bf, bias, mask)
        torch.cuda.synchronize()

    prof = profile_call(torch, forward_calls, ordered=True)
    device = None if prof is None else prof["device_ms"]
    log(f"window attention, the 12 calls of a forward: {tot['ms']:.4f} ms "
        f"by events, device "
        f"{'not measured' if device is None else f'{device:.4f}'} ms, bound "
        f"{bound(tot['flop'], tot['bytes'])[0]:.4f} ms, SDPA "
        f"{tot['library_ms']:.4f} ms")
    report["window_attention"] = {"max_abs_err": worst, "shapes": shapes,
                                  "device_ms": device, "profile": prof,
                                  **tot}


# one kernel H call by launch group (the wrapper allocates, so every
# device event is a launch of the kernel): the two projections and the
# attention; "att" names H's attention launch in both of its designs
H_GROUPS = (("GEMMs", "gemm"), ("attention", "att"))


def library_msa(torch, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, heads):
    """H's function as one PyTorch call, ``F.multi_head_attention_forward``
    on [T, nW, C] tokens with ``in_proj_weight = Wqkv^T``, ``out_proj_weight
    = Wproj^T`` and the float attn_mask [nW * heads, T, T] =
    rel_bias[h] + mask[w % nW_img], summed outside the call (bf16, as SDPA
    takes a float mask in the query's dtype).  Returns the call, ready to
    time, and its output's [nW, T, C] view."""
    import torch.nn.functional as F

    nw, t, c = x.shape
    full = rel_bias[None].expand(nw, heads, t, t)
    if mask is not None:
        full = full + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]
    attn_mask = full.reshape(nw * heads, t, t).to(x.dtype).contiguous()
    q = x.transpose(0, 1)
    w_in, w_out = wqkv.t().contiguous(), wproj.t().contiguous()
    b_in, b_out = bqkv.to(x.dtype), bproj.to(x.dtype)

    def call():
        return F.multi_head_attention_forward(
            q, q, q, c, heads, w_in, b_in, None, None, False, 0.0, w_out,
            b_out, training=False, need_weights=False,
            attn_mask=attn_mask)[0]

    return call, lambda: call().transpose(0, 1)


def check_fused_msa(torch, fm, mask_fn, dev, report):
    """Kernel H against its plain version at the four stage shapes of one
    evaluation forward, unmasked and masked; two calls on the same inputs
    bit for bit; one call's device time by launch group (profiler); the
    library yardstick ``F.multi_head_attention_forward``; sums per
    forward."""
    g = torch.Generator(device=dev).manual_seed(SEED + 12)

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flop": 0.0,
           "bytes": 0.0, "device_ms": 0.0, "gemm_device_ms": 0.0,
           "attention_device_ms": 0.0}
    worst, lib_worst, shapes, profiled = 0.0, 0.0, {}, True
    for side, c, heads, n_aligned, n_shifted in STAGES:
        nw = EVAL_IMAGES * (side // 7) ** 2
        # x, Wqkv, bqkv, Wproj, bproj (fan-in scale), rel_bias
        f32 = [r(nw, 49, c, s=0.5), r(c, 3 * c, s=c**-0.5), r(3 * c, s=0.1),
               r(c, c, s=c**-0.5), r(c, s=0.1), r(heads, 49, 49, s=0.5)]
        for masked, count in ((False, n_aligned), (True, n_shifted)):
            mask = (torch.from_numpy(mask_fn(side, side, 7, 3)).to(dev)
                    if masked else None)
            bf = list(f32)
            for i in (0, 1, 3):  # tokens and the two weights
                bf[i] = f32[i].bfloat16()
            with exact_f32(torch):
                ref = fm.fused_msa_reference(*f32, mask, heads)
            plain = fm.fused_msa_reference(*bf, mask, heads)
            got = fm.fused_window_msa(*bf, mask, heads)
            again = fm.fused_window_msa(*bf, mask, heads)
            torch.cuda.synchronize()
            name = f"{side}x{side}xC{c} {'masked' if masked else 'unmasked'}"
            err_k, err_p = hold_kernel(f"fused W-MSA {name}", got, plain, ref)
            if not torch.equal(got, again):
                raise AssertionError(f"fused W-MSA {name}: two calls on the "
                                     "same inputs differ")
            del again
            worst = max(worst, err_k)
            lib_call, lib_out = library_msa(torch, *bf, mask, heads)
            lib_err = (lib_out().float() - ref).abs().max().item()
            lib_worst = max(lib_worst, lib_err)
            p, kk = time_pair(
                torch, lambda: fm.fused_msa_reference(*bf, mask, heads),
                lambda: fm.fused_window_msa(*bf, mask, heads))
            lib_ms, _ = time_pair(torch, lib_call, lib_call)
            prof = profile_call(
                torch, lambda: (fm.fused_window_msa(*bf, mask, heads),
                                torch.cuda.synchronize()),
                H_GROUPS, ordered=True)
            tokens = nw * 49
            flop = 8 * tokens * c * c + nw * heads * 4 * 49 * 49 * 32
            nbytes = 2 * tokens * c * 2 + 4 * c * c * 2 + (
                mask.numel() * 4 if masked else 0)
            entry = {"ms": kk, "plain_ms": p, "library_ms": lib_ms,
                     "library_max_abs_err": lib_err,
                     "calls_per_forward": count, "err_kernel_vs_f32": err_k,
                     "err_bf16_plain_vs_f32": err_p, "repeat_bit_equal": True,
                     "kernel_tflops": flop / kk / 1e9}
            sums = {"ms": kk, "plain_ms": p, "library_ms": lib_ms,
                    "flop": flop, "bytes": nbytes}
            if prof is None:
                profiled = False
                log(f"  {name}: profiler recorded no device event; device "
                    "time not measured")
            else:
                gm = prof["groups_ms"].get("GEMMs", 0.0)
                at = prof["groups_ms"].get("attention", 0.0)
                entry.update({"device_ms": prof["device_ms"],
                              "gemm_device_ms": gm,
                              "attention_device_ms": at,
                              "launches_ms": prof["launches_ms"]})
                sums.update({"device_ms": prof["device_ms"],
                             "gemm_device_ms": gm,
                             "attention_device_ms": at})
            shapes[name] = entry
            log(f"  kernel {kk:.4f} ms ({flop / kk / 1e9:.1f} TFLOP/s)" + (
                f", device {entry['device_ms']:.4f} (GEMMs "
                f"{entry['gemm_device_ms']:.4f}, attention "
                f"{entry['attention_device_ms']:.4f})"
                if "device_ms" in entry else "")
                + f", plain {p:.4f} ms, multi_head_attention_forward "
                f"{lib_ms:.4f} ms (|lib-f32| {lib_err:.4g}; {count}x per "
                "forward); two calls bit-equal")
            for key, val in sums.items():
                tot[key] += count * val
    if not profiled:
        for key in ("device_ms", "gemm_device_ms", "attention_device_ms"):
            tot[key] = None
    log(f"fused W-MSA per forward (12 calls): kernel {tot['ms']:.4f} ms" + (
        f", device {tot['device_ms']:.4f} (GEMMs {tot['gemm_device_ms']:.4f}"
        f", attention {tot['attention_device_ms']:.4f})" if profiled else "")
        + f", plain {tot['plain_ms']:.4f}, multi_head_attention_forward "
        f"{tot['library_ms']:.4f}, bound "
        f"{bound(tot['flop'], tot['bytes'])[0]:.4f} ms")
    report["fused_msa"] = {"max_abs_err": worst,
                           "library_max_abs_err": lib_worst,
                           "shapes": shapes, **tot}


def check_merger_infer(torch, mi, dev, report):
    """Kernel I against its plain version at the 24 volumes of one
    evaluation forward (running statistics away from their init)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    chans = ((9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1))
    x = r(EVAL_IMAGES, 32, 32, 32, 9, s=0.5)
    ks = [r(3, 3, 3, ci, co, s=(27 * ci) ** -0.5) for ci, co in chans]
    bs = [r(co, s=0.1) for _, co in chans]
    bn = [(1 + r(co, s=0.1), r(co, s=0.1), r(co, s=0.1),
           0.5 + r(co).abs()) for _, co in chans]
    xb = x.bfloat16()
    with exact_f32(torch):
        ref = mi.merger_view_weights_reference(x, ks, bs, bn)
        plain = mi.merger_view_weights_reference(xb, ks, bs, bn)
    got = mi.merger_view_weights(xb, ks, bs, bn)
    again = mi.merger_view_weights(xb, ks, bs, bn)
    torch.cuda.synchronize()
    err_k, err_p = hold_kernel(f"inference merger V={EVAL_IMAGES}", got,
                               plain, ref)
    if not torch.equal(got, again):
        raise AssertionError(f"inference merger V={EVAL_IMAGES}: two calls "
                             "on the same inputs differ")

    def plain_call():
        with exact_f32(torch):
            mi.merger_view_weights_reference(xb, ks, bs, bn)

    p, kk = time_pair(torch, plain_call,
                      lambda: mi.merger_view_weights(xb, ks, bs, bn), iters=5)
    vox = EVAL_IMAGES * 32**3
    prof = profile_call(torch, lambda: (mi.merger_view_weights(xb, ks, bs, bn),
                                        torch.cuda.synchronize()),
                        (("convs", "conv"),), ordered=True)
    entry = {"max_abs_err": err_k, "err_bf16_plain": err_p, "ms": kk,
             "plain_ms": p, "flop": vox * MERGER_FLOP,
             "bytes": vox * (9 * 2 + 4) + 17739 * 4, "repeat_bit_equal": True}
    log(f"  kernel {kk:.4f} ms, plain {p:.4f} ms (1x per forward); two "
        "calls bit-equal")
    if prof is None:
        log("  inference merger: profiler recorded no device event; device "
            "time not measured")
    else:
        conv = prof["groups_ms"].get("convs", 0.0)
        layers = [ms_ for n, ms_ in prof["launches_ms"] if "conv" in n]
        entry.update({"device_ms": prof["device_ms"], "conv_device_ms": conv,
                      "layer_device_ms": layers,
                      "own_tflops": vox * MERGER_FLOP / conv / 1e9,
                      "padded_tflops": vox * MERGER_PADDED_FLOP[("E", "convs")]
                      / conv / 1e9, "profile": prof})
        log(f"  one call: device {prof['device_ms']:.4f} ms (convs "
            f"{conv:.4f}: {entry['own_tflops']:.1f} TFLOP/s of their own "
            f"FLOPs, {entry['padded_tflops']:.1f} of the padded); per layer "
            "launch " + ", ".join(f"{m:.4f}" for m in layers))
    report["merger_infer"] = entry


def hold_eval_calls(torch, tag, calls, plain_fn, launches):
    """Each recorded kernel call of an evaluation run against the bf16 and
    f32 plain versions on that call's own inputs, by phase 4's rule
    (the probabilities at the end of the model are too coarse to show
    every kernel fault).  Returns the worst readings and the failures."""
    def widen(a):
        if isinstance(a, (list, tuple)):
            return [widen(t) for t in a]
        return a.float() if torch.is_tensor(a) and a.is_floating_point() \
            else a

    failed = [] if len(calls) == launches else [
        f"{tag}: {len(calls)} calls recorded, {launches} launches"]
    worst = {"kernel": 0.0, "bf16_plain": 0.0, "headroom": float("inf")}
    for n, rec in enumerate(calls):
        args, kw = rec["args"], rec["kw"]
        with exact_f32(torch):
            plain = plain_fn(*args, **kw)
            ref = plain_fn(*widen(args), **kw)
        err_k = (rec["out"].float() - ref.float()).abs().max().item()
        err_p = (plain.float() - ref.float()).abs().max().item()
        worst["kernel"] = max(worst["kernel"], err_k)
        worst["bf16_plain"] = max(worst["bf16_plain"], err_p)
        headroom = 2 * err_p + B_FLOOR - err_k
        worst["headroom"] = min(worst["headroom"], headroom)
        if not np.isfinite(err_k) or headroom < 0:
            failed.append(f"{tag} call {n}: kernel {err_k} from f32 > 2 x "
                          f"{err_p} + {B_FLOOR}")
    log(f"  {tag}: {len(calls)} calls held against the plain version on "
        f"their own inputs: |kernel-f32| max {worst['kernel']:.6g}, |bf16 "
        f"plain-f32| max {worst['bf16_plain']:.6g}, least headroom "
        f"{worst['headroom']:.6g}; {len(failed)} failed")
    return {"calls": len(calls), "worst": worst, "failed": failed}


def eval_breakdown(torch, model, x):
    """Device ms per layer and a profiler breakdown of one eval forward
    on ``x`` (cuDNN deterministic, as the eval step runs it)."""
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        layers = layer_times(torch, model, x.float().clamp(-1, 1))

        def forward():
            with torch.inference_mode():
                model(x.float().clamp(-1, 1))
            torch.cuda.synchronize()

        return layers, profile_call(torch, forward)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det


def eval_phase(torch, dev, card, counters, report):
    """Phase 14: ``runner --test`` on a synthetic fixture in every
    EVAL_CONFIGS configuration, from one params-only checkpoint; the
    fixture and the checkpoint live in a temporary directory outside the
    repo, removed at the end even on failure."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="swinvox_chip_smoke_eval_"))
    try:
        return _eval_phase(torch, dev, card, counters, report, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _eval_phase(torch, dev, card, counters, report, work):
    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.data.synthetic import generate_dataset
    from swinvox_tpu_torch.models import merger as merger_mod
    from swinvox_tpu_torch.models import swin as swin_mod
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.ops import pallas_fused_msa as fm
    from swinvox_tpu_torch.ops import pallas_merger as mi
    from swinvox_tpu_torch.ops import pallas_swin_block as blk
    from swinvox_tpu_torch.train import evaluator, trainer
    from swinvox_tpu_torch.train.checkpoint import save_params_only

    t0 = time.perf_counter()
    generate_dataset(str(work / "data"), (0, 0, EVAL_SAMPLES // 2),
                     EVAL_VIEWS, list(EVAL_CATEGORIES), seed=SEED)
    cfg = default_config()
    cfg.NETWORK.INIT_SCHEME = "standard"
    weights = str(work / "weights.ckpt")
    model = SwinVoxModel.from_config(cfg, torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 14)
    for i in range(6):  # the merger's running statistics away from their
        bn = getattr(model.merger, f"bn{i + 1}")  # init: kernel I folds them
        bn.mean.add_(0.1 * torch.randn(bn.mean.shape, generator=g))
        bn.var.mul_(0.5 + torch.rand(bn.var.shape, generator=g))
    save_params_only(weights, model)
    del model
    log(f"evaluation fixture ({EVAL_SAMPLES} samples, {EVAL_VIEWS} views) "
        f"and checkpoint written in {time.perf_counter() - t0:.1f} s")

    rec = {}
    real_step, real_eval, real_test = (evaluator.make_eval_step,
                                       trainer.evaluate, trainer.test_net)

    def make_eval_step(model, thresholds):
        """The evaluator's step, keeping each batch's probabilities and
        CUDA events around each model forward."""
        step = real_step(model, thresholds)
        events = rec["events"] = []

        def before(module, args):
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()

        model.register_forward_pre_hook(before)
        model.register_forward_hook(lambda m, a, o: events[-1][1].record())

        def run(images, volumes, **kw):
            out = step(images, volumes, **kw)
            rec["probs"].append(out["probs"])
            rec.setdefault("images", torch.as_tensor(images).to(dev))
            return out

        rec["model"] = model

        return run

    def timed_evaluate(*a, **k):
        t = time.perf_counter()
        out = real_eval(*a, **k)
        torch.cuda.synchronize()
        rec["evaluate_s"] = time.perf_counter() - t
        return out

    def recorded_test_net(*a, **k):
        rec["iou"] = real_test(*a, **k)
        return rec["iou"]

    recorded = (  # kernel wrapper, its counter, its plain version
        (swin_mod, "fused_swin_block", "fused_swin_block",
         blk.swin_block_reference),
        (swin_mod, "fused_window_msa", "fused_msa_forward",
         fm.fused_msa_reference),
        (merger_mod, "merger_view_weights", "merger_view_weights",
         mi.merger_view_weights_reference))
    runs = {}
    evaluator.make_eval_step = make_eval_step
    trainer.evaluate = timed_evaluate
    trainer.test_net = recorded_test_net
    try:
        for name, flags in EVAL_CONFIGS.items():
            argv = ["--test", "--weights", weights, "--n-views",
                    str(EVAL_VIEWS), "--dataset-root", str(work / "data"),
                    "--out", str(work / "out"), "--platform", str(dev)]
            for key, val in flags.items():
                argv += ["--set", f"NETWORK.{key}={str(val).lower()}"]
            rec.update(probs=[], iou=None)
            rec.pop("images", None)
            for f in counters.values():
                f.launches = 0
            def ctx():
                return exact_f32(torch) if name == "f32 plain" else \
                    contextlib.nullcontext()
            with ctx(), contextlib.ExitStack() as stack:
                recs = [stack.enter_context(Recorder(torch, mod, attr))
                        for mod, attr, _, _ in recorded]
                if runner.main(argv) != 0:
                    raise AssertionError(f"runner --test {name} failed")
                torch.cuda.synchronize()
                launches = {k: f.launches for k, f in counters.items()}
            held = {attr: hold_eval_calls(torch, f"{name} {attr}", r.calls,
                                          plain, launches[counter])
                    for (_, attr, counter, plain), r in zip(recorded, recs)
                    if r.calls or launches[counter]}
            del recs
            with ctx():
                layers, prof = eval_breakdown(torch, rec.pop("model"),
                                              rec["images"])
            forwards = len(rec["probs"])
            probs = torch.cat(rec["probs"]).float().cpu()
            stream = statistics.median(
                a.elapsed_time(b) for a, b in rec["events"][1:])
            runs[name] = {"iou": rec["iou"], "probs": probs,
                          "forwards": forwards, "launches": launches,
                          "held_calls": held,
                          "evaluate_s": rec["evaluate_s"],
                          "samples_per_s": EVAL_SAMPLES / rec["evaluate_s"],
                          "forward_stream_ms": stream,
                          "layer_device_ms": layers, "profile": prof}
            log(f"runner --test {name}: max IoU {rec['iou']:.6f}, "
                f"{forwards} forwards of {EVAL_IMAGES} images, evaluate "
                f"{rec['evaluate_s']:.3f} s, "
                f"{runs[name]['samples_per_s']:.2f} samples/s (a smoke "
                f"reading: {EVAL_SAMPLES} samples), forward stream "
                f"{stream:.3f} ms (median of the {forwards - 1} after the "
                f"first); launches {launches}; on {card}")
            log("  device ms per forward (CUDA events, median of 5): "
                + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()))
            if prof is not None:
                log(f"  profiler over one forward: wall {prof['wall_ms']:.3f}"
                    f" ms, device {prof['device_ms']:.3f} ms, busy share "
                    f"{prof['busy_share']:.3f}; " + ", ".join(
                        f"{k} {v:.3f}" for k, v in prof["groups_ms"].items()))
    finally:
        evaluator.make_eval_step = real_step
        trainer.evaluate = real_eval
        trainer.test_net = real_test

    n_blocks = swin_calls(cfg)  # 12 at Swin-T depths
    want = {  # kernel launches per forward
        "default": {"fused_swin_block": n_blocks},
        "eval-merger": {"fused_swin_block": n_blocks,
                        "merger_view_weights": 1},
        "eval-wmsa": {"fused_msa_forward": n_blocks,
                      "merger_view_weights": 1},
    }
    ref = runs["f32 plain"]["probs"]
    base = (runs["bf16 plain"]["probs"] - ref).abs().max().item()
    base_mean = (runs["bf16 plain"]["probs"] - ref).abs().mean().item()
    out = {"fixture": {"samples": EVAL_SAMPLES, "views": EVAL_VIEWS,
                       "categories": len(EVAL_CATEGORIES)},
           "bf16_plain_max_abs_vs_f32": base,
           "bf16_plain_mean_abs_vs_f32": base_mean, "runs": {}}
    failed = []
    for name, r in runs.items():
        per_forward = {k: n / r["forwards"] for k, n in r["launches"].items()
                       if n}
        if r["forwards"] != EVAL_SAMPLES // 8 or per_forward != want.get(
                name, {}):
            failed.append(f"{name}: {r['forwards']} forwards, launches per "
                          f"forward {per_forward} != {want.get(name, {})}")
        failed += [f for h in r["held_calls"].values() for f in h["failed"]]
        p = r.pop("probs")
        if p.shape != (EVAL_SAMPLES, 32, 32, 32) or not bool(
                torch.isfinite(p).all()) or not 0.0 <= r["iou"] <= 1.0:
            failed.append(f"{name}: malformed result {p.shape} IoU "
                          f"{r['iou']}")
            continue
        r["max_abs_vs_f32"] = (p - ref).abs().max().item()
        r["mean_abs_vs_f32"] = (p - ref).abs().mean().item()
        out["runs"][name] = r
        if name in want:
            log(f"{name}: probabilities vs f32 plain max {r['max_abs_vs_f32']:.6g}"
                f" (bound 2 x {base:.6g}), mean {r['mean_abs_vs_f32']:.6g} "
                f"(bound {EVAL_MEAN_RATIO} x {base_mean:.6g}); IoU "
                f"{r['iou']:.6f} vs f32 {runs['f32 plain']['iou']:.6f}")
            if r["max_abs_vs_f32"] > 2 * base:
                failed.append(f"{name}: probabilities {r['max_abs_vs_f32']} "
                              f"from f32 > 2 x {base}")
            if r["mean_abs_vs_f32"] > EVAL_MEAN_RATIO * base_mean:
                failed.append(f"{name}: probabilities mean-abs "
                              f"{r['mean_abs_vs_f32']} from f32 > "
                              f"{EVAL_MEAN_RATIO} x {base_mean}")
    log(f"bf16 plain configuration vs f32 plain: max {base:.6g}, mean "
        f"{base_mean:.6g}, IoU {runs['bf16 plain']['iou']:.6f}")
    report["eval"] = out
    if failed:
        raise AssertionError("evaluation phase: " + "; ".join(failed))
    return out


# FLOPs a voxel of kernel J's tensor-core body for each (ci, co): depth
# 16 a tap (36 channels: three 16-channel groups; 1 -> 9: the 27 taps
# gathered into a depth of 32) against n padded to 8, 16 or 40
J_PADDED_FLOP = {(9, 9): 2.0 * 27 * 16 * 16, (36, 9): 2.0 * 27 * 48 * 16,
                 (9, 1): 2.0 * 27 * 16 * 8, (9, 36): 2.0 * 27 * 16 * 40,
                 (1, 9): 2.0 * 32 * 16}


def conv_work(ci, co, v, wgrad=False):
    """(FLOPs, own bytes) of one merger conv call at ``v`` volumes, bf16:
    J reads x and the kernel and writes y; K reads x and dy and writes
    the float32 dW."""
    vox = v * 32**3
    w_bytes = 27 * ci * co * (4 if wgrad else 2)
    return 2.0 * vox * 27 * ci * co, 2.0 * vox * (ci + co) + w_bytes


def down1_work(n):
    """(FLOPs, own bytes) of one kernel L call at ``n`` volumes, bf16:
    dy, x and the kernel in, dx and the float32 dW out."""
    return (2.0 * 2048 * n * (33**3 + 32**3),
            2.0 * n * (33**3 * 32 + 2 * 32**3) + 2048 * 6.0)


def hold_call(name, got, plain, ref, rel_tol, rule=True):
    """A kernel output against its plain version on the same inputs:
    relative L2 to the plain version <= ``rel_tol`` (the same exact
    products summed in another order, then rounded once), and, with
    ``rule``, phase 4's rule against the f32 plain version.  Returns
    (max-abs error vs the f32 plain version, relative L2 to the plain
    version, the failure or None)."""
    err_k = (got.float() - ref.float()).abs().max().item()
    err_p = (plain.float() - ref.float()).abs().max().item()
    rel = rel_l2(got, plain)
    fail = None
    if not np.isfinite(err_k) or not rel <= rel_tol:
        fail = f"{name}: relative L2 to the plain version {rel} > {rel_tol}"
    elif rule and err_k > 2 * err_p + B_FLOOR:
        fail = f"{name}: {err_k} from f32 > 2 x {err_p} + {B_FLOOR}"
    return err_k, rel, fail


# one kernel L call by launch group: its own launches (down1_*), and the
# wrapper's cast of the kernel to the tokens' dtype
L_GROUPS = (("kernel L", "down1"),)


def check_down1(torch, d1, dev, report):
    """Kernel L (phase 15's part) at the refiner's DOWN1_VOLUMES volumes of
    a 3-view batch-8 step, in bf16 and f32, against its plain version on
    the same inputs (TF32 off): dx by REL_TOL and phase 4's rule, dW by
    REL_TOL["f32"]; two calls on the same inputs bit for bit; ms (CUDA
    events) of the kernel, the plain version and
    ``aten.convolution_backward`` (TF32 off in f32); one call's device
    time by launch (profiler).  Returns (errors by key, the worst errors,
    the bf16 call's row for a step, the failures)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    n = DOWN1_VOLUMES
    errs, worst, failed, by_dtype = {}, {"max_abs": 0.0, "rel_l2": 0.0}, [], {}
    flop, nbytes = down1_work(n)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x = torch.randn(n, 32, 32, 32, 1, device=dev, generator=g)
        w = torch.randn(4, 4, 4, 1, 32, device=dev, generator=g) * 64 ** -0.5
        dy = torch.randn(n, 33, 33, 33, 32, device=dev, generator=g)
        xd, dyd = x.to(dtype), dy.to(dtype)
        with exact_f32(torch):
            ref = d1.down1_backward_reference(x, w, dy)
            plain = d1.down1_backward_reference(xd, w, dyd)
        got = d1.down1_backward(xd, w, dyd)
        again = d1.down1_backward(xd, w, dyd)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            failed.append(f"L {tag}: two launches on the same inputs differ")
        del again
        for key, k, tol, rule in (("dx", 0, REL_TOL[tag], True),
                                  ("dW", 1, REL_TOL["f32"], False)):
            err_k, rel, fail = hold_call(f"L {tag} {key}", got[k], plain[k],
                                         ref[k], tol, rule)
            errs[f"{tag} {key}"] = {"max_abs_vs_f32": err_k,
                                    "rel_l2_vs_plain": rel}
            if key == "dx":
                worst["max_abs"] = max(worst["max_abs"], err_k)
            worst["rel_l2"] = max(worst["rel_l2"], rel)
            if fail:
                failed.append(fail)
        xn, dyn = xd.permute(0, 4, 1, 2, 3), dyd.permute(0, 4, 1, 2, 3)
        wn = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous()

        def plain_l():
            with exact_f32(torch):
                d1.down1_backward_reference(xd, w, dyd)

        def lib_l():  # TF32 off: the f32 yardstick computes in f32
            with exact_f32(torch):
                torch.ops.aten.convolution_backward(
                    dyn, xn, wn, None, [1, 1, 1], [2, 2, 2], [1, 1, 1],
                    False, [0, 0, 0], 1, [True, True, False])

        pl, kl = time_pair(torch, plain_l,
                           lambda: d1.down1_backward(xd, w, dyd))
        ll, _ = time_pair(torch, lib_l, lib_l)
        prof = profile_call(torch, lambda: (d1.down1_backward(xd, w, dyd),
                                            torch.cuda.synchronize()),
                            L_GROUPS, ordered=True)
        b = (bound(flop, nbytes) if tag == "bf16"
             else bound(flop, 2 * nbytes - 2048 * 2.0, PEAK_F32))
        entry = {"ms": kl, "plain_ms": pl, "library_ms": ll, "bound": b,
                 "repeat_bit_equal": same}
        if prof is None:
            log(f"  L {tag}: profiler recorded no device event; device time "
                "not measured")
        else:
            entry.update({"device_ms": prof["device_ms"],
                          "kernel_device_ms": prof["groups_ms"].get(
                              "kernel L", 0.0),
                          "launches_ms": prof["launches_ms"]})
        by_dtype[tag] = entry
        log(f"  L {tag} at {n} volumes: kernel {kl:.4f} ms" + (
            f" (device {entry['device_ms']:.4f}: " + ", ".join(
                f"{nm} {ms_:.4f}" for nm, ms_ in entry["launches_ms"]) + ")"
            if "device_ms" in entry else "")
            + f", plain {pl:.4f}, convolution_backward {ll:.4f}, bound "
            f"{b[0]:.4f} ({b[1]})")
    log("L: " + ", ".join(
        f"{key} {e['max_abs_vs_f32']:.4g}/{e['rel_l2_vs_plain']:.3g}"
        for key, e in errs.items()) + " (max-abs vs f32 plain / relative L2 "
        "vs plain)")
    bf = by_dtype["bf16"]
    row = {"ms": bf["ms"], "plain_ms": bf["plain_ms"],
           "library_ms": bf["library_ms"], "bound": bf["bound"], "calls": 1}
    if "device_ms" in bf:
        row["device_ms"] = bf["device_ms"]
    report["down1"] = {"errors": errs, "worst": worst, "by_dtype": by_dtype}
    return errs, worst, row, failed


def check_train_kernels(torch, bc, d1, dev, report, only_j=False):
    """Phase 15: kernels J and K (one merger conv, forward and weight
    gradient) at the 24 volumes of a 3-view batch-8 step, every (ci, co)
    they run there (J's adjoints (9, 36) and (1, 9) included), and
    kernel L at the step's 8 refiner volumes, in bf16 and f32, against
    their plain versions on the same inputs (TF32 off); ``only_j``: J
    alone."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(SEED + 15)

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    v = TRAIN_VOLUMES
    out = {"J": {}, "K": {}, "L": {}}
    worst = {k: {"max_abs": 0.0, "rel_l2": 0.0} for k in out}
    failed = []

    def note(kernel, key, err_k, rel, fail):
        out[kernel][key] = {"max_abs_vs_f32": err_k,
                            "rel_l2_vs_plain": rel}
        worst[kernel]["max_abs"] = max(worst[kernel]["max_abs"], err_k)
        worst[kernel]["rel_l2"] = max(worst[kernel]["rel_l2"], rel)
        if fail:
            failed.append(fail)

    times, device = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        tol = REL_TOL[tag]
        for ci, co in bc.CONV_SHAPES:
            x = r(v, 32, 32, 32, ci)
            k = r(3, 3, 3, ci, co, s=(27 * ci) ** -0.5)
            xd = x.to(dtype)
            with exact_f32(torch):
                ref = bc.merger_conv_reference(x, k)
                plain = bc.merger_conv_reference(xd, k)
            got = bc.merger_conv_forward(xd, k)
            again = bc.merger_conv_forward(xd, k)
            torch.cuda.synchronize()
            note("J", f"{tag} {ci}->{co}", *hold_call(
                f"J {tag} {ci}->{co}", got, plain, ref, tol))
            if not torch.equal(got, again):
                failed.append(f"J {tag} {ci}->{co}: two launches on the "
                              "same inputs differ")
            del again
            if (ci, co) in bc.FORWARD_SHAPES and not only_j:
                dy = r(v, 32, 32, 32, co)
                dyd = dy.to(dtype)
                with exact_f32(torch):
                    ref_w = bc.merger_conv_wgrad_reference(x, dy)
                    plain_w = bc.merger_conv_wgrad_reference(xd, dyd)
                got_w = bc.merger_conv_wgrad(xd, dyd)
                torch.cuda.synchronize()
                note("K", f"{tag} {ci}->{co}", *hold_call(
                    f"K {tag} {ci}->{co}", got_w, plain_w, ref_w,
                    REL_TOL["f32"], rule=False))
                if not torch.equal(bc.merger_conv_wgrad(xd, dyd), got_w):
                    failed.append(f"K {tag} {ci}->{co}: two launches on "
                                  "the same inputs differ")
                xn, dyn = xd.permute(0, 4, 1, 2, 3), dyd.permute(0, 4, 1, 2, 3)

                def plain_k():
                    with exact_f32(torch):
                        bc.merger_conv_wgrad_reference(xd, dyd)

                def lib_k():  # TF32 off: the f32 yardstick computes in f32
                    with exact_f32(torch):
                        torch.nn.grad.conv3d_weight(xn, (co, ci, 3, 3, 3),
                                                    dyn, padding=1)

                pk, kk = time_pair(torch, plain_k,
                                   lambda: bc.merger_conv_wgrad(xd, dyd))
                lk, _ = time_pair(torch, lib_k, lib_k)
                key = "K" if tag == "bf16" else "K f32"
                times[(key, ci, co)] = (kk, pk, lk)
                if tag != "bf16":
                    log(f"  K f32 {ci}->{co} at {v} volumes: kernel "
                        f"{kk:.4f} ms, plain {pk:.4f}, conv3d_weight {lk:.4f}")
            if dtype != torch.bfloat16:
                continue
            xn = xd.permute(0, 4, 1, 2, 3)
            kn = k.to(dtype).permute(4, 3, 0, 1, 2).contiguous()

            def plain_j():
                with exact_f32(torch):
                    bc.merger_conv_reference(xd, k)

            pj, kj = time_pair(torch, plain_j,
                               lambda: bc.merger_conv_forward(xd, k))
            lj, _ = time_pair(torch, lambda: F.conv3d(xn, kn, padding=1),
                              lambda: F.conv3d(xn, kn, padding=1))
            times[("J", ci, co)] = (kj, pj, lj)
            # one call's device time: the conv launch, and the whole call
            # (the wrapper's cast of the kernel beside it)
            prof = profile_call(torch, lambda: (bc.merger_conv_forward(xd, k),
                                                torch.cuda.synchronize()),
                                (("conv", "conv"),))
            flop = conv_work(ci, co, v)[0]
            if prof is None:
                log(f"  J {ci}->{co}: profiler recorded no device event; "
                    "device time not measured")
            else:
                conv = prof["groups_ms"].get("conv", 0.0)
                device[(ci, co)] = {
                    "device_ms": prof["device_ms"], "conv_device_ms": conv,
                    "own_tflops": flop / conv / 1e9,
                    "padded_tflops": v * 32**3 * J_PADDED_FLOP[(ci, co)]
                    / conv / 1e9}
            dv = device.get((ci, co))
            kk = pk = lk = None
            if (ci, co) in bc.FORWARD_SHAPES and not only_j:
                kk, pk, lk = times[("K", ci, co)]
            log(f"  J {ci}->{co} at {v} volumes: kernel {kj:.4f} ms" + (
                f" (device {dv['device_ms']:.4f}, conv "
                f"{dv['conv_device_ms']:.4f}: {dv['own_tflops']:.1f} TFLOP/s "
                "own, "
                f"{dv['padded_tflops']:.1f} padded)" if dv else "")
                + f", plain {pj:.4f}, F.conv3d {lj:.4f}" + (
                    f"; K {kk:.4f} ms, plain {pk:.4f}, conv3d_weight "
                    f"{lk:.4f}" if kk is not None else ""))
    if not only_j:
        errs_l, worst["L"], row_l, failed_l = check_down1(torch, d1, dev,
                                                          report)
        out["L"] = errs_l
        failed += failed_l
    for kernel, errs in ((k_, e) for k_, e in out.items()
                         if e and k_ != "L"):  # check_down1 logs L's
        log(f"{kernel}: " + ", ".join(
            f"{key} {e['max_abs_vs_f32']:.4g}/{e['rel_l2_vs_plain']:.3g}"
            for key, e in errs.items()) + " (max-abs vs f32 plain / "
            "relative L2 vs plain)")
    # per main-path unit, a 3-view batch-8 step: J's 12 calls, K's 6, L's 1
    # (K f32: the f32 route, bound by f32 bytes and the f32 CUDA-core rate,
    # reported beside the table's bf16 row)
    rows = {}
    for kernel, calls in (("J", J_STEP), ("K", K_STEP), ("K f32", K_STEP)):
        if only_j and kernel != "J":
            continue
        ms_ = [times[(kernel,) + c] for c in calls]
        work = [conv_work(*c, v, kernel != "J") for c in calls]
        flop = sum(w[0] for w in work)
        nbytes = sum(w[1] for w in work)
        if kernel == "K f32":
            nbytes = sum(2.0 * v * 32**3 * (c[0] + c[1]) * 2
                         + 27 * c[0] * c[1] * 4 for c in calls)
        rows[kernel] = {"ms": sum(t[0] for t in ms_),
                        "plain_ms": sum(t[1] for t in ms_),
                        "library_ms": sum(t[2] for t in ms_),
                        "bound": bound(flop, nbytes, PEAK_F32
                                       if kernel == "K f32" else PEAK_BF16),
                        "calls": len(calls)}
    if len(device) == len(bc.CONV_SHAPES):
        rows["J"]["device_ms"] = sum(device[c]["device_ms"] for c in J_STEP)
        rows["J"]["conv_device_ms"] = sum(device[c]["conv_device_ms"]
                                          for c in J_STEP)
        flop = sum(conv_work(*c, v)[0] for c in J_STEP)
        padded = sum(v * 32**3 * J_PADDED_FLOP[c] for c in J_STEP)
        rows["J"]["own_tflops"] = flop / rows["J"]["conv_device_ms"] / 1e9
        rows["J"]["padded_tflops"] = (padded / rows["J"]["conv_device_ms"]
                                      / 1e9)
    if not only_j:
        rows["L"] = row_l
    for kernel, row in rows.items():
        log(f"{kernel} per step ({row['calls']} calls): kernel "
            f"{row['ms']:.4f} ms" + (
                f" (device {row['device_ms']:.4f}, convs "
                f"{row['conv_device_ms']:.4f}: {row['own_tflops']:.1f} "
                f"TFLOP/s own, {row['padded_tflops']:.1f} padded)"
                if "conv_device_ms" in row else "")
            + f", plain {row['plain_ms']:.4f}, library "
            f"{row['library_ms']:.4f}, bound {row['bound'][0]:.4f} "
            f"({row['bound'][1]})")
    report["train_kernels"] = {"errors": out, "worst": worst,
                               "per_step": rows,
                               "per_call_ms": {" ".join(map(str, k)): t
                                               for k, t in times.items()},
                               "j_device": {f"{ci}->{co}": d for (ci, co), d
                                            in device.items()}}
    if failed:
        raise AssertionError("training kernels: " + "; ".join(failed))
    return rows, worst


class CallKeeper:
    """While active, wraps ``module.<attr>`` (a kernel wrapper the ops call
    by its module-level name) to keep a copy of each call's tensor
    arguments and outputs; the wrapper runs and counts its launch."""

    def __init__(self, torch, module, attr):
        self.torch, self.module, self.attr = torch, module, attr
        self.fn, self.calls = getattr(module, attr), []

    def __enter__(self):
        def copy(a):
            if isinstance(a, tuple):
                return tuple(copy(t) for t in a)
            return a.detach().clone() if self.torch.is_tensor(a) else a

        def wrapped(*args):
            out = self.fn(*args)
            self.calls.append((copy(args), copy(out)))
            return out

        # the wrapper counts on its module-level name, this one meanwhile
        wrapped.launches = self.fn.launches
        self.wrapped = wrapped
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)
        self.fn.launches = self.wrapped.launches


def hold_train_calls(torch, bc, d1, kept, tag):
    """Every recorded J, K and L call of a training run against the plain
    version on that call's own inputs (phase 15's rules)."""
    failed, worst = [], {"J": 0.0, "K": 0.0, "L": 0.0}
    for kernel, calls in kept.items():
        for i, (args, out) in enumerate(calls):
            if kernel == "L":
                x, w, dy = args
                widened = (x.float(), w, dy.float())
                with exact_f32(torch):
                    plain = d1.down1_backward_reference(*args)
                    ref = d1.down1_backward_reference(*widened)
                pairs = [("dx", out[0], plain[0], ref[0], True),
                         ("dW", out[1], plain[1], ref[1], False)]
            else:
                fn = (bc.merger_conv_reference if kernel == "J"
                      else bc.merger_conv_wgrad_reference)
                widened = [a.float() for a in args]
                with exact_f32(torch):
                    plain = fn(*args)
                    ref = fn(*widened)
                pairs = [("", out, plain, ref, kernel == "J")]
            for what, got, p_, ref_, bf16_out in pairs:
                tol = REL_TOL["bf16" if bf16_out and got.dtype ==
                              torch.bfloat16 else "f32"]
                _, rel, fail = hold_call(f"{tag} {kernel}{what} call {i}",
                                         got, p_, ref_, tol, rule=bf16_out)
                worst[kernel] = max(worst[kernel], rel)
                if fail:
                    failed.append(fail)
    log(f"  {tag}: " + ", ".join(f"{k} {len(c)} calls" for k, c in
                                 kept.items())
        + " held against the plain version on their own inputs; relative "
        "L2 to it, worst: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                        worst.items())
        + f"; {len(failed)} failed")
    return {"calls": {k: len(c) for k, c in kept.items()}, "worst": worst,
            "failed": failed}


def hold_run_merger_calls(torch, ms, calls, tag):
    """Every merger-stack call (kernels E and F) recorded in a training
    run, each held against the plain stack on its own inputs and output
    gradient by phase 9's rule (``hold_step_merger``)."""
    failed = []
    worst = {"fwd_max_abs": 0.0, "bwd_rel_l2": 0.0, "dx_max_abs": 0.0}
    for i, rec in enumerate(calls):
        try:
            res = hold_step_merger(torch, ms, [rec], f"{tag} call {i}")
        except AssertionError as e:
            failed.append(str(e))
            continue
        for k in worst:
            worst[k] = max(worst[k], res["worst"][k])
    if calls:
        log(f"  {tag}: {len(calls)} merger-stack calls held against the "
            f"plain stack on their own inputs, worst {worst}; "
            f"{len(failed)} failed")
    return {"calls": len(calls), "worst": worst, "failed": failed}


def want_train_launches(cfg, batch, flags, steps, val_forwards):
    """Launches of a ``train_net`` run under ``cfg`` (3 views): per step
    the train kernels (C 12, D 12 at Swin-T depths, no A; the merger's E
    and F when B * 3 volumes take the stack, else J 12 and K 6 on the
    slab and banded routes; L 1 under REFINER_DOWN1_PALLAS), per
    validation forward B 12, and J 6 on the slab route (the slab merger
    runs at inference too).  At COMPUTE_DTYPE float32 ``from_config``
    runs the plain paths of the bf16-only kernels (B-F)."""
    n_blocks = swin_calls(cfg)
    per = train_launches(cfg, batch, TRAIN_VIEWS)
    if flags.get("COMPUTE_DTYPE") == "float32":
        per = dict.fromkeys(per, 0)
        n_blocks = 0
    layered = flags.get("USE_SLAB_MERGER") or flags.get(
        "USE_PALLAS_MERGER_TRAIN")
    stacked = per["merger_stack_forward"] > 0
    return {
        "rewindow": 0,
        "fused_swin_block": val_forwards * n_blocks,
        "swin_block_train_forward": steps * per["swin_block_train_forward"],
        "swin_block_train_backward": steps * per["swin_block_train_backward"],
        "merger_stack_forward": steps * per["merger_stack_forward"],
        "merger_stack_backward": steps * per["merger_stack_backward"],
        "merger_conv_forward": (steps * 12 if layered and not stacked else 0)
        + (val_forwards * 6 if flags.get("USE_SLAB_MERGER") else 0),
        "merger_conv_wgrad": steps * 6 if layered and not stacked else 0,
        "down1_backward": steps if flags.get("REFINER_DOWN1_PALLAS") else 0,
    }


@contextlib.contextmanager
def deterministic_algorithms(torch, fill=True):
    """Holds ``torch.use_deterministic_algorithms(True)`` (no
    ``warn_only``: an op with no deterministic implementation raises and
    names itself) and cuDNN's deterministic algorithms (benchmark off)
    over a block, then restores them.  ``fill=False`` turns off the NaN
    fill of every new tensor that the mode adds
    (``torch.utils.deterministic.fill_uninitialized_memory``)."""
    import torch.utils.deterministic as det

    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark,
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    det.fill_uninitialized_memory = fill
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        cudnn.deterministic, cudnn.benchmark = prev[2], prev[3]
        det.fill_uninitialized_memory = prev[4]


@contextlib.contextmanager
def cudnn_deterministic_only(torch):
    """cuDNN's deterministic algorithms (benchmark off) alone over a
    block, then as they were."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


# the settings a train step can run under: the step as it is ("default"),
# and three global modes a caller can put round it
DET_MODES = {
    "default": lambda torch: contextlib.nullcontext(),
    "cudnn deterministic": cudnn_deterministic_only,
    "deterministic, no fill": lambda torch: deterministic_algorithms(
        torch, fill=False),
    "deterministic": deterministic_algorithms,
}


def gradient_repeats(torch, dev, flags, batch, mode="default"):
    """Two forward-backward passes of the full-width train step's loss
    under DET_MODES[``mode``] from one state on one batch and one dropout
    seed: the parameters whose gradients differ in any bit, in
    registration order, and the first module that holds one (None when
    all repeat)."""
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import gradients, loss_and_grads

    state, _ = create_train_state(flag_config(flags),
                                  torch.Generator().manual_seed(SEED), 4, dev)
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.random(
        (batch, TRAIN_VIEWS, 224, 224, 3), np.float32)).to(dev)
    volumes = torch.from_numpy(
        (rng.random((batch, 32, 32, 32)) > 0.7).astype(np.uint8)).to(dev)
    model, grads = state.model, []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        with DET_MODES[mode](torch):
            loss_and_grads(model, images, volumes.float(),
                           torch.Generator(device=dev).manual_seed(SEED),
                           True, True)
            torch.cuda.synchronize()
        grads.append({k: v.detach().clone()
                      for k, v in gradients(model).items()})
    differ = [k for k in grads[0] if not torch.equal(grads[0][k],
                                                      grads[1][k])]
    del state, model, grads
    torch.cuda.empty_cache()
    return differ, (differ[0].rsplit(".", 1)[0] if differ else None)


def state_group_l2(torch, got, want):
    """Per (module, weights or moment) group of two ``_snapshot``s: the
    relative L2 of the concatenated tensors (a conv bias before a
    train-mode BatchNorm has a gradient of pure rounding noise, so its own
    moments differ from run to run by their whole size, while the group's
    do not)."""
    groups = {}
    for k in want:
        parts = k.split(".")
        g = (parts[1] + " weights" if parts[0] == "model"
             else f"{parts[0]} {parts[1]}")
        groups.setdefault(g, []).append(k)
    return {g: rel_l2(torch.cat([got[k].float().reshape(-1) for k in ks]),
                      torch.cat([want[k].float().reshape(-1) for k in ks]))
            for g, ks in groups.items()}


def resume_at_epoch2(work, epoch1_file, name):
    """A copy of an epoch-1 checkpoint whose meta says epoch_idx 1, so a
    run resumed from it starts again at epoch 2 (the JAX package's resume
    starts again at the epoch a checkpoint was saved after)."""
    from swinvox_tpu_torch.utils import flax_msgpack

    blob = flax_msgpack.unpackb(epoch1_file.read_bytes())
    blob["meta"]["epoch_idx"] = 1
    out = work / f"{name}-resume-at-epoch2.ckpt"
    out.write_bytes(flax_msgpack.packb(blob))
    return out


def _snapshot(torch, state):
    """Copies of a TrainState's tensors (weights, statistics, moments)."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for m, opt in state.opt_states.items():
        for kind in ("mu", "nu", "trace"):
            for k, v in opt.get(kind, {}).items():
                out[f"{m}.{kind}.{k}"] = v.detach().clone()
    return out


def train_phase(torch, dev, card, counters, report):
    """Phase 16: the training entry point through ``runner.main`` at full
    width on a synthetic fixture, in TRAIN_CONFIGS, then ``train-slab``
    resumed at its second epoch from its first epoch's checkpoint.  The
    fixture and every checkpoint live in a temporary directory outside
    the repo, removed at the end even on failure."""
    import shutil
    import tempfile

    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.data.synthetic import generate_dataset
    from swinvox_tpu_torch.models import merger as merger_mod
    from swinvox_tpu_torch.ops import pallas_band_conv as bc
    from swinvox_tpu_torch.ops import pallas_down1 as d1
    from swinvox_tpu_torch.ops import pallas_merger_stack as ms
    from swinvox_tpu_torch.train import checkpoint as ckpt_mod
    from swinvox_tpu_torch.train import trainer

    work = Path(tempfile.mkdtemp(prefix="swinvox_chip_smoke_train_"))
    real = {k: getattr(trainer, k) for k in
            ("make_train_step", "create_train_state", "save_checkpoint",
             "evaluate")}
    runs, failed = {}, []
    try:
        t0 = time.perf_counter()
        generate_dataset(str(work / "data"), (TRAIN_SAMPLES // 2,
                                              VAL_SAMPLES // 2, 0),
                         TRAIN_VIEWS, list(EVAL_CATEGORIES), seed=SEED)
        log(f"training fixture ({TRAIN_SAMPLES} train, {VAL_SAMPLES} val "
            f"samples, {TRAIN_VIEWS} views) written in "
            f"{time.perf_counter() - t0:.1f} s under {work}")
        rec = {}

        def make_train_step(*a, **k):
            step = real["make_train_step"](*a, **k)

            def timed(*sa, **sk):
                t = time.perf_counter()
                out = step(*sa, **sk)
                torch.cuda.synchronize()
                rec["steps"].append((t, time.perf_counter()))
                return out
            return timed

        def create_train_state(*a, **k):
            rec["state"] = real["create_train_state"](*a, **k)
            return rec["state"]

        def save_checkpoint(path, state, epoch_idx, *a):
            real["save_checkpoint"](path, state, epoch_idx, *a)
            keep = work / f"{rec['name']}-epoch{epoch_idx + 1}.ckpt"
            os.link(path, keep)  # outlives a later overwrite of ``path``
            rec["saved"].append((epoch_idx, keep))

        def evaluate(*a, **k):
            t = time.perf_counter()
            iou = real["evaluate"](*a, **k)
            torch.cuda.synchronize()
            rec["evals"].append((time.perf_counter() - t, iou))
            return iou

        trainer.make_train_step = make_train_step
        trainer.create_train_state = create_train_state
        trainer.save_checkpoint = save_checkpoint
        trainer.evaluate = evaluate

        def run(name, batch, flags, extra=(), keep_calls=True):
            rec.update(name=name, steps=[], saved=[], evals=[])
            out = work / "out" / name
            argv = ["--batch-size", str(batch), "--epoch", str(TRAIN_EPOCHS),
                    "--n-views", str(TRAIN_VIEWS), "--dataset-root",
                    str(work / "data"), "--out", str(out), "--platform",
                    str(dev), "--set", "NETWORK.INIT_SCHEME=standard",
                    "--set", "TRAIN.SAVE_FREQ=1", "--set",
                    "TRAIN.LOG_EVERY=1", "--set", "CONST.NUM_WORKER=8",
                    *extra]
            for key, val in flags.items():
                argv += ["--set", f"NETWORK.{key}={str(val).lower()}"]
            for f in counters.values():
                f.launches = 0
            t = time.perf_counter()
            with contextlib.ExitStack() as stack:
                kept = {k: stack.enter_context(CallKeeper(torch, mod, attr))
                        for k, mod, attr in (
                            ("J", bc, "merger_conv_forward"),
                            ("K", bc, "merger_conv_wgrad"),
                            ("L", d1, "down1_backward"))} \
                    if keep_calls else {}
                stack_calls = stack.enter_context(Recorder(
                    torch, merger_mod, "merger_stack")) if keep_calls else None
                if runner.main(argv) != 0:
                    raise AssertionError(f"runner {name} failed")
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {k: f.launches for k, f in counters.items()}
            (run_dir,) = list(out.iterdir())
            rows = [json.loads(line) for line in
                    (run_dir / "logs" / "train.jsonl").read_text()
                    .splitlines()]
            losses = [(row["step"], row["tag"], row["value"]) for row in rows
                      if row["tag"].endswith("BatchLoss")]
            spans = rec["steps"]
            steps_per_epoch = TRAIN_SAMPLES // batch
            epochs = [spans[i:i + steps_per_epoch]
                      for i in range(0, len(spans), steps_per_epoch)]
            res = {"batch": batch, "flags": flags, "wall_s": wall,
                   "launches": launches, "losses": losses,
                   "steps": len(spans),
                   "step_ms_median_after_first": statistics.median(
                       (b - a) * 1e3 for a, b in spans[1:]),
                   "epoch_train_s": [e[-1][1] - e[0][0] for e in epochs],
                   "evaluate_s": [e for e, _ in rec["evals"]],
                   "val_iou": [iou for _, iou in rec["evals"]],
                   "saved": [(e, str(p)) for e, p in rec["saved"]]}
            if keep_calls:
                res["held_calls"] = hold_train_calls(
                    torch, bc, d1, {k: c.calls for k, c in kept.items()},
                    name)
                failed.extend(res["held_calls"]["failed"])
                res["held_merger_stack"] = hold_run_merger_calls(
                    torch, ms, stack_calls.calls, name)
                failed.extend(res["held_merger_stack"]["failed"])
                del kept, stack_calls
            log(f"runner (train) {name}: batch {batch}, {len(spans)} steps, "
                f"step wall median {res['step_ms_median_after_first']:.3f} ms"
                f" (after the first), epoch train s "
                + ", ".join(f"{x:.3f}" for x in res["epoch_train_s"])
                + ", evaluate s " + ", ".join(
                    f"{x:.3f}" for x in res["evaluate_s"])
                + f", val IoU {res['val_iou']}, wall {wall:.1f} s "
                f"(smoke readings); launches {launches}; on {card}")
            if not all(np.isfinite(v) for _, _, v in losses) or not losses:
                failed.append(f"{name}: batch losses not finite: {losses}")
            return res

        cfg = default_config()
        for name, (batch, flags) in TRAIN_CONFIGS.items():
            res = runs[name] = run(name, batch, flags)
            steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // batch)
            val_fw = TRAIN_EPOCHS * (VAL_SAMPLES // cfg.TEST.EVAL_BATCH_SIZE)
            want = want_train_launches(cfg, batch, flags, steps, val_fw)
            if res["launches"] != want:
                failed.append(f"{name}: launches {res['launches']} != {want}")
            if name != "train-slab":  # keep the slab run's files for resume
                for _, p in rec["saved"]:
                    p.unlink()
                shutil.rmtree(work / "out" / name)
            else:
                slab_state = rec["state"][0]
                slab_saved = dict(rec["saved"])

        # resume train-slab at epoch 2 from its epoch-1 checkpoint.  The
        # JAX package's resume starts again at the epoch a checkpoint was
        # saved after (its meta's epoch_idx); the file's epoch_idx is set
        # to 1 so the run continues with epoch 2, as the uninterrupted
        # run did
        batch, flags = TRAIN_CONFIGS["train-slab"]
        final = _snapshot(torch, slab_state)  # what its epoch-2 file holds
        del slab_state
        rec.pop("state")
        slab_saved[1].unlink()
        shutil.rmtree(work / "out" / "train-slab")
        resume_file = resume_at_epoch2(work, slab_saved[0], "train-slab")
        slab_saved[0].unlink()
        res = runs["train-slab resumed"] = run(
            "train-slab-resumed", batch, flags,
            extra=("--weights", str(resume_file)), keep_calls=False)
        steps = TRAIN_SAMPLES // batch
        want = want_train_launches(cfg, batch, flags, steps,
                                   VAL_SAMPLES // cfg.TEST.EVAL_BATCH_SIZE)
        if res["launches"] != want:
            failed.append(f"resume: launches {res['launches']} != {want}")
        base = [x for x in runs["train-slab"]["losses"] if x[0] >= steps]
        if [x[:2] for x in res["losses"]] != [x[:2] for x in base]:
            failed.append("resume: the logged batch losses do not line up")
        loss_errs = [abs(a[2] - b[2]) / abs(b[2])
                     for a, b in zip(res["losses"], base)]
        loss_err = max(loss_errs)
        state = rec["state"][0]
        resumed = _snapshot(torch, state)
        # the resumed run's epoch-2 file, read back by the port's
        # load_checkpoint into a TrainState: the state it was saved from
        meta = ckpt_mod.load_checkpoint(str(dict(rec["saved"])[1]), state)
        back = _snapshot(torch, state)
        readback = [k for k in resumed if not torch.equal(resumed[k],
                                                          back[k])]
        if readback or meta["epoch_idx"] != 1 or state.step != 2 * steps:
            failed.append(f"resume: epoch-2 checkpoint read back differs in "
                          f"{readback[:4]} (meta {meta}, step {state.step})")
        group_l2 = state_group_l2(torch, resumed, final)
        held = {g: v for g, v in group_l2.items() if g.endswith("weights")}
        moments = {g: v for g, v in group_l2.items()
                   if not g.endswith("weights")}
        worst_g = max(held, key=held.get)
        worst_m = max(moments, key=moments.get)
        worst_name = max(final, key=lambda k: rel_l2(resumed[k], final[k]))
        res["vs_uninterrupted"] = {
            "batch_loss_rel": loss_errs, "batch_loss_max_rel": loss_err,
            "state_group_rel_l2": group_l2,
            "moments_max_rel_l2": moments[worst_m],
            "worst_tensor": worst_name,
            "worst_tensor_rel_l2": rel_l2(resumed[worst_name],
                                          final[worst_name]),
            "val_iou_uninterrupted": runs["train-slab"]["val_iou"][1]}
        log(f"resumed at epoch 2 vs uninterrupted: batch losses relative "
            f"difference per logged loss " + ", ".join(
                f"{e:.3g}" for e in loss_errs)
            + f" (limit {RESUME_LOSS_RTOL}); epoch-2 state relative L2 per "
            "group " + ", ".join(f"{g} {v:.3g}" for g, v in group_l2.items())
            + f" (limits {RESUME_STATE_RTOL} on the weights, "
            f"{DET_MOMENTS_RTOL} on the moments; the farthest tensor "
            f"{worst_name} {res['vs_uninterrupted']['worst_tensor_rel_l2']:.3g}"
            f"); val IoU {res['val_iou']} vs "
            f"{runs['train-slab']['val_iou'][1]}; epoch-2 checkpoint read "
            "back exactly")
        if not loss_err <= RESUME_LOSS_RTOL:
            failed.append(f"resume: batch losses {loss_err} > "
                          f"{RESUME_LOSS_RTOL}")
        if not held[worst_g] <= RESUME_STATE_RTOL:
            failed.append(f"resume: state {worst_g} {held[worst_g]} > "
                          f"{RESUME_STATE_RTOL}")
        if not moments[worst_m] <= DET_MOMENTS_RTOL:
            failed.append(f"resume: moments {worst_m} {moments[worst_m]} > "
                          f"{DET_MOMENTS_RTOL}")
        del state, resumed, back, final
        rec.clear()

        # the bisection beside it: do two default passes of one state on
        # one batch give the same gradients, bit for bit?
        differ, first = gradient_repeats(torch, dev, flags, batch)
        res["gradients_differing"] = differ
        log(f"two default passes of one state on one batch "
            f"(train-slab's flags): {len(differ)} parameter gradients differ"
            f"{f' (first module: {first}; {differ[:6]})' if differ else ''}"
            f"; on {card}")
        if differ:
            failed.append(f"gradient repeats: {len(differ)} differ, first "
                          f"module {first}")

        # float32 with the default flags, through the quickstart (runner
        # train mode, one epoch with validation): from_config runs the
        # bf16-only kernels' plain paths; which kernels launched
        from swinvox_tpu_torch.cli import quickstart
        rec.update(name="quickstart-f32", steps=[], saved=[], evals=[])
        for f in counters.values():
            f.launches = 0
        t = time.perf_counter()
        rc = quickstart.main(["--root", str(work / "quickstart-f32"),
                              "--epochs", "1", "--train-samples", "16",
                              "--views", "3", "--batch-size", "8",
                              "--dtype", "float32", "--platform", str(dev)])
        torch.cuda.synchronize()
        launched = {k: f.launches for k, f in counters.items()}
        routes = rec["state"][0].model.kernel_routes
        ious = [i for _, i in rec["evals"]]
        runs["quickstart f32"] = {
            "rc": rc, "wall_s": time.perf_counter() - t,
            "steps": len(rec["steps"]), "val_iou": ious,
            "launches": launched, "kernel_routes": routes}
        log(f"quickstart float32, default flags: rc {rc}, "
            f"{len(rec['steps'])} steps, val IoU {ious}; resolved routes "
            f"{routes}; launches {launched}; on {card}")
        if rc != 0 or not rec["steps"] or not rec["evals"] or any(
                routes.values()) or any(launched.values()):
            failed.append(f"quickstart float32: rc {rc}, routes {routes}, "
                          f"launches {launched}")
        rec.clear()
    finally:
        for k, fn in real.items():
            setattr(trainer, k, fn)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    report["train_net"] = runs
    if failed:
        raise AssertionError("training phase: " + "; ".join(failed))
    return runs


GRAD_GROUPS = {  # reported group: parameter-name prefixes
    "encoder": ("encoder.",), "decoder": ("decoder.",),
    "merger": ("merger.",), "refiner": ("refiner.",),
    "encoder.resnet": ("encoder.resnet.", "encoder.resnet_reduce."),
    "encoder.swin": ("encoder.swin.",),
    "encoder.stage maps": ("encoder.swin_",),
    "encoder.cross_view": ("encoder.cross_view_attention.",),
    "encoder.fusion": ("encoder.fusion_", "encoder.layer"),
}
MODULES = ("encoder", "decoder", "merger", "refiner")


def grad_distance(torch, grads, ref, names):
    """Per group of GRAD_GROUPS: relative L2 distance of the concatenated
    gradients, and the median over its tensors of each one's relative
    L2."""
    out = {}
    for mod, prefixes in GRAD_GROUPS.items():
        keys = [n for n in names if n.startswith(prefixes)]
        a = torch.cat([grads[k].float().reshape(-1) for k in keys])
        b = torch.cat([ref[k].float().reshape(-1) for k in keys])
        out[mod] = {"rel_l2": rel_l2(a, b), "norm": b.norm().item(),
                    "median_tensor_rel_l2": statistics.median(
                        rel_l2(grads[k], ref[k]) for k in keys)}
    return out


def profile_ops(torch, fn):
    """Over one call of ``fn`` (which ends in a synchronize): the wall, and
    by op (aten ops and CUDA runtime calls) its self host ms, self device
    ms and calls, and by kernel its device ms (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    ops, kernels = {}, {}
    for e in prof.key_averages():
        if "spin_kernel" in e.key or "_sleep" in e.key:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA:
            name = short_name(e.key)
            kernels[name] = kernels.get(name, 0.0) + dev_us / 1e3
        else:
            ops[e.key] = {"host_ms": e.self_cpu_time_total / 1e3,
                          "device_ms": dev_us / 1e3, "calls": e.count}
    return {"wall_ms": wall, "device_ms": sum(kernels.values()),
            "host_ms": sum(o["host_ms"] for o in ops.values()),
            "ops": ops, "kernels": kernels}


def op_growth(a, b, key, top=16):
    """The entries of ``key`` ("ops" or "kernels") of two ``profile_ops``
    readings whose time grows most from ``a`` to ``b``: (name, a's and
    b's times), by the larger of the host and device growth."""
    def times(prof, name):
        v = prof[key].get(name)
        if v is None:
            return {"host_ms": 0.0, "device_ms": 0.0, "calls": 0}
        return v if isinstance(v, dict) else {"host_ms": 0.0,
                                              "device_ms": v, "calls": None}

    rows = []
    for name in set(a[key]) | set(b[key]):
        ta, tb = times(a, name), times(b, name)
        grow = max(tb["host_ms"] - ta["host_ms"],
                   tb["device_ms"] - ta["device_ms"])
        rows.append((grow, name, ta, tb))
    rows.sort(key=lambda r: -r[0])
    return [{"name": n, "growth_ms": g, "a": ta, "b": tb}
            for g, n, ta, tb in rows[:top] if g > 0]


STEP_MODE_STEPS = 10  # timed steps per mode and turn


def step_modes(torch, dev, card, report):
    """The batch-32 1-view default train step, full width, run as it is
    ("default") and under ``deterministic_algorithms`` in turns (default,
    deterministic, deterministic, default; STEP_MODE_STEPS timed steps a
    turn, host clock around each step and its synchronize), then one step
    of each profiled by op and kernel: the wall medians, device times,
    and the ops and kernels whose time grows from one mode to the
    other."""
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    st, opts = create_train_state(flag_config({}),
                                  torch.Generator().manual_seed(SEED),
                                  device=dev)
    step = make_train_step(st.model, opts)
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.standard_normal(
        (BATCH, 1, 224, 224, 3)).astype(np.float32)).to(dev)
    vol = torch.from_numpy(
        (rng.random((BATCH, 32, 32, 32)) < 0.3).astype(np.uint8)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def one(mode):
        with DET_MODES[mode](torch):
            step(st, img, vol, gen)
            torch.cuda.synchronize()

    walls = {"default": [], "deterministic": []}
    for mode in walls:
        for _ in range(2):
            one(mode)
    for mode in ("default", "deterministic", "deterministic", "default"):
        for _ in range(STEP_MODE_STEPS):
            t0 = time.perf_counter()
            one(mode)
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    profs = {mode: profile_ops(torch, lambda m=mode: one(m)) for mode in walls}
    a, b = profs["default"], profs["deterministic"]
    out = {"card": card, "batch": BATCH, "views": 1,
           "wall_ms": {m: summary(w) for m, w in walls.items()},
           "profile": {m: {k: v for k, v in p.items()
                           if k not in ("ops", "kernels")}
                       for m, p in profs.items()},
           "ops": {m: p["ops"] for m, p in profs.items()},
           "ops_growing": op_growth(a, b, "ops"),
           "kernels_growing": op_growth(a, b, "kernels")}
    del st, opts, step
    torch.cuda.empty_cache()
    wd, wt = (statistics.median(walls[m]) for m in walls)
    log(f"train step batch {BATCH}, 1 view: wall median default {wd:.3f} ms"
        f", deterministic {wt:.3f} ms ({100 * (wt / wd - 1):+.1f}%); one "
        f"profiled step: device {a['device_ms']:.3f} / {b['device_ms']:.3f} "
        f"ms, host (self, all ops) {a['host_ms']:.3f} / {b['host_ms']:.3f} "
        f"ms, wall {a['wall_ms']:.3f} / {b['wall_ms']:.3f} ms; on {card}")
    for key in ("ops_growing", "kernels_growing"):
        log(f"  {key.replace('_', ' ')} (host / device ms, calls; default "
            "-> deterministic):")
        for r in out[key]:
            d, t = r["a"], r["b"]
            log(f"    {r['name'][:72]}: {d['host_ms']:.3f} / "
                f"{d['device_ms']:.3f} ({d['calls']}) -> {t['host_ms']:.3f} "
                f"/ {t['device_ms']:.3f} ({t['calls']})")
    report["step_modes"] = out
    return out


def step_repeats(torch, dev, card, report):
    """``gradient_repeats`` in the default mode for the default flags and
    for ``train-slab``'s (TRAIN_CONFIGS' batches, 3 views); where a
    gradient differs, again under each global mode of DET_MODES, which
    names the setting that makes it repeat.  Returns the failures."""
    out, failed = {}, []
    for name in ("train-default", "train-slab"):
        batch, flags = TRAIN_CONFIGS[name]
        rec = out[name] = {}
        for mode in DET_MODES:
            differ, first = gradient_repeats(torch, dev, flags, batch, mode)
            modules = sorted({".".join(k.split(".")[:2]) for k in differ})
            rec[mode] = {"differing": differ, "first_module": first,
                         "modules": modules}
            log(f"gradient repeats, {name} (batch {batch}, {TRAIN_VIEWS} "
                f"views), {mode}: {len(differ)} parameter gradients differ"
                + (f" (first module {first}; in {modules})" if differ
                   else "") + f"; on {card}")
            if mode == "default":
                if not differ:
                    break
                failed.append(f"{name}: {len(differ)} gradients differ "
                              f"between two default passes, first {first}")
    report["gradient_repeats"] = out
    return failed


def rewindow_wattn_phase(torch, dev, card, report):
    """``--rewindow-wattn``: kernel A's check (phase 3's, with the device
    time of a forward's 7 calls and the ``index_select`` yardstick) and
    kernel G's (phase 13's, with the device time of a forward's 12
    calls and the SDPA yardstick), then ``gradient_repeats`` in the
    default mode for both flag sets and the batch-32 1-view step
    profiled as it is and under ``deterministic_algorithms``."""
    from swinvox_tpu_torch.models.swin import shifted_window_mask
    from swinvox_tpu_torch.ops import pallas_window_attention as wa
    from swinvox_tpu_torch.ops import rewindow as rw

    check_rewindow(torch, rw, dev, report)
    report["rewindow"]["library_ms"] = library_rewindow(torch, rw, dev)
    log(f"index_select yardstick: {report['rewindow']['library_ms']:.4f} ms "
        "for the 7 calls of a forward")
    check_window_attention(torch, wa, shifted_window_mask, dev, report)
    failed = step_repeats(torch, dev, card, report)
    step_modes(torch, dev, card, report)
    if failed:
        raise AssertionError("gradient repeats: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# Phase 17: the front ends (HTTP serving, the LR finder, the tuner, the
# augmentation on the card with --profile, the pretrained start, the
# Pix3D and Pascal3D evaluation), each through its entry point.

FRONT_SAMPLES = (32, 8)        # train, val samples per category (2)
FRONT_BATCH = 16               # 1 view: E 1 a step; 3 views: E and F
HTTP_BATCH = 8                 # the HTTP servers' batch, 3 views
HTTP_REQUESTS = 48             # the timed burst, from HTTP_THREADS clients
HTTP_THREADS = 6
HTTP_MODELS_APART = 1e-2       # the two models' responses differ by more
LR_STEPS = 12
AUG_ATOL, AUG_RTOL = 3e-4, 1e-4  # device augmentation vs host transform
CROSS_SAMPLES = 8              # Pix3D and Pascal3D fixture samples
FRONT_COUNTERS = ("fused_swin_block", "swin_block_train_forward",
                  "swin_block_train_backward", "merger_stack_forward",
                  "merger_stack_backward")


@contextlib.contextmanager
def quiet_log():
    """The per-call lines of the hold helpers kept out of stdout."""
    global log
    real = log
    log = lambda *a: None  # noqa: E731
    try:
        yield
    finally:
        log = real


@contextlib.contextmanager
def counted(counters):
    """Launch counters at 0 for what runs inside."""
    for f in counters.values():
        f.launches = 0
    yield None


@contextlib.contextmanager
def front_recorders(torch, counters):
    """Launch counters at 0, and every B, C/D and merger-stack call of
    what runs inside recorded (``Recorder``); yields the recorders."""
    from swinvox_tpu_torch.models import merger as merger_mod
    from swinvox_tpu_torch.models import swin as swin_mod

    with counted(counters), contextlib.ExitStack() as stack:
        yield {k: stack.enter_context(Recorder(torch, mod, attr))
               for k, mod, attr in (
                   ("B", swin_mod, "fused_swin_block"),
                   ("CD", swin_mod, "fused_swin_block_train"),
                   ("EF", merger_mod, "merger_stack"))}


def hold_front_calls(torch, tag, recs, launches):
    """Every recorded call of a front-end run against its plain version on
    its own inputs: B by phase 4's rule, C and D by phase 10's
    (``hold_step_swin``), E and F by phase 9's.  Raises on any failure."""
    from swinvox_tpu_torch.ops import pallas_merger_stack as ms
    from swinvox_tpu_torch.ops import pallas_swin_block as blk

    out = {}
    with quiet_log():
        if recs["B"].calls or launches["fused_swin_block"]:
            out["B"] = hold_eval_calls(torch, tag, recs["B"].calls,
                                       blk.swin_block_reference,
                                       launches["fused_swin_block"])
        if recs["CD"].calls:
            out["CD"] = hold_step_swin(torch, blk, recs["CD"].calls, tag)
        out["EF"] = hold_run_merger_calls(torch, ms, recs["EF"].calls, tag)
    failed = out.get("B", {}).get("failed", []) + out["EF"]["failed"]
    if len(recs["CD"].calls) != launches["swin_block_train_forward"]:
        failed.append(f"{tag}: {len(recs['CD'].calls)} C calls recorded, "
                      f"{launches['swin_block_train_forward']} launched")
    if len(recs["EF"].calls) != launches["merger_stack_forward"]:
        failed.append(f"{tag}: {len(recs['EF'].calls)} merger-stack calls "
                      f"recorded, {launches['merger_stack_forward']} "
                      "launched")
    log(f"  {tag}: held " + ", ".join(
        f"{k} {len(r.calls)} calls" for k, r in recs.items())
        + " against the plain versions on their own inputs; worst " + "; "
        .join(f"{k} {v['worst']}" for k, v in out.items())
        + f"; {len(failed)} failed")
    if failed:
        raise AssertionError("; ".join(failed[:8]))
    for r in recs.values():
        r.calls.clear()
    return {k: {"calls": v.get("calls"), "worst": v["worst"]}
            for k, v in out.items()}


def want_front(cfg, batch, views, steps, forwards):
    """B, C, D, E, F launches of ``steps`` train steps and ``forwards``
    evaluation forwards under ``cfg`` (A is on no model path)."""
    per = train_launches(cfg, batch, views)
    want = {k: steps * per[k] for k in FRONT_COUNTERS[1:]}
    want["fused_swin_block"] = forwards * swin_calls(cfg)
    return want


def front_runner(torch, argv, name):
    from swinvox_tpu_torch.cli import runner

    t = time.perf_counter()
    if runner.main(argv) != 0:
        raise AssertionError(f"runner {name} failed")
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _post(url, body, timeout=300):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npy(x):
    import io

    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


class GatedPredictor:
    """A Predictor whose ``predict`` waits at a gate first (the queue and
    the timeout of the status checks made deterministic)."""

    def __init__(self, predictor):
        import threading

        self.predictor, self.cfg = predictor, predictor.cfg
        self.entered, self.gate = threading.Event(), threading.Event()

    def predict(self, batch):
        self.entered.set()
        if not self.gate.wait(300):
            raise TimeoutError("gate never opened")
        return self.predictor.predict(batch)


def http_statuses(serve, predictor, **server_kw):
    """Statuses of three requests to a gated server: the first held in
    ``predict``, the second queued, then the third; 0.3 s later the gate
    opens."""
    import threading

    gated = GatedPredictor(predictor)
    server = serve.BatchingServer(gated, batch_size=1, n_views=1,
                                  max_wait_ms=0.0, **server_kw)
    httpd = serve._make_http_server(server, 0, "127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
    body = _npy(np.random.default_rng(SEED + 21).standard_normal(
        (1, 224, 224, 3)).astype(np.float32))
    res, clients = {}, []

    def start(i):
        clients.append(threading.Thread(
            target=lambda: res.__setitem__(i, _post(url, body)[0])))
        clients[-1].start()

    try:
        start(0)
        if not gated.entered.wait(300):
            raise AssertionError("the gated server took no request")
        start(1)
        for _ in range(3000):
            if server._queue.qsize() == 1:
                break
            time.sleep(0.01)
        start(2)
        time.sleep(0.3)
    finally:
        gated.gate.set()
        for c in clients:
            c.join(timeout=300)
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        server.close()
    return tuple(res.get(i) for i in range(3))


def http_requests(n):
    """The HTTP phase's requests: two warm-ups, then ``n``; each (route,
    [1 or 3, 224, 224, 3] images), half to each model."""
    rng = np.random.default_rng(SEED + 20)
    return [("/predict" if i % 2 == 0 else "/predict/b",
             rng.standard_normal((1 if i % 4 < 2 else 3, 224, 224, 3))
             .astype(np.float32)) for i in range(n + 2)]


def http_client(url, out, n, threads):
    """The HTTP phase's clients, run in a process of their own: the two
    warm-up requests in turn, then the rest from HTTP_THREADS threads at
    once; the responses to ``out`` (npz) and, as the last line of stdout,
    each request's latency and the burst's start and length (perf_counter
    is one clock across processes here)."""
    import io

    reqs = http_requests(int(n))
    lat, results = {}, {}

    def send(i):
        path, x = reqs[i]
        t = time.perf_counter()
        status, body = _post(url + path, _npy(x))
        lat[i] = (time.perf_counter() - t) * 1e3
        if status != 200:
            raise AssertionError(f"request {i} {path}: status {status} "
                                 f"{body[:200]!r}")
        results[f"r{i}"] = np.load(io.BytesIO(body))

    send(0)
    send(1)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(int(threads)) as pool:
        list(pool.map(send, range(2, len(reqs))))
    burst_s = time.perf_counter() - t0
    np.savez(out, **results)
    print(json.dumps({"latency_ms": [lat[i] for i in range(len(reqs))],
                      "t0": t0, "burst_s": burst_s}))


def http_front(torch, dev, card, counters, ckpts, work):
    """``python -m swinvox_tpu_torch.serve`` in-process (``serve.main``):
    two checkpoints behind one MultiServer on 127.0.0.1, port 0, batch
    HTTP_BATCH at 3 views; a warm-up request per model, then HTTP_REQUESTS
    of 1 and 3 views from HTTP_THREADS threads of a client process, half
    to each model; each response held against Predictor.predict (see the
    top); 404 for an unknown model; 503 and 504 from gated servers
    (max_queue 1, timeout_ms 50) around the same predictor; every B call
    held against its plain version."""
    import threading
    import urllib.request

    from swinvox_tpu_torch import serve
    from swinvox_tpu_torch.infer import Predictor

    made, pred_spans, batches_run = [], [], []
    real_from = Predictor.from_checkpoint.__func__

    def recorded_from(cls, path, cfg=None, device="cuda"):
        """The predictor, its ``predict`` timed (it returns host arrays,
        so the wall is the card's work and the copies) and each batch it
        ran kept with its result."""
        pred = real_from(cls, path, cfg, device)
        real_predict = pred.predict
        which = len(made)

        def predict(batch):
            t = time.perf_counter()
            res = real_predict(batch)
            pred_spans.append((t, time.perf_counter()))
            batches_run.append((which, batch.copy(), res.copy()))
            return res

        pred.predict = predict
        made.append(pred)
        return pred

    reqs = http_requests(HTTP_REQUESTS)
    ready = []
    argv = ["--checkpoint", f"a={ckpts[0]}", "--checkpoint",
            f"b={ckpts[1]}", "--port", "0", "--host", "127.0.0.1",
            "--batch-size", str(HTTP_BATCH), "--n-views", "3",
            "--max-wait-ms", "5", "--platform", str(dev)]

    Predictor.from_checkpoint = classmethod(recorded_from)
    try:
        with front_recorders(torch, counters) as recs:
            thread = threading.Thread(target=lambda: serve.main(
                argv, on_ready=ready.append), daemon=True)
            thread.start()
            for _ in range(6000):
                if ready or not thread.is_alive():
                    break
                time.sleep(0.05)
            if not ready:
                raise AssertionError("serve.main did not come up")
            url = f"http://127.0.0.1:{ready[0].server_address[1]}"
            try:
                # the clients in a process of their own, off the server's
                # interpreter lock
                client = subprocess.run(
                    [sys.executable, "-c", "import sys; sys.path.insert(0, "
                     f"{str(ROOT)!r}); import chip_smoke; "
                     "chip_smoke.http_client(*sys.argv[1:])", url,
                     str(work / "responses.npz"), str(HTTP_REQUESTS),
                     str(HTTP_THREADS)], capture_output=True,
                    text=True, timeout=900)
                if client.returncode != 0:
                    raise AssertionError(
                        "HTTP client: " + client.stderr[-2000:])
                run = json.loads(client.stdout.splitlines()[-1])
                unknown = _post(url + "/predict/nope", _npy(reqs[0][1]))[0]
                with urllib.request.urlopen(url + "/stats", timeout=60) as r:
                    stats = json.loads(r.read())
            finally:
                ready[0].shutdown()
                thread.join(timeout=300)
            if thread.is_alive():
                raise AssertionError("serve.main did not return after "
                                     "shutdown")
            full = http_statuses(serve, made[0], max_queue=1)
            late = http_statuses(serve, made[0], max_queue=4,
                                 timeout_ms=50.0)
            torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
        batches = sum(s["batches"] for s in stats.values())
        held = hold_front_calls(torch, "HTTP", recs, launches)
    finally:
        Predictor.from_checkpoint = classmethod(real_from)
    gated_batches = sum(s == 200 for s in full + late)
    if launches["fused_swin_block"] != swin_calls(made[0].cfg) * (
            batches + gated_batches):
        raise AssertionError(f"HTTP: B launches {launches} for {batches} "
                             f"+ {gated_batches} batches")
    if (unknown, full, late) != (404, (200, 200, 503), (200, 504, 504)):
        raise AssertionError(f"HTTP statuses: unknown model {unknown}, "
                             f"full queue {full}, timeout {late}")
    # each response is its row of a batch the server ran, and
    # Predictor.predict of that batch gives the same bits again (it did
    # not while two dispatchers' predicts could clear each other's cuDNN
    # flags: up to 0.015 apart); slot_max_abs reads the request in
    # another batch and slot
    with np.load(work / "responses.npz") as z:
        results = [z[f"r{i}"] for i in range(len(reqs))]
    served = [b for b in batches_run if b[1].shape[0] == HTTP_BATCH]
    for which, batch, res in served:
        again = made[which].predict(batch)
        if not np.array_equal(again, res):
            raise AssertionError(
                "Predictor.predict of a served batch does not repeat its "
                f"result: max abs {float(np.abs(again - res).max())}")
    fits = [x[np.arange(3) % x.shape[0]] for _, x in reqs]
    for i, (path, _) in enumerate(reqs):
        got, which = results[i], int(path.endswith("/b"))
        if got.shape != (32, 32, 32) or not np.all(np.isfinite(got)):
            raise AssertionError(f"HTTP request {i}: bad result {got.shape}")
        rows = [res[j] for w, batch, res in served if w == which
                for j in range(HTTP_BATCH) if np.array_equal(batch[j],
                                                             fits[i])]
        if not any(np.array_equal(got, r) for r in rows):
            raise AssertionError(f"HTTP request {i} {path}: the response is "
                                 "no row of a batch its model ran")
    # the requests again in batches of their order, through both models:
    # the own model's result stays within VIEW3_MAX, the other's is far
    slot_err = between = 0.0
    for lo in range(0, len(reqs), HTTP_BATCH):
        group = np.zeros((HTTP_BATCH,) + fits[0].shape, np.float32)
        n = len(fits[lo:lo + HTTP_BATCH])
        group[:n] = fits[lo:lo + HTTP_BATCH]
        outs = [m.predict(group) for m in made[:2]]
        for j in range(n):
            which = int(reqs[lo + j][0].endswith("/b"))
            got = results[lo + j]
            slot_err = max(slot_err, float(np.abs(outs[which][j] - got)
                                           .max()))
            between = max(between, float(np.abs(outs[1 - which][j] - got)
                                         .max()))
    if between < HTTP_MODELS_APART or slot_err > VIEW3_MAX:
        raise AssertionError(f"HTTP: a response in another batch moves by "
                             f"{slot_err} (bound {VIEW3_MAX}); the two "
                             f"models differ by {between}")
    timed, t0, burst_s = run["latency_ms"][2:], run["t0"], run["burst_s"]
    burst = [(b - a) * 1e3 for a, b in pred_spans
             if t0 <= a and b <= t0 + burst_s]
    res = {"requests": len(reqs), "batches": batches, "stats": stats,
           "burst_predict_ms": summary(burst),
           "burst_predict_share": sum(burst) / 1e3 / burst_s,
           "latency_ms": summary(timed),
           "latency_p99_ms": float(np.percentile(timed, 99)),
           "requests_per_s": len(timed) / burst_s, "burst_s": burst_s,
           "served_batches_repeated": len(served),
           "slot_max_abs": slot_err, "models_differ_by": between,
           "statuses": {"unknown_model": unknown, "queue_full": full,
                        "timeout": late},
           "launches": launches, "held": held}
    log(f"HTTP (serve.main, 2 models, batch {HTTP_BATCH}, 3 views): "
        f"{len(timed)} requests of 1 and 3 views from {HTTP_THREADS} "
        f"threads of a client process in {burst_s:.3f} s, "
        f"{res['requests_per_s']:.2f} requests/s; latency ms median "
        f"{res['latency_ms']['median']:.3f}, "
        f"p99 {res['latency_p99_ms']:.3f}, max {max(timed):.3f}; "
        f"{batches} batches in all, {len(burst)} in the burst, predict ms "
        f"median {res['burst_predict_ms']['median']:.3f} (their sum "
        f"{res['burst_predict_share']:.3f} of the burst's wall; two "
        f"dispatchers share the card); every response its row of a batch "
        f"its model ran, and Predictor.predict of each of the "
        f"{len(served)} batches repeats its bits; the same request in "
        f"another batch and slot moves by up to {slot_err:.6g} (bf16), the "
        f"other model's by {between:.6g};"
        f" statuses unknown model {unknown}, full queue {full}, timeout "
        f"{late}; launches {launches}; on {card}")
    return res


def fake_backbones(out_dir):
    """``resnet50.npz`` and ``swin_tiny.npz`` of the real shapes
    (torchvision and timm names), numpy-seeded; returns the dicts."""
    rng = np.random.default_rng(SEED + 30)

    def normal(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    res = {}

    def bn(name, c):
        res[f"{name}.weight"] = 1 + normal(c)
        res[f"{name}.bias"] = normal(c)
        res[f"{name}.running_mean"] = normal(c)
        res[f"{name}.running_var"] = 1 + np.abs(normal(c))

    res["conv1.weight"] = normal(64, 3, 7, 7)
    bn("bn1", 64)
    in_c = 64
    for stage, (depth, width) in enumerate([(3, 64), (4, 128), (6, 256)], 1):
        for b in range(depth):
            p = f"layer{stage}.{b}"
            res[f"{p}.conv1.weight"] = normal(width, in_c if b == 0
                                              else width * 4, 1, 1)
            bn(f"{p}.bn1", width)
            res[f"{p}.conv2.weight"] = normal(width, width, 3, 3)
            bn(f"{p}.bn2", width)
            res[f"{p}.conv3.weight"] = normal(width * 4, width, 1, 1)
            bn(f"{p}.bn3", width * 4)
            if b == 0:
                res[f"{p}.downsample.0.weight"] = normal(width * 4, in_c, 1,
                                                         1)
                bn(f"{p}.downsample.1", width * 4)
        in_c = width * 4
    sw = {"patch_embed.proj.weight": normal(96, 3, 4, 4),
          "patch_embed.proj.bias": normal(96),
          "patch_embed.norm.weight": 1 + normal(96),
          "patch_embed.norm.bias": normal(96)}
    dims, heads = [96, 192, 384, 768], [3, 6, 12, 24]
    for s, depth in enumerate([2, 2, 6, 2]):
        c = dims[s]
        if s > 0:
            p = f"layers.{s}.downsample"
            sw[f"{p}.norm.weight"] = 1 + normal(4 * dims[s - 1])
            sw[f"{p}.norm.bias"] = normal(4 * dims[s - 1])
            sw[f"{p}.reduction.weight"] = normal(2 * dims[s - 1],
                                                 4 * dims[s - 1])
        for d in range(depth):
            p = f"layers.{s}.blocks.{d}"
            for n in ("norm1", "norm2"):
                sw[f"{p}.{n}.weight"] = 1 + normal(c)
                sw[f"{p}.{n}.bias"] = normal(c)
            for n, (o, i) in (("attn.qkv", (3 * c, c)),
                              ("attn.proj", (c, c)),
                              ("mlp.fc1", (4 * c, c)),
                              ("mlp.fc2", (c, 4 * c))):
                sw[f"{p}.{n}.weight"] = normal(o, i)
                sw[f"{p}.{n}.bias"] = normal(o)
            sw[f"{p}.attn.relative_position_bias_table"] = normal(
                169, heads[s], scale=0.5)
    np.savez(out_dir / "resnet50.npz", **res)
    np.savez(out_dir / "swin_tiny.npz", **sw)
    return res, sw


def pretrained_front(torch, dev, counters, work):
    """``create_train_state`` with NETWORK.PRETRAINED_BACKBONE on fake
    backbone files of the real shapes: every grafted tensor equal to its
    source; then one training step from the grafted state (batch
    FRONT_BATCH, 1 view), its C, D and E calls held."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.models.pretrained import (
        convert_timm_swin_tiny,
        convert_torch_resnet50_trunk,
    )
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    bdir = work / "backbones"
    bdir.mkdir()
    res_sd, swin_sd = fake_backbones(bdir)
    cfg = default_config()
    cfg.NETWORK.INIT_SCHEME = "standard"
    cfg.NETWORK.PRETRAINED_BACKBONE = str(bdir)
    state, opts = create_train_state(cfg, torch.Generator().manual_seed(SEED),
                                     device=dev)
    n = 0
    enc = state.model.encoder
    for part, conv in ((enc.resnet, convert_torch_resnet50_trunk(res_sd)),
                       (enc.swin, convert_timm_swin_tiny(swin_sd))):
        have = part.state_dict()
        for name, arr in conv.items():
            if not np.array_equal(have[name].cpu().numpy(), arr):
                raise AssertionError(f"grafted {name} differs from its "
                                     "source")
            n += 1
    rng = np.random.default_rng(SEED + 31)
    img = rng.standard_normal((FRONT_BATCH, 1, 224, 224, 3)).astype(
        np.float32)
    vol = (rng.random((FRONT_BATCH, 32, 32, 32)) < 0.3).astype(np.uint8)
    step = make_train_step(state.model, opts)
    with front_recorders(torch, counters) as recs:
        _, metrics = step(state, img, vol,
                          torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = want_front(cfg, FRONT_BATCH, 1, 1, 0)
    if launches != want:
        raise AssertionError(f"pretrained step launches {launches} != {want}")
    held = hold_front_calls(torch, "pretrained start", recs, launches)
    loss = float(metrics["total_loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"pretrained start: loss {loss}")
    log(f"pretrained graft: {n} tensors (ResNet-50 trunk and Swin-Tiny from "
        f".npz) equal to their sources; one step from it, loss {loss:.6f}, "
        f"launches {launches}")
    return {"grafted": n, "loss": loss, "launches": launches, "held": held}


def front_ends_phase(torch, dev, card, report):
    """Phase 17 (see the top); its fixtures and checkpoints live in a
    temporary directory outside the repo, removed even on failure."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="swinvox_chip_smoke_front_"))
    try:
        return _front_ends_phase(torch, dev, card, report, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _front_ends_phase(torch, dev, card, report, work):
    from swinvox_tpu_torch.cli import runner
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.data.pipeline import build_loader
    from swinvox_tpu_torch.data.synthetic import (
        generate_dataset,
        generate_pascal3d_dataset,
        generate_pix3d_dataset,
    )
    from swinvox_tpu_torch.data.taxonomy import DatasetType
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.ops import pallas_merger_stack as ms
    from swinvox_tpu_torch.ops import pallas_swin_block as blk
    from swinvox_tpu_torch.train import lr_finder, trainer
    from swinvox_tpu_torch.train.checkpoint import save_params_only

    counters = {"fused_swin_block": blk.fused_swin_block,
                "swin_block_train_forward": blk.swin_block_train_forward,
                "swin_block_train_backward": blk.swin_block_train_backward,
                "merger_stack_forward": ms.merger_stack_forward,
                "merger_stack_backward": ms.merger_stack_backward}
    out = {}
    t0 = time.perf_counter()
    n_train, n_val = FRONT_SAMPLES
    data = work / "data"
    generate_dataset(str(data), (n_train, n_val, 0), 3,
                     list(EVAL_CATEGORIES), seed=SEED)
    ckpts = []
    for i, seed in enumerate((SEED, SEED + 1)):
        cfg = default_config()
        cfg.NETWORK.INIT_SCHEME = "standard"
        ckpts.append(str(work / f"model{i}.ckpt"))
        save_params_only(ckpts[-1], SwinVoxModel.from_config(
            cfg, torch.Generator().manual_seed(seed)))
    log(f"front-end fixture ({2 * n_train} train, {2 * n_val} val samples, "
        f"3 views) and two checkpoints written in "
        f"{time.perf_counter() - t0:.1f} s")
    base = ["--dataset-root", str(data), "--platform", str(dev), "--set",
            "NETWORK.INIT_SCHEME=standard", "--set", "CONST.NUM_WORKER=8",
            "--set", "TEST.EVAL_BATCH_SIZE=8"]
    cfg = default_config()

    # ---- HTTP serving: serve.main with a MultiServer of two checkpoints
    out["http"] = http_front(torch, dev, card, counters, ckpts, work)

    # ---- runner --lr_find: LR_STEPS sweep steps at batch FRONT_BATCH
    real_make, real_suggest = trainer.make_train_step, lr_finder.suggest_lr
    spans, seen = [], {}

    def timed_make(*a, **k):
        step = real_make(*a, **k)

        def timed(*sa, **sk):
            t = time.perf_counter()
            res = step(*sa, **sk)
            torch.cuda.synchronize()
            spans.append((t, time.perf_counter()))
            return res
        return timed

    def suggest(lrs, losses):
        seen.update(lrs=list(lrs), losses=list(losses),
                    suggestion=real_suggest(lrs, losses))
        return seen["suggestion"]

    lr_finder.make_train_step, lr_finder.suggest_lr = timed_make, suggest
    try:
        with front_recorders(torch, counters) as recs:
            wall = front_runner(torch, base + [
                "--lr_find", "--batch-size", str(FRONT_BATCH), "--n-views",
                "1", "--out", str(work / "lr"), "--set",
                f"LR_FINDER.NUM_BATCHES_TO_TEST={LR_STEPS}"], "--lr_find")
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        lr_finder.make_train_step = real_make
        lr_finder.suggest_lr = real_suggest
    held = hold_front_calls(torch, "--lr_find", recs, launches)
    want = want_front(cfg, FRONT_BATCH, 1, LR_STEPS, 0)
    if (launches != want or len(seen.get("losses", ())) != LR_STEPS
            or not all(np.isfinite(seen["losses"]))):
        raise AssertionError(f"--lr_find: launches {launches} (want {want})"
                             f", losses {seen.get('losses')}")
    rec_rate = (len(spans) - 1) / (spans[-1][0] - spans[0][0])
    spans.clear()
    lr_finder.make_train_step = timed_make
    try:
        with counted(counters):
            wall_timed = front_runner(torch, base + [
                "--lr_find", "--batch-size", str(FRONT_BATCH), "--n-views",
                "1", "--out", str(work / "lr-timed"), "--set",
                f"LR_FINDER.NUM_BATCHES_TO_TEST={LR_STEPS}"], "--lr_find")
        timed_launches = {k: f.launches for k, f in counters.items()}
    finally:
        lr_finder.make_train_step = real_make
    if timed_launches != want:
        raise AssertionError(f"--lr_find, unrecorded: launches "
                             f"{timed_launches} != {want}")
    out["lr_find"] = {"wall_s": wall, "launches": launches, "held": held,
                      "steps_per_s_recorded": rec_rate,
                      "timed": {"wall_s": wall_timed,
                                "launches": timed_launches},
                      "lrs": seen["lrs"], "smoothed_losses": seen["losses"],
                      "suggestion": seen["suggestion"],
                      "steps_per_s": (len(spans) - 1) / (
                          spans[-1][0] - spans[0][0]),
                      "step_ms": summary([(b - a) * 1e3 for a, b in spans])}
    log(f"runner --lr_find: {LR_STEPS} steps at batch {FRONT_BATCH}, 1 view;"
        f" suggested LR {seen['suggestion']:.4g}; smoothed losses "
        + ", ".join(f"{v:.5f}" for v in seen["losses"])
        + f"; {out['lr_find']['steps_per_s']:.3f} steps/s by step starts "
        f"in a second run, unrecorded ({rec_rate:.3f} with every call "
        f"recorded), step ms median {out['lr_find']['step_ms']['median']:.3f}"
        f"; walls {wall:.1f} / {wall_timed:.1f} s; launches {launches}; "
        f"on {card}")

    # ---- runner --tune: 2 trials of 1 epoch (batch 32 or 64, 1 view)
    tune_out = work / "tune"
    with front_recorders(torch, counters) as recs:
        wall = front_runner(torch, base + [
            "--tune", "--tune-trials", "2", "--tune-epochs", "1",
            "--n-views", "1", "--out", str(tune_out)], "--tune")
    launches = {k: f.launches for k, f in counters.items()}
    best = json.loads((tune_out / "config_best.json").read_text())
    states = [t["state"] for t in best["trials"]]
    if len(states) != 2 or "FAILED" in states:  # a FAILED trial hides a fault
        raise AssertionError(f"--tune trials {best['trials']}")
    want = dict.fromkeys(FRONT_COUNTERS, 0)
    for t in best["trials"]:
        b = t["params"]["CONST.BATCH_SIZE"]
        w = want_front(cfg, b, 1, 2 * n_train // b, 2 * n_val // 8)
        want = {k: want[k] + w[k] for k in want}
    if launches != want:
        raise AssertionError(f"--tune launches {launches} != {want}")
    held = hold_front_calls(torch, "--tune", recs, launches)
    out["tune"] = {"wall_s": wall, "trials": best["trials"],
                   "best_params": best["best_params"],
                   "best_value": best["best_value"], "launches": launches,
                   "held": held}
    log(f"runner --tune: trials " + "; ".join(
        f"{t['number']} {t['params']} {t['state']} IoU {t['values']}"
        for t in best["trials"]) + f"; config_best.json written; wall "
        f"{wall:.1f} s; launches {launches}")

    # ---- train_net under TRAIN.DEVICE_AUGMENT with --profile, every call
    # held; then the same epoch timed, unrecorded and unprofiled, with the
    # augmentation on the card and with the host transform
    aug = {}
    real_aug = trainer.apply_device_augment

    def kept_aug(host, c, device=None):
        images = real_aug(host, c, device)
        aug.setdefault("first", (host, images.cpu().numpy()))
        return images

    n_steps = 2 * n_train // FRONT_BATCH
    want = want_front(cfg, FRONT_BATCH, 3, n_steps, 2 * n_val // 8)
    walls = {}
    for name, on in (("held", True), ("device", True), ("host", False)):
        argv = base + ["--batch-size", str(FRONT_BATCH), "--epoch", "1",
                       "--n-views", "3", "--out", str(work / name), "--set",
                       "TRAIN.LOG_EVERY=1", "--set",
                       f"TRAIN.DEVICE_AUGMENT={str(on).lower()}"]
        spans.clear()
        if name == "held":
            argv.append("--profile")
            trainer.apply_device_augment = kept_aug
            ctx = front_recorders(torch, counters)
        else:
            trainer.make_train_step = timed_make
            ctx = counted(counters)
        try:
            with ctx as recs:
                wall = front_runner(torch, argv, f"train {name}")
            launches = {k: f.launches for k, f in counters.items()}
        finally:
            trainer.make_train_step = real_make
            trainer.apply_device_augment = real_aug
        if launches != want:
            raise AssertionError(f"train {name}: launches {launches} != "
                                 f"{want}")
        if name != "held":
            walls[name] = {"wall_s": wall, "launches": launches,
                           "iteration_ms": summary([
                               (b[0] - a[0]) * 1e3
                               for a, b in zip(spans, spans[1:])]),
                           "step_ms": summary([(b - a) * 1e3
                                               for a, b in spans])}
            continue
        held = hold_front_calls(torch, "train_net device augment", recs,
                                launches)
        host_cfg = runner.build_config(runner.get_args_from_command_line(
            argv))
        host_cfg.TRAIN.DEVICE_AUGMENT = False
        loader = build_loader(host_cfg, DatasetType.TRAIN)
        want_img = next(iter(loader)).images
        loader.close()
        host, got_img = aug["first"]
        diff = np.abs(got_img - want_img)
        bad = diff > AUG_ATOL + AUG_RTOL * np.abs(want_img)
        if host["images"].dtype != np.uint8 or got_img.shape != \
                want_img.shape or bad.any():
            raise AssertionError(f"device augmentation vs host transform: "
                                 f"{host['images'].dtype}, {got_img.shape}, "
                                 f"{int(bad.sum())} values apart, max "
                                 f"{float(diff.max())}")
        traces = list((work / name / "profile").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"--profile wrote {traces}")
        kernels = [e for e in json.loads(traces[0].read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        out["device_augment"] = {
            "launches": launches, "held": held,
            "augment_max_abs_vs_host": float(diff.max()),
            "profile_trace_mb": traces[0].stat().st_size / 1e6,
            "profile_kernel_events": len(kernels)}
        log(f"train_net TRAIN.DEVICE_AUGMENT --profile: the first batch's "
            f"images (uint8 {host['images'].shape} to the card) vs the host "
            f"transform of the same draws: max abs {float(diff.max()):.3g} "
            f"(atol {AUG_ATOL}, rtol {AUG_RTOL}); trace {traces[0].name}, "
            f"{out['device_augment']['profile_trace_mb']:.1f} MB, "
            f"{len(kernels)} kernel events; launches {launches}")
    out["augment_walls"] = walls
    log(f"train_net batch {FRONT_BATCH}, 3 views, {n_steps} steps, "
        "unrecorded: iteration wall ms (step start to step start, median of "
        f"{n_steps - 1}) with the augmentation on the card "
        f"{walls['device']['iteration_ms']['median']:.3f}, host transform "
        f"{walls['host']['iteration_ms']['median']:.3f}; step ms median "
        f"{walls['device']['step_ms']['median']:.3f} / "
        f"{walls['host']['step_ms']['median']:.3f}; on {card}")

    # ---- the pretrained start
    out["pretrained"] = pretrained_front(torch, dev, counters, work)

    # ---- runner --test on the Pix3D and Pascal3D fixtures
    out["cross"] = {}
    for name, gen in (("Pix3D", generate_pix3d_dataset),
                      ("Pascal3D", generate_pascal3d_dataset)):
        ccfg = gen(str(work / name), CROSS_SAMPLES, seed=SEED)
        (work / f"{name}.json").write_text(ccfg.to_json())
        with front_recorders(torch, counters) as recs:
            wall = front_runner(torch, base + [
                "--test", "--weights", ckpts[0], "--config",
                str(work / f"{name}.json"), "--out",
                str(work / f"{name}-out")], f"--test {name}")
        launches = {k: f.launches for k, f in counters.items()}
        want = want_front(cfg, 1, 1, 0, -(-CROSS_SAMPLES // 8))
        if launches != want:
            raise AssertionError(f"--test {name}: launches {launches} != "
                                 f"{want}")
        held = hold_front_calls(torch, f"--test {name}", recs, launches)
        (run,) = list((work / f"{name}-out").iterdir())
        rows = [json.loads(line) for line in
                (run / "logs" / "test.jsonl").read_text().splitlines()]
        iou = [r["value"] for r in rows if r["tag"] == "Refiner/IoU"]
        if len(iou) != 1 or not 0.0 <= iou[0] <= 1.0:
            raise AssertionError(f"--test {name}: IoU {iou}")
        out["cross"][name] = {"iou": iou[0], "wall_s": wall,
                              "launches": launches, "held": held}
        log(f"runner --test {name}: {CROSS_SAMPLES} samples (bbox crop), "
            f"IoU {iou[0]:.4f}, wall {wall:.1f} s; launches {launches}")

    runs = [out["http"], out["lr_find"], out["lr_find"]["timed"], out["tune"],
            out["device_augment"],
            *walls.values(), out["pretrained"], *out["cross"].values()]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in FRONT_COUNTERS}
    report["front_ends"] = out
    return out


def eval_counters(rw, blk, fm, mi, wa):
    """The launch counters phase 14 reads."""
    return {"rewindow": rw.rewindow,
            "fused_swin_block": blk.fused_swin_block,
            "fused_msa_forward": fm.fused_msa_forward,
            "merger_view_weights": mi.merger_view_weights,
            "window_attention_forward": wa.window_attention_forward}


def main(argv) -> int:
    if argv == ["--rewindow-wattn"]:
        # cuBLAS reads this when it starts: use_deterministic_algorithms
        # (the step's readings in that mode) refuses cuBLAS without it.
        # The full run leaves it unset, as a user's run does: phase 16
        # holds the default step's repeats without it
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    modes = {"--eval-only": "eval", "--merger-stack": "merger",
             "--merger-conv": "merger_conv", "--wmsa-down1": "wmsa_down1",
             "--rewindow-wattn": "rewindow_wattn",
             "--front-ends": "front_ends"}
    if argv and (len(argv) > 1 or argv[0] not in modes):
        print(f"usage: chip_smoke.py [{' | '.join(modes)}], not {argv}",
              file=sys.stderr)
        return 2
    eval_only = argv == ["--eval-only"]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.infer import Predictor
    from swinvox_tpu_torch.kernels import build
    from swinvox_tpu_torch.models import merger as merger_mod
    from swinvox_tpu_torch.models import swin as swin_mod
    from swinvox_tpu_torch.models.swin import shifted_window_mask
    from swinvox_tpu_torch.models.swinvox import SwinVoxModel
    from swinvox_tpu_torch.ops import pallas_band_conv as bc
    from swinvox_tpu_torch.ops import pallas_down1 as d1
    from swinvox_tpu_torch.ops import pallas_fused_msa as fm
    from swinvox_tpu_torch.ops import pallas_merger as mi
    from swinvox_tpu_torch.ops import pallas_merger_stack as ms
    from swinvox_tpu_torch.ops import pallas_swin_block as blk
    from swinvox_tpu_torch.ops import pallas_window_attention as wa
    from swinvox_tpu_torch.ops import rewindow as rw
    from swinvox_tpu_torch.serve import BatchingServer
    from swinvox_tpu_torch.train.state import create_train_state, module_params
    from swinvox_tpu_torch.train.steps import gradients, make_train_step

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

    if argv:
        if eval_only:
            eval_phase(torch, dev, card, eval_counters(rw, blk, fm, mi, wa),
                       report)
        elif argv == ["--merger-stack"]:
            merger_stack_phase(torch, dev, card, report)
        elif argv == ["--merger-conv"]:
            merger_conv_phase(torch, dev, card, report)
        elif argv == ["--wmsa-down1"]:
            wmsa_down1_phase(torch, dev, card, report)
        elif argv == ["--front-ends"]:
            front_ends_phase(torch, dev, card, report)
        else:
            out_dir = ROOT / "chiprun_out"
            out_dir.mkdir(exist_ok=True)
            try:
                rewindow_wattn_phase(torch, dev, card, report)
            finally:  # the readings stay when a hold fails
                (out_dir / "chip_smoke_rewindow_wattn.json").write_text(
                    json.dumps(report, indent=1, default=str))
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"chip_smoke_{modes[argv[0]]}.json").write_text(
            json.dumps(report, indent=1, default=str))
        return 0

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
    n_blocks = swin_calls(cfg)
    if launches != {"rewindow": 0, "fused_swin_block": n_blocks * batches}:
        raise AssertionError(f"launch counts {launches} for {batches} "
                             f"batch(es): want no rewindow and {n_blocks} "
                             "blocks per batch")
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
    prof = profile_call(torch, lambda: predictor.predict(batch))
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


    # ---- 8./9. training kernels against their plain versions -------------
    check_swin_train(torch, blk, shifted_window_mask, dev, report)
    n1, n3 = BATCH, TRAIN3[0] * TRAIN3[1]
    check_merger_stack(torch, ms, dev, report, ((n1, True), (n3, True)))
    report["rewindow"]["library_ms"] = library_rewindow(torch, rw, dev)

    # ---- 10. the training step, batch 32, 1 view, three paths -------------
    del predictor, model
    torch.cuda.empty_cache()
    cfgs = {"kernels": default_config()}
    cfgs["bf16 plain"] = default_config()
    cfgs["bf16 plain"].NETWORK.USE_PALLAS_SWIN_BLOCK_TRAIN = False
    cfgs["bf16 plain"].NETWORK.USE_MERGER_STACK = False
    cfgs["f32 plain"] = default_config()
    cfgs["f32 plain"].NETWORK.USE_PALLAS_SWIN_BLOCK_TRAIN = False
    cfgs["f32 plain"].NETWORK.USE_MERGER_STACK = False
    cfgs["f32 plain"].NETWORK.COMPUTE_DTYPE = "float32"
    paths = {}
    for name, c in cfgs.items():
        c.NETWORK.INIT_SCHEME = "standard"
        st, opts = create_train_state(c, torch.Generator().manual_seed(SEED),
                                      device=dev)
        paths[name] = (st, opts, make_train_step(st.model, opts))
    net = cfgs["kernels"].NETWORK
    if not (net.COMPUTE_DTYPE == "bfloat16" and net.USE_PALLAS_SWIN_BLOCK_TRAIN
            and net.USE_REWINDOW_CHAIN and net.USE_MERGER_STACK):
        raise AssertionError("the default config no longer trains bf16 "
                             "through kernels C, D and E")
    state0 = {k: v.detach().clone()
              for k, v in paths["kernels"][0].model.state_dict().items()}
    n_train = sum(p.numel() for p in paths["kernels"][0].model.parameters())
    counters = {"rewindow": rw.rewindow,
                "swin_block_train_forward": blk.swin_block_train_forward,
                "swin_block_train_backward": blk.swin_block_train_backward,
                "merger_stack_forward": ms.merger_stack_forward,
                "merger_stack_backward": ms.merger_stack_backward}

    def reset_paths(names=None):
        for name in names or paths:
            st, opts, _ = paths[name]
            st.model.load_state_dict(state0)
            st.opt_states = {k: opts[k].init(module_params(st.model, k))
                             for k in opts}
            st.step = 0

    def one_step(name, images, volumes, count=False):
        """One step on a path; with ``count``, from launch counters at 0,
        recording the kernel wrappers' calls (Recorder)."""
        st, _, step = paths[name]
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        if count:
            for f in counters.values():
                f.launches = 0
        ctx = exact_f32(torch) if name == "f32 plain" else \
            contextlib.nullcontext()
        with ctx, contextlib.ExitStack() as stack:
            recs = [stack.enter_context(Recorder(torch, mod, attr))
                    for mod, attr in ((swin_mod, "fused_swin_block_train"),
                                      (merger_mod, "merger_stack"))
                    ] if count else []
            _, metrics = step(st, images, volumes, gen)
            torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
        return ({k: float(v) for k, v in metrics.items()},
                gradients(st.model), launches, [r.calls for r in recs])

    def compare(tag, images, volumes, want):
        reset_paths()
        res = {name: one_step(name, images, volumes, count=name == "kernels")
               for name in paths}
        launches = res["kernels"][2]
        names = [n for n, _ in paths["kernels"][0].model.named_parameters()]
        gk = grad_distance(torch, res["kernels"][1], res["f32 plain"][1],
                           names)
        gp = grad_distance(torch, res["bf16 plain"][1], res["f32 plain"][1],
                           names)
        # sensitivity: f32 plain again, on images moved by PERTURB
        reset_paths(["f32 plain"])
        noise = np.random.default_rng(SEED + 9).standard_normal(
            images.shape).astype(np.float32)
        pert = one_step("f32 plain", images * (1 + PERTURB * noise), volumes)
        gs = grad_distance(torch, pert[1], res["f32 plain"][1], names)
        # the step's Swin-block gradients, tensor by tensor, kernel path
        # against bf16 plain path
        sw_names = [n for n in names if n.startswith("encoder.swin.stage")]
        sw_kp = [rel_l2(res["kernels"][1][n], res["bf16 plain"][1][n])
                 for n in sw_names]
        loss = {name: r[0]["total_loss"] for name, r in res.items()}
        dk = abs(loss["kernels"] - loss["f32 plain"])
        dp = abs(loss["bf16 plain"] - loss["f32 plain"])
        log(f"{tag}: total loss kernels {loss['kernels']:.6f}, bf16 plain "
            f"{loss['bf16 plain']:.6f}, f32 plain {loss['f32 plain']:.6f} "
            f"(|kernels - f32| {dk:.3g} <= 2 x {dp:.3g} + {LOSS_FLOOR}), "
            f"f32 plain on images x (1 + {PERTURB} noise) "
            f"{pert[0]['total_loss']:.6f}; grad rel L2 vs f32, group "
            "(median tensor), kernels / bf16 plain / f32 on perturbed "
            "images: " + ", ".join(
                f"{m} {gk[m]['rel_l2']:.4g} "
                f"({gk[m]['median_tensor_rel_l2']:.3g})/{gp[m]['rel_l2']:.4g} "
                f"({gp[m]['median_tensor_rel_l2']:.3g})/{gs[m]['rel_l2']:.4g} "
                f"({gs[m]['median_tensor_rel_l2']:.3g})"
                for m in gk) + f"; Swin-block tensors, kernels vs bf16 "
            f"plain: median {statistics.median(sw_kp):.4g}, max "
            f"{max(sw_kp):.4g} over {len(sw_kp)}; launches {launches}")
        swin_calls_, merger_calls = res["kernels"][3]
        held = {"swin": hold_step_swin(torch, blk, swin_calls_, tag),
                "merger": hold_step_merger(torch, ms, merger_calls, tag)}
        for name, r in res.items():
            if not all(np.isfinite(v) for v in r[0].values()):
                raise AssertionError(f"{tag} {name}: loss not finite {r[0]}")
        if dk > 2 * dp + LOSS_FLOOR:
            raise AssertionError(f"{tag}: loss {dk} > 2 x {dp} + {LOSS_FLOOR}")
        for m in MODULES:
            if gk[m]["rel_l2"] > 2 * gp[m]["rel_l2"] + GRAD_FLOOR:
                raise AssertionError(f"{tag}: {m} grads {gk[m]['rel_l2']} > "
                                     f"2 x {gp[m]['rel_l2']} + {GRAD_FLOOR}")
        if launches != want["launches"]:
            raise AssertionError(f"{tag}: launches {launches} != "
                                 f"{want['launches']}")
        return {"loss": loss, "loss_f32_perturbed": pert[0]["total_loss"],
                "grad_rel_l2_kernels": gk, "grad_rel_l2_bf16_plain": gp,
                "grad_rel_l2_f32_perturbed": gs,
                "swin_tensors_kernels_vs_bf16_plain": {
                    "median": statistics.median(sw_kp), "max": max(sw_kp),
                    "n": len(sw_kp)},
                "held_calls": held, "launches": launches,
                "metrics": {k: r[0] for k, r in res.items()}}, res

    rng = np.random.default_rng(SEED)
    img1 = rng.standard_normal((BATCH, 1, 224, 224, 3)).astype(np.float32)
    vol1 = (rng.random((BATCH, 32, 32, 32)) < 0.3).astype(np.uint8)
    want1 = {"launches": train_launches(cfgs["kernels"], BATCH, 1)}
    train1, res1 = compare(f"train step B={BATCH} 1 view", img1, vol1,
                           want1)
    mg = [v for k, v in res1["kernels"][1].items() if k.startswith("merger.")]
    if any(bool(t.any()) for t in mg):
        raise AssertionError("1-view merger gradient is not exactly zero")
    del res1
    losses = [train1["loss"]["kernels"]]
    for _ in range(TRAIN_STEPS):
        losses.append(one_step("kernels", img1, vol1)[0]["total_loss"])
    log(f"kernel path, {TRAIN_STEPS} more steps on the same batch and masks:"
        f" losses {', '.join(f'{v:.6f}' for v in losses)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training does not reduce the loss: {losses}")
    train1["losses"] = losses
    report["train_1view"] = train1

    # ---- 11. batch 16, 3 views: the merger stack forward and backward -----
    b3, v3 = TRAIN3
    img3 = rng.standard_normal((b3, v3, 224, 224, 3)).astype(np.float32)
    vol3 = (rng.random((b3, 32, 32, 32)) < 0.3).astype(np.uint8)
    want3 = {"launches": train_launches(cfgs["kernels"], b3, v3)}
    train3, res3 = compare(f"train step B={b3} {v3} views", img3, vol3,
                           want3)
    del res3
    st, _, step = paths["kernels"]
    train3["profile_one_step"] = profile_step(torch, st, step, img3, vol3,
                                              dev, card)
    report["train_3view"] = train3
    for name in ("bf16 plain", "f32 plain"):
        del paths[name]
    torch.cuda.empty_cache()

    # ---- 12. training speed, batch 32, 1 view -------------------------------
    st, _, step = paths["kernels"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    img_dev = torch.from_numpy(img1).to(dev)
    vol_dev = torch.from_numpy(vol1).to(dev)
    for _ in range(3):
        step(st, img_dev, vol_dev, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SPEED_STEPS):
        t0 = time.perf_counter()
        step(st, img_dev, vol_dev, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tspeed = {"step_ms": summary(times),
              "img_per_s": BATCH / (statistics.median(times) / 1e3),
              "peak_mem_gb": peak}
    tprof = profile_call(torch, lambda: (step(st, img_dev, vol_dev, gen),
                                         torch.cuda.synchronize()))
    tspeed["profile_one_step"] = tprof
    report["train_speed"] = tspeed
    log(f"train step batch {BATCH}, 1 view, wall ms (median, min-max of "
        f"{SPEED_STEPS}): {tspeed['step_ms']['median']:.3f} ({min(times):.3f}"
        f"-{max(times):.3f}), {tspeed['img_per_s']:.1f} img/s, peak memory "
        f"{peak:.2f} GB; {n_train} params; on {card}")
    sw, mst = report["swin_block_train"], report["merger_stack"]["by_volumes"]
    log(f"kernel device ms per step, kernel (plain): C {sw['fwd_ms']:.3f} "
        f"({sw['fwd_plain_ms']:.3f}), D {sw['bwd_ms']:.3f} "
        f"({sw['bwd_plain_ms']:.3f}), E {mst[n1]['fwd_ms']:.3f} "
        f"({mst[n1]['fwd_plain_ms']:.3f}) at N={n1}, F "
        f"{mst[n3]['bwd_ms']:.3f} ({mst[n3]['bwd_plain_ms']:.3f}) at N={n3}")
    if tprof is None:
        log("profiler: no device events recorded; breakdown not measured")
    else:
        log(f"profiler over one step: wall {tprof['wall_ms']:.3f} ms, device "
            f"{tprof['device_ms']:.3f} ms, busy share "
            f"{tprof['busy_share']:.3f}; " + ", ".join(
                f"{k} {v:.3f}" for k, v in tprof["groups_ms"].items()))

    # ---- 13. inference kernels G, H, I against their plain versions -------
    del paths, st, step, img_dev, vol_dev
    torch.cuda.empty_cache()
    check_window_attention(torch, wa, shifted_window_mask, dev, report)
    check_fused_msa(torch, fm, shifted_window_mask, dev, report)
    check_merger_infer(torch, mi, dev, report)

    # ---- 14. the evaluation entry point, five configurations ---------------
    ev_counters = eval_counters(rw, blk, fm, mi, wa)
    ev = eval_phase(torch, dev, card, ev_counters, report)
    ev_n = {k: sum(r["launches"][k] for r in ev["runs"].values())
            for k in ev_counters}

    # ---- 15. training kernels J, K, L against their plain versions -------
    torch.cuda.empty_cache()
    tk, tk_worst = check_train_kernels(torch, bc, d1, dev, report)

    # ---- 16. the training entry point: three configurations, a resume ----
    tr_counters = {"rewindow": rw.rewindow,
                   "fused_swin_block": blk.fused_swin_block,
                   "swin_block_train_forward": blk.swin_block_train_forward,
                   "swin_block_train_backward": blk.swin_block_train_backward,
                   "merger_stack_forward": ms.merger_stack_forward,
                   "merger_stack_backward": ms.merger_stack_backward,
                   "merger_conv_forward": bc.merger_conv_forward,
                   "merger_conv_wgrad": bc.merger_conv_wgrad,
                   "down1_backward": d1.down1_backward}
    tr = train_phase(torch, dev, card, tr_counters, report)
    tr_n = {k: sum(r["launches"][k] for r in tr.values())
            for k in tr_counters}

    # ---- 17. the front ends -------------------------------------------------
    torch.cuda.empty_cache()
    fe_n = front_ends_phase(torch, dev, card, report)["launches"]

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernels = []
    t1, t3 = train1["launches"], train3["launches"]
    a_bound = bound(0.0, sum(4 * BATCH * (sd // 7) ** 2 * 49 * c * n
                             for sd, c, _, n in REWINDOW_CALLS))
    b_flop = b_bytes = 0.0
    for sd, c, _, na, nsh in STAGES:
        tokens = BATCH * (sd // 7) ** 2 * 49
        b_flop += (na + nsh) * tokens * (24 * c * c + 4 * 49 * c)
        b_bytes += (na + nsh) * (tokens * 4 * c + 24 * c * c)
    rows = (
        ("rewindow", "swinvox_tpu_torch/csrc/rewindow.cu",
         "swinvox_tpu/ops/rewindow.py:71",
         launches["rewindow"] + t1["rewindow"] + t3["rewindow"]
         + ev_n["rewindow"] + tr_n["rewindow"],
         report["rewindow"]["max_abs_err"], None, report["rewindow"]["ms"],
         report["rewindow"]["plain_ms"], a_bound,
         report["rewindow"]["library_ms"]),
        ("fused_swin_block", "swinvox_tpu_torch/csrc/swin_block.cu",
         "swinvox_tpu/ops/pallas_swin_block.py:58",
         launches["fused_swin_block"] + ev_n["fused_swin_block"]
         + tr_n["fused_swin_block"] + fe_n["fused_swin_block"],
         report["fused_swin_block"]["max_abs_err"], None,
         report["fused_swin_block"]["ms"],
         report["fused_swin_block"]["plain_ms"], bound(b_flop, b_bytes), None),
        ("swin_block_train_forward", "swinvox_tpu_torch/csrc/swin_block.cu",
         "swinvox_tpu/ops/pallas_swin_block.py:400",
         t1["swin_block_train_forward"] + t3["swin_block_train_forward"]
         + tr_n["swin_block_train_forward"]
         + fe_n["swin_block_train_forward"],
         sw["worst"]["out"], None, sw["fwd_ms"], sw["fwd_plain_ms"],
         (sw["fwd_bound_ms"], sw["fwd_bound_by"]), None),
        ("swin_block_train_backward",
         "swinvox_tpu_torch/csrc/swin_block_train.cu",
         "swinvox_tpu/ops/pallas_swin_block.py:508",
         t1["swin_block_train_backward"] + t3["swin_block_train_backward"]
         + tr_n["swin_block_train_backward"]
         + fe_n["swin_block_train_backward"],
         sw["worst"]["dx"], sw["worst"]["grad_rel_l2"], sw["bwd_ms"],
         sw["bwd_plain_ms"],
         (sw["bwd_bound_ms"], sw["bwd_bound_by"]), None),
        ("merger_stack_forward", "swinvox_tpu_torch/csrc/merger_stack.cu",
         "swinvox_tpu/ops/pallas_merger_stack.py:209",
         t1["merger_stack_forward"] + t3["merger_stack_forward"]
         + tr_n["merger_stack_forward"]
         + fe_n["merger_stack_forward"],
         report["merger_stack"]["worst"]["fwd_max_abs"], None,
         mst[n1]["fwd_ms"],
         mst[n1]["fwd_plain_ms"],
         (mst[n1]["fwd_bound_ms"], mst[n1]["fwd_bound_by"]), None),
        ("merger_stack_backward", "swinvox_tpu_torch/csrc/merger_stack.cu",
         "swinvox_tpu/ops/pallas_merger_stack.py:386",
         t1["merger_stack_backward"] + t3["merger_stack_backward"]
         + tr_n["merger_stack_backward"]
         + fe_n["merger_stack_backward"],
         report["merger_stack"]["worst"]["dx_max_abs"],
         report["merger_stack"]["worst"]["bwd_rel_l2"], mst[n3]["bwd_ms"],
         mst[n3]["bwd_plain_ms"],
         (mst[n3]["bwd_bound_ms"], mst[n3]["bwd_bound_by"]), None),
        ("window_attention", "swinvox_tpu_torch/csrc/window_attention.cu",
         "swinvox_tpu/ops/pallas_window_attention.py:31",
         ev_n["window_attention_forward"],
         report["window_attention"]["max_abs_err"], None,
         report["window_attention"]["ms"],
         report["window_attention"]["plain_ms"],
         bound(report["window_attention"]["flop"],
               report["window_attention"]["bytes"]),
         report["window_attention"]["library_ms"]),
        ("fused_window_msa", "swinvox_tpu_torch/csrc/swin_block.cu",
         "swinvox_tpu/ops/pallas_fused_msa.py:31",
         ev_n["fused_msa_forward"], report["fused_msa"]["max_abs_err"], None,
         report["fused_msa"]["ms"], report["fused_msa"]["plain_ms"],
         bound(report["fused_msa"]["flop"], report["fused_msa"]["bytes"]),
         report["fused_msa"]["library_ms"]),
        ("merger_view_weights", "swinvox_tpu_torch/csrc/merger_stack.cu",
         "swinvox_tpu/ops/pallas_merger.py:91",
         ev_n["merger_view_weights"], report["merger_infer"]["max_abs_err"],
         None, report["merger_infer"]["ms"],
         report["merger_infer"]["plain_ms"],
         bound(report["merger_infer"]["flop"],
               report["merger_infer"]["bytes"]), None),
        ("merger_conv", "swinvox_tpu_torch/csrc/merger_conv.cu",
         "swinvox_tpu/ops/pallas_band_conv.py:100; "
         "swinvox_tpu/ops/pallas_slab_conv.py:198",
         tr_n["merger_conv_forward"], tk_worst["J"]["max_abs"], None,
         tk["J"]["ms"], tk["J"]["plain_ms"], tk["J"]["bound"],
         tk["J"]["library_ms"]),
        ("merger_conv_wgrad", "swinvox_tpu_torch/csrc/merger_conv.cu",
         "swinvox_tpu/ops/pallas_band_conv.py:144; "
         "swinvox_tpu/ops/pallas_slab_conv.py:218",
         tr_n["merger_conv_wgrad"], tk_worst["K"]["max_abs"],
         tk_worst["K"]["rel_l2"], tk["K"]["ms"], tk["K"]["plain_ms"],
         tk["K"]["bound"], tk["K"]["library_ms"]),
        ("down1_backward", "swinvox_tpu_torch/csrc/down1.cu",
         "swinvox_tpu/ops/pallas_down1.py:126",
         tr_n["down1_backward"], tk_worst["L"]["max_abs"],
         tk_worst["L"]["rel_l2"], tk["L"]["ms"], tk["L"]["plain_ms"],
         tk["L"]["bound"], tk["L"]["library_ms"]),
    )
    for (name, src, replaces, n, err, rel, k_ms, p_ms, (b_ms, b_by),
         lib_ms) in rows:
        # kernel G is on no model path (as its TPU kernel), and kernel
        # A's relayout lives in B, C and D's attention loads: see the top
        if n < 1 and name not in ("window_attention", "rewindow"):
            raise AssertionError(f"{name}: no launch on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": err, "rel_l2_err": rel,
                        "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
