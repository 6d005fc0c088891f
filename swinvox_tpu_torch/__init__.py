"""swinvox_tpu_torch — swinvox_tpu's serving, training, evaluation and
their front ends in PyTorch + CUDA.

A port of the JAX package ``swinvox_tpu`` for one NVIDIA H100 (Hopper,
sm_90a).  The JAX package stays the reference: every module here has a
counterpart at the same relative path there, and the tests feed both the
same weights and inputs.

  * ``models/``  — ``SwinVoxModel`` and its parts, inference and training,
                   and the pretrained-backbone graft (``pretrained``);
  * ``ops/``     — the window-attention core, the losses and the
                   hand-written kernels (``rewindow``, the fused Swin block
                   for inference and training, the fused W-MSA, the merger
                   stack for training and inference, one merger conv, the
                   refiner's first-conv backward), each beside its plain
                   PyTorch version;
  * ``kernels/`` — builds ``csrc/*.cu`` with nvcc at first use;
  * ``train/``   — per-module optimizers, ``TrainState``,
                   ``create_train_state``, ``make_train_step``, the
                   evaluator, ``train_net``, ``test_net``, checkpoints,
                   the LR finder and the tuner;
  * ``cli/``     — the runner (train mode, ``--test``, ``--lr_find``,
                   ``--tune``, ``--profile``) and the quickstart;
  * ``utils/``   — the JSONL metrics log and TensorBoard event files;
  * ``convert``  — the JAX package's variables and whole ``TrainState``
                   in, the port's out in the JAX layout;
  * ``config``   — the serving, training and evaluation fields of the
                   JAX package's ``Config``;
  * ``data``     — image files in, the train and eval transforms and
                   their on-card form, binvox, the ShapeNet, Pix3D and
                   Pascal3D loaders and synthetic fixtures of each;
  * ``infer``    — ``Predictor``;
  * ``serve``    — ``BatchingServer``, micro-batching around a predictor,
                   ``MultiServer`` and the HTTP front end.

Layouts at the public functions follow the JAX package: images
``[B, N, H, W, 3]``, window-major tokens ``[nW, T, C]``, volumes
``[B, 32, 32, 32]``.  Inside, the convolutional modules run NCHW/NCDHW.
This package imports ``torch`` and never ``jax``, nor the JAX package.
"""

__version__ = "0.1.0"
