"""Ops: the window-attention core, the losses, and the hand-written
kernels of serving, training and evaluation, each beside its plain
PyTorch version."""
