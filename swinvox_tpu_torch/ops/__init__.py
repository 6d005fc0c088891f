"""Ops: the window-attention core, the losses, and the hand-written
kernels of the serving path and the training step, each beside its plain
PyTorch version."""
