"""Ops: the window-attention core and the serving path's two kernels, each
beside its plain PyTorch version."""
