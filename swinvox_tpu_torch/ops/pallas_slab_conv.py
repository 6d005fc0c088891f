"""One merger Conv3d on the slab route: the same kernels J and K.

Counterpart of ``slab_conv3d`` in ``swinvox_tpu/ops/pallas_slab_conv.py``
(the module keeps that path so a reader finds it; nothing here is Pallas).
The TPU's slab kernel computes the function of ``band_conv3d`` on
another lane layout, so both routes run ``pallas_band_conv.merger_conv3d``
(kernel J forward and for the input gradient, kernel K for the weight
gradient).  What differs is the caller's kernel: the slab merger passes
the float32 parameter, which J rounds to x's dtype for the products
(as the TPU kernel casts its band weights), and dW stays float32.

One difference from the TPU kernel, by design: it splits a 36-channel
input into four 9-channel chunks (its 128-lane budget) and sums their
bf16-rounded outputs in bf16; kernel J convolves all 36 channels in one
launch and rounds once.  In float32 the two agree to rounding; in
bfloat16 they differ by the chunk roundings (``tests/test_torch_train_
kernels.py`` holds that layer at bf16 tolerance).
"""

from __future__ import annotations

import torch

from swinvox_tpu_torch.ops.pallas_band_conv import merger_conv3d


def slab_conv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One merger Conv3d (stride 1, padding 1, channels-last),
    differentiable.

    x: [V, 32, 32, 32, ci]; kernel: the float32 [3, 3, 3, ci, co]
    parameter.  Returns [V, 32, 32, 32, co] in x's dtype (the bias is the
    caller's); dW comes back in float32.
    """
    return merger_conv3d(x, kernel)
