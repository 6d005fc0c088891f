"""The port's whole training step against the JAX package's at 3 views
(batch 1: the merger's softmax over views and cross-view attention in
full), nano depths, f32, on the CPU.  The shared setup is in
tests/_torch_train_common.py.

Each gradient is held to 2e-2 of its own norm plus 1e-3 of its module's
whole gradient norm.  With three images in each BatchNorm the reference
does not reproduce itself more closely: the same JAX step compiled at
XLA's default and at level-1 optimization gives gradients up to 1.1e-2
apart (relative L2, merger.bn1.bias: LeakyReLU branch flips, as in
tests/test_pallas.py:723-731), and the port lands up to 2.5e-2 from
either.  The module floor covers gradients that cancel almost exactly:
layer 5's BatchNorm offset shifts every view's score before a softmax over
views, so its gradient (~5e-5 against ~1e-2 for the merger) magnifies the
f32 differences arriving from the refiner (~2e-4) to 6e-2 of itself while
the port alone reproduces it to 1e-5.  Loss, new parameters and
BatchNorm statistics keep their 1e-4 / 1e-3 bounds.
"""

import numpy as np
import pytest

from _torch_train_common import (
    batch,
    compare,
    compile_jax,
    jax_setup,
    run_port,
)


@pytest.fixture(scope="module")
def setup():
    _, _, state0, step_with_grads, mp = jax_setup()
    rng = np.random.default_rng(12)
    first = batch(rng, 1, 3)
    step = compile_jax(step_with_grads, state0, *first)
    state1, _, _ = step(state0, *first)
    yield {"state1": state1, "step": step, "rng": rng}
    mp.undo()


def test_train_step_parity_three_views(setup):
    """Loss, every gradient (the merger's included), new parameters and
    BatchNorm statistics of one 3-view step from the same state."""
    images, volumes = batch(setup["rng"], 1, 3)
    new, loss, grads = setup["step"](setup["state1"], images, volumes)
    state, metrics, got = run_port(setup["state1"], images, volumes)
    compare(state, new, loss, metrics["total_loss"], grads, got, rtol=2e-2,
            module_floor=1e-3)
    merger = [g for n, g in got.items() if n.startswith("merger.conv")]
    assert all(float(g.abs().max()) > 0 for g in merger)
