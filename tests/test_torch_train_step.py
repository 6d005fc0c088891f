"""The port's whole training step against the JAX package's at 1 view
(batch 2: the merger only updates its BatchNorm statistics), nano depths,
f32, on the CPU; and the epoch gates.  The shared setup and tolerances
are in tests/_torch_train_common.py.

The ResNet trunk's gradients are held to 1e-2, the rest to 1e-3: the
trunk's stem max-pool routes each window's gradient to its argmax, and
near-ties flip under f32 rounding, so the reference does not reproduce
itself there — the JAX package's own jit and eager runs of this trunk
differ by up to 4.1e-3 (relative L2, at these shapes), the port and JAX
by up to 7.7e-3.  Outside the trunk the port is within 5e-5 of JAX.
"""

import numpy as np
import pytest
import torch

from _torch_train_common import (
    batch,
    compare,
    compile_jax,
    jax_setup,
    port_state,
    run_port,
)


@pytest.fixture(scope="module")
def setup():
    _, _, state0, step_with_grads, mp = jax_setup()
    rng = np.random.default_rng(11)
    first = batch(rng, 2, 1)
    step = compile_jax(step_with_grads, state0, *first)
    state1, _, _ = step(state0, *first)
    yield {"state1": state1, "step": step, "rng": rng}
    mp.undo()


def test_train_step_parity(setup):
    """Loss, every gradient, new parameters and BatchNorm statistics of
    one step from the same state, against the JAX step."""
    images, volumes = batch(setup["rng"], 2, 1)
    new, loss, grads = setup["step"](setup["state1"], images, volumes)
    state, metrics, got = run_port(setup["state1"], images, volumes)
    assert state.step == 2
    compare(state, new, loss, metrics["total_loss"], grads, got,
            rtol_for=lambda n: 1e-2 if n.startswith("encoder.resnet.")
            else None)
    merger = [g for n, g in got.items() if n.startswith("merger.")]
    assert merger and all(float(g.abs().max()) == 0 for g in merger)


def test_gated_modules_stay_untouched(setup):
    """With the merger and refiner gates closed, their parameters, moments
    and count do not move (nor the refiner's BatchNorm statistics), the
    encoder's do, and the step still counts."""
    images, volumes = batch(setup["rng"], 2, 1)
    state, step = port_state(setup["state1"])
    model = state.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mu = {m: {k: v.clone() for k, v in state.opt_states[m]["mu"].items()}
          for m in ("merger", "refiner")}
    counts = {m: state.opt_states[m]["count"] for m in state.opt_states}
    state, metrics = step(state, images, volumes, torch.Generator(),
                          enable_merger=False, enable_refiner=False)
    after = model.state_dict()
    for k, v in after.items():
        if k.startswith(("merger.", "refiner.")):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["encoder.resnet.conv1.kernel"],
                           before["encoder.resnet.conv1.kernel"])
    for m in ("merger", "refiner"):
        assert state.opt_states[m]["count"] == counts[m]
        for k, v in state.opt_states[m]["mu"].items():
            assert torch.equal(v, mu[m][k]), k
    assert state.opt_states["encoder"]["count"] == counts["encoder"] + 1
    assert float(metrics["total_loss"]) == float(metrics["encoder_loss"])
    assert state.step == 2
