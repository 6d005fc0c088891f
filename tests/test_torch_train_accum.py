"""The port's training step with GRAD_ACCUM_STEPS=2 against the JAX
package's own accumulating ``make_train_step``: two micro-batches of one
image at 1 view, gradients averaged, BatchNorm statistics advanced per
micro-batch; nano depths, f32, on the CPU.  Loss (atol 1e-4), new
parameters and BatchNorm statistics (relative L2 1e-3) are compared (the
package's step returns no gradients).  The shared setup is in
tests/_torch_train_common.py.
"""

import jax
import jax.numpy as jnp
import numpy as np

from _torch_train_common import (
    batch,
    compare,
    compile_jax,
    jax_setup,
    run_port,
)


def test_train_step_grad_accumulation():
    from swinvox_tpu.train.steps import make_train_step

    model, opts, state0, _, mp = jax_setup()
    try:
        step = make_train_step(model, opts, donate=False, grad_accum_steps=2)
        rng = np.random.default_rng(13)
        key = jax.random.PRNGKey(0)
        first = tuple(map(jnp.asarray, batch(rng, 2, 1)))
        accum = compile_jax(step.__wrapped__, state0, *first, key,
                            enable_merger=True, enable_refiner=True)
        state1, _ = accum(state0, *first, key)
        images, volumes = batch(rng, 2, 1)
        new, metrics = accum(state1, jnp.asarray(images),
                             jnp.asarray(volumes), key)
    finally:
        mp.undo()
    state, got, _ = run_port(state1, images, volumes, grad_accum_steps=2)
    assert state.step == 2
    compare(state, new, metrics["total_loss"], got["total_loss"])
