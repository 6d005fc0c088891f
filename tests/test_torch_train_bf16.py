"""The port's bf16 training step against the JAX package's bf16 step, on
the CPU, at nano depths, from one state, dropout off (shared setup and
state: tests/_torch_train_common.py).  The f32 reference is the port's
f32 step, which tests/test_torch_train_step.py holds to the JAX f32 step
within 1e-3; it spares this file a second JAX compile.

In bf16 this network's gradients land far from f32, in both packages
alike: at these shapes the JAX bf16 step's encoder gradients are about
35% (relative L2) from f32.  That is the network's sensitivity, not bf16
alone: the f32 step on images moved by 1e-3 relative noise moves the
encoder's gradients by about 10%.  Run with ``-s`` to print the
readings.

The rule, per group of parameters: the port's bf16 gradients lie within
2 x the JAX bf16 step's distance from f32, + 1e-2, of the f32 gradients
and of the JAX bf16 ones; the loss within 2 x + 1e-5.  A zero or
sign-flipped gradient (1.0 or 2.0 away) fails wherever the JAX bf16
distance is below 0.49.  The merger's gradient is exactly zero at one
view and is left to tests/test_torch_train_views.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_train_common import (
    batch,
    compile_jax,
    jax_setup,
    nano,
    rel_l2,
    run_port,
)
from swinvox_tpu_torch.convert import tree_to_torch

GROUPS = {  # group: (prefixes, prefixes excluded)
    "decoder": (("decoder.",), ()),
    "refiner": (("refiner.",), ()),
    "encoder.resnet": (("encoder.resnet.", "encoder.resnet_reduce."), ()),
    "encoder.swin": (("encoder.swin.",), ()),
    "encoder, outside the trunks": (
        ("encoder.",),
        ("encoder.resnet.", "encoder.resnet_reduce.", "encoder.swin.")),
}
PERTURB = 1e-3


def jax_loss_and_grads(model):
    """(loss, gradients) of the JAX training loss at a state's parameters
    and BatchNorm statistics (``steps.train_step``'s loss, dropout off)."""
    from swinvox_tpu.ops.losses import bce_with_logits

    def fn(params, stats, images, volumes):
        images = jnp.clip(images, -1.0, 1.0)
        volumes = jnp.clip(volumes.astype(jnp.float32), 0.0, 1.0)

        def loss_fn(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": stats}, images, train=True,
                enable_merger=True, enable_refiner=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return (bce_with_logits(out["merged_volumes"], volumes)
                    + bce_with_logits(out["refined_volumes"], volumes))

        return jax.value_and_grad(loss_fn)(params)

    return fn


@pytest.fixture(scope="module")
def readings():
    from swinvox_tpu.config import default_config
    from swinvox_tpu.models.swinvox import SwinVoxModel

    _, _, state0, _, mp = jax_setup()
    model16 = SwinVoxModel.from_config(nano(default_config(), "bfloat16"))
    images, volumes = batch(np.random.default_rng(11), 2, 1)
    noise = np.random.default_rng(5).standard_normal(images.shape)
    moved = (images * (1 + PERTURB * noise)).astype(np.float32)
    args = (state0.params, state0.batch_stats, images, volumes)
    loss, g = compile_jax(jax_loss_and_grads(model16), *args)(*args)
    out = {}
    for name, imgs, dtype in (("f32", images, "float32"),
                              ("f32, moved images", moved, "float32"),
                              ("port bf16", images, "bfloat16")):
        state, metrics, grads = run_port(state0, imgs, volumes, dtype=dtype)
        out[name] = (float(metrics["total_loss"]),
                     {k: v.float().numpy() for k, v in grads.items()})
    out["jax bf16"] = (float(loss), {k: v.numpy() for k, v in
                                     tree_to_torch(g, state.model).items()})
    yield out
    mp.undo()


def distance(a, b, group):
    keep, drop = GROUPS[group]
    names = [n for n in b if n.startswith(keep) and not n.startswith(drop)]
    assert names, group
    return rel_l2(np.concatenate([a[n].ravel() for n in names]),
                  np.concatenate([b[n].ravel() for n in names]))


@pytest.mark.parametrize("group", list(GROUPS))
def test_bf16_step_gradients_match_the_jax_bf16_step(readings, group):
    """Each group's gradients, by the rule of the module docstring."""
    g = {name: r[1] for name, r in readings.items()}
    ref = distance(g["jax bf16"], g["f32"], group)
    to_f32 = distance(g["port bf16"], g["f32"], group)
    to_bf16 = distance(g["port bf16"], g["jax bf16"], group)
    print(f"{group}: jax bf16 vs f32 {ref:.4g}; port bf16 vs f32 "
          f"{to_f32:.4g}, vs jax bf16 {to_bf16:.4g}")
    assert to_f32 <= 2 * ref + 1e-2
    assert to_bf16 <= 2 * ref + 1e-2


def test_bf16_step_loss_matches_the_jax_bf16_step(readings):
    loss = {name: r[0] for name, r in readings.items()}
    ref = abs(loss["jax bf16"] - loss["f32"])
    print(f"losses {loss}")
    assert abs(loss["port bf16"] - loss["f32"]) <= 2 * ref + 1e-5
    assert abs(loss["port bf16"] - loss["jax bf16"]) <= 2 * ref + 1e-5


def test_encoder_gradients_are_sensitive_to_their_input(readings):
    """The reading behind the tolerance: in f32, 1e-3 relative noise on
    the images moves the encoder's gradients by more than 30 x that, and
    bf16 moves them further than the noise does."""
    g = {name: r[1] for name, r in readings.items()}
    for group in GROUPS:
        moved = distance(g["f32, moved images"], g["f32"], group)
        bf16 = distance(g["jax bf16"], g["f32"], group)
        print(f"{group}: f32 on moved images {moved:.4g}, bf16 {bf16:.4g}")
        if group.startswith("encoder"):
            assert moved > 30 * PERTURB
            assert bf16 > moved
