"""Shared by tests/test_torch_train_{step,views,accum}.py: the whole
training step of swinvox_tpu_torch against the JAX package's, on the CPU,
at nano depths (SWIN_DEPTHS (1,1,1,1), RESNET_STAGE_DEPTHS (1,1,1)), full
widths, f32, 224^2.

Both packages start from one TrainState: random numpy weights on the JAX
model's shape trace (never initialized, jax.eval_shape), one JAX step
taken so Adam's moments are non-zero, then carried across by
``convert.load_jax_train_state``.  One more step on each side is compared:
the loss (atol 1e-4), the new parameters and BatchNorm statistics and
every gradient (per tensor relative L2; the tolerances are the callers').

Dropout and drop-path masks cannot match across frameworks: they are
turned off on both sides, in these tests only (flax ``Dropout`` and the
JAX ``DropPath`` patched to identity, the port's rates set to 0).  The
JAX step with gradients is ``steps.train_step``'s body written out (the
package's jitted step returns no gradients).  XLA compiles at
optimization level 1 without its expensive LLVM passes, which keeps each
file within a minute.

A conv bias that feeds a train-mode BatchNorm has gradient 0 in exact
arithmetic; both sides hold rounding noise there (~1e-10 against ~1e-3
for live gradients), so each must stay below 1e-6 of the largest
gradient norm instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swinvox_tpu_torch.convert import load_jax_train_state, tree_to_torch

COMPILE = {"xla_backend_optimization_level": 1,
           "xla_llvm_disable_expensive_passes": True}


def nano(cfg, dtype="float32"):
    cfg.NETWORK.SWIN_DEPTHS = (1, 1, 1, 1)
    cfg.NETWORK.RESNET_STAGE_DEPTHS = (1, 1, 1)
    cfg.NETWORK.COMPUTE_DTYPE = dtype
    cfg.TRAIN.DECODER_LEARNING_RATE = 1e-3  # steps large enough to compare
    return cfg


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def random_variables(shapes, seed=0):
    """numpy weights for a flax variables tree at fan-in scale; BatchNorm
    statistics and every affine and bias jittered away from their init
    values (as tests/test_torch_model.py draws them)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if "['batch_stats']" in name and "['var']" in name:
            return (1 + 0.2 * rng.random(shape)).astype(np.float32)
        if "['mean']" in name:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "['scale']" in name:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) < 2 or "rel_pos_bias_table" in name:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = float(np.prod(shape[:-1]))
        if "tconv" in name:  # input-dilated by the stride
            fan_in /= 4
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def batch(rng, b, n):
    return (rng.standard_normal((b, n, 224, 224, 3)).astype(np.float32),
            (rng.random((b, 32, 32, 32)) < 0.4).astype(np.uint8))


def jax_setup():
    """(model, optimizers, state0, step_with_grads, MonkeyPatch) with the
    JAX package's dropout and drop-path turned off until ``undo``."""
    import flax.linen as fnn

    from swinvox_tpu.config import default_config
    from swinvox_tpu.models import layers as jax_layers
    from swinvox_tpu.models.swinvox import SwinVoxModel
    from swinvox_tpu.ops.losses import bce_with_logits
    from swinvox_tpu.train.optim import MODULE_NAMES, build_optimizers
    from swinvox_tpu.train.state import TrainState

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(jax_layers.DropPath, "__call__", lambda self, x, *a, **k: x)
    cfg = nano(default_config())
    model = SwinVoxModel.from_config(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 224, 224, 3)), train=False))
    variables = random_variables(shapes, seed=3)
    opts = build_optimizers(cfg, 1)
    state0 = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_states={n: opts[n].init(variables["params"][n])
                    for n in MODULE_NAMES},
        step=jnp.zeros((), jnp.int32))

    def step_with_grads(state, images, volumes):
        # steps.train_step at grad_accum_steps=1, returning the gradients
        images = jnp.clip(images, -1.0, 1.0)
        volumes = jnp.clip(volumes.astype(jnp.float32), 0.0, 1.0)

        def loss_fn(params):
            out, mut = model.apply(
                {"params": params, "batch_stats": state.batch_stats}, images,
                train=True, enable_merger=True, enable_refiner=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            el = bce_with_logits(out["merged_volumes"], volumes)
            rl = bce_with_logits(out["refined_volumes"], volumes)
            return el + rl, (el, rl, mut["batch_stats"])

        grads, (el, rl, stats) = jax.grad(loss_fn, has_aux=True)(state.params)
        params, opt_states = dict(state.params), dict(state.opt_states)
        for name in MODULE_NAMES:
            lr = opts[name].schedule(state.step)
            upd, opt_states[name] = opts[name].transform.update(
                grads[name], state.opt_states[name], state.params[name])
            params[name] = optax.apply_updates(
                state.params[name], jax.tree.map(lambda u: -lr * u, upd))
        new = TrainState(params=params, batch_stats=stats,
                         opt_states=opt_states, step=state.step + 1)
        return new, el + rl, grads

    return model, opts, state0, step_with_grads, mp


def compile_jax(fn, *args, **static):
    """``jax.jit(fn)`` compiled for ``args`` at this file's XLA options."""
    return jax.jit(fn, static_argnames=tuple(static)).lower(
        *args, **static).compile(compiler_options=COMPILE)


def port_state(jax_state, grad_accum_steps=1, dtype="float32"):
    """(state, train_step) of the port (nano, CPU, no dropout; f32 unless
    ``dtype``) at ``jax_state``."""
    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.train.state import create_train_state
    from swinvox_tpu_torch.train.steps import make_train_step

    cfg = nano(default_config(), dtype)
    state, opts = create_train_state(cfg, device="cpu")
    model = state.model
    model.encoder.stage_dropout = 0.0
    model.encoder.cross_view_attention.dropout_rate = 0.0
    for mod in model.modules():
        if hasattr(mod, "drop_path1"):
            mod.drop_path1.rate = mod.drop_path2.rate = 0.0
    load_jax_train_state(state, jax_state)
    return state, make_train_step(model, opts, grad_accum_steps)


def compare(state, new_jax, loss_jax, loss, grads_jax=None, grads=None,
            rtol=1e-3, rtol_for=lambda name: None, module_floor=0.0):
    """Loss, new parameters and BatchNorm statistics (relative L2 1e-3)
    and, given, every gradient: ||port - jax|| <= tol * ||jax|| +
    module_floor * (the norm of its module's whole gradient), tol =
    ``rtol_for(name)`` or ``rtol``."""
    model = state.model
    assert abs(float(loss) - float(loss_jax)) <= 1e-4
    params = tree_to_torch(new_jax.params, model)
    assert set(params) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert rel_l2(p.detach().numpy(), params[name]) <= 1e-3, name
    stats = tree_to_torch(new_jax.batch_stats, model)
    assert set(stats) == {n for n, _ in model.named_buffers()
                          if n.endswith((".mean", ".var"))}
    for name, b in stats.items():
        assert rel_l2(model.get_buffer(name).numpy(), b) <= 1e-3, name
    if grads_jax is None:
        return
    ref = {k: v.numpy().astype(np.float64)
           for k, v in tree_to_torch(grads_jax, model).items()}
    assert set(ref) == set(grads)
    scale = max(np.linalg.norm(r) for r in ref.values())
    module = {}
    for name, r in ref.items():
        key = name.split(".")[0]
        module[key] = module.get(key, 0.0) + float((r * r).sum())
    live = 0
    for name, g in grads.items():
        want = np.linalg.norm(ref[name])
        if want <= 1e-6 * scale:  # exactly 0
            assert float(g.norm()) <= 1e-6 * scale, name
            continue
        live += 1
        tol = rtol_for(name) or rtol
        err = np.linalg.norm(g.numpy() - ref[name])
        floor = module_floor * np.sqrt(module[name.split(".")[0]])
        assert err <= tol * want + floor, (name, err / want)
    assert live > len(grads) // 2


def run_port(jax_state, images, volumes, grad_accum_steps=1,
             dtype="float32"):
    from swinvox_tpu_torch.train.steps import gradients

    state, step = port_state(jax_state, grad_accum_steps, dtype)
    state, metrics = step(state, images, volumes, torch.Generator())
    return state, metrics, gradients(state.model)
