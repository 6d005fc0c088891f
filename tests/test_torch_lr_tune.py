"""The port's LR finder (``train/lr_finder.py``) and tuner
(``train/tune.py``) against the JAX package's, on the CPU.

  * ``exponential_sweep``: the same float32 rates (rtol 1e-6) over a
    whole sweep; ``suggest_lr`` the same suggestion on the same lists;
  * ``find_lr``: 5 steps of both packages from one nano state (SWIN
    (1,1,1,1), ResNet (1,1,1), f32, 224^2; random numpy weights on the
    JAX shape trace, carried across by ``convert.load_jax_variables``) on
    one ShapeNet-format fixture at batch 2, dropout and drop-path off on
    both sides (their masks cannot match across frameworks), the JAX
    loader on its numpy path: the rates within rtol 1e-6 and the
    smoothed losses within rtol 1e-2 (the standing whole-step
    tolerance).  The JAX step compiles at XLA optimization level 1;
  * the samplers: ``_random_sample`` and ``TPESampler`` draw identical
    parameters for seeds 0-2 (a categorical, a uniform and a log-uniform
    dimension; TPE past its random start-up);
  * ``tune`` under an injected objective: the same trial states
    (COMPLETE, PRUNED, FAILED), values and ``config_best.json``.
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_train_common import COMPILE, random_variables

from swinvox_tpu_torch.convert import load_jax_variables

NANO = {"SWIN_DEPTHS": (1, 1, 1, 1), "RESNET_STAGE_DEPTHS": (1, 1, 1),
        "COMPUTE_DTYPE": "float32"}
SPACE = {"CONST.BATCH_SIZE": [32, 64],
         "TRAIN.GAMMA": (0.5, 0.99, "uniform"),
         "TRAIN.WEIGHT_DECAY": (1e-6, 1e-3, "log")}


@pytest.mark.parametrize("start,end,steps", [(1e-7, 1e-2, 1000),
                                             (1e-5, 3.0, 37), (1e-4, 1e-1, 1)])
def test_exponential_sweep_matches_jax(start, end, steps):
    from swinvox_tpu.train.lr_finder import exponential_sweep as jax_sweep

    from swinvox_tpu_torch.train.lr_finder import exponential_sweep

    ours, ref = exponential_sweep(start, end, steps), jax_sweep(start, end,
                                                                steps)
    for step in list(range(0, steps + 3)):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
        # inside the JAX step the schedule sees the int32 step
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)


def test_suggest_lr_matches_jax():
    from swinvox_tpu.train.lr_finder import suggest_lr as jax_suggest

    from swinvox_tpu_torch.train.lr_finder import suggest_lr

    rng = np.random.default_rng(0)
    cases = [([], []), ([1e-5], [1.0]), ([1e-5, 1e-4], [1.0, 0.9])]
    for n in (3, 10, 40):
        lrs = list(np.geomspace(1e-7, 1e-1, n))
        losses = list(1 + np.cumsum(rng.standard_normal(n) * 0.1))
        cases.append((lrs, losses))
        cases.append((lrs, sorted(losses, reverse=True)))
    for lrs, losses in cases:
        assert suggest_lr(lrs, losses) == jax_suggest(lrs, losses)


def test_find_lr_matches_jax(tmp_path, monkeypatch):
    """5 sweep steps of both packages from one state and one fixture:
    the recorded rates (rtol 1e-6) and smoothed losses (rtol 1e-2)."""
    import flax.linen as fnn
    from swinvox_tpu.config import default_config as jax_default
    from swinvox_tpu.models import layers as jax_layers
    from swinvox_tpu.native import runtime
    from swinvox_tpu.train import lr_finder as jax_lr
    from swinvox_tpu.train import state as jax_state

    from swinvox_tpu_torch.data.synthetic import generate_dataset
    from swinvox_tpu_torch.train import lr_finder

    cfg = generate_dataset(str(tmp_path / "data"), (6, 0, 0), 2)
    jcfg = jax_default()
    for c in (cfg, jcfg):
        for k, v in NANO.items():
            setattr(c.NETWORK, k, v)
        s = c.DATASETS.SHAPENET
        s.TAXONOMY_FILE_PATH = cfg.DATASETS.SHAPENET.TAXONOMY_FILE_PATH
        s.RENDERING_PATH = cfg.DATASETS.SHAPENET.RENDERING_PATH
        s.VOXEL_PATH = cfg.DATASETS.SHAPENET.VOXEL_PATH
        c.CONST.BATCH_SIZE = 2
        c.CONST.NUM_WORKER = 2
        c.LR_FINDER.NUM_BATCHES_TO_TEST = 5
        c.LR_FINDER.START_LR, c.LR_FINDER.END_LR = 1e-5, 1e-2
    cfg.DIR.OUT_PATH = str(tmp_path / "port")
    jcfg.DIR.OUT_PATH = str(tmp_path / "jax")

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jax_layers.DropPath, "__call__",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(runtime, "decode_image_native", lambda data: None)
    monkeypatch.setattr(runtime, "resize_bilinear_native", lambda *a: None)
    shared = {}

    def jax_create(c, key, steps_per_epoch=1):
        model, state, opts = jax_state.create_train_state(
            c, key, steps_per_epoch, jit_init="shape")
        v = random_variables(jax.eval_shape(lambda: {
            "params": state.params, "batch_stats": state.batch_stats}),
            seed=5)
        shared["variables"] = v
        return model, state.replace(params=v["params"],
                                    batch_stats=v["batch_stats"]), opts

    real_step = jax_lr.make_train_step
    monkeypatch.setattr(jax_lr, "create_train_state", jax_create)
    monkeypatch.setattr(jax_lr, "make_train_step", lambda *a, **k: jax.jit(
        real_step(*a, **k).__wrapped__,
        static_argnames=("enable_merger", "enable_refiner"),
        compiler_options=COMPILE))
    seen = {}
    real_suggest = jax_lr.suggest_lr

    def capture(name, fn):
        def suggest(lrs, losses):
            seen[name] = (list(lrs), list(losses))
            return fn(lrs, losses)
        return suggest

    monkeypatch.setattr(jax_lr, "suggest_lr", capture("jax", real_suggest))
    jax_lr.find_lr(jcfg)

    real_create = lr_finder.create_train_state

    def port_create(c, *a, **k):
        st, opts = real_create(c, *a, **k)
        m = st.model
        load_jax_variables(m, shared["variables"])
        m.encoder.stage_dropout = 0.0
        m.encoder.cross_view_attention.dropout_rate = 0.0
        for mod in m.modules():
            if hasattr(mod, "drop_path1"):
                mod.drop_path1.rate = mod.drop_path2.rate = 0.0
        return st, opts

    monkeypatch.setattr(lr_finder, "create_train_state", port_create)
    monkeypatch.setattr(lr_finder, "suggest_lr",
                        capture("port", lr_finder.suggest_lr))
    lr_finder.find_lr(cfg, device="cpu")

    (jl, jloss), (pl, ploss) = seen["jax"], seen["port"]
    assert len(jl) == len(pl) == 5
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-2)
    assert len(set(np.round(ploss, 6))) > 1  # the sweep moved the loss


def _scored_trials(mod, sampler, space, n):
    """``n`` trials drawn by ``sampler``, each scored by a fixed function
    of its parameters (the TPE models start after 3)."""
    trials = []
    for i in range(n):
        params = sampler.sample(space, trials)
        value = (params["TRAIN.GAMMA"] + np.log10(
            params["TRAIN.WEIGHT_DECAY"]) / 10 + params["CONST.BATCH_SIZE"]
            / 640)
        trials.append(mod.Trial(number=i, params=params, values=[value],
                                state="COMPLETE"))
    return [t.params for t in trials]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_samplers_draw_the_jax_parameters(seed):
    from swinvox_tpu.train import tune as jax_tune

    from swinvox_tpu_torch.train import tune

    for _ in range(3):
        a = tune._random_sample(SPACE, random.Random(seed))
        b = jax_tune._random_sample(SPACE, random.Random(seed))
        assert a == b
    assert _scored_trials(tune, tune.TPESampler(seed=seed), SPACE, 8) == \
        _scored_trials(jax_tune, jax_tune.TPESampler(seed=seed), SPACE, 8)


def make_objective():
    """Trials scored by their gamma, rising each epoch; the second trial
    raises, as a broken run would."""
    calls = []

    def objective(trial_cfg, n_epochs, report):
        calls.append(None)
        if len(calls) == 2:
            raise RuntimeError("planted trial failure")
        gamma = trial_cfg.TRAIN.GAMMA
        best = -1.0
        for epoch in range(n_epochs):
            iou = gamma * (epoch + 1) / n_epochs
            best = max(best, iou)
            if report(epoch, iou):
                break
        return best

    return objective


@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_tune_matches_jax_under_an_injected_objective(tmp_path, sampler):
    from swinvox_tpu.config import default_config as jax_default
    from swinvox_tpu.train import tune as jax_tune

    from swinvox_tpu_torch.config import default_config
    from swinvox_tpu_torch.train import tune

    results = {}
    for name, mod, cfg in (("jax", jax_tune, jax_default()),
                           ("port", tune, default_config())):
        cfg.DIR.OUT_PATH = str(tmp_path / name)
        kw = dict(n_trials=8, n_epochs=3, search_space=SPACE,
                  objective=make_objective(), min_iou=0.45, grace_epochs=1,
                  seed=4, sampler=sampler)
        results[name] = mod.tune(cfg, **kw)
        on_disk = json.loads((tmp_path / name / "config_best.json")
                             .read_text())
        assert on_disk == json.loads(json.dumps(results[name]))
    assert results["port"] == results["jax"]
    assert (tmp_path / "port" / "config_best.json").read_bytes() == \
        (tmp_path / "jax" / "config_best.json").read_bytes()
    states = {t["state"] for t in results["port"]["trials"]}
    assert {"COMPLETE", "PRUNED", "FAILED"} <= states, states
