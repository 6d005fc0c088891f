"""Weight bridge: the JAX package's variables -> the port's ``SwinVoxModel``.

The JAX model's variables are ``{"params": ..., "batch_stats": ...}``
nested dicts; with their leaves as numpy arrays (``jax.device_get`` of the
flax tree, or a checkpoint read into numpy) ``load_jax_variables`` copies
them into a port module.  The port names its submodules after the flax
paths, so a leaf's torch name is its flax path with the flax wrapper
levels (``Conv_0``, ``Dense_0``, ``LayerNorm_0``, and the BatchNorm's
``bn``) dropped, e.g.

  params/encoder/swin/stage0_block0/attn/qkv_kernel
      -> encoder.swin.stage0_block0.attn.qkv_kernel
  batch_stats/encoder/resnet/bn1/bn/mean -> encoder.resnet.bn1.mean

and the layout change depends only on the owning module's type:
``Conv`` kernels (*k, in, out) -> (out, in, *k); ``ConvTranspose``
kernels are spatially flipped and laid out (in, out, *k) (the JAX
transposed conv does not flip, torch's does); the encoder's [C, H, W]
``LayerNorm`` affine comes from [H, W, C].  Any leaf left over or missing,
on either side, raises.

``jax_variables`` is the inverse: a port module's weights as the flax
``{"params", "batch_stats"}`` tree of numpy arrays, in the JAX layout,
for a checkpoint the JAX package can read.

``load_jax_train_state`` carries a whole JAX ``TrainState`` across: the
variables as above, each module's optimizer state (Adam's ``mu``, ``nu``
and ``count``, or SGD's ``trace``, laid out as the parameters they
shadow) and the step, so both packages can continue from one state.  It
takes the live state (optax's named tuples) or the state-dict form a JAX
checkpoint file holds; ``jax_train_state`` writes that form from the
port's state.  In the file, each module's optax chain (clip, decay, Adam
or SGD) is a dict keyed ``"0"``, ``"1"``, ``"2"``: the first two are
empty, the third holds ``count`` (an int32 scalar), ``mu`` and ``nu``, or
``trace``; ``step`` is an int.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from swinvox_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    Norm,
)

_WRAPPERS = frozenset({"Conv_0", "Dense_0", "LayerNorm_0", "bn"})
_WRAPPER_OF = ((Conv, "Conv_0"), (Dense, "Dense_0"), (LayerNorm, "LayerNorm_0"),
               (Norm, "bn"))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def torch_name(path: Tuple[str, ...]) -> str:
    """The port's parameter/buffer name of a flax leaf path."""
    return ".".join(p for p in path if p not in _WRAPPERS)


def to_torch_layout(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    """Rearranges one flax leaf for the port module ``owner``."""
    if leaf == "kernel" and isinstance(owner, Conv):
        nd = arr.ndim - 2
        return np.transpose(arr, (nd + 1, nd, *range(nd)))
    if leaf == "kernel" and isinstance(owner, ConvTranspose):
        nd = arr.ndim - 2
        arr = np.flip(arr, axis=tuple(range(nd)))
        return np.transpose(arr, (nd, nd + 1, *range(nd)))
    if isinstance(owner, LayerNorm) and len(owner.shape) == 3:
        return np.transpose(arr, (2, 0, 1))
    return arr


def load_jax_variables(model: nn.Module,
                       variables: Mapping[str, Mapping]) -> None:
    """Copies a flax ``{"params", "batch_stats"}`` tree into ``model``."""
    sources: Dict[str, Tuple[str, np.ndarray]] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            name = torch_name(path)
            if name in sources:
                raise ValueError(f"two flax leaves map to {name}")
            sources[name] = ("/".join((coll,) + path), np.asarray(leaf))
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    targets = model.state_dict(keep_vars=True)
    missing = sorted(set(targets) - set(sources))
    leftover = sorted(sources[n][0] for n in set(sources) - set(targets))
    if missing or leftover:
        raise ValueError(
            f"weight bridge mismatch: {len(missing)} port tensors without a "
            f"flax leaf {missing[:8]}, {len(leftover)} flax leaves without a "
            f"port tensor {leftover[:8]}"
        )
    with torch.no_grad():
        for name, tensor in targets.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            flax_path, arr = sources[name]
            arr = to_torch_layout(owner, leaf, arr)
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f"{flax_path}: shape {arr.shape} does not "
                                 f"fit {name} {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(arr.copy()))  # copy: drops flips


def to_jax_layout(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of ``to_torch_layout``."""
    if leaf == "kernel" and isinstance(owner, Conv):
        nd = arr.ndim - 2
        return np.transpose(arr, (*range(2, nd + 2), 1, 0))
    if leaf == "kernel" and isinstance(owner, ConvTranspose):
        nd = arr.ndim - 2
        arr = np.transpose(arr, (*range(2, nd + 2), 0, 1))
        return np.flip(arr, axis=tuple(range(nd)))
    if isinstance(owner, LayerNorm) and len(owner.shape) == 3:
        return np.transpose(arr, (1, 2, 0))
    return arr


def _jax_leaf(model: nn.Module, name: str, tensor: torch.Tensor
              ) -> Tuple[str, list, np.ndarray]:
    """(collection, flax path, numpy array in the JAX layout) of a port
    tensor, or of a tensor shaped like it (an optimizer moment)."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    path = owner_name.split(".") if owner_name else []
    path += [w for cls, w in _WRAPPER_OF if isinstance(owner, cls)]
    coll = ("batch_stats" if isinstance(owner, Norm)
            and leaf in ("mean", "var") else "params")
    arr = tensor.detach().cpu().float().numpy()
    return coll, path + [leaf], np.ascontiguousarray(
        to_jax_layout(owner, leaf, arr))


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def jax_variables(model: nn.Module) -> Dict[str, dict]:
    """The port module's weights as the flax ``{"params", "batch_stats"}``
    tree (numpy, JAX layout): each tensor under its owner's flax path,
    with the owner type's wrapper level put back; BatchNorm running
    statistics go to ``batch_stats``."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in model.state_dict().items():
        coll, path, arr = _jax_leaf(model, name, tensor)
        _put(out[coll], path, arr)
    return out


def jax_train_state(state) -> Dict[str, object]:
    """The port's ``TrainState`` in the state-dict form of a JAX full
    checkpoint: ``{params, batch_stats, opt_states, step}``, numpy leaves
    in the JAX layout; each module's optimizer state as the optax chain
    ``{"0": {}, "1": {}, "2": {count, mu, nu} | {trace}}``."""
    model = state.model
    out: Dict[str, object] = dict(jax_variables(model))
    opt_states = {}
    for module, ours in state.opt_states.items():
        inner: Dict[str, object] = {}
        for kind in ("mu", "nu", "trace"):
            if kind in ours:
                tree: dict = {}
                for name, t in ours[kind].items():
                    _, path, arr = _jax_leaf(model, name, t)
                    _put(tree, path[1:], arr)  # under the module's key
                inner[kind] = tree
        if "count" in ours:
            inner["count"] = np.asarray(ours["count"], np.int32)
        opt_states[module] = {"0": {}, "1": {}, "2": inner}
    out["opt_states"] = opt_states
    out["step"] = int(state.step)
    return out


def tree_to_torch(tree: Mapping, model: nn.Module, prefix: Tuple[str, ...] = ()
                  ) -> Dict[str, torch.Tensor]:
    """A parameter-shaped flax tree (gradients, optimizer moments) as torch
    tensors by the port's parameter names, in the port's layout;
    ``prefix`` is the tree's path in the flax params (e.g. a module)."""
    out = {}
    for path, leaf in _flatten(tree, prefix):
        name = torch_name(path)
        owner_name, _, leaf_name = name.rpartition(".")
        arr = to_torch_layout(model.get_submodule(owner_name), leaf_name,
                              np.asarray(leaf))
        out[name] = torch.from_numpy(arr.copy())
    return out


def _chain_inner(opt) -> Dict[str, object]:
    """The Adam or SGD state of one module's optax chain, as a dict: from
    the live tuple of named tuples or from a checkpoint's ``{"0": ...}``
    form."""
    parts = opt.values() if isinstance(opt, Mapping) else opt
    for part in parts:
        d = part if isinstance(part, Mapping) else (
            part._asdict() if hasattr(part, "_asdict") else {})
        if "mu" in d or "trace" in d:
            return dict(d)
    raise ValueError("optimizer state has neither Adam moments nor a trace")


def load_jax_train_state(state, jax_state) -> None:
    """Copies a JAX ``TrainState`` (params, batch_stats, per-module optax
    states, step; leaves as arrays), or the state-dict form of a full JAX
    checkpoint (a mapping with those keys), into the port's
    ``TrainState``."""
    if isinstance(jax_state, Mapping):
        params, batch_stats = jax_state["params"], jax_state["batch_stats"]
        opt_states, step = jax_state["opt_states"], jax_state["step"]
    else:
        params, batch_stats = jax_state.params, jax_state.batch_stats
        opt_states, step = jax_state.opt_states, jax_state.step
    model = state.model
    load_jax_variables(model, {"params": params, "batch_stats": batch_stats})
    if set(opt_states) != set(state.opt_states):
        raise ValueError(f"optimizer states for {sorted(opt_states)}, the "
                         f"port has {sorted(state.opt_states)}")
    for module, opt in opt_states.items():
        ours = state.opt_states[module]
        inner = _chain_inner(opt)
        kinds = ("mu", "nu") if "mu" in inner else ("trace",)
        if set(kinds) != set(ours) - {"count"}:
            raise ValueError(f"{module}: optimizer state {sorted(inner)} "
                             f"does not fit the port's {sorted(ours)}")
        for kind in kinds:
            src = tree_to_torch(inner[kind], model, (module,))
            dst = ours[kind]
            if set(src) != set(dst):
                raise ValueError(f"{module}.{kind}: moment names do not "
                                 "match the port's parameters")
            with torch.no_grad():
                for name, t in dst.items():
                    t.copy_(src[name])
        if "count" in inner:
            ours["count"] = int(np.asarray(inner["count"]))
    state.step = int(np.asarray(step))
