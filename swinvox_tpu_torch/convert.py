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
shadow) and the step, so both packages can continue from one state.
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


def jax_variables(model: nn.Module) -> Dict[str, dict]:
    """The port module's weights as the flax ``{"params", "batch_stats"}``
    tree (numpy, JAX layout): each tensor under its owner's flax path,
    with the owner type's wrapper level put back; BatchNorm running
    statistics go to ``batch_stats``."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in model.state_dict().items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        path = owner_name.split(".") if owner_name else []
        path += [w for cls, w in _WRAPPER_OF if isinstance(owner, cls)]
        coll = ("batch_stats" if isinstance(owner, Norm)
                and leaf in ("mean", "var") else "params")
        node = out[coll]
        for key in path:
            node = node.setdefault(key, {})
        arr = tensor.detach().cpu().float().numpy()
        node[leaf] = np.ascontiguousarray(to_jax_layout(owner, leaf, arr))
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


def load_jax_train_state(state, jax_state) -> None:
    """Copies a JAX ``TrainState`` (params, batch_stats, per-module optax
    states, step; leaves as arrays) into the port's ``TrainState``."""
    model = state.model
    load_jax_variables(model, {"params": jax_state.params,
                               "batch_stats": jax_state.batch_stats})
    for module, opt in jax_state.opt_states.items():
        if module not in state.opt_states:
            raise ValueError(f"no optimizer state for module {module!r}")
        ours = state.opt_states[module]
        # the optax chain's states: (clip, decay, adam-or-trace)
        inner = next(s for s in opt if hasattr(s, "mu") or hasattr(s, "trace"))
        kinds = ("mu", "nu") if hasattr(inner, "mu") else ("trace",)
        for kind in kinds:
            src = tree_to_torch(getattr(inner, kind), model, (module,))
            dst = ours[kind]
            if set(src) != set(dst):
                raise ValueError(f"{module}.{kind}: moment names do not "
                                 "match the port's parameters")
            with torch.no_grad():
                for name, t in dst.items():
                    t.copy_(src[name])
        if hasattr(inner, "count"):
            ours["count"] = int(np.asarray(inner.count))
    state.step = int(np.asarray(jax_state.step))
