"""Pretrained and reference weights onto the port's modules.

Counterpart of ``swinvox_tpu/models/pretrained.py``.  The reference
builds its encoder from torchvision's ResNet-50 and timm's
``swin_tiny_patch4_window7_224`` (and then re-initializes them,
core/train.py:91-94); ``NETWORK.PRETRAINED_BACKBONE`` names a directory
of such weights that ``create_train_state`` grafts onto the encoder
(``apply_pretrained_backbone``), the "as intended" mode.  The
``convert_reference_*`` maps carry a trained reference checkpoint's
decoder, merger, refiner and cross-view attention across.

Inputs are dicts of numpy arrays under torch names (``load_state_dict_file``
reads a .npz, or a .pth / .pt with torch).  Each converter returns a dict
of numpy arrays under the names of the port module's ``state_dict``
(parameters and BatchNorm running statistics together).  The port keeps
torch's layouts for its convs and transposed convs, so those are renames;
its ``Dense`` kernels are [in, out] (the JAX layout), so a linear weight
is transposed, and the refiner's bottleneck is permuted as in JAX (the
port flattens (D, H, W, C), the reference (C, D, H, W)).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

Array = np.ndarray
StateDict = Mapping[str, Array]


def _linear(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w))


def _bn(sd: StateDict, src: str, dst: str) -> Dict[str, Array]:
    """torch BatchNorm ``src`` -> the port ``Norm`` ``dst``."""
    return {f"{dst}.scale": sd[f"{src}.weight"],
            f"{dst}.bias": sd[f"{src}.bias"],
            f"{dst}.mean": sd[f"{src}.running_mean"],
            f"{dst}.var": sd[f"{src}.running_var"]}


def convert_torch_resnet50_trunk(sd: StateDict) -> Dict[str, Array]:
    """A torchvision resnet50 state dict -> the port's ResNet-50 trunk
    (conv1 .. layer3; layer4 and fc are ignored)."""
    out = {"conv1.kernel": sd["conv1.weight"], **_bn(sd, "bn1", "bn1")}
    for stage, depth in {1: 3, 2: 4, 3: 6}.items():
        for block in range(depth):
            src, dst = f"layer{stage}.{block}", f"layer{stage}_block{block}"
            for i in (1, 2, 3):
                out[f"{dst}.conv{i}.kernel"] = sd[f"{src}.conv{i}.weight"]
                out.update(_bn(sd, f"{src}.bn{i}", f"{dst}.bn{i}"))
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.kernel"] = sd[
                    f"{src}.downsample.0.weight"]
                out.update(_bn(sd, f"{src}.downsample.1",
                               f"{dst}.downsample_bn"))
    return out


def convert_timm_swin_tiny(sd: StateDict,
                           depths: Sequence[int] = (2, 2, 6, 2)
                           ) -> Dict[str, Array]:
    """A timm swin_tiny_patch4_window7_224 state dict -> the port's
    Swin-Tiny, from 'layers.N' (classic) or 'layers_N' (newer timm)
    names, the patch merging at the end of stage s-1 or the start of
    stage s."""

    def get(*names: str) -> Array:
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(f"none of {names} in state dict")

    def ln(dst: str, prefixes) -> Dict[str, Array]:
        return {f"{dst}.scale": get(*[f"{p}.weight" for p in prefixes]),
                f"{dst}.bias": get(*[f"{p}.bias" for p in prefixes])}

    out = {"patch_embed.kernel": get("patch_embed.proj.weight"),
           "patch_embed.bias": get("patch_embed.proj.bias"),
           **ln("patch_norm", ["patch_embed.norm"])}
    for s, depth in enumerate(depths):
        layers = [f"layers.{s}", f"layers_{s}"]
        if s > 0:
            down = ([f"{p}.downsample" for p in layers]
                    + [f"layers.{s - 1}.downsample",
                       f"layers_{s - 1}.downsample"])
            out.update(ln(f"merge{s}.norm", [f"{p}.norm" for p in down]))
            out[f"merge{s}.reduction.kernel"] = _linear(
                get(*[f"{p}.reduction.weight" for p in down]))
        for d in range(depth):
            blk = [f"{p}.blocks.{d}" for p in layers]
            dst = f"stage{s}_block{d}"

            def w(name):
                return get(*[f"{p}.{name}" for p in blk])

            out.update(ln(f"{dst}.norm1", [f"{p}.norm1" for p in blk]))
            out.update(ln(f"{dst}.norm2", [f"{p}.norm2" for p in blk]))
            out.update({
                f"{dst}.attn.qkv_kernel": _linear(w("attn.qkv.weight")),
                f"{dst}.attn.qkv_bias": w("attn.qkv.bias"),
                f"{dst}.attn.proj_kernel": _linear(w("attn.proj.weight")),
                f"{dst}.attn.proj_bias": w("attn.proj.bias"),
                f"{dst}.attn.rel_pos_bias_table": w(
                    "attn.relative_position_bias_table"),
                f"{dst}.mlp_fc1.kernel": _linear(w("mlp.fc1.weight")),
                f"{dst}.mlp_fc1.bias": w("mlp.fc1.bias"),
                f"{dst}.mlp_fc2.kernel": _linear(w("mlp.fc2.weight")),
                f"{dst}.mlp_fc2.bias": w("mlp.fc2.bias"),
            })
    return out


# The reference SwinVox's own heads (models/{decoder,merger,refiner,
# cross_view_attention}.py): torch layouts, so renames but for the
# refiner's bottleneck.


def convert_reference_decoder(sd: StateDict) -> Dict[str, Array]:
    """Reference decoder -> the port's Decoder (tconv1 .. tconv5, bn1 ..
    bn4)."""
    out = {}
    for i in range(1, 6):
        out[f"tconv{i}.kernel"] = sd[f"layer{i}.0.weight"]
        if f"layer{i}.0.bias" in sd:
            out[f"tconv{i}.bias"] = sd[f"layer{i}.0.bias"]
        if i <= 4:
            out.update(_bn(sd, f"layer{i}.1", f"bn{i}"))
    return out


def convert_reference_merger(sd: StateDict) -> Dict[str, Array]:
    """Reference merger -> the port's Merger (conv1 .. conv6, bn1 ..
    bn6)."""
    out = {}
    for i in range(1, 7):
        out[f"conv{i}.kernel"] = sd[f"layer{i}.0.weight"]
        out[f"conv{i}.bias"] = sd[f"layer{i}.0.bias"]
        out.update(_bn(sd, f"layer{i}.1", f"bn{i}"))
    return out


def convert_reference_refiner(sd: StateDict) -> Dict[str, Array]:
    """Reference refiner -> the port's Refiner.  fc1's input axis and
    fc2's output axis go from the reference's (C, D, H, W) flatten to the
    port's (D, H, W, C), and both kernels to [in, out]: the same
    function."""
    out = {}
    for i, name in ((1, "down1"), (2, "down2"), (3, "down3")):
        out[f"{name}_conv.kernel"] = sd[f"layer{i}.0.weight"]
        out[f"{name}_conv.bias"] = sd[f"layer{i}.0.bias"]
        out.update(_bn(sd, f"layer{i}.1", f"{name}_bn"))
    # fc1: torch [2048, 8192 (C,D,H,W)] -> kernel [8192 (D,H,W,C), 2048]
    w1 = sd["layer4.0.weight"].reshape(2048, 128, 4, 4, 4)
    w1 = w1.transpose(0, 2, 3, 4, 1).reshape(2048, 8192)
    out["fc1.kernel"] = _linear(w1)
    out["fc1.bias"] = sd["layer4.0.bias"]
    # fc2: torch [8192 (C,D,H,W), 2048] -> kernel [2048, 8192 (D,H,W,C)]
    w2 = sd["layer5.0.weight"].reshape(128, 4, 4, 4, 2048)
    w2 = w2.transpose(1, 2, 3, 0, 4).reshape(8192, 2048)
    b2 = sd["layer5.0.bias"].reshape(128, 4, 4, 4).transpose(1, 2, 3, 0)
    out["fc2.kernel"] = _linear(w2)
    out["fc2.bias"] = np.ascontiguousarray(b2.reshape(8192))
    for i, name in ((6, "up1"), (7, "up2"), (8, "up3")):
        out[f"{name}_tconv.kernel"] = sd[f"layer{i}.0.weight"]
        if f"layer{i}.0.bias" in sd:
            out[f"{name}_tconv.bias"] = sd[f"layer{i}.0.bias"]
        if name != "up3":
            out.update(_bn(sd, f"layer{i}.1", f"{name}_bn"))
    return out


def convert_reference_cross_view(sd: StateDict) -> Dict[str, Array]:
    """Reference cross-view attention -> the port's CrossViewAttention
    (the depthwise downsample [C, 1, r, r], the 1x1 convs, the
    BatchNorm)."""
    out = {}
    if "downsample_qkv.weight" in sd:
        out["downsample_qkv.kernel"] = sd["downsample_qkv.weight"]
        out["downsample_qkv.bias"] = sd["downsample_qkv.bias"]
    for src, dst in (("qkv_conv", "qkv_conv"), ("proj_conv", "proj_conv"),
                     ("ffn.0", "ffn_fc1"), ("ffn.2", "ffn_fc2")):
        out[f"{dst}.kernel"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]
    out.update(_bn(sd, "batch_norm", "batch_norm"))
    return out


def load_state_dict_file(path: str) -> Dict[str, Array]:
    """A torch .pth / .pt (a state dict, or a dict with ``state_dict``)
    or a numpy .npz of weights, as numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.numpy() for k, v in obj.items()}


def graft(module: torch.nn.Module, converted: Mapping[str, Array],
          where: str = "") -> None:
    """Copies ``converted`` into ``module``'s parameters and buffers by
    name, cast to their dtype; a name the module lacks raises KeyError, a
    shape that does not fit ValueError (before anything is copied)."""
    targets = module.state_dict(keep_vars=True)
    for name, arr in converted.items():
        if name not in targets:
            raise KeyError(f"{where}/{name}: not in the module")
        if tuple(targets[name].shape) != tuple(np.shape(arr)):
            raise ValueError(f"shape mismatch at {where}/{name}: "
                             f"{tuple(targets[name].shape)} vs "
                             f"{np.shape(arr)}")
    with torch.no_grad():
        for name, arr in converted.items():
            t = targets[name]
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype))


def apply_pretrained_backbone(model: torch.nn.Module,
                              resnet_sd: Optional[StateDict] = None,
                              swin_sd: Optional[StateDict] = None) -> None:
    """Grafts converted backbone weights onto ``model.encoder.resnet`` and
    ``model.encoder.swin``, in place."""
    if resnet_sd is not None:
        graft(model.encoder.resnet, convert_torch_resnet50_trunk(resnet_sd),
              "resnet")
        log.info("Loaded pretrained ResNet-50 trunk weights")
    if swin_sd is not None:
        graft(model.encoder.swin, convert_timm_swin_tiny(swin_sd), "swin")
        log.info("Loaded pretrained Swin-Tiny weights")


def backbone_files(root: str) -> Tuple[Optional[str], Optional[str]]:
    """The ``resnet50`` and ``swin_tiny`` weight files of a
    ``NETWORK.PRETRAINED_BACKBONE`` directory (.npz, .pth, then .pt), or
    None where there is none."""

    def find(stem):
        for ext in (".npz", ".pth", ".pt"):
            p = os.path.join(root, stem + ext)
            if os.path.exists(p):
                return p
        return None

    return find("resnet50"), find("swin_tiny")
