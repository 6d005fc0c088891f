"""Flax's msgpack format of the JAX package's checkpoints, on the msgpack
package without flax.

``flax.serialization.msgpack_serialize`` / ``msgpack_restore`` (flax
0.12.3) add two extension types to msgpack that checkpoints use:

  * 1 ndarray: the msgpack of (shape, dtype name, C-order bytes);
    ``bfloat16``, which numpy lacks, decodes by name to a torch bfloat16
    tensor (any torch tensor encodes as one, bfloat16 included);
  * 3 numpy scalar: an ndarray of shape ().

Arrays over 2^30 bytes are split by flax into a chunked form (a map with
``__msgpack_chunked_array__``); ``unpackb`` refuses it loudly, since no
checkpoint of this model has one.
"""

from __future__ import annotations

from typing import Any

import msgpack
import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = msgpack.unpackb(data, raw=False)
    if name == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"msgpack: unknown extension type {code}")


def _refuse_chunked(obj: dict) -> dict:
    if obj.get("__msgpack_chunked_array__"):
        raise ValueError("msgpack: chunked array (an array over 2^30 bytes) "
                         "is not supported")
    return obj


def unpackb(data: bytes) -> Any:
    """Decodes one msgpack object (flax's extension types included)."""
    return msgpack.unpackb(data, ext_hook=_ext_hook,
                           object_hook=_refuse_chunked, raw=False)


def _ndarray_to_bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return msgpack.packb((t.shape, "bfloat16",
                                  t.view(torch.int16).numpy().tobytes()))
        arr = t.numpy()
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _default(obj: Any) -> msgpack.ExtType:
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(obj)))
    raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def _sorted(tree: Any) -> Any:
    """flax copies the tree with ``tree_map``, which sorts dict keys."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def packb(obj: Any) -> bytes:
    """Encodes a tree of dicts (str keys), scalars, numpy arrays and torch
    tensors to the bytes ``flax.serialization.msgpack_serialize`` writes
    for it."""
    return msgpack.packb(_sorted(obj), default=_default, strict_types=True)
