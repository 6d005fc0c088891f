"""binvox voxel files: the reader and the writer.

Counterpart of ``swinvox_tpu/data/binvox.py`` (``read_as_3d_array`` and
``write``), in numpy.  File format (http://www.patrickmin.com/binvox):

    #binvox 1
    dim 32 32 32
    translate tx ty tz
    scale s
    data
    <value, count> byte pairs, counts <= 255, voxels in x-z-y order
    (y fastest), i.e. index = x*d*d + z*d + y.

The reader returns the dense grid transposed from the file's (x, z, y)
order to (x, y, z), as the JAX reader does with ``fix_coords``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, List

import numpy as np


@dataclass
class Voxels:
    """A dense binvox model: bool grid (x, y, z) and its metadata."""

    data: np.ndarray
    dims: List[int]
    translate: List[float]
    scale: float


def read_header(fp: BinaryIO):
    """Parses the ASCII header; returns (dims, translate, scale)."""
    first = fp.readline().strip()
    if not first.startswith(b"#binvox"):
        raise IOError("Not a binvox file")
    dims = translate = None
    scale = 1.0
    while True:
        line = fp.readline()
        if not line:
            raise IOError("binvox header ended before 'data' line")
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b"dim":
            dims = [int(t) for t in tokens[1:]]
        elif key == b"translate":
            translate = [float(t) for t in tokens[1:]]
        elif key == b"scale":
            scale = float(tokens[1])
        elif key == b"data":
            break
        else:
            raise IOError(f"unexpected binvox header token {key!r}")
    if dims is None:
        raise IOError("binvox header missing 'dim' line")
    return dims, translate or [0.0, 0.0, 0.0], scale


def read_as_3d_array(fp: BinaryIO) -> Voxels:
    """Reads a binvox file into a dense (x, y, z) bool grid: the RLE
    <value, count> pairs expanded, then the file's x-z-y order
    transposed."""
    dims, translate, scale = read_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    if raw.size % 2:
        raise IOError("binvox RLE payload has odd length")
    flat = np.repeat(raw[::2], raw[1::2]).astype(bool)
    n = int(np.prod(dims))
    if flat.size != n:
        raise IOError(f"binvox RLE decoded {flat.size} voxels, expected {n}")
    data = np.transpose(flat.reshape(dims), (0, 2, 1))
    return Voxels(data, dims, translate, scale)


def write_binvox(occupied: np.ndarray, fp: BinaryIO) -> None:
    """Write a dense [D, D, D] bool grid (x, y, z) as binary binvox:
    <value, count> byte pairs, counts <= 255, voxels in x-z-y order."""
    header = ("#binvox 1\n"
              f"dim {' '.join(str(d) for d in occupied.shape)}\n"
              "translate 0.0 0.0 0.0\nscale 1.0\ndata\n")
    fp.write(header.encode("latin-1"))
    flat = np.transpose(occupied.astype(np.uint8), (0, 2, 1)).reshape(-1)
    starts = np.concatenate(([0], np.flatnonzero(flat[1:] != flat[:-1]) + 1))
    lengths = np.diff(np.concatenate((starts, [flat.size])))
    pairs = []
    for value, n in zip(flat[starts], lengths):
        full, rest = divmod(int(n), 255)
        pairs += [value, 255] * full + ([value, rest] if rest else [])
    fp.write(np.asarray(pairs, np.uint8).tobytes())
