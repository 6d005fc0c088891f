"""Builds ``swinvox_tpu_torch/csrc/*.cu`` with nvcc and loads it via ctypes.

The kernels are compiled at first use into ``swinvox_tpu_torch/_build/``
(git-ignored) as one shared library with a plain C interface: one nvcc
per source, all started together, to an object each, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o
    nvcc -shared -o libswinvox_kernels-<hash>.so *.o

The file name carries a hash of the sources and flags, so an edited
source rebuilds; each build writes a per-process temporary and renames it
atomically, so concurrent builders never load a half-written library.
nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
kernel) is kept beside the library as ``.log``.

A failed build raises: there is no CPU fallback behind a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _sources():
    cu = sorted(CSRC_DIR.glob("*.cu"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return cu, sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libswinvox_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the kernels unless the library for these sources exists:
    one nvcc per source, all running at once, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = BUILD_DIR / f"obj.{os.getpid()}"
    objs.mkdir(exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(objs / f"{src.stem}.o")] for src in cu]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for c, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(c)}"
                          f"\n{out}")
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp),
                *(str(objs / f"{src.stem}.o") for src in cu)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}): "
                          f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
    shutil.rmtree(objs, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    so.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so)
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = ctypes.c_float
    lib.swinvox_cuda_error_string.argtypes = [i]
    lib.swinvox_cuda_error_string.restype = ctypes.c_char_p
    # (x, out, n_windows, nwh, nww, window, shift, sign, row_bytes, stream)
    lib.swinvox_rewindow.argtypes = [p, p, i64, i, i, i, i, i, i64, p]
    lib.swinvox_rewindow.restype = i
    # the window map of kernels B, C, D: (nwh, nww, window, shift)
    grid = [i, i, i, i]
    # (x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, rel_bias, mask, nw_img,
    #  ln2s, ln2b, w1, b1, w2, b2, out, h1, qkv, ctx, x2, h2, hidden,
    #  n_windows, tokens, channels, heads, grid, scale, eps, stream)
    lib.swinvox_swin_block.argtypes = (
        [p] * 9 + [i] + [p] * 13 + [i64, i, i, i] + grid + [f, f, p]
    )
    lib.swinvox_swin_block.restype = i
    # (x, dp1, dp2, ln1s, ln1b, wqkv, bqkv, wproj, bproj, rel_bias, mask,
    #  nw_img, ln2s, ln2b, w1, b1, w2, b2, out, h1, stats1, qkv, ctx, x2,
    #  h2, stats2, pre, hidden, n_windows, tokens, channels, heads, grid,
    #  scale, eps, stream)
    lib.swinvox_swin_block_train_fwd.argtypes = (
        [p] * 11 + [i] + [p] * 16 + [i64, i, i, i] + grid + [f, f, p]
    )
    lib.swinvox_swin_block_train_fwd.restype = i
    lib.swinvox_swin_block_train_bwd_workspace.argtypes = [i64, i, i, i]
    lib.swinvox_swin_block_train_bwd_workspace.restype = i64
    # (dout, x, dp1, dp2, 9 saved, ln1s, wqkv, wproj, rel_bias, mask,
    #  nw_img, ln2s, w1, w2, 14 gradients, work, work_bytes, n_windows,
    #  tokens, channels, heads, grid, scale, stream)
    lib.swinvox_swin_block_train_bwd.argtypes = (
        [p] * 18 + [i] + [p] * 17 + [p, i64, i64, i, i, i] + grid + [f, p]
    )
    lib.swinvox_swin_block_train_bwd.restype = i
    # merger stack: (x, w, bias, gamma, beta, raws, raw5, stats, work,
    #  work_bytes, n, leaky, eps, stream) and (x, raws, stats, w, gamma,
    #  d_raw5, dx, dw, dbias, dgamma, dbeta, work, work_bytes, n, leaky,
    #  eps, stream)
    for name in ("fwd", "bwd"):
        ws = getattr(lib, f"swinvox_merger_stack_{name}_workspace")
        ws.argtypes = [i64]
        ws.restype = i64
    lib.swinvox_merger_stack_fwd.argtypes = [p] * 9 + [i64, i64, f, f, p]
    lib.swinvox_merger_stack_fwd.restype = i
    lib.swinvox_merger_stack_bwd.argtypes = [p] * 12 + [i64, i64, f, f, p]
    lib.swinvox_merger_stack_bwd.restype = i
    # (x, w, fold, acts, out, n, leaky, stream)
    lib.swinvox_merger_infer.argtypes = [p] * 5 + [i64, f, p]
    lib.swinvox_merger_infer.restype = i
    # (q, k, v, rel_bias, mask, nw_img, out, n_windows, heads, tokens,
    #  scale, stream)
    lib.swinvox_window_attention.argtypes = [p] * 5 + [i, p, i64, i, i, f, p]
    lib.swinvox_window_attention.restype = i
    # (x, wqkv, bqkv, wproj, bproj, rel_bias, mask, nw_img, out, qkv, ctx,
    #  n_windows, tokens, channels, heads, scale, stream)
    lib.swinvox_fused_msa.argtypes = [p] * 7 + [i] + [p] * 3 + [i64, i, i, i,
                                                                f, p]
    lib.swinvox_fused_msa.restype = i
    # kernel J: (x, w, y, n, cin, cout, is_bf16, stream)
    lib.swinvox_merger_conv.argtypes = [p, p, p, i64, i, i, i, p]
    lib.swinvox_merger_conv.restype = i
    # kernel K: (x, dy, dw, work, work_bytes, n, cin, cout, is_bf16, stream);
    # its workspace (n, cin, cout, is_bf16)
    lib.swinvox_merger_conv_wgrad_workspace.argtypes = [i64, i, i, i]
    lib.swinvox_merger_conv_wgrad_workspace.restype = i64
    lib.swinvox_merger_conv_wgrad.argtypes = [p] * 4 + [i64, i64, i, i, i, p]
    lib.swinvox_merger_conv_wgrad.restype = i
    # kernel L: (x, w, dy, dx, dw, work, work_bytes, n, is_bf16, stream)
    lib.swinvox_down1_bwd_workspace.argtypes = [i64]
    lib.swinvox_down1_bwd_workspace.restype = i64
    lib.swinvox_down1_bwd.argtypes = [p] * 6 + [i64, i64, i, p]
    lib.swinvox_down1_bwd.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (thread-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


_SAME_DEVICE = contextlib.nullcontext()


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` around a launch, or nothing when
    ``device`` is already the current one (the common case: the guard's
    switch and switch back are host time on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``, as an int for
    a kernel's C entry point (``torch.cuda.current_stream(device)
    .cuda_stream`` without building a Stream object)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().swinvox_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
