#!/usr/bin/env python3
"""Compares the bf16 merger kernels of two source trees of the PyTorch +
CUDA port bit for bit, on one NVIDIA GPU.

    python3 tools/compare_merger_bits.py OTHER_TREE [THIS_TREE]

Each tree's ``swinvox_tpu_torch`` runs in a process of its own (the two
packages share a name; each builds its kernels into its own
``_build``) on the same inputs drawn from a seed: kernel E (the merger
stack forward) and F (its backward) at 48 volumes, kernel K (the merger
conv weight gradient) and J (the merger conv) at 24 volumes on every
shape they run, and kernel I (the inference merger) at 24 volumes.  E, F
and K must give the same bits in both trees (the script exits 1
otherwise); J and I are reported (a redesign sums the same exact
products in another order).  The outputs go to a temporary directory
that is removed at the end.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SAME_BITS = ("E", "F", "K")


def dump(tree: str, out: str) -> None:
    import torch

    sys.path.insert(0, tree)
    from swinvox_tpu_torch.ops import pallas_band_conv as bc
    from swinvox_tpu_torch.ops import pallas_merger as mi
    from swinvox_tpu_torch.ops import pallas_merger_stack as ms

    if not bc.__file__.startswith(str(Path(tree).resolve())):
        raise RuntimeError(f"imported {bc.__file__}, not from {tree}")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    res = {}
    x = r(48, 32, 32, 32, 9).bfloat16()
    ks = [r(3, 3, 3, ci, co, s=(27 * ci) ** -0.5) for ci, co in ms.CHANNELS]
    bs = [r(co, s=0.1) for _, co in ms.CHANNELS]
    gs = [1 + r(9, s=0.1) for _ in range(5)]
    bts = [r(9, s=0.1) for _ in range(5)]
    dy = r(48, 32, 32, 32, 1).bfloat16()
    raw5, stats, raws = ms.merger_stack_forward(x, ks, bs, gs, bts, 0.2, 1e-5)
    # layer 5's stats rows hold its mean and variance only
    res.update({"E raw5": raw5, "E stats": stats[:5], "E raws": raws})
    dx, dks, db, dg, dbt = ms.merger_stack_backward(dy, x, raws, stats, ks,
                                                    gs, 0.2, 1e-5)
    res.update({"F dx": dx, "F db": db, "F dgamma": dg, "F dbeta": dbt})
    res.update({f"F dW{i}": d for i, d in enumerate(dks)})
    for ci, co in bc.CONV_SHAPES:
        xc = r(24, 32, 32, 32, ci).bfloat16()
        kc = r(3, 3, 3, ci, co, s=(27 * ci) ** -0.5)
        res[f"J {ci}->{co}"] = bc.merger_conv_forward(xc, kc)
        if (ci, co) in bc.FORWARD_SHAPES:
            dyc = r(24, 32, 32, 32, co).bfloat16()
            res[f"K {ci}->{co}"] = bc.merger_conv_wgrad(xc, dyc)
    xi = r(24, 32, 32, 32, 9, s=0.5).bfloat16()
    ki = [r(3, 3, 3, ci, co, s=(27 * ci) ** -0.5) for ci, co in ms.CHANNELS]
    bi = [r(co, s=0.1) for _, co in ms.CHANNELS]
    bn = [(1 + r(co, s=0.1), r(co, s=0.1), r(co, s=0.1), 0.5 + r(co).abs())
          for _, co in ms.CHANNELS]
    res["I logits"] = mi.merger_view_weights(xi, ki, bi, bn)
    torch.cuda.synchronize()
    torch.save({k: t.cpu() for k, t in res.items()}, out)


def compare(a_file: str, b_file: str) -> int:
    import torch

    a, b = torch.load(a_file), torch.load(b_file)
    bad = []
    for key in a:
        same = torch.equal(a[key], b[key])
        diff = (a[key].float() - b[key].float()).abs().max().item()
        print(f"{key}: {'the same bits' if same else 'differ'} (max abs "
              f"{diff:.4g})")
        if not same and key.split()[0] in SAME_BITS:
            bad.append(key)
    print(f"{', '.join(SAME_BITS)}: " + (f"DIFFER in {bad}" if bad else
                                         "the same bits in both trees"))
    return 1 if bad else 0


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--dump":
        dump(argv[1], argv[2])
        return 0
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in
             (argv[0], argv[1] if len(argv) == 2
              else Path(__file__).resolve().parent.parent)]
    work = tempfile.mkdtemp(prefix="merger_bits_")
    try:
        files = [str(Path(work) / f"{i}.pt") for i in range(2)]
        for tree, out in zip(trees, files):
            subprocess.run([sys.executable, __file__, "--dump", tree, out],
                           check=True)
        return compare(*files)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
