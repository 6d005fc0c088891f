"""The tensor-core operand layout of kernels E and F, modelled in torch on
the CPU and held to the JAX package's merger stack.

Kernels E and F (``swinvox_tpu_torch/csrc/merger_stack.cu`` on the bodies
of ``csrc/merger_mma.cuh``) run every conv of the merger's six-layer
stack as an implicit GEMM on ``mma.sync``: a block stages its input halo
with 16 channels a position (normalized on read from the previous
layer's raw output; the conv's zero padding and the padded channels zero
in activation space), each tap's A operand is a shifted window of 16
consecutive w positions, the weights are B tiles padded to [27][16 k][8
n], layer 4's 36 input channels are four 16-channel groups in the
forward (one per source) and three over the concatenated sources in the
weight gradient (kernel K's body), layer 5's 1 -> 9 input gradient
gathers the 27 taps into the depth (27 -> 32), the weight gradient is
the transposed product of the staged windows with dr, and F computes dr
on read from the raw output and the gradient reaching its activation.
CUDA does not run here, so these tests model that arithmetic in float32
and hold the modelled forward, dx and dW to JAX
``merger_stack_reference`` and ``jax.vjp`` at N = 2 (atol 1e-4 forward,
relative L2 STACK_RTOL gradients, as
``test_torch_train_ops.py::test_merger_stack_parity``).  A planted fault
(the affine applied to the padding in r-space) must fail the same hold,
so the check can see the trap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swinvox_tpu_torch.ops import pallas_merger_stack as port_ms

STACK_RTOL = 1e-2
FWD_ATOL = 1e-4
LEAKY, EPS = 0.2, 1e-5
N = 2
TAPS = [(kd, kh, kw) for kd in range(3) for kh in range(3) for kw in range(3)]


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def groups(c):
    return -(-c // 16)


def affine(mean, var, gamma, beta):
    """A BatchNorm layer's normalize affine (scale, shift), as E's
    statistics launch computes it."""
    scale = gamma * torch.rsqrt(var + EPS)
    return scale, beta - mean * scale


def stage(sources, affines, r_space_pad=False, per_source=False):
    """The staged halo of whole volumes: each source normalized on read
    (``leaky(r * scale + shift)``, or raw where its affine is None),
    concatenated and zero-padded to 16-channel groups (``per_source``:
    each source padded to a group of its own, as the forward stages layer
    4), and zero-padded by one position on each side.  ``r_space_pad``
    plants the trap: the affine applied after the spatial padding, so the
    border reads leaky(shift), not 0."""
    acts = []
    for r, aff in zip(sources, affines):
        if r_space_pad:
            r = F.pad(r, (0, 0, 1, 1, 1, 1, 1, 1))
        a = r if aff is None else F.leaky_relu(r * aff[0] + aff[1], LEAKY)
        acts.append(F.pad(a, (0, 16 - a.shape[-1])) if per_source else a)
    a = torch.cat(acts, -1)
    c = a.shape[-1]
    a = F.pad(a, (0, 16 * groups(c) - c))
    return a if r_space_pad else F.pad(a, (0, 0, 1, 1, 1, 1, 1, 1))


def b_tiles(w, adjoint=False):
    """A layer's DHWIO kernel as B tiles [27][16 k][8 n]: each source's 9
    input channels zero-padded to a 16-deep group, n to a multiple of 8;
    for an input gradient the flipped, channel-swapped kernel."""
    w = w.reshape(27, *w.shape[3:])
    if adjoint:
        w = w.flip(0).transpose(1, 2)
    k, n = w.shape[1:]
    w = torch.cat([F.pad(w[:, i:i + 9], (0, 0, 0, 16 - min(9, k - i)))
                   for i in range(0, k, 9)], 1)
    return F.pad(w, (0, -(-n // 8) * 8 - n))


def a_windows(halo, tap, w0):
    """The A operand of one tap for the M-tiles starting at w0: 16
    consecutive w positions of every (volume, d, h) row, all groups."""
    kd, kh, kw = tap
    return halo[:, kd:kd + 32, kh:kh + 32, w0 + kw:w0 + kw + 16, :]


def tc_conv(halo, b, cout):
    """Sum over taps and 16-channel groups of A-window x B-tile products,
    M-tile by M-tile (two 16-wide halves of each row)."""
    halves = []
    for w0 in (0, 16):
        acc = 0.0
        for t, tap in enumerate(TAPS):
            a = a_windows(halo, tap, w0)
            for g in range(halo.shape[-1] // 16):
                k = slice(16 * g, 16 * g + 16)
                acc = acc + a[..., k] @ b[t, k]
        halves.append(acc)
    return torch.cat(halves, 3)[..., :cout]


def wgrad(halo, dr, cin, cout):
    """dW[tap] = X_tap^T dr: the staged windows against dr, transposed
    product over every voxel."""
    dr2 = dr.reshape(-1, dr.shape[-1])
    out = []
    for tap in TAPS:
        kd, kh, kw = tap
        x = halo[:, kd:kd + 32, kh:kh + 32, kw:kw + 32, :]
        out.append(x.reshape(-1, x.shape[-1]).T @ dr2)
    return torch.stack(out).reshape(3, 3, 3, -1, dr.shape[-1])[..., :cin,
                                                                :cout]


def adjoint1(dr5, w5):
    """Layer 5's input gradient, 1 -> 9: A[voxel][tap] = dr5 at voxel +
    tap (27 taps padded to a depth of 32), B[tap][ci] = W5[26 - tap][ci]."""
    p = F.pad(dr5[..., 0], (1, 1, 1, 1, 1, 1))
    cols = [p[:, kd:kd + 32, kh:kh + 32, kw:kw + 32] for kd, kh, kw in TAPS]
    a = F.pad(torch.stack(cols, -1), (0, 32 - 27))
    b = F.pad(w5.reshape(27, 9).flip(0), (0, 16 - 9, 0, 32 - 27))
    return (a @ b)[..., :9]


def dr_on_read(r, da, stats, gamma):
    """F's BatchNorm backward, computed where dr is read: e = dA *
    leaky'(r * scale + shift), xhat = (r - mean) * inv, S1 = sum e, S2 =
    sum e * xhat, and dr = gamma * inv * (e - S1 / n - xhat * S2 / n) in
    the kernel's form gi * e + K0 + K1 * r (the finalize launch's table);
    returns dr, S2 (dgamma), S1 (dbeta)."""
    mean, var, scale, shift = stats
    inv = torch.rsqrt(var + EPS)
    e = da * torch.where(r * scale + shift > 0, 1.0, LEAKY)
    n = r.numel() // r.shape[-1]
    s1, s2 = e.sum((0, 1, 2, 3)), (e * (r - mean) * inv).sum((0, 1, 2, 3))
    gi = gamma * inv
    k0, k1 = gi * (inv * mean * s2 - s1) / n, -gi * inv * s2 / n
    return gi * e + k0 + k1 * r, s2, s1


def model_stack(x, ks, bs, gs, bts, dy=None, r_space_pad=False):
    """Kernels E and F as modelled: returns raw5, the means and variances,
    and with dy the gradients (dx, dW, db, dgamma, dbeta)."""
    raws, stats = [], []
    for layer in range(6):
        if layer == 0:
            srcs, affs = [x], [None]
        elif layer == 4:
            srcs, affs = raws[:4], [s[2:] for s in stats[:4]]
        else:
            srcs, affs = [raws[-1]], [stats[-1][2:]]
        halo = stage(srcs, affs, r_space_pad, per_source=layer == 4)
        r = tc_conv(halo, b_tiles(ks[layer]), ks[layer].shape[-1]) + bs[layer]
        m = r.mean((0, 1, 2, 3))
        v = (r * r).mean((0, 1, 2, 3)) - m * m
        stats.append((m, v, *affine(m, v, gs[layer], bts[layer]))
                     if layer < 5 else (m, v))
        raws.append(r)
    out = (raws[5], [s[0] for s in stats], [s[1] for s in stats])
    if dy is None:
        return out
    dw, db, dg, dbt = [None] * 6, [None] * 6, [None] * 5, [None] * 5
    halo4 = stage([raws[4]], [stats[4][2:]])
    dw[5] = wgrad(halo4, dy, 9, 1)
    db[5] = dy.sum((0, 1, 2, 3))
    da = {4: adjoint1(dy, ks[5])}
    for layer in range(4, -1, -1):
        dr, dg[layer], dbt[layer] = dr_on_read(raws[layer], da[layer],
                                               stats[layer], gs[layer])
        db[layer] = dr.sum((0, 1, 2, 3))
        if layer == 4:
            srcs, affs = raws[:4], [s[2:] for s in stats[:4]]
        elif layer > 0:
            srcs, affs = [raws[layer - 1]], [stats[layer - 1][2:]]
        else:
            srcs, affs = [x], [None]
        dw[layer] = wgrad(stage(srcs, affs), dr, ks[layer].shape[3], 9)
        gin = tc_conv(stage([dr], [None]), b_tiles(ks[layer], adjoint=True),
                      ks[layer].shape[3])
        if layer == 4:
            for k in range(4):
                da[k] = gin[..., 9 * k:9 * k + 9]
        elif layer > 0:
            da[layer - 1] = da[layer - 1] + gin
        else:
            dx = gin
    return out, (dx, dw, db, dg, dbt)


@pytest.fixture(scope="module")
def case():
    """N = 2 inputs drawn with numpy and the JAX reference's forward and
    VJP on them."""
    from swinvox_tpu.ops.pallas_merger_stack import merger_stack_reference

    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, 32, 32, 32, 9)).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, 3, ci, co)) * (0.5 / np.sqrt(27 * ci))
           ).astype(np.float32) for ci, co in port_ms.CHANNELS]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32)
          for _, co in port_ms.CHANNELS]
    gs = [(1 + 0.1 * rng.standard_normal(9)).astype(np.float32)
          for _ in range(5)]
    bts = [(0.3 * rng.standard_normal(9)).astype(np.float32)
           for _ in range(5)]
    dy = rng.standard_normal((N, 32, 32, 32, 1)).astype(np.float32)
    args = (jnp.asarray(x), tuple(map(jnp.asarray, ks)),
            tuple(map(jnp.asarray, bs)), tuple(map(jnp.asarray, gs)),
            tuple(map(jnp.asarray, bts)))
    y, means, vars_ = merger_stack_reference(*args)
    _, vjp = jax.vjp(lambda *a: merger_stack_reference(*a)[0], *args)
    grads = vjp(jnp.asarray(dy))
    inputs = [torch.tensor(x), [torch.tensor(k) for k in ks],
              [torch.tensor(b) for b in bs], [torch.tensor(g) for g in gs],
              [torch.tensor(b) for b in bts], torch.tensor(dy)]
    with torch.no_grad():
        fwd, bwd = model_stack(*inputs)
    return {"inputs": inputs, "fwd": fwd, "bwd": bwd,
            "jax_fwd": (np.asarray(y), [np.asarray(m) for m in means],
                        [np.asarray(v) for v in vars_]),
            "jax_grads": grads}


def fwd_error(got, want):
    """Largest max-abs difference over raw5, the means and the
    variances."""
    errs = [np.abs(got[0].numpy() - want[0]).max()]
    for i in (1, 2):
        errs += [np.abs(g.numpy() - w).max() for g, w in zip(got[i], want[i])]
    return float(max(errs))


def test_modelled_forward_matches_jax(case):
    """raw5 and the six layers' means and variances of the modelled E."""
    assert fwd_error(case["fwd"], case["jax_fwd"]) <= FWD_ATOL


def test_affine_on_r_space_padding_fails_the_hold(case):
    """The trap planted: normalizing the zero-padded r (the border reads
    leaky(shift), not 0) moves the forward far outside the hold."""
    x, ks, bs, gs, bts, _ = case["inputs"]
    with torch.no_grad():
        bad = model_stack(x, ks, bs, gs, bts, r_space_pad=True)
    assert fwd_error(bad, case["jax_fwd"]) > 100 * FWD_ATOL


@pytest.mark.parametrize("what", ["dx", "dW", "db", "dgamma", "dbeta"])
def test_modelled_gradients_match_jax_vjp(case, what):
    """F as modelled (dW as transposed products, the input gradients with
    the flipped, channel-swapped B tiles and layer 5's tap-gathered depth,
    dr on read) against ``jax.vjp``.  The conv biases of layers 0..4 feed
    a train-mode BatchNorm, so their exact gradient is 0: both sides'
    values are rounding noise, held to STACK_RTOL of the layer's dbeta."""
    dx, dw, db, dg, dbt = case["bwd"]
    gx, gk, gb, gg, gbt = case["jax_grads"]
    if what == "dx":
        assert rel_l2(dx.numpy(), gx) <= STACK_RTOL
    elif what == "dW":
        for i in range(6):
            assert rel_l2(dw[i].numpy(), gk[i]) <= STACK_RTOL, i
    elif what == "db":
        for i in range(5):
            noise = np.linalg.norm(db[i].numpy() - np.asarray(gb[i]))
            assert noise <= STACK_RTOL * np.linalg.norm(np.asarray(gbt[i])), i
        assert rel_l2(db[5].numpy(), gb[5]) <= STACK_RTOL
    elif what == "dgamma":
        for i in range(5):
            assert rel_l2(dg[i].numpy(), gg[i]) <= STACK_RTOL, i
    else:
        for i in range(5):
            assert rel_l2(dbt[i].numpy(), gbt[i]) <= STACK_RTOL, i


@pytest.mark.parametrize("cin,per_source,groups_",
                         [(9, False, 1), (36, False, 3), (36, True, 4)])
def test_channel_groups_of_the_sources(cin, per_source, groups_):
    """9 channels fill one 16-channel group; layer 4's 36 fill three in
    order in the weight gradient (its four sources straddle groups) and
    four, one per source, in the forward; the padded channels stay zero
    after normalization (shift 0.5 would make leaky 0.5 there if the
    affine reached them)."""
    rng = np.random.default_rng(3)
    srcs = [torch.tensor(rng.standard_normal((1, 32, 32, 32, 9)),
                         dtype=torch.float32) for _ in range(cin // 9)]
    affs = [(torch.ones(9), torch.full((9,), 0.5)) for _ in srcs]
    halo = stage(srcs, affs, per_source=per_source)
    assert halo.shape[-1] == 16 * groups_
    want = [F.leaky_relu(s + 0.5, LEAKY) for s in srcs]
    real = ([halo[..., 16 * i:16 * i + 9] for i in range(len(srcs))]
            if per_source else [halo[..., :cin]])
    torch.testing.assert_close(torch.cat(real, -1)[:, 1:-1, 1:-1, 1:-1],
                               torch.cat(want, -1))
    pads = ([halo[..., 16 * i + 9:16 * i + 16] for i in range(len(srcs))]
            if per_source else [halo[..., cin:]])
    assert not any(p.any() for p in pads)
    for side in (0, -1):
        assert not halo[:, side].any() and not halo[:, :, side].any()
        assert not halo[:, :, :, side].any()


def kw_x_off(g, npos, pos, h):
    """Element offset of channel half h of halo position pos in group g
    (merger_mma.cuh): 16 channels a position, halves swapped by bit 2."""
    return (g * npos + pos) * 16 + ((h ^ ((pos >> 2) & 1)) << 3)


@pytest.mark.parametrize("h", [0, 1])
def test_ldmatrix_rows_of_the_swizzled_halo_share_no_bank(h):
    """Any 8 consecutive positions (one 8 x 8 matrix of an A fragment,
    whatever tap shift it starts at) read 16-byte rows in 8 distinct
    bank groups, so an ldmatrix of the halo is conflict-free."""
    for start in range(64):
        chunks = {kw_x_off(0, 1360, p, h) // 8 % 8
                  for p in range(start, start + 8)}
        assert len(chunks) == 8, start
