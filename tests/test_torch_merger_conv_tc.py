"""The tensor-core operand layouts of kernels J and I, modelled in torch on
the CPU and held to the JAX package.

Kernel J (one merger conv, ``swinvox_merger_conv`` in
``swinvox_tpu_torch/csrc/merger_conv.cu``) and kernel I (the inference
merger, ``swinvox_merger_infer`` in ``csrc/merger_stack.cu``) run in bf16
on the implicit-GEMM body of ``csrc/merger_mma.cuh``: a block stages its
input halo with 16 channels a position (the conv's zero padding and the
padded channels zero), each tap's A operand is a shifted window of 16
consecutive w positions, the weights are B tiles of a 16-deep group
against n padded to a multiple of 8.  What J and I add to kernel E's
layout, and what these tests model in float32:

  * J's 36-channel input is one interleaved tensor [V, 32^3, 36] (the
    merger's concat of four activations), staged as three 16-channel
    groups over the concatenated channels (36 -> 48), not as E's four
    separate 9-channel sources;
  * J's 9 -> 36 input gradient has n padded to 40 and writes one
    interleaved [V, 32^3, 36] output, a (volume, plane, 8 rows) tile at a
    time;
  * J's 1 -> 9 input gradient gathers the 27 taps of the one input
    channel into the depth (27 -> 32) of a kernel the host already
    flipped (forward-indexed here, unlike kernel F's layer 5);
  * I's epilogue applies the folded BatchNorm to the unrounded f32 sum,
    then LeakyReLU, then rounds the activation once; the next layer's
    halo reads the stored activations raw, its out-of-volume positions
    zero.

CUDA does not run here.  The modelled J is held on all five (ci, co)
against ``jax.lax.conv_general_dilated`` at 2 volumes with
``test_torch_train_kernels.py``'s tolerances (rtol 1e-4, atol 1e-4), the
modelled I against JAX ``merger_view_weights(..., interpret=True)`` at 1
volume (rtol 3e-3, atol 5e-4, ``test_torch_infer_kernels.py``'s).  Two
planted faults must fail the same holds: J's interleaved input read as
E's four stride-9 sources, and I's fold applied to the halo's
out-of-volume positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swinvox_tpu_torch.ops import pallas_band_conv as port_bc
from swinvox_tpu_torch.ops import pallas_merger as port_merger

S = 32
LEAKY = 0.2
J_RTOL = J_ATOL = 1e-4
I_RTOL, I_ATOL = 3e-3, 5e-4
BF16_ULPS = 2.0**-6  # two bf16 ulps of the largest logit
TAPS = [(kd, kh, kw) for kd in range(3) for kh in range(3) for kw in range(3)]
CHANNELS = ((9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1))


def groups(c):
    return -(-c // 16)


def pad_halo(a):
    """Zero padding of one position on each side of d, h and w."""
    return F.pad(a, (0, 0, 1, 1, 1, 1, 1, 1))


def stage_interleaved(x):
    """J's halo of an interleaved input [V, 32, 32, 32, C]: the C
    channels in order, zero-padded to 16-channel groups (36 -> three
    groups: channels 0-15, 16-31 and 32-35 with 12 zeros)."""
    c = x.shape[-1]
    return pad_halo(F.pad(x, (0, 16 * groups(c) - c)))


def stage_sources(sources):
    """A halo of separate 9-channel sources, each zero-padded to a
    16-channel group of its own (kernel E's and I's layer 4)."""
    return pad_halo(torch.cat([F.pad(s, (0, 16 - s.shape[-1]))
                               for s in sources], -1))


def e_sources_of_interleaved(x):
    """The trap: E's layer-4 layout applied to J's interleaved input.
    E reads source k at p + 9 k with a channel stride of 9, which on one
    [V, 32^3, 36] tensor is row j + k of its memory viewed as rows of 9
    channels (zeros past the end)."""
    rows = F.pad(x.reshape(-1, 9), (0, 0, 0, 3))
    n = x[..., 0].numel()
    return [rows[k:k + n].reshape(*x.shape[:4], 9) for k in range(4)]


def b_tiles(w, group_width=16):
    """A forward-indexed DHWIO kernel as B tiles [27][16 g][n8]: the input
    channels in 16-deep groups (``group_width`` 9: one 9-channel source a
    group, zero-padded), n padded to a multiple of 8."""
    w = w.reshape(27, *w.shape[3:])
    k, n = w.shape[1:]
    w = torch.cat([F.pad(w[:, i:i + group_width],
                         (0, 0, 0, 16 - min(group_width, k - i)))
                   for i in range(0, k, group_width)], 1)
    return F.pad(w, (0, -(-n // 8) * 8 - n))


def tc_conv(halo, b):
    """Sum over taps and 16-channel groups of A-window x B-tile products,
    M-tile by M-tile (two 16-wide halves of each row): the padded
    accumulators [V, 32, 32, 32, n8]."""
    halves = []
    for w0 in (0, 16):
        acc = 0.0
        for t, (kd, kh, kw) in enumerate(TAPS):
            a = halo[:, kd:kd + S, kh:kh + S, w0 + kw:w0 + kw + 16, :]
            for g in range(halo.shape[-1] // 16):
                k = slice(16 * g, 16 * g + 16)
                acc = acc + a[..., k] @ b[t, k]
        halves.append(acc)
    return torch.cat(halves, 3)


def write_tiles(acc, cout, dt=1, ht=8):
    """The epilogue's store of the padded accumulators: a block stages
    its (volume, dt planes, ht rows) tile as [voxel][cout] in shared
    memory (the padded n columns dropped) and copies it to the output at
    the tile's first voxel times cout: one interleaved [V, 32^3, cout]
    tensor."""
    v = acc.shape[0]
    out = torch.zeros(v * S**3 * cout)
    for n in range(v):
        for d0 in range(0, S, dt):
            for h0 in range(0, S, ht):
                tile = acc[n, d0:d0 + dt, h0:h0 + ht, :, :cout].reshape(-1)
                base = ((n * S + d0) * S + h0) * S * cout
                out[base:base + tile.numel()] = tile
    return out.reshape(v, S, S, S, cout)


def conv1_gathered(x, w):
    """J's 1 -> 9 conv: A[voxel][tap] = x at voxel + tap (the 27 taps
    padded to a depth of 32, two k16 steps), B[tap][co] = w[tap][0][co]
    as the host passed it (already flipped for an input gradient)."""
    p = pad_halo(x)[..., 0]
    cols = [p[:, kd:kd + S, kh:kh + S, kw:kw + S] for kd, kh, kw in TAPS]
    a = F.pad(torch.stack(cols, -1), (0, 32 - 27))
    b = F.pad(w.reshape(27, w.shape[-1]), (0, 16 - w.shape[-1], 0, 32 - 27))
    return a[..., :16] @ b[:16] + a[..., 16:] @ b[16:]


def model_j(x, w, e_sources=False):
    """Kernel J as modelled: x [V, 32, 32, 32, ci], w [3, 3, 3, ci, co]
    forward-indexed -> [V, 32, 32, 32, co].  ``e_sources`` plants the
    trap on the 36-channel input."""
    ci, co = w.shape[3:]
    if ci == 1:
        return conv1_gathered(x, w)[..., :co]
    if e_sources:
        acc = tc_conv(stage_sources(e_sources_of_interleaved(x)),
                      b_tiles(w, group_width=9))
    else:
        acc = tc_conv(stage_interleaved(x), b_tiles(w))
    if co == 36:
        return write_tiles(acc, co)
    return acc[..., :co]


def model_i(x, ks, biases, bn, fold_halo=False, dtype=torch.float32):
    """Kernel I as modelled: each layer's halo of the stored activations
    (x for layer 0; layer 4 reads a_0..a_3 as four sources), the f32 sum
    z, then a_l = leaky(z * s_l + t_l) rounded once to ``dtype``; f32
    logits out.  ``fold_halo`` plants the fault: the previous layer's
    fold applied to the zero padding too (the halo's out-of-volume
    positions read leaky(t), not 0)."""
    acts, shifts = [], []
    for layer, (ci, co) in enumerate(CHANNELS):
        srcs = [x] if layer == 0 else (acts[:4] if layer == 4 else
                                       [acts[-1]])
        halo = stage_sources(srcs)
        if fold_halo and layer > 0:
            inside = torch.zeros_like(halo[..., :1])
            inside[:, 1:-1, 1:-1, 1:-1] = 1
            border = torch.cat([F.pad(F.leaky_relu(t, LEAKY), (0, 16 - 9))
                                for t in (shifts[:4] if layer == 4
                                          else shifts[-1:])], -1)
            halo = halo + (1 - inside) * border
        s, t = port_merger.fold_bn(*bn[layer], biases[layer])
        z = tc_conv(halo, b_tiles(ks[layer], group_width=9))[..., :co]
        a = F.leaky_relu(z * s + t, LEAKY)
        if layer == 5:
            return a[..., 0]
        acts.append(a.to(dtype).float())
        shifts.append(t)


def _lax_conv(x, k):
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=dn))


def _j_case(ci, co, seed=5):
    rng = np.random.default_rng(seed + ci * 100 + co)
    x = rng.standard_normal((2, S, S, S, ci)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("ci,co", port_bc.CONV_SHAPES)
def test_modelled_j_matches_lax_conv(ci, co):
    """Every (ci, co) kernel J runs (the three forward shapes and the two
    adjoint shapes, on a kernel the host passes as it is) against JAX's
    SAME conv at 2 volumes."""
    x, k = _j_case(ci, co)
    with torch.no_grad():
        got = model_j(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, _lax_conv(x, k), rtol=J_RTOL,
                               atol=J_ATOL)


def test_j_e_sources_on_interleaved_input_fails_the_hold():
    """The trap planted: J's [V, 32^3, 36] input staged as E's four
    stride-9 sources moves the output far outside the hold."""
    x, k = _j_case(36, 9)
    with torch.no_grad():
        bad = model_j(torch.from_numpy(x), torch.from_numpy(k),
                      e_sources=True).numpy()
    err = np.abs(bad - _lax_conv(x, k)).max()
    assert err > 100 * (J_ATOL + J_RTOL * np.abs(_lax_conv(x, k)).max())


def test_interleaved_groups_and_padding():
    """36 interleaved channels fill three 16-channel groups in order
    (group 2: channels 32-35, then 12 zeros); the halo's border is zero."""
    x = torch.arange(1.0, 37.0).expand(1, S, S, S, 36)
    halo = stage_interleaved(x)
    assert halo.shape == (1, S + 2, S + 2, S + 2, 48)
    inner = halo[0, 1, 1, 1]
    assert torch.equal(inner[:36], torch.arange(1.0, 37.0))
    assert not inner[36:].any()
    for side in (0, -1):
        assert not halo[:, side].any() and not halo[:, :, side].any()
        assert not halo[:, :, :, side].any()


def test_adjoint_9_to_36_tile_writes_interleaved_output():
    """n padded to 40 (five n8 tiles); a tile's store drops the four
    padded columns, so voxel p's 36 channels land at p * 36 whatever
    the padded accumulators hold past channel 35."""
    rng = np.random.default_rng(1)
    acc = torch.from_numpy(rng.standard_normal((1, S, S, S, 40)).astype(
        np.float32))
    assert b_tiles(torch.zeros(3, 3, 3, 9, 36)).shape == (27, 16, 40)
    out = write_tiles(acc, 36)
    assert torch.equal(out, acc[..., :36])


@pytest.fixture(scope="module")
def infer_case():
    """One volume drawn with numpy (test_torch_infer_kernels.py's
    fixture), and JAX ``merger_view_weights`` in interpret mode on it."""
    from swinvox_tpu.ops.pallas_merger import merger_view_weights

    rng = np.random.default_rng(0)
    kernels, biases, bn = [], [], []
    for ci, co in CHANNELS:
        kernels.append((rng.standard_normal((3, 3, 3, ci, co)) * 0.2
                        ).astype(np.float32))
        biases.append((rng.standard_normal(co) * 0.1).astype(np.float32))
        bn.append(((1 + 0.1 * rng.standard_normal(co)).astype(np.float32),
                   (0.1 * rng.standard_normal(co)).astype(np.float32),
                   (0.1 * rng.standard_normal(co)).astype(np.float32),
                   (0.5 + np.abs(rng.standard_normal(co))).astype(
                       np.float32)))
    x = (rng.standard_normal((1, S, S, S, 9)) * 0.5).astype(np.float32)
    ref = np.asarray(merger_view_weights(jnp.asarray(x), kernels, biases, bn,
                                         interpret=True))
    t = torch.from_numpy
    return {"x": t(x), "ks": [t(k) for k in kernels],
            "bs": [t(b) for b in biases],
            "bn": [tuple(t(p) for p in b) for b in bn], "ref": ref}


@pytest.mark.parametrize("fold_halo", [False, True],
                         ids=["as-designed", "fold-on-halo-fails"])
def test_modelled_i_against_jax_merger_view_weights(infer_case, fold_halo):
    """The modelled I (the fold on the f32 sum, zero halo) holds to JAX;
    with the previous layer's fold applied to the halo's out-of-volume
    positions it fails the same hold."""
    c = infer_case
    with torch.no_grad():
        got = model_i(c["x"], c["ks"], c["bs"], c["bn"],
                      fold_halo=fold_halo).numpy()
    assert got.shape == (1, S, S, S)
    close = np.allclose(got, c["ref"], rtol=I_RTOL, atol=I_ATOL)
    assert close != fold_halo


def test_modelled_i_bf16_matches_the_plain_version(infer_case):
    """With each activation rounded once to bf16 after the epilogue, the
    modelled I equals the port's plain version on bf16 volumes up to the
    order of the f32 sums (a bf16 ulp where a rounding tie flips)."""
    c = infer_case
    xb = c["x"].bfloat16()
    ks = [k.bfloat16().float() for k in c["ks"]]  # the packed bf16 kernels
    with torch.no_grad():
        got = model_i(xb.float(), ks, c["bs"], c["bn"], dtype=torch.bfloat16)
        want = port_merger.merger_view_weights_reference(
            xb, c["ks"], c["bs"], c["bn"])
    err = (got - want).abs().max().item()
    assert err <= BF16_ULPS * want.abs().max().item(), err
