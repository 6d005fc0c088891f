"""Kernel L's tensor-core tiling and kernel H's route on kernel B's
launches, modelled in torch on the CPU and held to the JAX package.

Kernel L (the refiner's down1 backward, ``swinvox_down1_bwd`` in
``swinvox_tpu_torch/csrc/down1.cu``) runs in bf16 as one pass over dy: a
block owns an input tile of 4 planes x 8 rows x 32 columns, streams the
7 x 11 dy rows the tile reads (its own and the halo rows its neighbours
also read), computes per staged row R[iw, (kd, kh)] = sum over (kw, c)
of dy[od, oh, iw + 2 - kw, c] W[kd, kh, kw, c] and adds the R entries
that reach its voxels in a fixed order; the rows it owns (o = 32 in the
last tiles) add x_pad[o + k] dy[o, c] to two per-block halves of dW,
which the block adds in order into its partial, and the partials meet in
``mma_common.cuh``'s fixed-order reduce.  Kernel H (the fused W-MSA,
``swinvox_fused_msa`` in ``csrc/swin_block.cu``) runs kernel B's QKV
product (bf16(acc + b)), B's attention at shift 0 (row w * T + t, tokens
padded to 64 on chip with the pad keys at probability 0, the mask of
window w mask[w % nW_img]) and the QKV product again on ctx and Wproj.

CUDA does not run here: these models are float32 torch.  L's model is
held at N = 2 against ``jax.vjp`` of ``lax.conv_general_dilated`` with
``test_torch_train_kernels.py``'s down1 tolerances (dx rtol = atol =
1e-4; dW rtol 1e-4, atol 1e-4 x its scale) and against the port's
``down1_backward_reference``; H's model against JAX
``_reference_fused_msa`` at C = 96 and 192 with several images' windows,
at ``test_fused_msa_parity``'s tolerance (rtol 5e-4, atol 5e-5).  Two
planted faults must fail the same holds: a tile's boundary dy plane
dropped from its dx, and the mask indexed by w // nW_per_image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swinvox_tpu_torch.ops import pallas_down1 as port_down1
from swinvox_tpu_torch.ops import pallas_fused_msa as port_msa

S, SO, K, C = 32, 33, 4, 32
TD, TH = 4, 8                  # input planes and rows of an L tile
YROWS = TH + 3                 # dy rows of a plane an L tile stages
DW_PAD = 48                    # positions of a dW product (33 -> 48)
RED_WARPS, SERIAL_PARTS = 8, 16  # mma_common.cuh's fixed_order_reduce
DX_TOL = 1e-4
DW_RTOL = 1e-4
H_RTOL, H_ATOL = 5e-4, 5e-5
TMAX, HD = 64, 32


# ------------------------------------------------------------- kernel L


def fixed_order_sum(parts):
    """mma_common.cuh's fixed_order_reduce over a list of partials: with
    at most 16 parts, in order; else warp w of 8 sums parts w, w + 8, ...
    in order, then the 8 warp sums in order."""
    if len(parts) <= SERIAL_PARTS:
        total = torch.zeros_like(parts[0])
        for p in parts:
            total = total + p
        return total
    warps = []
    for w in range(RED_WARPS):
        s = torch.zeros_like(parts[0])
        for p in parts[w::RED_WARPS]:
            s = s + p
        warps.append(s)
    total = torch.zeros_like(parts[0])
    for s in warps:
        total = total + s
    return total


def r_of_rows(rows, wk):
    """R[row, iw, kd, kh] of staged dy rows [R, 33, 32]: the sum over (kw,
    c) of dy[oh, iw + 2 - kw, c] W[kd, kh, kw, c], the A row of column iw
    being positions iw - 1 .. iw + 2 (kw' = 3 - kw) of the row padded with
    one zero position on each side."""
    pad = F.pad(rows, (0, 0, 1, 1))                     # [R, 35, 32]
    win = pad.unfold(1, K, 1)                           # [R, 32, 32 c, 4 kw']
    wf = wk.flip(2)                                     # [kd, kh, kw', c]
    return torch.einsum("ricj,dhjc->ridh", win, wf)


def down1_tc_model(x, wk, dy, drop_plane=None):
    """Kernel L's bf16 route as tiles, in float32: x [N, 32, 32, 32], wk
    [4, 4, 4, 32], dy [N, 33, 33, 33, 32] -> (dx [N, 32, 32, 32], dW [4, 4,
    4, 32]).  ``drop_plane``: a planted fault, the tile's dy plane od =
    id0 + drop_plane left out of its dx."""
    n = x.shape[0]
    dx = torch.zeros(n, S, S, S)
    parts = []
    for v in range(n):
        # x padded by 2 before each axis; 20 after w: pair column p holds
        # x[p - 2] (and x[p - 1]) for p up to 51
        xpad = F.pad(x[v], (2, 20, 2, 2, 2, 2))
        for dt in range(S // TD):
            for ht in range(S // TH):
                id0, ih0 = dt * TD, ht * TH
                halo = xpad[id0:id0 + TD + 4, ih0:ih0 + TH + 4]  # [8, 12, 54]
                last_h = ih0 + TH == S
                owned_rows = range(TH + (1 if last_h else 0))
                acc = torch.zeros(TD, TH, S)
                halves = [torch.zeros(K * K * K, C) for _ in range(2)]
                for od in range(max(id0 - 1, 0), min(id0 + TD + 2, SO)):
                    # the staged plane: rows oh = ih0 - 1 + r inside 0..32
                    rows = torch.stack([
                        dy[v, od, oh] if 0 <= oh < SO else torch.zeros(SO, C)
                        for oh in range(ih0 - 1, ih0 - 1 + YROWS)])
                    rr = r_of_rows(rows, wk)            # [11, 32, 4, 4]
                    if drop_plane is None or od != id0 + drop_plane:
                        # voxel (id0 + l, ih0 + ihl): kd = id + 2 - od,
                        # staged row r = ihl + 3 - kh (R of a row outside
                        # the volume is 0: it was never staged)
                        for l in range(TD):
                            kd = id0 + l + 2 - od
                            if not 0 <= kd < K:
                                continue
                            for kh in range(K):
                                acc[l] += rr[3 - kh:3 - kh + TH, :, kd, kh]
                    owned_d = id0 <= od < id0 + TD or (od == S
                                                       and id0 + TD == S)
                    if not owned_d:
                        continue
                    for j in owned_rows:
                        # Xpatch[(kd, kh, kw), o] = x[od + kd - 2][oh + kh
                        # - 2][o + kw - 2], o < 48; dy rows 33..47 zero
                        sub = halo[od - id0:od - id0 + K, j:j + K]
                        patch = sub.unfold(2, DW_PAD, 1)[:, :, :K].reshape(
                            K * K * K, DW_PAD)
                        b = F.pad(rows[j + 1], (0, 0, 0, DW_PAD - SO))
                        halves[j % 2] = halves[j % 2] + patch @ b
                dx[v, id0:id0 + TD, ih0:ih0 + TH] = acc
                parts.append(halves[0] + halves[1])
    return dx, fixed_order_sum(parts).reshape(K, K, K, C)


def _jax_down1_vjp(x, w, dy):
    """(dx, dW) of Conv3d(1 -> 32, k4, p2) by ``jax.vjp`` of the lax conv."""
    def conv(x, w):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                            ("NDHWC", "DHWIO", "NDHWC"))
        return jax.lax.conv_general_dilated(x, w, (1, 1, 1), [(2, 2)] * 3,
                                            dimension_numbers=dn)

    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(dy))
    return np.asarray(gx), np.asarray(gw)


@pytest.fixture(scope="module")
def down1_case():
    """N = 2 inputs from a seed, the JAX gradients and the port's plain
    version's, computed once for the module's holds."""
    rng = np.random.default_rng(10)
    n = 2
    x = rng.standard_normal((n, S, S, S, 1)).astype(np.float32)
    w = (rng.standard_normal((K, K, K, 1, C)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((n, SO, SO, SO, C)).astype(np.float32)
    gx, gw = _jax_down1_vjp(x, w, dy)
    px, pw = port_down1.down1_backward_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy))
    return {"x": x, "w": w, "dy": dy, "jax": (gx, gw),
            "plain": (px.numpy(), pw.numpy())}


def _down1_model_outputs(case, drop_plane=None):
    dx, dw = down1_tc_model(torch.from_numpy(case["x"][..., 0]),
                            torch.from_numpy(case["w"][:, :, :, 0]),
                            torch.from_numpy(case["dy"]), drop_plane)
    return dx.numpy()[..., None], dw.numpy()[:, :, :, None]


def _hold_down1(got, want):
    dx, dw = got
    np.testing.assert_allclose(dx, want[0], rtol=DX_TOL, atol=DX_TOL)
    np.testing.assert_allclose(dw, want[1], rtol=DW_RTOL,
                               atol=DW_RTOL * float(np.abs(want[1]).max()))


@pytest.mark.parametrize("against", ["jax", "plain"])
def test_down1_tiling_matches(down1_case, against):
    """The modelled tiles (staged planes, halo rows, R summed per voxel,
    per-block dW partials in their fixed-order sum) give the gradients of
    JAX's lax conv and of the port's plain version."""
    _hold_down1(_down1_model_outputs(down1_case), down1_case[against])


@pytest.mark.parametrize("drop_plane", [-1, TD + 1])
def test_down1_dropped_boundary_plane_fails(down1_case, drop_plane):
    """A tile that leaves out its first (od = id0 - 1) or last (od = id0 +
    5) dy plane from its dx fails the hold; dW, which only owned planes
    feed, still holds."""
    dx, dw = _down1_model_outputs(down1_case, drop_plane)
    with pytest.raises(AssertionError):
        _hold_down1((dx, dw), down1_case["jax"])
    _hold_down1((down1_case["jax"][0], dw), down1_case["jax"])


# ------------------------------------------------------------- kernel H


def qkv_product(a, w, b):
    """Kernel B's QKV product and epilogue, swin_fwd_gemm<QKV>: the f32 sum
    plus the bias, rounded once to the tokens' dtype."""
    return (a.float() @ w.float() + b.float()).to(a.dtype)


def attention_identity_map(qkv, rel_bias, mask, n_windows, t, c, heads,
                           scale, mask_index=None):
    """Kernel B's attention (swin_fwd_attn_kernel) at shift 0 on the packed
    qkv [nW * T, 3C]: window w, token k at row w * T + k; q, k, v of head h
    at columns h * 32, C + h * 32, 2C + h * 32; tokens padded to 64 with
    the pad keys' bias -inf (probability 0) and the pad query rows never
    written; the mask of window w is mask[mask_index(w)] (the kernel's
    w % nW_img by default); P = e / sum rounded to the tokens' dtype,
    ctx = P v rounded."""
    nw_img = 0 if mask is None else mask.shape[0]
    if mask_index is None:
        mask_index = lambda w: w % nw_img  # noqa: E731
    bias = torch.full((heads, TMAX, TMAX), -torch.inf)
    bias[:, :t, :t] = rel_bias
    ctx = torch.empty(n_windows * t, c, dtype=qkv.dtype)
    for w in range(n_windows):
        rows = qkv[w * t:(w + 1) * t].float()
        tile = F.pad(rows, (0, 0, 0, TMAX - t))          # [64, 3C], zeros
        for h in range(heads):
            q = tile[:, h * HD:(h + 1) * HD]
            k = tile[:, c + h * HD:c + (h + 1) * HD]
            v = tile[:, 2 * c + h * HD:2 * c + (h + 1) * HD]
            s = q @ k.T * scale + bias[h]
            if mask is not None:
                s[:t, :t] += mask[mask_index(w)]
            m = s.max(-1, keepdim=True).values
            e = torch.where(m == -torch.inf, 0.0, torch.exp(s - m))
            tot = e.sum(-1, keepdim=True)
            p = torch.where(tot > 0, e / tot, 0.0).to(qkv.dtype).float()
            out = (p @ v).to(qkv.dtype)
            ctx[w * t:(w + 1) * t, h * HD:(h + 1) * HD] = out[:t]
    return ctx


def fused_msa_model(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, heads,
                    mask_index=None):
    """Kernel H's three launches: x [nW, T, C] -> [nW, T, C]."""
    nw, t, c = x.shape
    qkv = qkv_product(x.reshape(nw * t, c), wqkv, bqkv)
    ctx = attention_identity_map(qkv, rel_bias, mask, nw, t, c, heads,
                                 (c // heads) ** -0.5, mask_index)
    return qkv_product(ctx, wproj, bproj).reshape(nw, t, c)


def _msa_case(rng, c, heads, n_images):
    """Inputs at test_fused_msa_parity's scales: 14 x 14 maps (4 windows an
    image) of ``n_images`` images, the shifted-window mask."""
    from swinvox_tpu.models.swin import shifted_window_mask

    t, nw = 49, 4 * n_images
    ops = (rng.standard_normal((nw, t, c)).astype(np.float32) * 0.5,
           rng.standard_normal((c, 3 * c)).astype(np.float32) * 0.05,
           rng.standard_normal((3 * c,)).astype(np.float32) * 0.01,
           rng.standard_normal((c, c)).astype(np.float32) * 0.05,
           rng.standard_normal((c,)).astype(np.float32) * 0.01,
           rng.standard_normal((heads, t, t)).astype(np.float32),
           shifted_window_mask(14, 14, 7, 3))
    return ops


def _jax_fused_msa(ops, heads):
    from swinvox_tpu.ops.pallas_fused_msa import _reference_fused_msa

    c = ops[0].shape[-1]
    return np.asarray(_reference_fused_msa(*[jnp.asarray(a) for a in ops],
                                           heads, (c // heads) ** -0.5))


@pytest.mark.parametrize("c,heads,n_images", [(96, 3, 2), (192, 6, 3)])
def test_fused_msa_route_matches_jax(rng, c, heads, n_images):
    """H on B's launches (QKV epilogue, identity-map attention with
    mask[w % nW_img], the same epilogue on ctx Wproj) == JAX
    ``_reference_fused_msa`` over several images' windows."""
    ops = _msa_case(rng, c, heads, n_images)
    got = fused_msa_model(*[torch.from_numpy(a) for a in ops], heads)
    np.testing.assert_allclose(got.numpy(), _jax_fused_msa(ops, heads),
                               rtol=H_RTOL, atol=H_ATOL)


def test_fused_msa_mask_by_image_fails(rng):
    """The mask taken by w // nW_per_image (the image, not the window's
    place in it) fails the same hold."""
    c, heads, n_images = 96, 3, 2
    ops = _msa_case(rng, c, heads, n_images)
    nw_img = ops[-1].shape[0]
    got = fused_msa_model(*[torch.from_numpy(a) for a in ops], heads,
                          mask_index=lambda w: w // nw_img)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), _jax_fused_msa(ops, heads),
                                   rtol=H_RTOL, atol=H_ATOL)


# --------------------------------------------------------- the wrappers


def test_wrappers_run_plain_on_cpu(rng):
    """On CPU tensors kernel L's and kernel H's wrappers run their plain
    versions (bit for bit) and their launch counters do not move."""
    x = torch.from_numpy(rng.standard_normal((1, S, S, S, 1), np.float32))
    w = torch.from_numpy(rng.standard_normal((K, K, K, 1, C), np.float32))
    dy = torch.from_numpy(rng.standard_normal((1, SO, SO, SO, C),
                                              np.float32))
    before = port_down1.down1_backward.launches
    got = port_down1.down1_backward(x, w, dy)
    want = port_down1.down1_backward_reference(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert port_down1.down1_backward.launches == before
    ops = [torch.from_numpy(a) for a in _msa_case(rng, 96, 3, 2)]
    before = port_msa.fused_msa_forward.launches
    got = port_msa.fused_window_msa(*ops, 3)
    assert torch.equal(got, port_msa.fused_msa_reference(*ops, 3,
                                                         HD ** -0.5))
    assert port_msa.fused_msa_forward.launches == before


@pytest.mark.parametrize("c,heads", [(128, 4), (96, 4), (64, 2)])
def test_fused_msa_check_refuses_other_widths(c, heads):
    """Kernel H takes Swin-T's widths (96, 192, 384, 768) at head_dim 32:
    its wrapper's check refuses any other C or head count before a
    launch."""
    x = torch.zeros(4, 49, c, dtype=torch.bfloat16)
    args = (x, torch.zeros(c, 3 * c, dtype=torch.bfloat16),
            torch.zeros(3 * c), torch.zeros(c, c, dtype=torch.bfloat16),
            torch.zeros(c), torch.zeros(heads, 49, 49), None, heads)
    with pytest.raises(ValueError, match="C in"):
        port_msa._check(*args)
