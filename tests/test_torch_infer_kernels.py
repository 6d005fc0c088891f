"""swinvox_tpu_torch kernels G (window-attention core), H (fused W-MSA)
and I (inference merger) against the JAX package, f32, inputs drawn with
numpy from a seed.  On the CPU the port's wrappers run their plain PyTorch
versions; the JAX side runs its plain XLA functions and, once each, its
Pallas kernel in interpret mode (as tests/test_pallas.py does, with its
tolerances).  The comparison on the card lives in
``test_infer_kernels_match_plain_on_card`` (marked ``cuda``) and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu_torch.convert import load_jax_variables
from swinvox_tpu_torch.ops import pallas_fused_msa as port_msa
from swinvox_tpu_torch.ops import pallas_merger as port_merger
from swinvox_tpu_torch.ops import pallas_window_attention as port_attn
from swinvox_tpu_torch.ops.window_attention import window_attention


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jitter(tree, rng, scale=0.05):
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32),
        tree,
    )


# ------------------------------------------------------------- kernel G


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_parity(rng, masked):
    """Kernel G's wrapper (plain on the CPU) == JAX ``window_attention_xla``
    and ``window_attention_pallas`` in interpret mode, at the JAX test's
    size (8 windows, 4 per image, 3 heads): rtol 2e-4, atol 2e-5."""
    from swinvox_tpu.models.swin import shifted_window_mask
    from swinvox_tpu.ops.pallas_window_attention import (
        window_attention_pallas,
    )
    from swinvox_tpu.ops.window_attention import window_attention_xla

    nw, heads, t, d = 8, 3, 49, 32
    q, k, v = (rng.standard_normal((nw, heads, t, d), np.float32)
               for _ in range(3))
    bias = rng.standard_normal((heads, t, t), np.float32)
    mask = shifted_window_mask(14, 14, 7, 3) if masked else None
    jx = [jnp.asarray(a) if a is not None else None
          for a in (q, k, v, bias, mask)]
    refs = (np.asarray(window_attention_xla(*jx)),
            np.asarray(window_attention_pallas(*jx, interpret=True)))
    before = port_attn.window_attention_forward.launches
    ins = [_t(a) for a in (q, k, v, bias, mask)]
    for got in (port_attn.window_attention_pallas(*ins),
                window_attention(*ins, use_pallas=True)):
        for ref in refs:
            np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)
    assert port_attn.window_attention_forward.launches == before  # CPU: plain


# ------------------------------------------------------------- kernel H


@pytest.mark.parametrize("c,heads,nwpi", [(96, 3, 4), (192, 6, 1)])
def test_fused_msa_parity(rng, c, heads, nwpi):
    """Kernel H's wrapper (plain on the CPU) == JAX ``_reference_fused_msa``
    and ``fused_window_msa`` in interpret mode (which pads T to 64 with a
    -1e9 key bias): rtol 5e-4, atol 5e-5, test_pallas.py's tolerance."""
    from swinvox_tpu.models.swin import shifted_window_mask
    from swinvox_tpu.ops.pallas_fused_msa import (
        _reference_fused_msa,
        fused_window_msa,
    )

    t, nw = 49, 8
    x = rng.standard_normal((nw, t, c), np.float32) * 0.5
    wqkv = rng.standard_normal((c, 3 * c), np.float32) * 0.05
    bqkv = rng.standard_normal((3 * c,), np.float32) * 0.01
    wproj = rng.standard_normal((c, c), np.float32) * 0.05
    bproj = rng.standard_normal((c,), np.float32) * 0.01
    bias = rng.standard_normal((heads, t, t), np.float32)
    g = int(np.sqrt(nwpi)) * 7
    mask = shifted_window_mask(g, g, 7, 3) if nwpi > 1 else None
    ops = (x, wqkv, bqkv, wproj, bproj, bias, mask)
    jx = [jnp.asarray(a) if a is not None else None for a in ops]
    refs = (np.asarray(_reference_fused_msa(*jx, heads, (c // heads) ** -0.5)),
            np.asarray(fused_window_msa(*jx, heads, interpret=True)))
    before = port_msa.fused_msa_forward.launches
    got = port_msa.fused_window_msa(*[_t(a) for a in ops], heads).numpy()
    for ref in refs:
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5)
    assert port_msa.fused_msa_forward.launches == before


@pytest.mark.parametrize("shift", [0, 3])
def test_window_msa_kernel_branch(rng, shift, monkeypatch):
    """The port's SwinBlock with the W-MSA kernel branch on (the JAX gate:
    ``use_pallas`` at inference without the block kernel) == the JAX
    block's XLA path on a 14x14 map (4 windows per image, 2 images, so the
    shifted mask's per-image order is exercised), f32, rtol = atol = 2e-4;
    the kernel branch and the unfused one read the same parameter tree."""
    from swinvox_tpu.models.swin import SwinBlock
    from swinvox_tpu_torch.models import swin as port_swin
    from swinvox_tpu_torch.models.swin import SwinBlock as PortBlock

    dim, heads, hw = 96, 3, 14
    x = (rng.standard_normal((2, hw, hw, dim)) * 0.5).astype(np.float32)
    ref_blk = SwinBlock(dim=dim, num_heads=heads, shift=shift,
                        dtype=jnp.float32, use_pallas=True)
    params = _jitter(
        ref_blk.init(jax.random.PRNGKey(1), jnp.asarray(x), True)["params"],
        rng)
    out_ref = np.asarray(ref_blk.apply({"params": params}, jnp.asarray(x),
                                       True))
    blocks = [PortBlock(dim, heads, shift=shift, dtype=torch.float32,
                        use_pallas=p) for p in (True, False)]
    names = [sorted((k, tuple(v.shape)) for k, v in b.state_dict().items())
             for b in blocks]
    assert names[0] == names[1]
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return port_msa.fused_window_msa(*a, **k)

    monkeypatch.setattr(port_swin, "fused_window_msa", counting)
    for blk in blocks:
        load_jax_variables(blk, {"params": params})
        with torch.no_grad():
            got = blk(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, out_ref, rtol=2e-4, atol=2e-4)
    assert len(calls) == 1  # the kernel branch only


def test_eval_wmsa_forward_calls_kernel_h_per_block(monkeypatch):
    """At Swin-T depths (2, 2, 6, 2) with the block kernel off and the
    W-MSA kernel on, one inference forward makes 12 W-MSA kernel calls and
    no block or rewindow call: the counts chip_smoke.py expects of the
    ``eval-wmsa`` configuration."""
    from swinvox_tpu_torch.models import swin as port_swin
    from swinvox_tpu_torch.ops import rewindow as port_rw

    calls = {"wmsa": 0, "block": 0, "rewindow": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name, mod, attr in (("wmsa", port_swin, "fused_window_msa"),
                            ("block", port_swin, "fused_swin_block"),
                            ("rewindow", port_rw, "rewindow")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    model = port_swin.SwinTiny(embed_dim=32, num_heads=(1, 2, 4, 8),
                               dtype=torch.float32, use_pallas_block=False,
                               use_pallas=True)
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 3))
    assert calls == {"wmsa": 12, "block": 0, "rewindow": 0}


# ------------------------------------------------------------- kernel I


def _merger_fixture(rng):
    chans = [(9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1)]
    kernels, biases, bn = [], [], []
    for ci, co in chans:
        kernels.append((rng.standard_normal((3, 3, 3, ci, co)) * 0.2
                        ).astype(np.float32))
        biases.append((rng.standard_normal(co) * 0.1).astype(np.float32))
        bn.append(((1 + 0.1 * rng.standard_normal(co)).astype(np.float32),
                   (0.1 * rng.standard_normal(co)).astype(np.float32),
                   (0.1 * rng.standard_normal(co)).astype(np.float32),
                   (0.5 + np.abs(rng.standard_normal(co))).astype(np.float32)))
    return kernels, biases, bn


def test_merger_view_weights_parity(rng):
    """Kernel I's wrapper (plain on the CPU) == JAX ``merger_view_weights``
    in interpret mode on one volume (rtol 3e-3, atol 5e-4: test_pallas.py's
    tolerance for its banded matmuls against a direct conv)."""
    from swinvox_tpu.ops.pallas_merger import merger_view_weights

    kernels, biases, bn = _merger_fixture(rng)
    x = (rng.standard_normal((1, 32, 32, 32, 9)) * 0.5).astype(np.float32)
    ref = np.asarray(merger_view_weights(
        jnp.asarray(x), kernels, biases, bn, interpret=True))
    before = port_merger.merger_view_weights.launches
    got = port_merger.merger_view_weights(
        _t(x), [_t(k) for k in kernels], [_t(b) for b in biases],
        [tuple(_t(p) for p in b) for b in bn]).numpy()
    assert port_merger.merger_view_weights.launches == before
    assert got.shape == (1, 32, 32, 32)
    np.testing.assert_allclose(got, ref, rtol=3e-3, atol=5e-4)


def test_merger_kernel_branch_matches_xla_merger(rng):
    """The port's Merger with the kernel branch on == the JAX XLA Merger in
    eval mode, running statistics shifted by +0.1 (test_pallas.py's
    fused-branch check), 2 objects x 3 views, f32, tolerance 1e-4; both
    branches of the port read one parameter tree, the JAX tree of either
    JAX branch."""
    import jax.tree_util as tu

    from swinvox_tpu.models.merger import Merger
    from swinvox_tpu_torch.models.merger import Merger as PortMerger

    raw = rng.standard_normal((2, 3, 32, 32, 32, 9)).astype(np.float32)
    coarse = rng.standard_normal((2, 3, 32, 32, 32)).astype(np.float32)
    m_xla = Merger(dtype=jnp.float32)
    v = m_xla.init(jax.random.PRNGKey(0), jnp.asarray(raw),
                   jnp.asarray(coarse), False)
    v = {"params": _jitter(v["params"], rng),
         "batch_stats": jax.tree.map(lambda a: np.asarray(a) + 0.1,
                                     v["batch_stats"])}
    v_fused = Merger(dtype=jnp.float32, use_pallas=True,
                     pallas_interpret=True).init(
        jax.random.PRNGKey(0), jnp.asarray(raw[:, :1]),
        jnp.asarray(coarse[:, :1]), False)
    for coll in ("params", "batch_stats"):
        assert tu.tree_structure(v_fused[coll]) == tu.tree_structure(v[coll])
    ref = np.asarray(m_xla.apply(v, jnp.asarray(raw), jnp.asarray(coarse),
                                 False))

    x = torch.from_numpy(raw).reshape(6, 32, 32, 32, 9).permute(0, 4, 1, 2, 3)
    outs = []
    for use_pallas in (True, False):
        port = PortMerger(dtype=torch.float32, use_pallas=use_pallas)
        load_jax_variables(port, v)
        with torch.no_grad():
            outs.append(port(x, torch.from_numpy(coarse)).numpy())
    for got in outs:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never reaches a
    plain version: the wrappers raise."""
    q = torch.empty(4, 3, 49, 32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_attn.window_attention_pallas(q, q, q, q)
    x = torch.empty(4, 49, 96, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_msa.fused_window_msa(x, *([None] * 6), num_heads=3)
    v = torch.empty(2, 32, 32, 32, 9, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_merger.merger_view_weights(v, [], [], [])


@pytest.mark.cuda
def test_infer_kernels_match_plain_on_card():
    """On a card: kernels G, H and I within twice the error of their bf16
    plain versions (against the f32 plain versions) plus 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the H100")
    from swinvox_tpu_torch.models.swin import shifted_window_mask

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    def check(fn, f32, bf_idx, **kw):
        bf = [a.bfloat16() if i in bf_idx else a for i, a in enumerate(f32)]
        ref = fn(*[a.cpu() if a is not None else None for a in f32], **kw)
        plain = fn(*[a.cpu() if a is not None else None for a in bf],
                   **kw).float()
        got = fn(*bf, **kw).float().cpu()
        torch.cuda.synchronize()
        err_plain = (plain - ref).abs().max().item()
        assert (got - ref).abs().max().item() <= 2 * err_plain + 1e-2

    mask = torch.from_numpy(shifted_window_mask(28, 28, 7, 3)).to(dev)
    check(port_attn.window_attention_pallas,
          [r(32, 3, 49, 32), r(32, 3, 49, 32), r(32, 3, 49, 32),
           r(3, 49, 49, s=0.5), mask], {0, 1, 2})
    c = 96
    check(port_msa.fused_window_msa,
          [r(32, 49, c, s=0.5), r(c, 3 * c, s=c**-0.5), r(3 * c, s=0.1),
           r(c, c, s=c**-0.5), r(c, s=0.1), r(3, 49, 49, s=0.5), mask],
          {0, 1, 3}, num_heads=3)
    chans = ((9, 9), (9, 9), (9, 9), (9, 9), (36, 9), (9, 1))
    x = r(2, 32, 32, 32, 9, s=0.5)
    ks = [r(3, 3, 3, ci, co, s=0.2) for ci, co in chans]
    bs = [r(co, s=0.1) for _, co in chans]
    bn = [(1 + r(co, s=0.1), r(co, s=0.1), r(co, s=0.1), 0.5 + r(co).abs())
          for _, co in chans]
    ref = port_merger.merger_view_weights_reference(x.cpu(), *[
        [a.cpu() for a in ks], [a.cpu() for a in bs],
        [tuple(p.cpu() for p in b) for b in bn]])
    plain = port_merger.merger_view_weights_reference(
        x.bfloat16().cpu(), [a.cpu() for a in ks], [a.cpu() for a in bs],
        [tuple(p.cpu() for p in b) for b in bn])
    got = port_merger.merger_view_weights(x.bfloat16(), ks, bs, bn).cpu()
    torch.cuda.synchronize()
    err_plain = (plain - ref).abs().max().item()
    assert (got - ref).abs().max().item() <= 2 * err_plain + 1e-2
