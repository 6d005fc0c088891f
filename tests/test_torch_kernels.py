"""swinvox_tpu_torch kernels A (rewindow) and B (fused Swin block) against
the JAX package: on the CPU the port's wrappers run their plain PyTorch
versions, the JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas.py does).  Inputs are drawn with numpy from a seed; the
JAX-initialized parameters are jittered with numpy so LayerNorm affines
and biases are non-trivial.  The comparison on the card lives in
``test_kernels_match_plain_on_card`` (marked ``cuda``) and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinvox_tpu_torch.convert import load_jax_variables
from swinvox_tpu_torch.ops import pallas_swin_block as port_block
from swinvox_tpu_torch.ops import rewindow as port_rw


def _jitter(tree, rng, scale=0.05):
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32),
        tree,
    )


# ------------------------------------------------------------- kernel A


@pytest.mark.parametrize("h,w,c", [(56, 56, 96), (14, 14, 40)])
def test_rewindow_parity(rng, h, w, c):
    """Both signs equal the JAX kernel exactly on the 49 logical tokens;
    sign +1 inverts sign -1."""
    from swinvox_tpu.models.swin import window_partition
    from swinvox_tpu.ops.rewindow import rewindow

    win, s = 7, 3
    nwh, nww = h // win, w // win
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    xw = np.array(window_partition(jnp.asarray(x), win))
    xt = torch.from_numpy(xw)
    assert torch.equal(port_rw.window_partition(torch.from_numpy(x), win), xt)
    for sign in (-1, 1):
        ref = np.asarray(rewindow(jnp.asarray(xw), nwh, nww, win, s, sign,
                                  interpret=True))
        got = port_rw.rewindow(xt, nwh, nww, win, s, sign)
        np.testing.assert_array_equal(got.numpy(), ref)
    back = port_rw.rewindow(port_rw.rewindow(xt, nwh, nww, win, s, -1),
                            nwh, nww, win, s, 1)
    assert torch.equal(back, xt)


# ------------------------------------------------------------- kernel B


@pytest.mark.parametrize(
    "shift,dim,heads,hw", [(0, 96, 3, 14), (3, 96, 3, 14), (3, 192, 6, 28)]
)
def test_fused_swin_block_parity(rng, shift, dim, heads, hw):
    """Kernel B's plain version == JAX ``fused_swin_block`` (interpret) on
    window-major tokens, and the port's SwinBlock (fused and unfused) ==
    JAX ``SwinBlock(use_pallas_block=True, pallas_interpret=True)``, f32,
    rtol = atol = 2e-4 (test_pallas.py's tolerance for the same pair)."""
    from swinvox_tpu.models.swin import (
        SwinBlock,
        relative_position_index,
        shifted_window_mask,
        window_partition,
    )
    from swinvox_tpu.ops.pallas_swin_block import fused_swin_block
    from swinvox_tpu_torch.models.swin import SwinBlock as PortBlock

    x = (rng.standard_normal((2, hw, hw, dim)) * 0.5).astype(np.float32)
    kw = dict(dim=dim, num_heads=heads, shift=shift, drop_path_rate=0.0,
              dtype=jnp.float32)
    ref_blk = SwinBlock(use_pallas_block=True, pallas_interpret=True, **kw)
    params = _jitter(
        ref_blk.init(jax.random.PRNGKey(1), jnp.asarray(x), True)["params"],
        rng,
    )
    out_ref = np.asarray(ref_blk.apply({"params": params}, jnp.asarray(x),
                                       True))

    # the op itself, on the tokens the block hands it
    xs = np.roll(x, (-shift, -shift), (1, 2)) if shift else x
    tok = np.asarray(window_partition(jnp.asarray(xs), 7))
    a, n1, n2 = params["attn"], params["norm1"]["LayerNorm_0"], \
        params["norm2"]["LayerNorm_0"]
    f1, f2 = params["mlp_fc1"]["Dense_0"], params["mlp_fc2"]["Dense_0"]
    idx = relative_position_index(7).reshape(-1)
    rel = a["rel_pos_bias_table"][idx].reshape(49, 49, heads).transpose(2, 0, 1)
    mask = shifted_window_mask(hw, hw, 7, shift) if shift else None
    ops = [tok, n1["scale"], n1["bias"], a["qkv_kernel"], a["qkv_bias"],
           a["proj_kernel"], a["proj_bias"], rel, mask, n2["scale"],
           n2["bias"], f1["kernel"], f1["bias"], f2["kernel"], f2["bias"]]
    op_ref = np.asarray(fused_swin_block(
        *[None if o is None else jnp.asarray(o) for o in ops],
        num_heads=heads, interpret=True))
    before = port_block.fused_swin_block.launches
    op_got = port_block.fused_swin_block(
        *[None if o is None else torch.from_numpy(np.array(o)) for o in ops],
        num_heads=heads)
    assert port_block.fused_swin_block.launches == before  # CPU: plain
    np.testing.assert_allclose(op_got.numpy(), op_ref, rtol=2e-4, atol=2e-4)

    for fused in (True, False):
        blk = PortBlock(dim, heads, shift=shift, dtype=torch.float32,
                        use_pallas_block=fused)
        load_jax_variables(blk, {"params": params})
        with torch.no_grad():
            got = blk(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, out_ref, rtol=2e-4, atol=2e-4)


def test_swin_chained_stage_parity(rng):
    """The window-major stage chain (fused blocks + rewindow between them)
    == the JAX chain in interpret mode, stage by stage, f32, 2e-4 (the
    tolerance test_pallas.py holds the JAX chain to)."""
    from swinvox_tpu.models.swin import SwinTiny
    from swinvox_tpu_torch.models.swin import SwinTiny as PortSwin

    x = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref = SwinTiny(embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                   img_size=56, dtype=jnp.float32, use_pallas_block=True,
                   pallas_interpret=True)
    params = _jitter(
        ref.init(jax.random.PRNGKey(1), jnp.asarray(x), False)["params"], rng)
    outs = ref.apply({"params": params}, jnp.asarray(x), False)
    port = PortSwin(embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                    img_size=56, dtype=torch.float32, use_pallas_block=True)
    assert port.chain
    load_jax_variables(port, {"params": params})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(outs)
    for a, b in zip(outs, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-4,
                                   atol=2e-4)


def test_serving_chain_calls_each_kernel_as_the_card_counts(monkeypatch):
    """At Swin-T depths (2, 2, 6, 2) and 224^2 input one forward makes 12
    fused-block calls (2+2+6+2) and no rewindow call (the chain stays
    aligned: the shifted blocks' kernels read their windows through the
    roll's map): the counts chip_smoke.py expects per batch."""
    from swinvox_tpu_torch.models import swin as port_swin

    calls = {"block": 0, "rewindow": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_swin, "fused_swin_block",
                        counting("block", port_swin.fused_swin_block))
    monkeypatch.setattr(port_rw, "rewindow",
                        counting("rewindow", port_rw.rewindow))
    model = port_swin.SwinTiny(embed_dim=8, num_heads=(1, 1, 1, 1),
                               dtype=torch.float32, use_pallas_block=True)
    for p in model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.02)
    with torch.no_grad():
        feats = model(torch.zeros(1, 224, 224, 3))
    assert [tuple(f.shape) for f in feats] == [
        (1, 56, 56, 8), (1, 28, 28, 16), (1, 14, 14, 32), (1, 7, 7, 64)]
    assert calls == {"block": 12, "rewindow": 0}


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never reaches a
    plain version: the wrappers raise."""
    x = torch.empty(4, 49, 32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_rw.rewindow(x, 2, 2, 7, 3, -1)
    with pytest.raises(RuntimeError, match="unsupported device"):
        port_block.fused_swin_block(x, *([None] * 14), num_heads=1)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a card: kernel A is exact, kernel B (a shifted block on aligned
    tokens) within twice the error of the bf16 plain version (both against
    the f32 plain version) plus 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the H100")
    from swinvox_tpu_torch.models.swin import shifted_window_mask

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    x = torch.randn(8 * 16, 49, 96, device=dev, generator=g)
    for sign in (-1, 1):
        ref = port_rw.rewindow_reference(x, 4, 4, 7, 3, sign)
        assert torch.equal(port_rw.rewindow(x, 4, 4, 7, 3, sign), ref)
    c, heads = 96, 3

    def r(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    f32 = [r(64, 49, c, s=0.5), 1 + r(c, s=0.1), r(c, s=0.1),
           r(c, 3 * c, s=c**-0.5), r(3 * c, s=0.1), r(c, c, s=c**-0.5),
           r(c, s=0.1), r(heads, 49, 49, s=0.5),
           torch.from_numpy(shifted_window_mask(28, 28, 7, 3)).to(dev),
           1 + r(c, s=0.1), r(c, s=0.1), r(c, 4 * c, s=c**-0.5),
           r(4 * c, s=0.1), r(4 * c, c, s=(4 * c)**-0.5), r(c, s=0.1)]
    bf = list(f32)
    for i in (0, 3, 5, 11, 13):
        bf[i] = f32[i].bfloat16()
    kw = dict(num_heads=heads, nwh=4, nww=4, shift=3)  # 4 images, 28^2
    ref = port_block.swin_block_reference(*f32, **kw)
    plain = port_block.swin_block_reference(*bf, **kw).float()
    got = port_block.fused_swin_block(*bf, **kw).float()
    torch.cuda.synchronize()
    err_plain = (plain - ref).abs().max().item()
    assert (got - ref).abs().max().item() <= 2 * err_plain + 1e-2
