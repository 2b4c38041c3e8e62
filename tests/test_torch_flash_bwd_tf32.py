"""K5's f32 route (3xTF32 on the tensor cores) emulated on the CPU.

`flash_attention_bwd_3xtf32_reference` repeats the f32 backward kernels'
arithmetic: each of the five products (S, dP, dQ, dK, dV) taken from TF32
operands, three TF32 products each, with P and dS split after they are
formed in f32.  Here it is held to usdm_tpu's f32 backward (`_bwd_reference`
and the Pallas dq/dkv kernels in interpret mode, Precision.HIGHEST) on the
Pallas forward's residuals, and to the f64 plain backward on the same
residuals; a single TF32 product per product (terms=1) misses the same
bound.  tests/test_torch_cuda.py holds the kernels to the emulation on the
card.  Inputs come from numpy generators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import usdm_tpu.ops.flash_attention as JFL
from usdm_tpu_torch.ops import flash_attention as FL

BLOCK = 32  # the Pallas blocks: they divide every case's T
BOUND = 1e-4  # the f32 route's bound (chip_smoke phase 3, the card tests)


@pytest.fixture(autouse=True)
def interpret_highest(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


CASES = {
    # name: (B, T, H, Hkv, d, flags, packed segments)
    "a alibi d32 padded": (2, 160, 4, 4, 32, dict(causal=False, sliding_window=None,
                                                   alibi=True), False),
    "b gqa causal window packed d16": (2, 192, 4, 2, 16, dict(causal=True, sliding_window=40,
                                                             alibi=False), True),
    "c alibi d8 padded": (2, 128, 4, 4, 8, dict(causal=False, sliding_window=None,
                                                alibi=True), False),
}


def _inputs(rng, name):
    b, tlen, h, hkv, d, flags, packed = CASES[name]
    q, do = (rng.standard_normal((b, tlen, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, tlen, hkv, d)).astype(np.float32) for _ in range(2))
    if packed:  # three segments, positions restarting in each
        seg = np.repeat(np.arange(3), tlen // 3)[None].repeat(b, 0).astype(np.int32)
        pos = np.tile(np.arange(tlen // 3), 3)[None].repeat(b, 0).astype(np.int32)
    else:  # the second row padded from 101 on
        pos = np.broadcast_to(np.arange(tlen, dtype=np.int32), (b, tlen)).copy()
        seg = np.where(pos < np.asarray([[tlen], [101]]), 0, -1).astype(np.int32)
    return q, k, v, do, seg, pos, flags


@pytest.mark.parametrize("name", list(CASES))
def test_flash_bwd_3xtf32_plain_matches_jax_f32(rng, name):
    """dq, dk, dv of the 3xTF32 emulation within 1e-4 of usdm_tpu's f32
    backward (the jnp reference and the Pallas kernels) and of the f64 plain
    backward, all on the Pallas forward's output and log-sum-exp; one TF32
    product per product misses 1e-4 against f64."""
    q, k, v, do, seg, pos, flags = _inputs(rng, name)
    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    rows = [jnp.asarray(x) for x in (pos, pos, seg, seg)]
    o, lse8 = JFL._fwd_call(qt, kt, vt, *rows, scale, flags["causal"], flags["sliding_window"],
                            flags["alibi"], BLOCK, BLOCK)
    res = (qt, kt, vt, o, lse8[..., 0], *rows)
    g_out = jnp.asarray(np.swapaxes(do, 1, 2))
    kw = dict(scale=scale, causal=flags["causal"], window=flags["sliding_window"],
              alibi=flags["alibi"])
    jax_ref = JFL._bwd_reference(res, g_out, block_k=BLOCK, **kw)
    jax_kern = JFL._bwd_pallas(res, g_out, block_q=BLOCK, block_k=BLOCK, **kw)

    o_t = t(np.swapaxes(np.asarray(o), 1, 2))
    lse_t = t(np.asarray(lse8[..., 0]))
    masks = [t(x) for x in (seg, seg, pos, pos)]
    tail = (flags["causal"], flags["sliding_window"], None, flags["alibi"])
    ins = [t(x) for x in (q, k, v)]
    three = FL.flash_attention_bwd_3xtf32_reference(*ins, o_t, lse_t, t(do), *masks, *tail)
    one = FL.flash_attention_bwd_3xtf32_reference(*ins, o_t, lse_t, t(do), *masks, *tail,
                                                  terms=1)
    exact = FL.flash_attention_bwd_reference(*[x.double() for x in (*ins, o_t, lse_t, t(do))],
                                             *masks, *tail)

    def err(a, want):
        return np.abs(np.asarray(a, np.float64) - np.asarray(want, np.float64)).max()

    for name3, g3, g1, ge, jr, jk in zip(("dq", "dk", "dv"), three, one, exact, jax_ref,
                                         jax_kern):
        assert g3.dtype == torch.float32 and ge.dtype == torch.float64
        jr, jk = np.swapaxes(np.asarray(jr), 1, 2), np.swapaxes(np.asarray(jk), 1, 2)
        assert err(g3, ge) <= BOUND, name3
        assert err(g3, jr) <= BOUND, name3
        assert err(g3, jk) <= BOUND, name3
        assert err(g1, ge) > BOUND, name3
    padded = seg < 0  # rows with no valid key get zero gradient
    assert not np.any(three[0].numpy()[padded])


def test_flash_bwd_3xtf32_takes_one_or_three_terms():
    x = torch.zeros(1, 4, 2, 8)
    z = torch.zeros(1, 4, dtype=torch.int32)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError):
        FL.flash_attention_bwd_3xtf32_reference(x, x, x, x, lse, x, z, z, z, z, terms=2)


def test_flash_bwd_plain_f32_keeps_its_bits_through_the_product_hook(rng):
    """The plain backward through the product hook with torch.einsum is the
    f32 computation it was: the f32 autograd Function's CPU route gives its
    gradients bit for bit, and f64 operands give f64 gradients within 1e-4 of
    the f32 ones."""
    q, k, v, do, seg, pos, flags = _inputs(rng, "b gqa causal window packed d16")
    masks = [t(x) for x in (seg, seg, pos, pos)]
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    o, lse = FL.flash_attention(*ins, *masks, return_lse=True, **flags)
    got = torch.autograd.grad(o, ins, t(do))
    tail = (flags["causal"], flags["sliding_window"], None, flags["alibi"])
    raw = [x.detach() for x in ins]
    want = FL.flash_attention_bwd_reference(*raw, o.detach(), lse, t(do), *masks, *tail)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    wide = FL.flash_attention_bwd_reference(*[x.double() for x in (*raw, o.detach(), lse,
                                                                  t(do))], *masks, *tail)
    assert all(w.dtype == torch.float64 for w in wide)
    assert max((w.double() - x).abs().max().item() for w, x in zip(want, wide)) <= BOUND
