"""K4 and K5 of usdm_tpu_torch against usdm_tpu, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; these tests
hold them to the JAX goldens and to the Pallas kernels in interpret mode (as
tests/test_flash_attention.py and tests/test_fused_ln.py run them), forward
and backward.  tests/test_torch_cuda.py holds the CUDA kernels to the same
plain versions on the card.  Inputs come from numpy generators; JAX runs
under `highest` matmul precision; tolerances are stated at each assert.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import usdm_tpu.ops.flash_attention as JFL
import usdm_tpu.ops.fused_ln as JLN
from usdm_tpu_torch.ops import flash_attention as FL
from usdm_tpu_torch.ops import fused_ln as LN

TOL = dict(rtol=2e-5, atol=2e-5)  # f32 on both sides, different summation order


@pytest.fixture(autouse=True)
def interpret_highest(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------- K5
def _case(rng, case):
    """[B, T, H, d] inputs, masks and flags of the two backward cases:
    GQA 4/2, causal, window 40, three packed segments; or 4 heads, non-causal
    ALiBi (the Voicebox shape), second row padded from 101 on."""
    b, tlen, d = 2, 192, 32
    h, hkv = (4, 2) if case == "gqa_causal_window_packed" else (4, 4)
    q = rng.standard_normal((b, tlen, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tlen, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tlen, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, tlen, h, d)).astype(np.float32)
    if case == "gqa_causal_window_packed":
        seg = np.repeat(np.asarray([0, 1, 2]), tlen // 3)[None].repeat(b, 0).astype(np.int32)
        pos = np.tile(np.arange(tlen // 3), 3)[None].repeat(b, 0).astype(np.int32)
        flags = dict(causal=True, sliding_window=40, alibi=False)
    else:
        pos = np.broadcast_to(np.arange(tlen, dtype=np.int32), (b, tlen)).copy()
        seg = np.where(pos < np.asarray([[tlen], [101]]), 0, -1).astype(np.int32)
        flags = dict(causal=False, sliding_window=None, alibi=True)
    return q, k, v, do, seg, pos, flags


CASES = ["gqa_causal_window_packed", "alibi_noncausal_padding"]


def _jax_res(q, k, v, seg, pos, flags):
    """usdm_tpu's forward residuals ([B, H, T, d] layout) from the Pallas
    forward in interpret mode."""
    qt, kt, vt = (jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v))
    o, lse8 = JFL._fwd_call(qt, kt, vt, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg),
                            jnp.asarray(seg), q.shape[-1] ** -0.5, flags["causal"],
                            flags["sliding_window"], flags["alibi"], 64, 64)
    return (qt, kt, vt, o, lse8[..., 0], jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg),
            jnp.asarray(seg))


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_plain_matches_jax(rng, case):
    """The plain backward against `_bwd_reference` and the Pallas dq/dkv
    kernels (`_bwd_pallas`) on the same residuals."""
    q, k, v, do, seg, pos, flags = _case(rng, case)
    res = _jax_res(q, k, v, seg, pos, flags)
    o = np.swapaxes(np.asarray(res[3]), 1, 2)
    lse = np.asarray(res[4])
    got = FL.flash_attention_bwd(t(q), t(k), t(v), t(o), t(lse), t(do), t(seg), t(seg), t(pos),
                                 t(pos), flags["causal"], flags["sliding_window"], None,
                                 flags["alibi"])
    kw = dict(scale=q.shape[-1] ** -0.5, causal=flags["causal"], window=flags["sliding_window"],
              alibi=flags["alibi"])
    g_out = jnp.asarray(np.swapaxes(do, 1, 2))
    ref = JFL._bwd_reference(res, g_out, block_k=64, **kw)
    kern = JFL._bwd_pallas(res, g_out, block_q=64, block_k=64, **kw)
    for g, r, kk in zip(got, ref, kern):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 1, 2), **TOL)
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(kk), 1, 2), **TOL)
    padded = seg < 0  # rows with no valid key get zero gradient
    assert not np.any(got[0].numpy()[padded])


@pytest.mark.parametrize("case", CASES)
def test_flash_function_grads_match_jax(rng, case):
    """Gradients through the port's autograd Function (plain forward and
    plain backward on the CPU) against jax.grad of usdm_tpu's flash_attention
    (Pallas forward and backward, interpret mode) and against torch.autograd
    of the plain forward."""
    q, k, v, do, seg, pos, flags = _case(rng, case)
    valid = (seg >= 0)[:, :, None, None]
    w = np.where(valid, do, 0.0).astype(np.float32)  # padded rows carry no loss

    def jloss(q, k, v):
        o = JFL.flash_attention(q, k, v, jnp.asarray(seg), jnp.asarray(seg), jnp.asarray(pos),
                                jnp.asarray(pos), block_q=64, block_k=64, **flags)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    o = FL.flash_attention(*ins, t(seg), t(seg), t(pos), t(pos), **flags)
    got = torch.autograd.grad((o * t(w)).sum(), ins)
    ins2 = [t(x).requires_grad_() for x in (q, k, v)]
    o2, _ = FL.flash_attention_reference(*ins2, t(seg), t(seg), t(pos), t(pos), **flags)
    auto = torch.autograd.grad((o2 * t(w)).sum(), ins2)
    for g, jw, a in zip(got, want, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL)


def _bf16_residuals(rng, case):
    """bf16 inputs of `_case` and the Pallas forward's residuals on them."""
    q, k, v, do, seg, pos, flags = _case(rng, case)
    qt, kt, vt = (jnp.asarray(np.swapaxes(x, 1, 2), jnp.bfloat16) for x in (q, k, v))
    o, lse8 = JFL._fwd_call(qt, kt, vt, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg),
                            jnp.asarray(seg), q.shape[-1] ** -0.5, flags["causal"],
                            flags["sliding_window"], flags["alibi"], 64, 64)
    res = (qt, kt, vt, o, lse8[..., 0], jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg),
           jnp.asarray(seg))
    return q, k, v, do, seg, pos, flags, res


def _bf(x):
    return t(x).to(torch.bfloat16)


@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_plain_rounded_matches_pallas_bf16(rng, case):
    """bf16 operands: the plain backward with round_operands=True against the
    Pallas dq/dkv kernels in interpret mode (T 192, blocks of 64, which
    divide it) on the Pallas forward's residuals.  Both multiply bf16 values
    with f32 accumulation, round P before P^T.dO and dS before dS.K and
    dS^T.Q, and round the gradients to bf16: within one bf16 ulp of each
    gradient's largest value, plus 1e-4 for the order of the f32 sums."""
    q, k, v, do, seg, pos, flags, res = _bf16_residuals(rng, case)
    o = torch.from_numpy(np.swapaxes(np.asarray(res[3], np.float32), 1, 2).copy()).bfloat16()
    lse = t(np.asarray(res[4]))
    got = FL.flash_attention_bwd_reference(_bf(q), _bf(k), _bf(v), o, lse, _bf(do), t(seg),
                                           t(seg), t(pos), t(pos), flags["causal"],
                                           flags["sliding_window"], None, flags["alibi"],
                                           round_operands=True)
    kern = JFL._bwd_pallas(res, jnp.asarray(np.swapaxes(do, 1, 2), jnp.bfloat16), block_q=64,
                           block_k=64, scale=q.shape[-1] ** -0.5, causal=flags["causal"],
                           window=flags["sliding_window"], alibi=flags["alibi"])
    for g, kk in zip(got, kern):
        assert g.dtype == torch.bfloat16
        want = np.swapaxes(np.asarray(kk, np.float32), 1, 2)
        assert np.abs(g.float().numpy() - want).max() <= 2.0**-7 * np.abs(want).max() + 1e-4


def test_flash_bwd_plain_round_operands_is_a_no_op_in_f32(rng):
    """f32 operands: round_operands=True returns the unrounded plain
    backward bit for bit."""
    q, k, v, do, seg, pos, flags = _case(rng, "alibi_noncausal_padding")
    rows = [t(x) for x in (seg, seg, pos, pos)]
    o, lse = FL.flash_attention_reference(t(q), t(k), t(v), *rows, **flags)
    args = (t(q), t(k), t(v), o, lse, t(do), *rows, False, None, None, True)
    a = FL.flash_attention_bwd_reference(*args, round_operands=True)
    b = FL.flash_attention_bwd_reference(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_function_cpu_route_rounds_by_dtype(rng, dtype):
    """The Function's CPU route computes what the card's route of that dtype
    computes: for bf16 the plain versions with round_operands=True (bit for
    bit, and not the unrounded ones), for f32 the unrounded ones."""
    q, k, v, do, seg, pos, flags = _case(rng, "gqa_causal_window_packed")
    rows = [t(x) for x in (seg, seg, pos, pos)]
    ins = [t(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = FL.flash_attention(*ins, *rows, return_lse=True, **flags)
    got = torch.autograd.grad(o, ins, t(do).to(dtype))
    rounded = dtype != torch.float32
    raw = [x.detach() for x in ins]
    want_o, want_lse = FL.flash_attention_reference(*raw, *rows, **flags, round_operands=rounded)
    bwd_args = (*raw, want_o, want_lse, t(do).to(dtype), *rows, True, 40, None, False)
    want = FL.flash_attention_bwd_reference(*bwd_args, round_operands=rounded)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if rounded:
        exact = FL.flash_attention_bwd_reference(*bwd_args)
        assert not all(torch.equal(g, e) for g, e in zip(got, exact))


def test_flash_function_no_grad_matches_forward(rng):
    """Under no_grad (the respond() path) the Function returns the plain
    forward's output and log-sum-exp unchanged."""
    q, k, v, _, seg, pos, flags = _case(rng, "alibi_noncausal_padding")
    args = [t(x) for x in (q, k, v, seg, seg, pos, pos)]
    with torch.no_grad():
        o, lse = FL.flash_attention(*args, return_lse=True, **flags)
    want, want_lse = FL.flash_attention_reference(*args, **flags)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)


def test_flash_bwd_launchers_refuse_cpu_tensors(rng):
    q, k, v, do, seg, pos, flags = _case(rng, "alibi_noncausal_padding")
    lse = torch.zeros(2, 4, 192)
    args = [t(x) for x in (q, k, v, do)] + [lse, lse] + [t(x) for x in (seg, seg, pos, pos)]
    for fn in (FL.flash_attention_bwd_dq, FL.flash_attention_bwd_dkv):
        with pytest.raises(ValueError):
            fn(*args)


# ----------------------------------------------------------------- K4
def _ln_inputs(rng, b, tlen, h):
    x = rng.standard_normal((b, tlen, h)).astype(np.float32)
    r = rng.standard_normal((b, tlen, h)).astype(np.float32)
    w = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    bb = (rng.standard_normal(h) * 0.1).astype(np.float32)
    lengths = np.asarray([tlen, max(1, tlen // 2 - 3), 1][:b], np.int32)
    return x, r, lengths, w, bb


@pytest.mark.parametrize("post_mask", [False, True])
def test_fused_ln_plain_matches_jax(rng, post_mask):
    """f32: against `_xla_ref` and the Pallas kernel in interpret mode with a
    ragged last block (T = 100, blk_t = 32)."""
    x, r, lengths, w, b = _ln_inputs(rng, 3, 100, 128)
    got = LN.add_mask_ln(t(x), t(r), t(lengths), t(w), t(b), post_mask).numpy()
    jargs = [jnp.asarray(a) for a in (x, r, lengths, w, b)]
    ref = JLN._xla_ref(*jargs, post_mask, 1e-5)
    kern = JLN._pallas_impl(*jargs, post_mask, 1e-5, blk_t=32)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)  # f32 LN outputs O(1)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-5, atol=1e-5)


def test_fused_ln_plain_bf16_matches_jax(rng):
    """bf16: both sides round x + r, the normalized row, the product with w
    and the sum with b to bf16; a flip of one rounding moves an output by at
    most two bf16 ulps of the largest output (2^-6 * max|want|)."""
    x, r, lengths, w, b = _ln_inputs(rng, 3, 100, 256)
    tb = [t(a).to(torch.bfloat16) for a in (x, r)]
    wb = [t(a).to(torch.bfloat16) for a in (w, b)]
    got = LN.add_mask_ln(tb[0], tb[1], t(lengths), wb[0], wb[1], True).float().numpy()
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, r)]
    jw = [jnp.asarray(a, jnp.bfloat16) for a in (w, b)]
    want = np.asarray(JLN._xla_ref(jb[0], jb[1], jnp.asarray(lengths), jw[0], jw[1], True, 1e-5),
                      np.float32)
    assert np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max()


@pytest.mark.parametrize("post_mask", [False, True])
def test_fused_ln_grads_match_jax(rng, post_mask):
    """The Function's backward (on the CPU, add_mask_ln_backward_reference)
    against the JAX custom_vjp (a recompute through `_xla_ref`); lengths get
    no gradient."""
    x, r, lengths, w, b = _ln_inputs(rng, 3, 40, 128)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x, r, w, b):
        return jnp.sum(JLN.add_mask_ln(x, r, jnp.asarray(lengths), w, b, post_mask) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, r, w, b)))
    ins = [t(a).requires_grad_() for a in (x, r, w, b)]
    out = LN.add_mask_ln(ins[0], ins[1], t(lengths), ins[2], ins[3], post_mask)
    got = torch.autograd.grad((out * t(g)).sum(), ins)
    for gg, jw in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)  # f32 sums


@pytest.mark.parametrize("post_mask", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_backward_reference_matches_jax(rng, post_mask, dtype):
    """The plain backward (the CPU route and the card kernel's yardstick)
    against jax.grad of usdm_tpu's add_mask_ln, on the inputs of
    test_fused_ln_grads_match_jax.  f32: 1e-4 (f32 sums in another order).
    bf16: dx and dr within two bf16 ulps of the largest (2^-6 * max|want|:
    both round dn and ds, and a flip of dn can carry); dw and db within
    four (2^-5 * max|want|): XLA sums the bf16 products of its vjp in its own
    order and precision before the one rounding both sides make."""
    x, r, lengths, w, b = _ln_inputs(rng, 3, 40, 128)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)

    def jfn(x, r, w, b):
        return JLN.add_mask_ln(x, r, jnp.asarray(lengths), w, b, post_mask)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a, jdt) for a in (x, r, w, b)))
    want = vjp(jnp.asarray(g, jdt))
    got = LN.add_mask_ln_backward_reference(t(x).to(tdt), t(r).to(tdt), t(lengths), t(w).to(tdt),
                                            t(g).to(tdt), post_mask)
    assert got[0] is got[1]  # dx and dr are one tensor
    for name, gg, jw in zip(("dx", "dr", "dw", "db"), got, want):
        ww = np.asarray(jw, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(gg.numpy(), ww, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            bound = (2.0**-6 if name in ("dx", "dr") else 2.0**-5) * np.abs(ww).max()
            assert np.abs(gg.float().numpy() - ww).max() <= bound, name


@pytest.mark.parametrize("post_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ln_backward_reference_matches_autograd(rng, post_mask, dtype):
    """The plain backward written out against torch.autograd through the
    plain forward, whose roundings it names: f32 within 1e-5 of the largest
    value of each gradient (the LayerNorm backward's algebra in another
    order); bf16 within two bf16 ulps of it (a flip of dn or ds can carry)."""
    x, r, lengths, w, b = _ln_inputs(rng, 3, 57, 256)
    g = rng.standard_normal(x.shape).astype(np.float32)
    ins = [t(a).to(dtype).requires_grad_() for a in (x, r, w, b)]
    out = LN.add_mask_ln_reference(ins[0], ins[1], t(lengths), ins[2], ins[3], post_mask)
    want = torch.autograd.grad(out, ins, t(g).to(dtype))
    got = LN.add_mask_ln_backward_reference(*(a.detach() for a in ins[:2]), t(lengths),
                                            ins[2].detach(), t(g).to(dtype), post_mask)
    for name, gg, ww in zip(("dx", "dr", "dw", "db"), got, want):
        scale = ww.float().abs().max().item()
        bound = 1e-5 * scale if dtype == torch.float32 else 2.0**-6 * scale
        assert (gg.float() - ww.float()).abs().max().item() <= bound, name
