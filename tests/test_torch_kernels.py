"""K1-K3 of usdm_tpu_torch against usdm_tpu.

On the CPU each port wrapper runs its plain PyTorch version; these tests hold
that version to the JAX golden and to the Pallas kernel in interpret mode
(as tests/test_paged_attention.py and tests/test_flash_attention.py run it).
tests/test_torch_cuda.py holds the CUDA kernels to these plain versions on
the card.  Inputs come from numpy generators; f32 tolerances are stated at
each assert.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import usdm_tpu.ops.flash_attention as JFL
import usdm_tpu.ops.fused_act as JFA
import usdm_tpu.ops.paged_attention as JPA
from usdm_tpu.ops.attention import mha as jax_mha
from usdm_tpu_torch.ops import flash_attention as FL
from usdm_tpu_torch.ops import fused_act as FA
from usdm_tpu_torch.ops import paged_attention as PA

TOL = dict(rtol=2e-5, atol=2e-5)  # f32 on both sides, different summation order


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))


def t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------- K1
def _paged_inputs(rng, b=3, hkv=2, g=4, d=32, n_pages=16, p=8, maxp=4):
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pages, p, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pages, p, d)).astype(np.float32)
    table = rng.permutation(n_pages - 1)[: b * maxp].reshape(b, maxp).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("window,lens", [(None, [5, 17, 32]), (10, [30, 25, 32]),
                                         (None, [1, 8, 9])])
def test_paged_plain_matches_jax(rng, interpret, window, lens):
    q, kp, vp, table = _paged_inputs(rng)
    lens = np.asarray(lens, np.int32)
    got = PA.paged_decode_attention(t(q), t(kp), t(vp), t(table), t(lens), window).numpy()
    ref = JPA.paged_decode_attention_reference(jnp.asarray(q), jnp.asarray(kp),
                                               jnp.asarray(vp), jnp.asarray(table),
                                               jnp.asarray(lens), sliding_window=window)
    kern = JPA.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(table), jnp.asarray(lens),
                                      sliding_window=window)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


def test_paged_int8_pools_not_ported(rng, interpret):
    """The int8 branch, ported since: int8 pools with page-major scales give
    the JAX reference's output (f32, 2e-5) and the Pallas kernel's in
    interpret mode (its bf16 p @ V after the v-scale fold: 2e-2, usdm_tpu's
    own bound); one scale without the other raises."""
    from usdm_tpu.engine.paged_ops import quant_kv_token

    q, kp, vp, table = _paged_inputs(rng)
    (kq, ks), (vq, vs) = (quant_kv_token(jnp.asarray(x)) for x in (kp, vp))
    ks, vs = (np.asarray(jnp.transpose(a, (1, 0, 2))) for a in (ks, vs))  # [N, Hkv, P]
    lens = np.asarray([5, 17, 32], np.int32)
    got = PA.paged_decode_attention(t(q), t(kq), t(vq), t(table), t(lens), k_scales=t(ks),
                                    v_scales=t(vs)).numpy()
    jargs = tuple(map(jnp.asarray, (q, kq, vq, table, lens)))
    ref = JPA.paged_decode_attention_reference(*jargs, k_scales=jnp.asarray(ks),
                                               v_scales=jnp.asarray(vs))
    kern = JPA.paged_decode_attention(*jargs, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError):
        PA.paged_decode_attention(t(q), t(kq), t(vq), t(table), t(lens), k_scales=t(ks))


@pytest.mark.parametrize("n_splits", [1, 2, 3, "maxp"])
@pytest.mark.parametrize("case", ["plain", "window", "int8"])
def test_paged_split_plain_matches_jax(rng, case, n_splits):
    """The kernel's split computation (partial softmax states over n_splits
    row ranges, merged) in plain PyTorch against the plain version and the
    JAX golden, in f32: 2e-5.  At n_splits = maxp (4) the 5-token slot's
    rows all fall in the first split and the other three are empty."""
    q, kp, vp, table = _paged_inputs(rng)
    lens = np.asarray([5, 17, 32], np.int32)
    window = 10 if case == "window" else None
    scales = {}
    if case == "int8":
        from usdm_tpu.engine.paged_ops import quant_kv_token

        (kp, ks), (vp, vs) = (quant_kv_token(jnp.asarray(x)) for x in (kp, vp))
        kp, vp = np.asarray(kp), np.asarray(vp)
        scales = {n: np.asarray(jnp.transpose(a, (1, 0, 2))) for n, a in  # [N, Hkv, P]
                  (("k_scales", ks), ("v_scales", vs))}
    n = table.shape[1] if n_splits == "maxp" else n_splits
    targs = [t(x) for x in (q, kp, vp, table, lens)]
    tscales = {k: t(v) for k, v in scales.items()}
    got = PA.paged_decode_attention_split_reference(*targs, n, window, **tscales).numpy()
    plain = PA.paged_decode_attention_reference(*targs, window, **tscales).numpy()
    golden = JPA.paged_decode_attention_reference(*map(jnp.asarray, (q, kp, vp, table, lens)),
                                                  sliding_window=window,
                                                  **{k: jnp.asarray(v) for k, v in scales.items()})
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, np.asarray(golden), **TOL)
    r0, r1 = PA.split_rows(t(lens), window, n)
    if n_splits == "maxp":
        assert (r0[0, 1:] == r1[0, 1:]).all()  # empty splits


@pytest.mark.parametrize("window", [None, 0, 7, 100])
def test_paged_split_rows_cover_the_valid_rows(window):
    """Every split count cuts [lo, kv_len) into contiguous ranges that cover
    it once, each a multiple of ROW_ALIGN rows but the last busy one."""
    lens = torch.tensor([1, 2, 15, 16, 17, 700, 4200])
    for n in (1, 2, 3, 5, 32, 128):
        r0, r1 = PA.split_rows(lens, window, n)
        lo = torch.zeros_like(lens) if window is None else (lens - 1 - window).clamp(min=0)
        assert (r0[:, 0] == lo).all() and (r1[:, -1] == lens).all()
        assert (r0[:, 1:] == r1[:, :-1]).all() and (r1 >= r0).all()
        busy = (r1 - r0)[r1 < lens[:, None]]
        assert (busy % PA.ROW_ALIGN == 0).all()


def test_paged_split_count_from_shapes():
    """The host's split count comes from shapes alone: two blocks per SM at
    batch 1 and 8 kv heads (capped at 32), fewer at batch 8, never more than
    the table's 16-row ranges."""
    assert PA.split_count(1, 8, 128, 64, 132) == 32
    assert PA.split_count(8, 8, 3, 256, 132) == 5
    assert PA.split_count(1, 8, 1, 16, 132) == 1
    assert PA.split_count(64, 8, 128, 64, 132) == 1


# ----------------------------------------------------------------- K2
def _attn_inputs(rng, b=2, tq=128, tk=128, h=4, hkv=2, d=32):
    return (rng.standard_normal((b, tq, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32))


def _flash_both(q, k, v, qseg, kseg, qpos, kpos, causal, window, alibi=False):
    got = FL.flash_attention(t(q), t(k), t(v), t(qseg), t(kseg), t(qpos), t(kpos), causal,
                             window, alibi=alibi).numpy()
    pad = (qseg < 0)[:, :, None, None]
    return np.where(pad, 0.0, got), pad


def _packed(b, tlen):
    seg = np.zeros((b, tlen), np.int32)
    seg[:, tlen // 3:] = 1
    seg[:, 2 * tlen // 3:] = 2
    pos = np.concatenate([np.arange(tlen // 3), np.arange(2 * tlen // 3 - tlen // 3),
                          np.arange(tlen - 2 * tlen // 3)])
    return seg, np.broadcast_to(pos[None], (b, tlen)).astype(np.int32)


@pytest.mark.parametrize("case", ["causal", "window", "packed", "padding", "gqa_noncausal"])
def test_flash_plain_matches_jax(rng, interpret, case):
    tlen = 192
    q, k, v = _attn_inputs(rng, tq=tlen, tk=tlen)
    b = q.shape[0]
    pos = np.broadcast_to(np.arange(tlen, dtype=np.int32)[None], (b, tlen))
    seg = np.zeros((b, tlen), np.int32)
    causal, window = True, None
    if case == "window":
        window = 40
    elif case == "packed":
        seg, pos = _packed(b, tlen)
    elif case == "padding":
        seg[1, 150:] = -1
    elif case == "gqa_noncausal":
        causal = False
    got, pad = _flash_both(q, k, v, seg, seg, pos, pos, causal, window)
    args = [jnp.asarray(x) for x in (q, k, v, seg, seg, pos, pos)]
    kern = JFL.flash_attention(*args, causal=causal, sliding_window=window, block_q=64,
                               block_k=64)
    ref = jax_mha(*args, causal=causal, sliding_window=window, impl="xla")
    np.testing.assert_allclose(got, np.where(pad, 0.0, np.asarray(kern)), **TOL)
    np.testing.assert_allclose(got, np.where(pad, 0.0, np.asarray(ref)), **TOL)


def _bf16_case(rng, case, tlen=128):
    """bf16 inputs (made in f32 from the numpy generator, rounded once) of the
    two cases the tensor-core route is held to: the Voicebox shape (4 heads,
    non-causal, ALiBi, second row padded) and an LM shape (GQA 4/2, causal,
    window 40, two packed segments)."""
    b, d = 2, 32
    h, hkv = (4, 4) if case == "voicebox" else (4, 2)
    q, k, v = _attn_inputs(rng, b=b, tq=tlen, tk=tlen, h=h, hkv=hkv, d=d)
    if case == "voicebox":
        pos = np.broadcast_to(np.arange(tlen, dtype=np.int32), (b, tlen)).copy()
        seg = np.where(pos < np.asarray([[tlen], [tlen * 2 // 3 + 1]]), 0, -1).astype(np.int32)
        flags = dict(causal=False, sliding_window=None, alibi=True)
    else:
        seg = np.repeat(np.asarray([0, 1]), tlen // 2)[None].repeat(b, 0).astype(np.int32)
        pos = np.tile(np.arange(tlen // 2), 2)[None].repeat(b, 0).astype(np.int32)
        flags = dict(causal=True, sliding_window=40, alibi=False)
    return q, k, v, seg, pos, flags


@pytest.mark.parametrize("case", ["voicebox", "lm"])
def test_flash_plain_rounded_matches_pallas_bf16(rng, interpret, case):
    """bf16 operands: the plain forward with round_operands=True against the
    Pallas forward in interpret mode (blocks of 64).  Both multiply bf16
    values with f32 accumulation and round the probabilities to bf16 before
    P.V, the Pallas kernel relative to its running block max, the plain
    version to the row's max; outputs are bf16 on both sides: within one bf16
    ulp of the largest output.  The log-sum-exp is f32 on both sides and is
    taken from the unrounded probabilities: 1e-4."""
    q, k, v, seg, pos, flags = _bf16_case(rng, case)
    tb = [t(x).to(torch.bfloat16) for x in (q, k, v)]
    got, got_lse = FL.flash_attention_reference(*tb, t(seg), t(seg), t(pos), t(pos),
                                                flags["causal"], flags["sliding_window"], None,
                                                flags["alibi"], round_operands=True)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(np.swapaxes(x, 1, 2), jnp.bfloat16) for x in (q, k, v)]
    o, lse8 = JFL._fwd_call(*jb, jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg),
                            jnp.asarray(seg), q.shape[-1] ** -0.5, flags["causal"],
                            flags["sliding_window"], flags["alibi"], 64, 64)
    want = np.swapaxes(np.asarray(o, np.float32), 1, 2)
    valid = (seg >= 0)[:, :, None, None]
    err = np.abs(np.where(valid, got.float().numpy() - want, 0.0)).max()
    assert err <= 2.0**-7 * np.abs(want).max()
    lse_err = np.abs(np.where(seg[:, None, :] >= 0, got_lse.numpy() - np.asarray(lse8[..., 0]), 0))
    assert lse_err.max() <= 1e-4


def test_flash_plain_round_operands_is_a_no_op_in_f32(rng):
    """f32 operands have nothing narrower to round to: round_operands=True
    returns the unrounded plain forward bit for bit."""
    q, k, v, seg, pos, flags = _bf16_case(rng, "voicebox")
    args = [t(x) for x in (q, k, v, seg, seg, pos, pos)]
    a = FL.flash_attention_reference(*args, **flags, round_operands=True)
    b = FL.flash_attention_reference(*args, **flags)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_flash_plain_alibi_matches_jax(rng, interpret):
    """Voicebox geometry in small: non-causal, power-of-2 heads, in-kernel
    ALiBi with key position 0 exempt, second row shorter."""
    tlen, h = 160, 4
    q, k, v = _attn_inputs(rng, tq=tlen, tk=tlen, h=h, hkv=h)
    pos = np.broadcast_to(np.arange(tlen, dtype=np.int32)[None], (2, tlen))
    seg = np.where(pos < np.asarray([[tlen], [101]]), 0, -1).astype(np.int32)
    got, pad = _flash_both(q, k, v, seg, seg, pos, pos, False, None, alibi=True)
    args = [jnp.asarray(x) for x in (q, k, v, seg, seg, pos, pos)]
    kern = JFL.flash_attention(*args, causal=False, alibi=True, block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.where(pad, 0.0, np.asarray(kern)), **TOL)
    # the same bias materialized for the plain JAX attention path
    from usdm_tpu.models.voicebox import alibi_slopes

    dist = np.abs(np.arange(tlen)[None, :] - np.arange(tlen)[:, None]).astype(np.float32)
    bias = -alibi_slopes(h)[:, None, None] * dist[None]
    bias[:, :, 0] = 0.0
    bias = np.broadcast_to(bias[None], (2, h, tlen, tlen))
    ref = jax_mha(*args, causal=False, bias=jnp.asarray(bias), impl="xla")
    np.testing.assert_allclose(got, np.where(pad, 0.0, np.asarray(ref)), **TOL)


@pytest.mark.parametrize("alibi", [False, True])
def test_flash_plain_lse_matches_jax(rng, interpret, alibi):
    """The log-sum-exp the forward emits for the backward pass, against the
    Pallas forward's, on the rows of valid queries: causal with a window over
    GQA heads, or non-causal with ALiBi; second row shorter."""
    tlen = 128
    q, k, v = _attn_inputs(rng, tq=tlen, tk=tlen)
    pos = np.broadcast_to(np.arange(tlen, dtype=np.int32)[None], (2, tlen))
    seg = np.where(pos < np.asarray([[tlen], [90]]), 0, -1).astype(np.int32)
    causal, window = (False, None) if alibi else (True, 40)
    _, lse = FL.flash_attention(t(q), t(k), t(v), t(seg), t(seg), t(pos), t(pos), causal,
                                window, alibi=alibi, return_lse=True)
    _, lse8 = JFL._fwd_call(*[jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v)],
                            *[jnp.asarray(x) for x in (pos, pos, seg, seg)],
                            q.shape[-1] ** -0.5, causal, window, alibi, 64, 64)
    valid = np.broadcast_to((seg >= 0)[:, None, :], lse.shape)
    np.testing.assert_allclose(lse.numpy()[valid], np.asarray(lse8)[..., 0][valid], **TOL)


def test_flash_plain_chunked_prefill_offset(rng):
    """Chunked prefill with queries at start + i against context keys at j:
    C=512, S_ctx=2048, start=768, causal, window 4096.  The Pallas kernel's
    flat-index block skip drops the newest keys of rows >= 1024 here, so the
    port is held to mha(impl="xla") only."""
    c, s_ctx, start, n_valid = 512, 2048, 768, 512
    q, k, v = _attn_inputs(rng, b=1, tq=c, tk=s_ctx, h=2, hkv=1, d=16)
    qpos = (start + np.arange(c, dtype=np.int32))[None]
    kpos = np.arange(s_ctx, dtype=np.int32)[None]
    qseg = np.where(np.arange(c)[None] < n_valid, 0, -1).astype(np.int32)
    kseg = np.where(kpos < start + n_valid, 0, -1).astype(np.int32)
    got, pad = _flash_both(q, k, v, qseg, kseg, qpos, kpos, True, 4096)
    ref = jax_mha(*[jnp.asarray(x) for x in (q, k, v, qseg, kseg, qpos, kpos)],
                  causal=True, sliding_window=4096, impl="xla")
    np.testing.assert_allclose(got, np.where(pad, 0.0, np.asarray(ref)), **TOL)


def test_tf32_round_is_cvt_rna():
    """Round to 10 mantissa bits, ties away from zero; x - tf32(x) is exact
    and its own rounding leaves x within 2^-22 of |x|."""
    x = torch.tensor([1.0, 1.0 + 2**-11, -(1.0 + 2**-11), 1.0 + 3 * 2**-11, 1.0 + 2**-12,
                      3.14159265, -2.7182818, 1e-3])
    want = [1.0, 1.0 + 2**-10, -(1.0 + 2**-10), 1.0 + 2**-9, 1.0, 3.140625, -2.71875,
            0.0010004043579101562]
    assert FL.tf32_round(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    big = FL.tf32_round(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    rest = (y.double() - big.double() - FL.tf32_round(y - big).double()).abs()
    assert (rest <= 2.0**-22 * y.double().abs()).all()


F32_CASES = {  # name: (B, T, H, d, alibi); (b) Voicebox and (c) XLS-R in small
    "b voicebox": (2, 160, 4, 64, True),
    "c xlsr": (1, 192, 2, 80, False),
}


@pytest.mark.parametrize("name", list(F32_CASES))
def test_flash_3xtf32_plain_matches_jax_f32(rng, interpret, name):
    """The f32 route's arithmetic (3xTF32) within 1e-4 of the JAX f32 flash
    forward (Pallas, interpret mode, Precision.HIGHEST) and of the f64 plain
    version, output and log-sum-exp, at small (b)- and (c)-like shapes (the
    second row of (b) padded); a single TF32 product misses 1e-4 against the
    f64 plain version."""
    b, tlen, h, d, alibi = F32_CASES[name]
    q, k, v = _attn_inputs(rng, b=b, tq=tlen, tk=tlen, h=h, hkv=h, d=d)
    pos = np.broadcast_to(np.arange(tlen, dtype=np.int32), (b, tlen)).copy()
    seg = np.where(pos < np.asarray([[tlen], [101]])[:b], 0, -1).astype(np.int32)
    targs = [t(x) for x in (q, k, v, seg, seg, pos, pos)]
    got, lse = FL.flash_attention_3xtf32_reference(*targs, False, None, None, alibi)
    one, _ = FL.flash_attention_3xtf32_reference(*targs, False, None, None, alibi, terms=1)
    exact, exact_lse = FL.flash_attention_reference(*[x.double() for x in targs[:3]],
                                                    *targs[3:], False, None, None, alibi)
    kern = JFL.flash_attention(*map(jnp.asarray, (q, k, v, seg, seg, pos, pos)), causal=False,
                               alibi=alibi, block_q=64, block_k=64)
    _, jlse = JFL._fwd_call(*[jnp.asarray(np.swapaxes(x, 1, 2)) for x in (q, k, v)],
                            *map(jnp.asarray, (pos, pos, seg, seg)), d**-0.5, False, None,
                            alibi, 64, 64)
    valid = (seg >= 0)[:, :, None, None]
    rows = np.broadcast_to((seg >= 0)[:, None, :], lse.shape)

    def err(a, want):
        return np.abs(np.where(valid, np.asarray(a, np.float64) - np.asarray(want), 0.0)).max()

    assert err(got, exact) <= 1e-4
    assert err(got, kern) <= 1e-4
    assert np.abs(lse.numpy() - exact_lse.numpy())[rows].max() <= 1e-4
    assert np.abs(lse.numpy() - np.asarray(jlse)[..., 0])[rows].max() <= 1e-4
    assert err(one, exact) > 1e-4


def test_flash_rejects_non_pow2_alibi():
    x = torch.zeros(1, 4, 3, 16)
    z = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        FL.flash_attention(x, x, x, z, z, z, z, causal=False, alibi=True)


# ----------------------------------------------------------------- K3
def _act_inputs(rng, b, tlen, c):
    return (rng.standard_normal((b, tlen, c)).astype(np.float32),
            (rng.standard_normal(c) * 0.3).astype(np.float32),
            (rng.standard_normal(c) * 0.3).astype(np.float32))


@pytest.mark.parametrize("snakebeta", [False, True])
@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("tlen", [1, 7, 64, 200])
def test_fused_act_plain_matches_jax(rng, snakebeta, logscale, tlen):
    """Edges included: every output, down to single-sample clips."""
    x, alpha, beta = _act_inputs(rng, 2, tlen, 8)
    jb = jnp.asarray(beta) if snakebeta else None
    got = FA.fused_activation1d(t(x.transpose(0, 2, 1).copy()), t(alpha),
                                t(beta) if snakebeta else None, logscale).numpy()
    want = JFA._xla_ref(jnp.asarray(x), jnp.asarray(alpha), jb, logscale, snakebeta)
    np.testing.assert_allclose(got.transpose(0, 2, 1), np.asarray(want), **TOL)
    if tlen >= 64:  # the Pallas path's own minimum length
        kern = JFA._fused_fwd_impl(jnp.asarray(x), jnp.asarray(alpha), jb, logscale,
                                   snakebeta, interpret=True)
        np.testing.assert_allclose(got.transpose(0, 2, 1), np.asarray(kern), **TOL)
