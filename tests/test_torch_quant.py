"""The port's W8A8 int8 path against usdm_tpu, on the CPU.

quantize_weight, qmm's plain version (the CPU route of K6) and the Pallas
stream_qmv in interpret mode; bridged quantized trees; the W8A8 Voicebox
estimator and Heun generate; a tiny W8A8 PagedEngine with bf16-layout (f32
here) and int8 KV pools; K1's int8 branch; a tiny int8 respond() turn.
Inputs come from numpy generators; each tolerance is stated where it is
asserted.  tests/test_torch_cuda.py holds the CUDA kernels (K6, K1 int8) to
these plain versions on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import usdm_tpu.ops.paged_attention as JPA
import usdm_tpu.ops.stream_matvec as JSM
from usdm_tpu.core.config import EngineConfig, MistralConfig, VoiceboxConfig
from usdm_tpu.engine.paged import PagedEngine as JaxEngine
from usdm_tpu.engine.paged import Request as JaxRequest
from usdm_tpu.engine.paged_ops import quant_kv_token as jax_quant_kv_token
from usdm_tpu.models import mistral as JLM
from usdm_tpu.models import quant as JQ
from usdm_tpu.models import voicebox as JVB
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.engine import paged_ops
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import quant as Q
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.ops import paged_attention as PA
from usdm_tpu_torch.ops import stream_matvec as SM


def port_cfg(jcfg):
    """The port's config of the same fields as a usdm_tpu config."""
    return getattr(C, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))


def t(x):
    return torch.from_numpy(np.array(x))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value: 2^(exponent - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


# ----------------------------------------------------------------- quantize
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_weight_matches_jax(rng, dtype):
    """q and s equal usdm_tpu's exactly; the port stores q transposed."""
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jw = jnp.asarray(w).astype(dtype)
    want = JQ.quantize_weight(jw, axis=-2)
    got = Q.quantize_weight(t(jw.astype(jnp.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["q"].numpy().T, np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].float().numpy(),
                                  np.asarray(want["s"].astype(jnp.float32)))
    deq = Q.dequantize_weight(got, torch.float32).numpy()
    np.testing.assert_array_equal(deq, np.asarray(JQ.dequantize_weight(want, jnp.float32)))


# ----------------------------------------------------------------- qmm / K6
def _qweight(rng, din, dout):
    w = (rng.standard_normal((din, dout)) * 0.02).astype(np.float32)
    jw = JQ.quantize_weight(jnp.asarray(w), axis=-2)
    tw = {"q": t(np.asarray(jw["q"]).T.copy()),
          "s": t(np.asarray(jw["s"].astype(jnp.float32))).to(torch.bfloat16)}
    return jw, tw


@pytest.mark.parametrize("m", [1, 8, 17, 64])
@pytest.mark.parametrize("din,dout", [(4096, 1024), (512, 1792)])
def test_qmm_plain_matches_jax(rng, m, din, dout):
    """f32: equal to usdm_tpu's qmm bit for bit (the int8 activations and the
    int32 accumulators are the same, and the epilogue is the same three
    IEEE operations).  bf16 activations: within one bf16 ulp of each value
    (the outputs round once on each side).  Din 4096 x Dout 1024 is a 7B
    k/v projection; 512 x 1792 the FFN's aspect scaled down by 8."""
    jw, tw = _qweight(rng, din, dout)
    y = rng.standard_normal((m, din)).astype(np.float32) * 3.0
    y[0, :7] = 0.0
    want = np.asarray(JQ.qmm(jnp.asarray(y), jw))
    got = Q.qmm(t(y), tw).numpy()
    np.testing.assert_array_equal(got, want)
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    want_b = np.asarray(JQ.qmm(yb, jw).astype(jnp.float32))
    got_b = Q.qmm(t(np.asarray(yb.astype(jnp.float32))).bfloat16(), tw).float().numpy()
    assert np.all(np.abs(got_b - want_b) <= _bf16_ulp(want_b))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("din,dout", [(512, 1024), (4096, 1024)])
def test_stream_qmv_plain_matches_pallas(rng, interpret, m, din, dout):
    """The plain version of K6 against the Pallas kernel in interpret mode,
    f32 out: within two f32 ulps, rtol 2^-22 (the Pallas kernel multiplies
    the int32 accumulator by s before ys, qmm and the port by ys before s;
    each order rounds twice, so the two may end up to two ulps apart)."""
    jw, tw = _qweight(rng, din, dout)
    y = rng.standard_normal((m, din)).astype(np.float32)
    oi = {"q": jnp.asarray(np.asarray(jw["q"]).T), "s": jw["s"]}  # the Pallas "oi" contract
    want = np.asarray(JSM.stream_qmv(jnp.asarray(y), oi, out_dtype=jnp.float32))
    got = SM.stream_qmv(t(y), tw, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0**-22, atol=0)


def test_qmm_exact_where_f32_products_round(rng):
    """The accumulator is exact: at Din 14336 with |q| = 127 on both sides
    partial sums reach 2.3e8 > 2^24, where a float32 product would round."""
    din = 14336
    qy = np.full((1, din), 127, np.int8)
    qy[0, ::3] = -127
    q = np.full((2, din), 127, np.int8)
    q[1, 1::2] = 126
    acc = SM.int_matmul_reference(t(qy), t(q)).numpy()
    want = qy.astype(np.int64) @ q.astype(np.int64).T
    np.testing.assert_array_equal(acc, want.astype(np.float64))


# ----------------------------------------------------------------- bridge
def test_bridged_quantized_trees(rng):
    """Quantized stacked leaves become per-layer "oi" {"q", "s"}; plain
    leaves stay as the bridge made them before."""
    cfg = MistralConfig.tiny()
    jp = JQ.quantize_llm_params(JLM.init_params(cfg, jax.random.PRNGKey(3)))
    tp = bridge.mistral_from_jax(jax.device_get(jp))
    assert len(tp["layers"]) == cfg.num_layers
    for i, lp in enumerate(tp["layers"]):
        for k in Q.QUANT_KEYS:
            assert Q.is_quantized(lp[k]) and lp[k]["q"].is_contiguous()
            np.testing.assert_array_equal(lp[k]["q"].numpy(), np.asarray(jp["layers"][k]["q"][i]).T)
            np.testing.assert_array_equal(lp[k]["s"].float().numpy(),
                                          np.asarray(jp["layers"][k]["s"][i].astype(jnp.float32)))
        np.testing.assert_array_equal(lp["ln1"].numpy(), np.asarray(jp["layers"]["ln1"][i]))
    assert Q.out_dim(tp["layers"][0]["wq"]) == cfg.num_heads * cfg.head_dim
    # the same bytes as usdm_tpu counts (embed and lm_head f32 on both sides)
    assert Q.quantized_bytes(tp) == JQ.quantized_bytes(jp)
    vcfg = VoiceboxConfig.tiny()
    vp = JQ.quantize_voicebox_params(JVB.init_params(vcfg, jax.random.PRNGKey(4)))
    tv = bridge.voicebox_from_jax(jax.device_get(vp))
    assert len(tv["skip_w"]) == vcfg.num_layers // 2 and Q.is_quantized(tv["skip_w"][1])
    np.testing.assert_array_equal(tv["skip_w"][1]["q"].numpy(), np.asarray(vp["skip_w"]["q"][1]).T)
    assert all(Q.is_quantized(lp[k]) for lp in tv["layers"] for k in Q.VB_QUANT_KEYS)
    assert not Q.is_quantized(tv["layers"][0]["bq"])
    # quantizing the port's own bridged float tree gives the same leaves
    own = Q.quantize_voicebox_params(
        bridge.voicebox_from_jax(jax.device_get(JVB.init_params(vcfg, jax.random.PRNGKey(4)))))
    for a, b in zip(own["layers"][2]["ffn_w1"].values(), tv["layers"][2]["ffn_w1"].values()):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- Voicebox
@pytest.fixture(scope="module")
def vb_int8():
    """(cfg, usdm_tpu's f32 params, its W8A8 params, the port's bridged W8A8
    params)."""
    cfg = VoiceboxConfig.tiny()
    jf = JVB.init_params(cfg, jax.random.PRNGKey(2))
    jq = JQ.quantize_voicebox_params(jf)
    return cfg, jf, jq, bridge.voicebox_from_jax(jax.device_get(jq))


def _nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def assert_within_int8_drift(got, want, want_f32):
    """The port against usdm_tpu's W8A8 output `want`, bounded by usdm_tpu's
    own W8A8 drift from its f32 output `want_f32` on the same inputs.  The
    two W8A8 computations differ in f32 summation order (~1e-7) outside the
    int8 products; where an activation lies within that noise of a .5
    boundary of y / ys, it rounds to neighbouring int8 values on the two
    sides: one quantization step on one element.  W8A8 itself moves every
    activation by up to half a step, so a few flips stay inside the W8A8
    drift: normalized RMS and largest error at most the drift's.  (Measured
    here: 0.04-0.6 of it where a flip occurs, ~1e-5 of it where none does.)
    A wrong scale, layout or route misses both by far."""
    got, want, want_f32 = (np.asarray(a, np.float64) for a in (got, want, want_f32))
    drift, drift_max = _nrms(want, want_f32), np.abs(want - want_f32).max()
    assert drift > 0
    assert _nrms(got, want) <= drift, (_nrms(got, want), drift)
    assert np.abs(got - want).max() <= drift_max, (np.abs(got - want).max(), drift_max)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_voicebox_w8a8_estimator_matches_jax(vb_int8, rng, impl):
    """Both attention paths of the port against usdm_tpu's XLA path, over
    three draws of inputs."""
    cfg, jf, jq, tp = vb_int8
    b, tt = 2, 30
    for _ in range(3):
        x = rng.integers(0, cfg.n_tokens + 1, size=(b, tt)).astype(np.int32)
        y = rng.standard_normal((b, cfg.n_feats, tt)).astype(np.float32)
        cond = rng.standard_normal((b, cfg.n_feats, tt)).astype(np.float32)
        ts = rng.uniform(size=b).astype(np.float32)
        lens = np.asarray([tt, 19], np.int32)
        args = tuple(map(jnp.asarray, (x, y, cond, ts, lens)))
        with jax.default_matmul_precision("highest"):
            want, want_f32 = (JVB.estimator(p, cfg, *args, attn_impl="xla", fused_ln="xla")
                              for p in (jq, jf))
        got = VB.estimator(tp, port_cfg(cfg), t(x).long(), t(y), t(cond), t(ts), t(lens).long(),
                           attn_impl=impl)
        assert_within_int8_drift(got.numpy(), want, want_f32)


def test_voicebox_w8a8_generate_matches_jax(vb_int8, rng):
    """Heun with CFG (batch doubling), the same initial noise z on both
    sides; the ODE state is f32."""
    cfg, jf, jq, tp = vb_int8
    tt = 24
    x = rng.integers(0, cfg.n_tokens, size=(1, tt)).astype(np.int32)
    z = rng.standard_normal((1, cfg.n_feats, tt)).astype(np.float32)
    cond = np.zeros((1, cfg.n_feats, tt), np.float32)
    lens = np.asarray([20], np.int32)
    with jax.default_matmul_precision("highest"):
        want, want_f32 = (JVB.generate(p, cfg, jnp.asarray(x), jnp.asarray(cond),
                                       jnp.asarray(lens), jax.random.PRNGKey(0), n_timesteps=7,
                                       z=jnp.asarray(z), fused_ln="xla") for p in (jq, jf))
    got = VB.generate(tp, port_cfg(cfg), t(x).long(), t(cond), t(lens).long(), n_timesteps=7,
                      z=t(z))
    assert_within_int8_drift(got.numpy(), want, want_f32)


def test_quantized_voicebox_refuses_training(vb_int8, rng):
    cfg, _, _, tp = vb_int8
    tt = 8
    with pytest.raises(ValueError, match="inference-only"):
        VB.cfm_loss(tp, port_cfg(cfg), torch.zeros(1, tt, dtype=torch.long),
                    torch.zeros(1, 1, tt), torch.zeros(1, cfg.n_feats, tt), torch.tensor([tt]))


# ----------------------------------------------------------------- engine
LM_CFG = MistralConfig.tiny()


@pytest.fixture(scope="module")
def lm_int8():
    """Tiny W8A8 Mistral.  lm_head is scaled up (peaked logits) so a greedy
    argmax is never decided by a margin within f32 rounding of the two
    implementations."""
    jp = JLM.init_params(LM_CFG, jax.random.PRNGKey(7))
    jp["lm_head"] = jp["lm_head"] * 8.0
    jp = JQ.quantize_llm_params(jp)
    return jp, bridge.mistral_from_jax(jax.device_get(jp))


def _requests(mk, v):
    rng = np.random.default_rng(11)
    allow = np.ones(v, bool)
    allow[:3] = False  # EOS (2) unreachable: every request runs its budget
    units = np.zeros(v, bool)
    units[250:290] = True
    prompts = [rng.integers(3, 250, size=n).tolist() for n in (9, 23, 37)]
    return [mk(0, prompts[0], allow, 2, 12), mk(1, prompts[1], units, 2, 10),
            mk(2, prompts[2], allow, 2, 14)]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_w8a8_engine_tokens_match_jax(lm_int8, kv_dtype):
    """Three requests on two slots (one waits for capacity), a 3-chunk
    prompt, an interval mask: greedy tokens identical to usdm_tpu's engine
    on the same quantized params, with f32 and with int8 KV pools."""
    jp, tp = lm_int8
    ecfg = EngineConfig(max_batch_size=2, page_size=8, max_pages_per_seq=16, prefill_chunk=16,
                        decode_horizon=4, kv_dtype=kv_dtype)
    with jax.default_matmul_precision("highest"):
        rj = JaxEngine(jp, LM_CFG, ecfg).run(_requests(JaxRequest, LM_CFG.vocab_size))
    et = PagedEngine(tp, port_cfg(LM_CFG), port_cfg(ecfg), device="cpu")
    assert et.kv.quantized == (kv_dtype == "int8")
    rt = et.run(_requests(Request, LM_CFG.vocab_size))
    for a, b in zip(rt, rj):
        assert a.error is None and a.finished
        assert a.output_ids == b.output_ids
        assert len(a.output_ids) == a.max_new_tokens


def test_int8_kv_writes_match_jax(lm_int8):
    """quant_kv_token equals usdm_tpu's; one decode step writes int8 rows
    and their scales in place at the token's page and row."""
    x = np.random.default_rng(2).standard_normal((3, 2, 16)).astype(np.float32)
    x[1, 0] = 0.0
    jq, js = jax_quant_kv_token(jnp.asarray(x))
    tq, ts = paged_ops.quant_kv_token(t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _, tp = lm_int8
    cfg = port_cfg(LM_CFG)
    kv = paged_ops.PagedKV.create(cfg, 5, 8, "cpu", "int8")
    ptrs = (kv.k_pages.data_ptr(), kv.k_scales.data_ptr())
    paged_ops.paged_decode_step(tp, kv, cfg, torch.tensor([3]), torch.tensor([9], dtype=torch.int32),
                                torch.tensor([[0, 1, 4, 4]], dtype=torch.int32),
                                torch.tensor([True]), torch.ones((1, cfg.vocab_size), dtype=torch.bool),
                                8)
    assert (kv.k_pages.data_ptr(), kv.k_scales.data_ptr()) == ptrs
    for li in range(cfg.num_layers):  # position 9 -> page 1, row 1
        assert kv.k_pages[:, li * 5 + 1, 1].abs().sum() > 0
        assert (kv.k_scales[li * 5 + 1, :, 1] > 0).all() and (kv.v_scales[li * 5 + 1, :, 1] > 0).all()
    assert kv.k_scales.count_nonzero() == cfg.num_layers * cfg.num_kv_heads


# ----------------------------------------------------------------- K1 int8
def _int8_pools(rng, hkv=2, n_pages=16, p=8, d=32):
    pools = []
    for _ in range(2):
        x = rng.standard_normal((hkv, n_pages, p, d)).astype(np.float32)
        q, s = jax_quant_kv_token(jnp.asarray(x))  # scales [Hkv, N, P]
        pools += [np.asarray(q), np.asarray(jnp.transpose(s, (1, 0, 2)))]
    return pools


@pytest.mark.parametrize("window,lens", [(None, [5, 17, 32]), (10, [30, 25, 32])])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_int8_plain_matches_jax(rng, interpret, window, lens, dtype):
    """K1's plain version with int8 pools against usdm_tpu's reference:
    f32 q within 2e-5 (summation order); bf16 q within one bf16 ulp of the
    largest output (both dequantize to bf16 after the gather and differ only
    in summation order and the output rounding).  Against the Pallas kernel
    in interpret mode: usdm_tpu's own bound for its int8 branch, 2e-2 (its
    p @ V runs in bf16 after the v-scale fold)."""
    kq, ks, vq, vs = _int8_pools(rng)
    q = rng.standard_normal((3, 2, 4, 32)).astype(np.float32)
    table = rng.permutation(15)[:12].reshape(3, 4).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    jq = jnp.asarray(q).astype(dtype)
    jargs = (jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table), jnp.asarray(lens))
    ref = np.asarray(JPA.paged_decode_attention_reference(
        jq, *jargs, sliding_window=window, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs)).astype(jnp.float32))
    tq = t(np.asarray(jq.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = PA.paged_decode_attention(tq, t(kq), t(vq), t(table), t(lens), window,
                                    k_scales=t(ks), v_scales=t(vs)).float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        kern = np.asarray(JPA.paged_decode_attention(
            jq, *jargs, sliding_window=window, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
        np.testing.assert_allclose(got, kern, rtol=2e-2, atol=2e-2)
    else:
        assert np.abs(got - ref).max() <= 2.0**-7 * np.abs(ref).max() + 1e-4


# ----------------------------------------------------------------- turn
def test_tiny_int8_turn_matches_jax(tmp_path):
    """usdm_tpu's tiny_random pipeline with its LM and Voicebox quantized as
    from_pretrained(lm_int8=True, vb_int8=True) quantizes them, bridged into
    the port: the same wav gives the same DialogResult, and the same units
    and initial noise synthesize the same waveform within usdm_tpu's own
    W8A8 drift (assert_within_int8_drift: its synthesis with the float
    Voicebox is the yardstick)."""
    from usdm_tpu.audio.units import expand_and_pool
    from usdm_tpu.audio.wav import ceil_to, write_wav
    from usdm_tpu.pipeline import UsdmPipeline as JaxPipeline
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
    from usdm_tpu_torch.engine.synthesis import SpeechDecoder
    from usdm_tpu_torch.pipeline import UsdmPipeline

    with jax.default_matmul_precision("highest"):
        jpipe = JaxPipeline.tiny_random(seed=0)
        jpipe.lm_params = JQ.quantize_llm_params(jpipe.lm_params)
        d = jpipe.decoder
        vb_f32 = d.voicebox_params
        d.voicebox_params = JQ.quantize_voicebox_params(vb_f32)
    host = jax.device_get
    decoder = SpeechDecoder(bridge.voicebox_from_jax(host(d.voicebox_params)),
                            port_cfg(d.voicebox_cfg),
                            bridge.bigvgan_from_jax(host(d.vocoder_params)),
                            port_cfg(d.vocoder_cfg), port_cfg(d.mel_cfg))
    tpipe = UsdmPipeline(UsdmTokenizer.build_test(num_units=32),
                         bridge.mistral_from_jax(host(jpipe.lm_params)), port_cfg(jpipe.lm_cfg),
                         bridge.xlsr_from_jax(host(jpipe.xlsr_params)), port_cfg(jpipe.xlsr_cfg),
                         decoder, device="cpu", max_new_tokens=jpipe.max_new_tokens)
    wav_path = str(tmp_path / "user.wav")
    write_wav(wav_path, (np.random.default_rng(5).standard_normal(16000) * 0.1)
              .astype(np.float32), 16000)
    try:
        with jax.default_matmul_precision("highest"):
            want = jpipe.respond(wav_path, n_timesteps=4, seed=3)
        got = tpipe.respond(wav_path, str(tmp_path / "agent.wav"), n_timesteps=4, seed=3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.agent_units, "degenerate turn: no agent units"
        units = got.agent_units
        key = jax.random.PRNGKey(11)
        n = len(expand_and_pool(np.asarray(units))[0])
        shape = (1, d.mel_cfg.num_mels, ceil_to(n, d.frame_bucket))
        z = np.asarray(jax.random.normal(jax.random.split(key)[0], shape, jnp.float32))
        with jax.default_matmul_precision("highest"):
            want_audio = d.synthesize(units, key, n_timesteps=6)
            f32_audio = dataclasses.replace(d, voicebox_params=vb_f32).synthesize(
                units, key, n_timesteps=6)
        got_audio = tpipe.decoder.synthesize(units, z=t(z), n_timesteps=6)
        assert got_audio.shape == want_audio.shape and np.abs(want_audio).max() > 0
        assert_within_int8_drift(got_audio, want_audio, f32_audio)
    finally:
        jpipe.close()
        tpipe.close()
