"""usdm_tpu_torch models against usdm_tpu on the same weights (tiny configs).

JAX weights are made by usdm_tpu's own init, carried over through
usdm_tpu_torch.core.bridge, and both sides run in f32 (JAX under
default_matmul_precision("highest"), since its CPU default is bf16-like).
Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import BigVGANConfig, MistralConfig, VoiceboxConfig, XlsrConfig
from usdm_tpu.models import bigvgan as JBV
from usdm_tpu.models import mistral as JLM
from usdm_tpu.models import voicebox as JVB
from usdm_tpu.models import xlsr as JXL
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.models import mistral as LM
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.models import xlsr as XL


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def host(tree):
    return jax.device_get(tree)


def port_cfg(jcfg):
    """The port's config of the same fields as a usdm_tpu config."""
    return getattr(C, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_mistral_forward_matches(rng):
    cfg = MistralConfig.tiny()
    jp = JLM.init_params(cfg, jax.random.PRNGKey(0))
    ids = rng.integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    seg = np.zeros((2, 40), np.int32)
    seg[1, 25:] = 1  # two packed sequences in row 1
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    pos[1, 25:] -= 25
    want = JLM.forward(jp, cfg, jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(pos),
                       attn_impl="xla")
    got = LM.forward(bridge.mistral_from_jax(host(jp)), port_cfg(cfg), torch.from_numpy(ids).long(),
                     torch.from_numpy(seg), torch.from_numpy(pos))
    close(got, want, rtol=1e-4, atol=1e-4)  # f32 logits of O(1)


def test_mistral_rope_and_norm_match(rng):
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 100, 4095, 4096, 9000]], np.int32)
    jc, js = JLM.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tc, ts = LM.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    close(tc, jc, rtol=1e-5, atol=2e-5)  # f32 cos/sin of arguments up to ~9000
    close(LM.apply_rope(torch.from_numpy(x), tc, ts),
          JLM.apply_rope(jnp.asarray(x), jc, js), rtol=1e-5, atol=2e-5)
    w = rng.standard_normal(16).astype(np.float32)
    close(LM.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
          JLM.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def xlsr():
    cfg = XlsrConfig.tiny()
    with jax.default_matmul_precision("highest"):
        jp = JXL.init_params(cfg, jax.random.PRNGKey(1))
    return cfg, jp, bridge.xlsr_from_jax(host(jp))


def test_xlsr_units_match(xlsr, rng):
    cfg, jp, tp = xlsr
    wav = (rng.standard_normal(7000) * 0.1).astype(np.float32)
    want = JXL.extract_units_bucketed(jp, cfg, wav)
    got = XL.extract_units_bucketed(tp, port_cfg(cfg), wav)
    assert got == want  # exact units
    assert len(got) > 100


def test_xlsr_features_match_with_padding(xlsr, rng):
    cfg, jp, tp = xlsr
    wav = (rng.standard_normal((2, 6000)) * 0.1).astype(np.float32)
    lens = np.asarray([6000, 4100], np.int32)
    jf, jl = JXL.encode(jp, cfg, jnp.asarray(wav), jnp.asarray(lens), attn_impl="xla")
    for impl in ("plain", "flash"):  # flash: the kernel wrapper's CPU version
        tf, tl = XL.encode(tp, port_cfg(cfg), torch.from_numpy(wav), torch.from_numpy(lens).long(),
                           attn_impl=impl)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        n = int(jl[1])
        close(tf[0], jf[0], rtol=1e-4, atol=1e-4)  # f32 through 3 layers
        close(tf[1, :n], jf[1, :n], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def voicebox():
    cfg = VoiceboxConfig.tiny()
    with jax.default_matmul_precision("highest"):
        jp = JVB.init_params(cfg, jax.random.PRNGKey(2))
    return cfg, jp, bridge.voicebox_from_jax(host(jp))


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_voicebox_estimator_matches(voicebox, rng, impl):
    """Both attention paths (`flash` runs the kernel wrapper's CPU version,
    ALiBi computed from positions) against the JAX XLA path."""
    cfg, jp, tp = voicebox
    b, t = 2, 30
    x = rng.integers(0, cfg.n_tokens + 1, size=(b, t)).astype(np.int32)
    y = rng.standard_normal((b, cfg.n_feats, t)).astype(np.float32)
    cond = rng.standard_normal((b, cfg.n_feats, t)).astype(np.float32)
    tt = rng.uniform(size=b).astype(np.float32)
    lens = np.asarray([t, 19], np.int32)
    want = JVB.estimator(jp, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(cond),
                         jnp.asarray(tt), jnp.asarray(lens), attn_impl="xla", fused_ln="xla")
    got = VB.estimator(tp, port_cfg(cfg), torch.from_numpy(x).long(), torch.from_numpy(y),
                       torch.from_numpy(cond), torch.from_numpy(tt),
                       torch.from_numpy(lens).long(), attn_impl=impl)
    close(got, want, rtol=1e-4, atol=1e-4)  # f32 through 4 post-LN layers


def test_voicebox_generate_matches(voicebox, rng):
    """Heun, CFG 1.0, same initial noise z on both sides."""
    cfg, jp, tp = voicebox
    t = 24
    x = rng.integers(0, cfg.n_tokens, size=(1, t)).astype(np.int32)
    z = rng.standard_normal((1, cfg.n_feats, t)).astype(np.float32)
    cond = np.zeros((1, cfg.n_feats, t), np.float32)
    lens = np.asarray([20], np.int32)
    want = JVB.generate(jp, cfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(lens),
                        jax.random.PRNGKey(0), n_timesteps=7, z=jnp.asarray(z), fused_ln="xla")
    got = VB.generate(tp, port_cfg(cfg), torch.from_numpy(x).long(), torch.from_numpy(cond),
                      torch.from_numpy(lens).long(), n_timesteps=7, z=torch.from_numpy(z))
    close(got, want, rtol=1e-4, atol=1e-4)  # f32 over 4 Heun steps


@pytest.mark.parametrize("fused", [True, False])
def test_bigvgan_generator_matches(rng, fused):
    cfg = BigVGANConfig.tiny().replace(fused_act=fused)
    jp = JBV.init_generator(cfg, jax.random.PRNGKey(3))
    # non-zero snake parameters so alpha and beta both matter
    for blk in jp["resblocks"]:
        for a in blk["acts"]:
            for k in a:
                a[k] = jnp.asarray(rng.standard_normal(a[k].shape).astype(np.float32) * 0.3)
    mel = rng.standard_normal((1, cfg.num_mels, 20)).astype(np.float32)
    want = JBV.generator(jp, cfg, jnp.asarray(mel))
    got = BV.generator(bridge.bigvgan_from_jax(host(jp)), port_cfg(cfg), torch.from_numpy(mel))
    assert got.shape == want.shape
    close(got, want, rtol=1e-4, atol=1e-5)  # f32 waveform in [-1, 1]
