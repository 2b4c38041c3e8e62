"""Speaker reference prompts: usdm_tpu_torch against usdm_tpu at tiny width, f32.

The bucketed reference mel, the prompt renoise, Voicebox's prompted ODE
(Heun, Euler, no CFG), prepare_reference, synthesize(reference=...) and
respond(reference_path=...), each on the same seeded inputs on both sides
(JAX under default_matmul_precision("highest")); where usdm_tpu draws from
a key, the test reproduces its draws and hands them to the port.
Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.audio import mel as JMEL
from usdm_tpu.audio.units import expand_and_pool
from usdm_tpu.audio.wav import ceil_to, write_wav
from usdm_tpu.core.config import MelConfig, VoiceboxConfig
from usdm_tpu.engine.synthesis import prepare_reference as jax_prepare_reference
from usdm_tpu.models import voicebox as JVB
from usdm_tpu.pipeline import UsdmPipeline as JaxPipeline
from usdm_tpu_torch.audio import mel as MEL
from usdm_tpu_torch.audio.wav import read_wav
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine.synthesis import SpeechDecoder, prepare_reference
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.pipeline import UsdmPipeline


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def port_cfg(jcfg):
    return getattr(C, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


@pytest.fixture(scope="module")
def pipes():
    with jax.default_matmul_precision("highest"):
        jpipe = JaxPipeline.tiny_random(seed=0)
    host = jax.device_get
    d = jpipe.decoder
    decoder = SpeechDecoder(bridge.voicebox_from_jax(host(d.voicebox_params)),
                            port_cfg(d.voicebox_cfg),
                            bridge.bigvgan_from_jax(host(d.vocoder_params)),
                            port_cfg(d.vocoder_cfg), port_cfg(d.mel_cfg))
    tpipe = UsdmPipeline(UsdmTokenizer.build_test(num_units=32),
                         bridge.mistral_from_jax(host(jpipe.lm_params)), port_cfg(jpipe.lm_cfg),
                         bridge.xlsr_from_jax(host(jpipe.xlsr_params)), port_cfg(jpipe.xlsr_cfg),
                         decoder, device="cpu", max_new_tokens=jpipe.max_new_tokens)
    yield jpipe, tpipe
    jpipe.close()
    tpipe.close()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """A 1 s user clip at 16 kHz and a 2.3 s reference clip at 22.05 kHz
    (each loader resamples it to its rate), seeded noise."""
    d = tmp_path_factory.mktemp("wavs")
    user, ref = str(d / "user.wav"), str(d / "ref.wav")
    write_wav(user, (np.random.default_rng(5).standard_normal(16000) * 0.1)
              .astype(np.float32), 16000)
    write_wav(ref, (np.random.default_rng(6).standard_normal(50715) * 0.2)
              .astype(np.float32), 22050)
    return user, ref


# ------------------------------------------------------------------------ mel
@pytest.mark.parametrize("n", [1234, 9984, 22016, 30001])
def test_mel_bucketed_matches(rng, n):
    """Off-bucket lengths, hop multiples or not: usdm_tpu's bucketed mel
    within 1e-5, and the port's exact-length mel on the valid frames within
    1e-6 (usdm_tpu's own assertion of its bucketing)."""
    cfg = MelConfig()
    wav = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want = JMEL.mel_for_config_bucketed(wav, cfg)
    got = MEL.mel_for_config_bucketed(wav, port_cfg(cfg))
    exact = MEL.mel_for_config(t(wav[None]), port_cfg(cfg))
    assert got.shape == exact.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-6, atol=1e-6)


def test_mel_center_pad_off(rng):
    """center_pad=False on a host-padded signal equals the padded call."""
    wav = (rng.standard_normal((1, 5000)) * 0.1).astype(np.float32)
    y = np.pad(wav, ((0, 0), (384, 384)), mode="reflect")
    np.testing.assert_array_equal(MEL.mel_spectrogram(t(y), center_pad=False).numpy(),
                                  MEL.mel_spectrogram(t(wav)).numpy())


# --------------------------------------------------------------- prompted ODE
def test_renoise_prompt_matches(rng):
    shape = (2, 8, 30)
    z, cond, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    for tt, plen in ((0.25, 11), (1.0, 0), (0.6, 30)):
        want = JVB._renoise_prompt(jnp.asarray(z), jnp.asarray(cond), jnp.float32(tt), plen,
                                   1e-4, jnp.asarray(noise))
        got = VB._renoise_prompt(t(z), t(cond), tt, plen, 1e-4, t(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def voicebox():
    cfg = VoiceboxConfig.tiny()
    with jax.default_matmul_precision("highest"):
        jp = JVB.init_params(cfg, jax.random.PRNGKey(2))
    return cfg, jp, bridge.voicebox_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("solver,gradient_scale", [("heun", 1.0), ("euler", 1.0),
                                                   ("heun", 0.0)])
def test_generate_with_prompt_matches(voicebox, rng, solver, gradient_scale):
    """The same z and prompt_noises on both sides: within 1e-4 of the peak."""
    cfg, jp, tp = voicebox
    tt, n_prompt, n_timesteps = 32, 13, 7
    steps = (n_timesteps + 1) // 2 if solver == "heun" else n_timesteps
    x = rng.integers(0, cfg.n_tokens, size=(1, tt)).astype(np.int32)
    cond = np.zeros((1, cfg.n_feats, tt), np.float32)
    cond[:, :, :n_prompt] = rng.standard_normal((1, cfg.n_feats, n_prompt))
    z = rng.standard_normal(cond.shape).astype(np.float32)
    pn = rng.standard_normal((steps, 2, *cond.shape)).astype(np.float32)
    lens = np.asarray([28], np.int32)
    want = np.asarray(JVB.generate(
        jp, cfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(lens), jax.random.PRNGKey(0),
        n_timesteps=n_timesteps, solver=solver, gradient_scale=gradient_scale,
        speech_prompt=True, prompt_len=n_prompt, z=jnp.asarray(z), prompt_noises=jnp.asarray(pn),
        fused_ln="xla"))
    got = VB.generate(tp, port_cfg(cfg), t(x, torch.int64), t(cond), t(lens, torch.int64),
                      n_timesteps=n_timesteps, solver=solver, gradient_scale=gradient_scale,
                      z=t(z), speech_prompt=True, prompt_len=n_prompt, prompt_noises=t(pn))
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * peak)  # f32 both sides
    # the prompt frames end re-noised to t = 1 by the last step's first draw
    # (Heun's last step has no corrector)
    np.testing.assert_allclose(got.numpy()[:, :, :n_prompt],
                               (cfg.sigma_min * pn[-1, 0] + cond)[:, :, :n_prompt],
                               rtol=0, atol=1e-5)


def test_generate_draws_prompt_noises_from_generator(voicebox, rng):
    """Without z and prompt_noises the draws come from the generator: z, then
    all of prompt_noises in one call, as the docstring states."""
    cfg, _, tp = voicebox
    shape = (1, cfg.n_feats, 24)
    x = t(rng.integers(0, cfg.n_tokens, size=(1, 24)), torch.int64)
    cond = torch.zeros(shape)
    cond[:, :, :9] = 1.0
    args = (tp, port_cfg(cfg), x, cond, torch.tensor([24]))
    kw = dict(n_timesteps=4, speech_prompt=True, prompt_len=9)
    got = VB.generate(*args, generator=torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(3)
    z = torch.randn(shape, generator=g)
    pn = torch.randn((2, 2, *shape), generator=g)
    assert torch.equal(got, VB.generate(*args, z=z, prompt_noises=pn, **kw))


# ------------------------------------------------------------ the reference
def test_prepare_reference_matches(pipes, wavs):
    """Units equal, normalized mel within 1e-5; both cut to the shorter."""
    jpipe, tpipe = pipes
    _, ref = wavs
    want_u, want_m = jax_prepare_reference(ref, jpipe.xlsr_params, jpipe.xlsr_cfg,
                                           jpipe.decoder.mel_cfg)
    got_u, got_m = prepare_reference(ref, tpipe.xlsr_params, tpipe.xlsr_cfg,
                                     tpipe.decoder.mel_cfg, device="cpu")
    assert len(want_u) > 50
    np.testing.assert_array_equal(np.asarray(got_u), np.asarray(want_u))
    assert got_m.shape == want_m.shape == (1, 80, len(want_u))
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=0, atol=1e-5)


def _jax_draws(key, shape, n_timesteps: int, solver: str):
    """The initial noise and prompt renoise draws of usdm_tpu's generate:
    kz, kloop = split(key); per step (key, k1, k2) = split(key, 3) (Heun) or
    (key, k1) = split(key) (Euler); noise[i, j] = normal(k_{j+1})."""
    kz, key = jax.random.split(key)
    z = jax.random.normal(kz, shape, jnp.float32)
    steps = (n_timesteps + 1) // 2 if solver == "heun" else n_timesteps
    draws = []
    for _ in range(steps):
        if solver == "heun":
            key, k1, k2 = jax.random.split(key, 3)
        else:
            (key, k1), k2 = jax.random.split(key), None
        draws.append([jax.random.normal(k, shape, jnp.float32) if k is not None
                      else jnp.zeros(shape) for k in (k1, k2)])
    return t(np.asarray(z)), t(np.asarray(draws))


@pytest.mark.parametrize("solver", ["heun", "euler"])
def test_synthesize_with_reference_matches(pipes, wavs, rng, solver):
    """The same reference, units and draws: the waveform within 1e-3 of its
    peak (as the plain synthesis test), covering the agent's units only."""
    jpipe, tpipe = pipes
    _, ref = wavs
    jref = jax_prepare_reference(ref, jpipe.xlsr_params, jpipe.xlsr_cfg, jpipe.decoder.mel_cfg)
    units = rng.integers(0, 32, size=40).tolist()
    key = jax.random.PRNGKey(11)
    n_agent = len(expand_and_pool(np.asarray(units))[0])
    frames = ceil_to(len(jref[0]) + n_agent, jpipe.decoder.frame_bucket)
    z, pn = _jax_draws(key, (1, 80, frames), 5, solver)
    want = jpipe.decoder.synthesize(units, key, reference=jref, n_timesteps=5, solver=solver)
    got = tpipe.decoder.synthesize(units, reference=(jref[0], t(jref[1])), n_timesteps=5,
                                   solver=solver, z=z, prompt_noises=pn)
    assert got.shape == want.shape == (n_agent * jpipe.decoder.vocoder_cfg.total_upsample,)
    peak = np.abs(want).max()
    assert peak > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * peak)  # f32 both sides


def test_respond_with_reference_matches(pipes, wavs, tmp_path):
    """The same DialogResult as usdm_tpu's turn with the reference, the
    dialog untouched by it, and audio covering only the agent's units."""
    jpipe, tpipe = pipes
    user, ref = wavs
    with jax.default_matmul_precision("highest"):
        want = jpipe.respond(user, None, ref, n_timesteps=2, seed=3)
    out = str(tmp_path / "agent.wav")
    trace = {}
    got = tpipe.respond_with_policy(tpipe.dense_policy(), user, out, ref, n_timesteps=2,
                                    seed=3, trace=trace)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tpipe.respond(user, None, ref, n_timesteps=2, seed=3)) \
        == dataclasses.asdict(want)
    assert got.agent_units and trace["ref_s"] > 0
    wav, sr = read_wav(out)
    up = tpipe.decoder.vocoder_cfg.total_upsample
    expected = len(got.agent_units) * (22050 // 50) // 256 * up
    assert sr == 22050 and abs(len(wav) - expected) <= up and np.isfinite(wav).all()
