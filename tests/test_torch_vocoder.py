"""BigVGAN GAN training of usdm_tpu_torch against usdm_tpu, on the CPU.

K3's autograd Function against the gradients of usdm_tpu's custom_vjp (its
XLA path on the CPU), the discriminators, `discriminate` and the three GAN
losses, one discriminator step and one generator step from the same
GanTrainState (weights, moments and step carried by
usdm_tpu_torch.core.bridge), the dataset's crops and mels, and
cli.train_vocoder at --tiny: resumed equals uninterrupted, and the --export
round trip.  Inputs come from numpy generators; JAX runs under `highest`
matmul and convolution precision.  Every f32 convolution of the port goes
through ops/conv.py (scanned here).  Tolerances are stated at each assert.
"""

import dataclasses
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import BigVGANConfig, MelConfig
from usdm_tpu.core.mesh import create_mesh
from usdm_tpu.data import mel_dataset as JMD
from usdm_tpu.models import bigvgan as JBV
from usdm_tpu.ops import fused_act as JFA
from usdm_tpu.train import vocoder as JV
from usdm_tpu_torch.audio.wav import write_wav
from usdm_tpu_torch.cli import train_vocoder
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import checkpoint as CK
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.core.tree import tree_leaves
from usdm_tpu_torch.data import mel_dataset as MD
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.ops import conv as CV
from usdm_tpu_torch.ops import fused_act as FA
from usdm_tpu_torch.train import vocoder as V

TINY = BigVGANConfig.tiny()
TINY_MEL = MelConfig().replace(num_mels=TINY.num_mels, n_fft=64, win_size=64,
                               hop_size=TINY.total_upsample)
TINY_RES = ((256, 64, 128),)
PERIODS = (2, 3)


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port: its tiny convolutions gain nothing
    from more, and in a parallel test run (more busy threads than cores)
    OpenMP's waits made the CLI test over 10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg):
    return getattr(PC, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_vocoder_data.py's corpus: nine 22.05 kHz noise clips, one
    longer than a second, two shorter than a segment."""
    root = tmp_path_factory.mktemp("vocoder")
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(3)
    names = []
    for i, n in enumerate([22050, 4096, 9000] + [16384] * 6):
        write_wav(str(wavs / f"clip{i}.wav"), (rng.standard_normal(n) * 0.2).astype(np.float32),
                  22050)
        names.append(f"clip{i}")
    train = root / "train.txt"
    train.write_text("\n".join(f"{n}|unused transcript" for n in names))
    return str(wavs), str(train)


# ------------------------------------------------------------------ K3's vjp
@pytest.mark.parametrize("snakebeta,logscale", [(False, False), (False, True), (True, False),
                                                (True, True)])
def test_k3_function_grads_match_jax_custom_vjp(rng, snakebeta, logscale):
    """fused_activation1d's forward and its dx, dalpha, dbeta (None for
    snake) against jax.vjp through usdm_tpu's fused_activation1d (the
    custom_vjp; its XLA path on the CPU), x [B, T, C] there and [B, C, T]
    here: within 1e-5 of each tensor's peak (f32 both sides, the sums in
    another order)."""
    x = rng.standard_normal((2, 80, 12)).astype(np.float32)
    alpha = (rng.standard_normal(12) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(12) * 0.3).astype(np.float32) if snakebeta else None
    g = rng.standard_normal((2, 80, 12)).astype(np.float32)
    if snakebeta:
        y, vjp = jax.vjp(lambda a, b, c: JFA.fused_activation1d(a, b, c, logscale, True),
                         jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))
    else:
        y, vjp = jax.vjp(lambda a, b: JFA.fused_activation1d(a, b, None, logscale, False),
                         jnp.asarray(x), jnp.asarray(alpha))
    want = vjp(jnp.asarray(g))
    xt = t(x.transpose(0, 2, 1)).requires_grad_()
    at = t(alpha).requires_grad_()
    bt = t(beta).requires_grad_() if snakebeta else None
    yt = FA.fused_activation1d(xt, at, bt, logscale)
    assert yt.grad_fn is not None
    got = torch.autograd.grad(yt, [v for v in (xt, at, bt) if v is not None],
                              t(g.transpose(0, 2, 1)))
    peak = lambda a: 1e-5 * float(np.abs(np.asarray(a)).max())  # noqa: E731
    close(yt.detach().numpy().transpose(0, 2, 1), y, 0, peak(y))
    close(got[0].numpy().transpose(0, 2, 1), want[0], 0, peak(want[0]))
    for gv, wv in zip(got[1:], want[1:]):
        close(gv, wv, 0, peak(wv))


def test_every_conv_goes_through_the_full_f32_helper():
    """No convolution call in usdm_tpu_torch outside ops/conv.py, so every
    f32 convolution runs without TF32 on the card; on the CPU the helper is
    F.conv*'s arithmetic, and its autograd Function (the card's route) gives
    autograd's gradients (1e-6 of the peak: the same kernels, another
    caller)."""
    pkg = os.path.join(os.path.dirname(CV.__file__), "..")
    pat = re.compile(r"\bF\.conv|\bconv[12]d\(|conv_transpose[12]d\(|nn\.Conv|torch\.conv")
    hits = []
    for root, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and os.path.abspath(path) != os.path.abspath(CV.__file__):
                src = open(path).read()
                hits += [f"{path}:{m.start()}" for m in pat.finditer(src)]
    assert not hits, hits
    gen = torch.Generator().manual_seed(0)
    cases = [((2, 6, 40), (4, 3, 5), dict(stride=2, padding=3, dilation=2, groups=2),
              torch.nn.functional.conv1d),
             ((2, 4, 12, 5), (6, 4, 3, 1), dict(stride=(3, 1), padding=(1, 0)),
              torch.nn.functional.conv2d),
             ((2, 6, 9), (6, 2, 4), dict(stride=2, padding=1, groups=3),
              torch.nn.functional.conv_transpose1d)]
    for xs, ws, kw, ref in cases:
        x = torch.randn(*xs, generator=gen, requires_grad=True)
        w = torch.randn(*ws, generator=gen, requires_grad=True)
        b = torch.randn(ws[1] * kw.get("groups", 1) if ref is torch.nn.functional.conv_transpose1d
                        else ws[0], generator=gen, requires_grad=True)
        transposed = ref is torch.nn.functional.conv_transpose1d
        want = ref(x, w, b, **kw)
        assert torch.equal(CV.conv(x, w, b, transposed=transposed, **kw), want)
        args = ([kw.get("stride", 1)] * (x.dim() - 2) if isinstance(kw.get("stride", 1), int)
                else list(kw["stride"]),
                [kw.get("padding", 0)] * (x.dim() - 2) if isinstance(kw.get("padding", 0), int)
                else list(kw["padding"]),
                [kw.get("dilation", 1)] * (x.dim() - 2), transposed, [0] * (x.dim() - 2),
                kw.get("groups", 1))
        got = CV._FullF32Conv.apply(x, w, b, args)
        g = torch.randn(*want.shape, generator=gen)
        for a, c in zip(torch.autograd.grad(got, (x, w, b), g),
                        torch.autograd.grad(want, (x, w, b), g)):
            assert float((a - c).abs().max()) <= 1e-6 * float(c.abs().max())


# ------------------------------------------------------------ discriminators
@pytest.fixture(scope="module")
def discs():
    """usdm_tpu's MPD (the five default periods) and MRD (the three default
    resolutions) at d_mult 0.25, and the port's through the bridge."""
    kp, kr = jax.random.split(jax.random.PRNGKey(4))
    jmpd = [JBV.init_period_discriminator(k, p, d_mult=0.25)
            for k, p in zip(jax.random.split(kp, 5), JBV.DEFAULT_PERIODS)]
    jmrd = [JBV.init_resolution_discriminator(k, d_mult=0.25) for k in jax.random.split(kr, 3)]
    jmpd, jmrd = jax.device_get((jmpd, jmrd))
    return jmpd, jmrd, bridge.mpd_from_jax(jmpd), bridge.mrd_from_jax(jmrd)


def test_discriminators_discriminate_and_losses_match_jax(discs, rng):
    """Each period discriminator (T 4001: reflect-padded for every period
    but 1) and resolution discriminator, `discriminate` and the three
    losses on (real, fake): scores and feature maps (NHWC there, NCHW here)
    within 1e-5 of each tensor's peak + 1e-7, the losses within 1e-5
    relative (f32 both sides, the sums in another order).  usdm_tpu's side
    runs as one jit (op by op, XLA compiles each convolution apart)."""
    jmpd, jmrd, mpd, mrd = discs
    real = (rng.standard_normal((2, 1, 4001)) * 0.3).astype(np.float32)
    fake = (rng.standard_normal((2, 1, 4001)) * 0.3).astype(np.float32)

    @jax.jit
    def jax_side(jmpd, jmrd, real, fake):
        y_r, y_g, f_r, f_g = JBV.discriminate(jmpd, jmrd, JBV.DEFAULT_RESOLUTIONS, real, fake)
        return ([JBV.period_discriminator(jd, real, p) for jd, p in zip(jmpd, JBV.DEFAULT_PERIODS)],
                [JBV.resolution_discriminator(jd, real, r)
                 for jd, r in zip(jmrd, JBV.DEFAULT_RESOLUTIONS)], (y_r, y_g),
                (JBV.discriminator_loss(y_r, y_g)[0], JBV.generator_loss(y_g)[0],
                 JBV.feature_loss(f_r, f_g)))

    jper, jres, want, wloss = jax_side(jmpd, jmrd, jnp.asarray(real), jnp.asarray(fake))

    def same_maps(got, want):
        for g, w in zip(got, want):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            close(g, w, 0, 1e-5 * float(np.abs(w).max()) + 1e-7)

    for (ws, wf), d, p in zip(jper, mpd, JBV.DEFAULT_PERIODS):
        gs, gf = BV.period_discriminator(d, t(real), p)
        close(gs, ws, 0, 1e-5 * float(np.abs(ws).max()) + 1e-7)
        same_maps(gf, wf)
    for (ws, wf), d, r in zip(jres, mrd, JBV.DEFAULT_RESOLUTIONS):
        gs, gf = BV.resolution_discriminator(d, t(real), r)
        close(gs, ws, 0, 1e-5 * float(np.abs(ws).max()) + 1e-7)
        same_maps(gf, wf)
    got = BV.discriminate(mpd, mrd, BV.DEFAULT_RESOLUTIONS, t(real), t(fake))
    for gs, ws in zip(got[0] + got[1], want[0] + want[1]):
        close(gs, ws, 0, 1e-5 * float(np.abs(ws).max()) + 1e-7)
    pairs = zip((float(BV.discriminator_loss(got[0], got[1])[0]),
                 float(BV.generator_loss(got[1])[0]), float(BV.feature_loss(got[2], got[3]))),
                map(float, wloss))
    for g, w in pairs:
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)


# ----------------------------------------------------------------- GAN steps
def test_gan_steps_match_jax(rng):
    """One discriminator step, then one generator step, of the port and of
    usdm_tpu from the same GanTrainState (tiny BigVGAN, periods 2 and 3,
    one 256-point resolution) on the same batch: every metric within 1e-4
    relative; the moments (m = 0.2 g, v = 0.01 g^2 after one step) within
    1e-3 of each leaf's peak (the gradients' f32 sums in another order); the
    params within 2 lr (AdamW's first update is lr * g / (|g| + eps), so a
    gradient near eps or of flipped sign moves a weight by up to 2 lr) and
    99 % of them within lr / 100."""
    lr = 2e-4
    mesh = create_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    jstate, gopt, dopt = JV.init_state(TINY, jax.random.PRNGKey(0), lr=lr, periods=PERIODS)
    mel_loss = JMD.loss_mel_config(TINY_MEL)
    jd, jg = JV.make_train_steps(TINY, mesh, gopt, dopt, mel_loss, resolutions=TINY_RES,
                                 periods=PERIODS)
    state = bridge.gan_train_state_from_jax(jax.device_get(jstate))
    pd_, pg = V.make_train_steps(port_cfg(TINY), V.make_optimizer(lr), V.make_optimizer(lr),
                                 port_cfg(mel_loss), TINY_RES, PERIODS)
    frames = 32
    mel = (rng.standard_normal((2, TINY.num_mels, frames)) - 5.0).astype(np.float32)
    wav = (rng.standard_normal((2, 1, frames * TINY.total_upsample)) * 0.1).astype(np.float32)
    jbatch = {"mel": jnp.asarray(mel), "wav": jnp.asarray(wav)}
    batch = {"mel": t(mel), "wav": t(wav)}
    jstate, jdm = jd(jstate, jbatch)
    jstate, jgm = jg(jstate, jbatch)
    got = {**pd_(state, batch), **pg(state, batch)}
    for k, w in {**jdm, **jgm}.items():
        assert abs(float(got[k]) - float(w)) <= 1e-4 * abs(float(w)), (k, float(got[k]), float(w))
    want = bridge.gan_train_state_from_jax(jax.device_get(jstate))
    assert state.step == want.step == 1
    assert state.gen_opt.count == want.gen_opt.count == state.disc_opt.count == 1
    for opt, wopt in ((state.gen_opt, want.gen_opt), (state.disc_opt, want.disc_opt)):
        for g, w in zip(opt.m + opt.v, wopt.m + wopt.v):
            close(g, w, 0, 1e-3 * float(w.abs().max()) + 1e-12)
    diffs = np.concatenate([(g.detach() - w.detach()).abs().flatten().numpy() for g, w in
                            zip(tree_leaves(state.params), tree_leaves(want.params))])
    assert diffs.max() <= 2 * lr and np.quantile(diffs, 0.99) <= lr / 100


def test_gan_optimizer_schedule_matches_optax():
    """make_optimizer's learning rate against optax's exponential_decay(lr, 1000,
    decay**1000) at several counts: within 1e-6 relative (optax computes
    in f32)."""
    import optax

    sched = optax.exponential_decay(2e-4, transition_steps=1000, decay_rate=0.999**1000)
    opt = V.make_optimizer(2e-4, 0.999)
    for c in (0, 1, 7, 999, 1000, 12345):
        assert abs(opt.schedule(c) / float(sched(c)) - 1) <= 1e-6


# ---------------------------------------------------------------------- data
def test_dataset_crops_mels_and_fine_tuning_match_jax(corpus, tmp_path):
    """For one numpy seed the port's MelAudioDataset gives usdm_tpu's crops
    bit for bit (scratch mode: peak-normalized, padded short clips; fine-
    tuning mode: hop-aligned audio and mel crops from dump_base_mels' .npy
    files, which match usdm_tpu's within 1e-4); collate_mel_batch's mel
    within 1e-4 of usdm_tpu's (f32 STFTs); loss_mel_config is full band."""
    wavs, train = corpus
    files = MD.read_vocoder_filelist(train, wavs)
    assert files == JMD.read_vocoder_filelist(train, wavs)
    mc, jmc = PC.MelConfig(), MelConfig()
    ds, jds = MD.MelAudioDataset(files, 8192, mc), JMD.MelAudioDataset(files, 8192, jmc)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    items = [ds.__getitem__(i, r1) for i in range(len(files))]
    jitems = [jds.__getitem__(i, r2) for i in range(len(files))]
    for (w, m), (jw, jm) in zip(items, jitems):
        np.testing.assert_array_equal(w, jw)
        assert m is None and jm is None
    batch = MD.collate_mel_batch(items[:3], mc)
    jbatch = JMD.collate_mel_batch(jitems[:3], jmc)
    np.testing.assert_array_equal(batch["wav"].numpy(), np.asarray(jbatch["wav"]))
    close(batch["mel"], jbatch["mel"], 0, 1e-4)
    assert MD.loss_mel_config(mc).fmax == mc.sampling_rate / 2 == JMD.loss_mel_config(jmc).fmax
    assert MD.dump_base_mels(files, str(tmp_path / "m"), mc) == 9
    JMD.dump_base_mels(files, str(tmp_path / "jm"), jmc)
    for f in sorted(os.listdir(tmp_path / "m")):
        close(np.load(tmp_path / "m" / f), np.load(tmp_path / "jm" / f), 0, 1e-4)
    ft = MD.MelAudioDataset(files, 8192, mc, fine_tuning=True, base_mels_path=str(tmp_path / "m"))
    jft = JMD.MelAudioDataset(files, 8192, jmc, fine_tuning=True,
                              base_mels_path=str(tmp_path / "m"))
    r1, r2 = np.random.default_rng(2), np.random.default_rng(2)
    for i in range(len(files)):
        (w, m), (jw, jm) = ft.__getitem__(i, r1), jft.__getitem__(i, r2)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(m, jm)
        assert w.shape == (8192,) and m.shape == (mc.num_mels, 8192 // mc.hop_size)


# ----------------------------------------------------------------------- CLI
def _state(path, step):
    return torch.load(os.path.join(path, "checkpoints", f"step_{step}", "state.pt"),
                      map_location="cpu", weights_only=True)


def test_train_vocoder_tiny_resume_and_export(corpus, tmp_path):
    """cli.train_vocoder --tiny on the CPU, 9 clips at batch 4 (two steps an
    epoch): 5 steps uninterrupted against 3 steps then --resume to 5 (the
    checkpoint of step 3 lies inside epoch 1): the same step-5 state bit
    for bit (every param, both optimizers' moments and counts), and the
    same metrics for steps 4-5; every checkpoint is named by its global
    step, with its epoch; the --export dir loads back through load_bigvgan
    with every weight within 2^-21 of its scale (the weight-norm split and
    fold round each weight, by about an ulp) and every bias and snake
    parameter bit for bit; --device cuda raises without a card."""
    wavs, train = corpus
    common = ["--input_wavs_dir", wavs, "--input_training_file", train,
              "--input_validation_file", train, "--tiny", "--batch_size", "4",
              "--segment_size", "1024", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    exp = str(tmp_path / "exp")
    assert train_vocoder.main(common + ["--output_dir", a, "--max_steps", "5",
                                        "--export", exp]) == 0
    assert train_vocoder.main(common + ["--output_dir", b, "--max_steps", "3"]) == 0
    assert sorted(os.listdir(os.path.join(b, "checkpoints"))) == ["step_2", "step_3"]
    with open(os.path.join(b, "checkpoints", "step_3", "extra.json")) as f:
        assert json.load(f)["epoch"] == 1
    shutil.rmtree(os.path.join(b, "checkpoints", "step_2"))
    assert train_vocoder.main(common + ["--output_dir", b, "--max_steps", "5", "--resume"]) == 0
    sa, sb = _state(a, 5), _state(b, 5)
    ta = tree_leaves(sa["params"]) + [x for k in ("gen", "disc")
                                      for x in sa["opt_state"][k]["m"] + sa["opt_state"][k]["v"]]
    tb = tree_leaves(sb["params"]) + [x for k in ("gen", "disc")
                                      for x in sb["opt_state"][k]["m"] + sb["opt_state"][k]["v"]]
    assert sa["step"] == sb["step"] == 5 and len(ta) == len(tb)
    assert sa["opt_state"]["gen"]["count"] == sb["opt_state"]["disc"]["count"] == 5
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))

    def metrics(path):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            return {r["step"]: r for r in map(json.loads, f) if "train/gen_loss" in r}

    ma, mb = metrics(a), metrics(b)
    for s in (4, 5):
        assert all(ma[s][k] == mb[s][k] for k in ma[s] if k.startswith("train/")
                   and k != "train/step_s")
    loaded, cfg = CK.load_bigvgan(exp, device="cpu")
    assert cfg == port_cfg(TINY)
    trained = sa["params"]["gen"]
    for (path, g), w in zip(_named(loaded), tree_leaves(trained)):
        if path.endswith("w"):
            assert float((g - w).abs().max()) <= 2.0**-21 * float(w.abs().max()), path
        else:
            assert torch.equal(g, w), path
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vocoder.main(common[:-2] + ["--output_dir", str(tmp_path / "c")])


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]
