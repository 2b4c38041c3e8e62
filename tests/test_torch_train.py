"""The CFM training slice of usdm_tpu_torch against usdm_tpu, on the CPU.

Mel extraction, unit pooling, the unit-mel dataset and collate, the
estimator (bf16 params; fused LayerNorm, flash attention and remat), the CFM
loss and its gradients, the optimizer and whole train steps are held to their
usdm_tpu counterparts on the same inputs (numpy generators; the same weights
through usdm_tpu_torch.core.bridge; the same t and z).  JAX runs under
`highest` matmul precision, Pallas in interpret mode.  Then the trainer CLI
runs end to end at --tiny on the CPU.  Tolerances are stated at each assert.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from usdm_tpu.audio import mel as JMEL
from usdm_tpu.audio import units as JUN
from usdm_tpu.audio.wav import write_wav
from usdm_tpu.core.config import CfmTrainConfig, MelConfig, VoiceboxConfig
from usdm_tpu.data import unit_mel as JUM
from usdm_tpu.models import voicebox as JVB
from usdm_tpu.train import cfm as JC
from usdm_tpu_torch.audio import mel as MEL
from usdm_tpu_torch.audio import units as UN
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import checkpoint as CK
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.core.tree import tree_leaves, tree_map
from usdm_tpu_torch.data import unit_mel as UM
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.train import cfm as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def interpret_highest(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    with jax.default_matmul_precision("highest"):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


def port_cfg(jcfg):
    """The port's config of the same fields as a usdm_tpu config."""
    return getattr(PC, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def close_trees(got, want_jax, rtol, atol_frac):
    """Leaves of a port params tree against a usdm_tpu pytree (carried over
    by the bridge): each within rtol, plus atol_frac of the leaf's largest
    magnitude, plus 1e-6 of the largest magnitude in the whole tree, for
    leaves that are zero in exact arithmetic and hold only rounding noise
    (the key bias's gradient: softmax ignores a per-row constant)."""
    want = [w.numpy() for w in tree_leaves(bridge.voicebox_from_jax(jax.device_get(want_jax)))]
    got = tree_leaves(got)
    assert len(got) == len(want)
    floor = 1e-6 * max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=rtol,
                                   atol=atol_frac * np.abs(w).max() + floor)


# ----------------------------------------------------------------- audio, data
def test_mel_matches_jax(rng):
    """Same frame count exactly; log-mel within 1e-4 (f32 FFTs of two
    libraries, log of values clipped at 1e-5)."""
    mc = MelConfig()
    for n in (22050, 22050 + 37, 5 * 256):
        wav = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
        want = np.asarray(JMEL.mel_for_config(jnp.asarray(wav), mc))
        got = MEL.mel_for_config(t(wav), port_cfg(mc)).numpy()
        assert got.shape == want.shape == (2, mc.num_mels, n // mc.hop_size)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    pmc = port_cfg(mc)
    assert MEL.denormalize_mel(MEL.normalize_mel(1.5, pmc), pmc) == pytest.approx(1.5)


def test_expand_durations_and_pool_exact(rng):
    for n in (1, 7, 60):
        units = rng.integers(0, 40, n)
        durs = rng.integers(1, 5, n)
        got, got_len = UN.expand_durations_and_pool(units, durs)
        want, want_len = JUN.expand_durations_and_pool(units, durs)
        assert got_len == want_len
        np.testing.assert_array_equal(got, np.asarray(want))


def _filelist(tmp_path, rng, n_items, seconds, n_tokens=32):
    """Noise wavs at 22.05 kHz and a filelist of random units and durations
    covering each clip."""
    lines = []
    for i in range(n_items):
        n = int(22050 * rng.uniform(*seconds))
        path = str(tmp_path / f"clip{i}.wav")
        write_wav(path, (rng.standard_normal(n) * 0.1).astype(np.float32), 22050)
        units, durs = [], []
        while sum(durs) * 441 < n:
            units.append(int(rng.integers(0, n_tokens)))
            durs.append(int(rng.integers(1, 4)))
        lines.append(f"{path}|{' '.join(map(str, units))}|{' '.join(map(str, durs))}")
    path = tmp_path / "list.txt"
    path.write_text("\n".join(lines))
    return str(path)


def test_unit_mel_batches_match_jax(tmp_path, rng):
    """One seed gives the same batches: units, context masks and lengths
    exactly, mels within 1e-4 / 2.1575 (normalized log-mel)."""
    filelist = _filelist(tmp_path, rng, 6, (0.6, 1.6))
    tc = CfmTrainConfig(out_size_seconds=1)  # 86 frames: the longer clips are cropped
    mc = MelConfig()
    ds, jds = UM.UnitMelDataset(filelist, port_cfg(mc), 32), JUM.UnitMelDataset(filelist, mc, 32)
    items = [ds[i] for i in range(len(ds))]
    for (u, m), (ju, jm) in zip(items, (jds[i] for i in range(len(jds)))):
        np.testing.assert_array_equal(u, ju)
        assert m.shape == jm.shape
        np.testing.assert_allclose(m, jm, rtol=0, atol=1e-4)
    col = UM.UnitMelCollate(port_cfg(tc), port_cfg(mc), 32)
    jcol = JUM.UnitMelCollate(tc, mc, 32)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for evaluation in (False, False, True):
        got = col(items, rng_a, evaluation)
        want = jcol(items, rng_b, evaluation)
        for key in ("x", "mask", "y_lengths"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-4)
    assert rng_a.random() == rng_b.random()  # both consumed the generator alike


# ----------------------------------------------------------------- estimator
@pytest.fixture(scope="module")
def vb():
    cfg = VoiceboxConfig.tiny()
    with jax.default_matmul_precision("highest"):
        jp = JVB.init_params(cfg, jax.random.PRNGKey(2))
    return cfg, jp


def _est_inputs(rng, cfg, b=2, tlen=30):
    return (rng.integers(0, cfg.n_tokens + 1, size=(b, tlen)).astype(np.int32),
            rng.standard_normal((b, cfg.n_feats, tlen)).astype(np.float32),
            rng.standard_normal((b, cfg.n_feats, tlen)).astype(np.float32),
            rng.uniform(size=b).astype(np.float32),
            np.asarray([tlen, 19], np.int32)[:b])


def test_estimator_bf16_params_match_jax(vb, rng):
    """bf16 compute over bf16 params, as a bf16 train step runs it: the
    estimator casts every floating leaf and input to the dtype of
    proj_in_w.  Output dtype bf16; within 2^-5 * max|want| + 1e-3 of the JAX
    estimator on the same bf16 params (bf16 rounds at other places in the
    two frameworks: erf-GELU in one op here, five there)."""
    cfg, jp = vb
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    x, y, cond, tt, lens = _est_inputs(rng, cfg)
    want = JVB.estimator(jp16, cfg, *(jnp.asarray(a) for a in (x, y, cond, tt, lens)),
                         attn_impl="xla", fused_ln="xla")
    tp = tree_map(lambda a: a.to(torch.bfloat16), bridge.voicebox_from_jax(jax.device_get(jp16)))
    got = VB.estimator(tp, port_cfg(cfg), t(x).long(), t(y), t(cond), t(tt), t(lens).long())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0**-5 * np.abs(want).max() + 1e-3, err


@pytest.mark.parametrize("attn,fused,remat", [("flash", "fused", True), ("plain", "fused", False),
                                              ("flash", "plain", True)])
def test_estimator_paths_match_jax(vb, rng, attn, fused, remat):
    """f32: the port's flash (plain versions of K2 and K5 on the CPU), fused
    LayerNorm (plain versions of K4's forward and backward) and remat paths
    against usdm_tpu's estimator on its own flash + fused + remat path
    (Pallas interpret), forward and parameter gradients of sum(out * w):
    outputs within 1e-4, each gradient leaf within 1e-4 relative plus 1e-4 of
    its largest magnitude (f32 through 4 layers)."""
    cfg, jp = vb
    x, y, cond, tt, lens = _est_inputs(rng, cfg)
    w = rng.standard_normal(y.shape).astype(np.float32)
    jin = [jnp.asarray(a) for a in (x, y, cond, tt, lens)]

    def jfwd(p):
        return JVB.estimator(p, cfg, *jin, remat=True, attn_impl="flash", fused_ln="fused")

    want = jfwd(jp)
    want_grads = jax.grad(lambda p: jnp.sum(jfwd(p) * w))(jp)
    tp = tree_map(lambda a: a.requires_grad_(), bridge.voicebox_from_jax(jax.device_get(jp)))
    got = VB.estimator(tp, port_cfg(cfg), t(x).long(), t(y), t(cond), t(tt), t(lens).long(), remat=remat,
                       attn_impl=attn, fused_ln=fused)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    (got * t(w)).sum().backward()
    close_trees(tree_map(lambda a: a.grad, tp), want_grads, rtol=1e-4, atol_frac=1e-4)


def test_estimator_casts_ln_lengths_once(vb, rng, monkeypatch):
    """The fused-LN path hands K4 int32 lengths, one tensor made once per
    forward, so the K4 wrapper's cast is a no-op and not a launch per call;
    the caller's int64 lengths are accepted as before."""
    cfg, jp = vb
    x, y, cond, tt, lens = _est_inputs(rng, cfg)
    seen, real = [], VB.add_mask_ln

    def spy(xx, r, lengths, *args, **kwargs):
        seen.append(lengths)
        return real(xx, r, lengths, *args, **kwargs)

    monkeypatch.setattr(VB, "add_mask_ln", spy)
    tp = bridge.voicebox_from_jax(jax.device_get(jp))
    VB.estimator(tp, port_cfg(cfg), t(x).long(), t(y), t(cond), t(tt), t(lens).long(),
                 fused_ln="fused")
    assert len(seen) == 2 * cfg.num_layers
    assert all(s.dtype == torch.int32 for s in seen) and len({id(s) for s in seen}) == 1


def _train_batch(rng, cfg, b=2, tlen=24):
    mask = np.zeros((b, 1, tlen), np.float32)
    mask[0, 0, 3:9] = 1.0  # context frames in row 0
    return {"x": rng.integers(0, cfg.n_tokens, (b, tlen)).astype(np.int32),
            "mask": mask,
            "y": rng.standard_normal((b, cfg.n_feats, tlen)).astype(np.float32),
            "y_lengths": np.asarray([tlen, 17], np.int32)[:b]}


def _tz(rng, cfg, batch):
    b, _, tlen = batch["y"].shape
    return (rng.uniform(size=b).astype(np.float32),
            rng.standard_normal((b, cfg.n_feats, tlen)).astype(np.float32))


def _torch_batch(batch):
    return {"x": t(batch["x"]).long(), "mask": t(batch["mask"]), "y": t(batch["y"]),
            "y_lengths": t(batch["y_lengths"]).long()}


def test_cfm_loss_and_grads_match_jax(vb, rng):
    """cfm_loss (remat on) and its parameter gradients against
    jax.value_and_grad of usdm_tpu's cfm_loss, same t and z: loss within
    1e-5 relative, each gradient leaf within 1e-4 relative plus 1e-4 of its
    largest magnitude (f32 sums in other orders)."""
    cfg, jp = vb
    batch = _train_batch(rng, cfg)
    tt, z = _tz(rng, cfg, batch)

    def jloss(p):
        return JVB.cfm_loss(p, cfg, jnp.asarray(batch["x"]), jnp.asarray(batch["mask"]),
                            jnp.asarray(batch["y"]), jnp.asarray(batch["y_lengths"]),
                            jax.random.PRNGKey(0), t=jnp.asarray(tt), z=jnp.asarray(z))[0]

    want_loss, want_grads = jax.value_and_grad(jloss)(jp)
    tp = tree_map(lambda a: a.requires_grad_(), bridge.voicebox_from_jax(jax.device_get(jp)))
    tb = _torch_batch(batch)
    loss, aux = VB.cfm_loss(tp, port_cfg(cfg), tb["x"], tb["mask"], tb["y"], tb["y_lengths"], t=t(tt),
                            z=t(z))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(aux["nframes"]) == 24 + 17 - 6
    close_trees(tree_map(lambda a: a.grad, tp), want_grads, rtol=1e-4, atol_frac=1e-4)


def test_optimizer_matches_optax(rng):
    """Three steps of clip_by_global_norm(0.2) + adam with the clip engaged
    (gradient norms 6-9), at a learning rate of 0.1 so the updates dominate:
    parameters within 1e-5 of optax, pre-clip norms within 1e-6 relative."""
    tc = CfmTrainConfig(learning_rate=0.1)
    shapes = {"w": (5, 7), "layers": [{"a": (7,)}, {"a": (7,)}], "b": (3, 2, 4)}
    init = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda s: (rng.standard_normal(s) * 2).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple)) for _ in range(3)]
    jopt = JC.make_optimizer(tc)
    jp = jax.tree.map(jnp.asarray, init)
    jst = jopt.init(jp)
    opt = C.make_optimizer(port_cfg(tc))
    tp = tree_map(lambda a: t(a).requires_grad_(), init)
    adam = opt.init(tp)
    for g in grads:
        upd, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gg in zip(tree_leaves(tp), tree_leaves(tree_map(t, g))):
            p.grad = gg
        norm = opt.update(adam)
        want_norm = float(optax.global_norm(g))
        assert want_norm > 5 * tc.grad_clip
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        assert all(p.grad is None for p in tree_leaves(tp))
    for p, w in zip(tree_leaves(tp), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_train_steps_match_jax(vb, rng):
    """Three f32 train steps (remat, clip, Adam) on one batch with the same
    t and z against a JAX step built from usdm_tpu's make_optimizer and
    cfm_loss: losses within 1e-4 relative, parameters within 1e-5."""
    cfg, jp = vb
    tc = CfmTrainConfig()
    batch = _train_batch(rng, cfg)
    tz = [_tz(rng, cfg, batch) for _ in range(3)]
    jopt = JC.make_optimizer(tc)
    jst = jopt.init(jp)
    jparams = jp
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p, tt, z):
        return JVB.cfm_loss(p, cfg, jb["x"], jb["mask"], jb["y"], jb["y_lengths"],
                            jax.random.PRNGKey(0), t=tt, z=z)[0]

    opt = C.make_optimizer(port_cfg(tc))
    params = tree_map(lambda a: a.requires_grad_(), bridge.voicebox_from_jax(jax.device_get(jp)))
    state = C.CfmTrainState(params, opt.init(params), 0)
    step = C.make_train_step(port_cfg(cfg), port_cfg(tc), opt, compute_dtype="float32")
    tb = _torch_batch(batch)
    for tt, z in tz:
        want_loss, g = jax.value_and_grad(jloss)(jparams, jnp.asarray(tt), jnp.asarray(z))
        upd, jst = jopt.update(g, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        m = step(state, tb, t=t(tt), z=t(z))
        assert float(m["loss"]) == pytest.approx(float(want_loss), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(optax.global_norm(g)), rel=1e-4)
    assert state.step == 3
    for p, w in zip(tree_leaves(state.params),
                    tree_leaves(bridge.voicebox_from_jax(jax.device_get(jparams)))):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=0, atol=1e-5)


# ----------------------------------------------------------------- checkpoints, CLI
def test_checkpoint_keeps_two_and_restores(tmp_path):
    cfg, tc = PC.VoiceboxConfig.tiny(), PC.CfmTrainConfig()
    state, opt = C.init_state(cfg, tc, "cpu", torch.Generator().manual_seed(0))
    for step in (1, 2, 3):
        state.step = step
        CK.save_train_state(str(tmp_path), state, step)
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    assert CK.latest_step(str(tmp_path)) == 3
    fresh, _ = C.init_state(cfg, tc, "cpu", torch.Generator().manual_seed(1))
    CK.restore_train_state(str(tmp_path), fresh)
    assert fresh.step == 3
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    assert CK.latest_step(str(tmp_path / "none")) is None


def _cli_args(tmp_path, filelist, *extra):
    return ["--train_filelist", filelist, "--valid_filelist", filelist, "--output_dir",
            str(tmp_path / "out"), "--tiny", "--device", "cpu", "--batch_size", "2", *extra]


def _metrics(tmp_path):
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_tiny_cpu_trains_and_resumes(tmp_path, rng):
    """--tiny --device cpu --max_steps 3 runs in a process that never
    imports jax and writes a checkpoint; --resume continues from it to step
    5.  Eval and the Euler synthesis smoke test run at each epoch end."""
    filelist = _filelist(tmp_path, rng, 4, (0.8, 1.5))
    code = ("import sys; from usdm_tpu_torch.cli import train_voicebox as T; "
            f"T.main({_cli_args(tmp_path, filelist, '--max_steps', '3')!r}); "
            "assert 'jax' not in sys.modules, 'jax was imported'")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpt_dir = str(tmp_path / "out" / "checkpoints")
    assert CK.latest_step(ckpt_dir) == 3
    rec = _metrics(tmp_path)
    train = [r for r in rec if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) and r["train/step_s"] >= 0 for r in train)
    assert any("eval/loss" in r for r in rec) and any("smoke/synth_mel_mean" in r for r in rec)

    from usdm_tpu_torch.cli import train_voicebox as T

    assert T.main(_cli_args(tmp_path, filelist, "--max_steps", "5", "--resume")) == 0
    assert CK.latest_step(ckpt_dir) == 5
    assert [r["step"] for r in _metrics(tmp_path) if "train/loss" in r] == [1, 2, 3, 4, 5]


def test_cli_refuses_missing_cuda_and_unported_flags(tmp_path):
    """Without a card the default device raises, with or without the flags
    that were refused before their exporter and loader existed
    (--export_hub, --bigvgan_dir: test_cli_exports_hub_and_vocodes_smoke)."""
    from usdm_tpu_torch.cli import train_voicebox as T

    base = ["--train_filelist", "x", "--output_dir", str(tmp_path)]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for extra in ([], ["--export_hub", str(tmp_path / "hub")], ["--bigvgan_dir", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.main(base + extra)


def _by_path(tree, prefix=""):
    """{"a.0.b": leaf} of a params tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_by_path(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def test_cli_exports_hub_and_vocodes_smoke(tmp_path, rng):
    """--export_hub writes a HubMixin dir that load_voicebox (and
    usdm_tpu's) reads back to the trained params; --bigvgan_dir vocodes the
    epoch's synthesis smoke test into a finite wav through log_audio."""
    from usdm_tpu.core import checkpoint as JCK
    from usdm_tpu_torch.cli import train_voicebox as T
    from usdm_tpu_torch.models import bigvgan as BV

    bv_cfg = PC.BigVGANConfig.tiny().replace(num_mels=80)
    CK.save_bigvgan_generator(str(tmp_path / "bv"), BV.init_generator(
        bv_cfg, torch.Generator().manual_seed(0)), bv_cfg)
    filelist = _filelist(tmp_path, rng, 4, (0.8, 1.5))
    hub = str(tmp_path / "hub")
    assert T.main(_cli_args(tmp_path, filelist, "--max_steps", "3", "--export_hub", hub,
                            "--bigvgan_dir", str(tmp_path / "bv"))) == 0
    trained = torch.load(tmp_path / "out" / "checkpoints" / "step_3" / "state.pt",
                         weights_only=True)["params"]
    back, cfg = CK.load_voicebox(hub, device="cpu")
    assert cfg == PC.VoiceboxConfig.tiny().replace(n_feats=80)
    # every leaf bit-equal but the positional convs, folded back from
    # weight-norm's (g = ||w||, v = w): within 1e-6 of each weight
    flat_t, flat_b = _by_path(trained), _by_path(back)
    assert sorted(flat_t) == sorted(flat_b)
    for k, a in flat_t.items():
        if k.startswith("convpos_w"):
            torch.testing.assert_close(flat_b[k], a, rtol=1e-6, atol=0)
        else:
            assert torch.equal(flat_b[k], a), k
    jp, _ = JCK.load_voicebox(hub)
    for k, a in _by_path(bridge.voicebox_from_jax(jax.device_get(jp))).items():
        assert torch.equal(a, flat_b[k]), k
    wavs = sorted(p for p in os.listdir(tmp_path / "out") if p.startswith("audio_smoke_audio_"))
    assert wavs == ["audio_smoke_audio_2.wav"], wavs
    from usdm_tpu_torch.audio.wav import load_wav

    audio, sr = load_wav(str(tmp_path / "out" / wavs[0]), sr=None)
    assert sr == 22050 and len(audio) and len(audio) % bv_cfg.total_upsample == 0
    assert np.isfinite(audio).all()
