"""UsdmPipeline.from_pretrained and `python -m usdm_tpu_torch.cli.infer`
against usdm_tpu's, on the CPU.

(1) Full geometry: checkpoint directories in each reference format at the
real widths (42,003-token vocab, 4096-wide LM, 1280-wide XLS-R, 1024/1280
Voicebox, 1536-channel BigVGAN), 2 layers each, written as usdm_tpu's
tests/test_from_pretrained.py writes them (its writers, copied): the port's
params equal usdm_tpu's through the bridge, with the defaults (bf16 LM,
W8A8 Voicebox).  No turn runs at that size.

(2) A small turn: a tiny_random port pipeline goes out through the port's
exporters (XLS-R as an HF Wav2Vec2Model directory by chip_smoke.py's
`save_xlsr`: usdm_tpu has no XLS-R exporter) and back
through from_pretrained(device="cpu"): its turn's tokens equal the source
pipeline's and usdm_tpu's from_pretrained on the same directories, and its
synthesis from a shared initial noise lies within the stated bounds of
both.  Then cli.infer runs with --demo and on those directories.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

st_np = pytest.importorskip("safetensors.numpy")
st_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

from usdm_tpu.audio.units import expand_and_pool  # noqa: E402
from usdm_tpu.audio.wav import ceil_to, write_wav  # noqa: E402
from usdm_tpu.core.tokenizer import UsdmTokenizer as JaxTokenizer  # noqa: E402
from usdm_tpu.pipeline import UsdmPipeline as JaxPipeline  # noqa: E402
from usdm_tpu_torch.core import bridge  # noqa: E402
from usdm_tpu_torch.core import checkpoint as CK  # noqa: E402
from usdm_tpu_torch.pipeline import UsdmPipeline  # noqa: E402
from chip_smoke import save_xlsr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _tree_equal(a, b, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


# ------------------------------------------- usdm_tpu's writers, copied
def _write_llm_dir(d):
    """HF-Mistral dir at USDM-7B widths, 2 layers, f16 safetensors."""
    V, H, F, HKV = 42003, 4096, 14336, 8 * 128
    cfg = {
        "vocab_size": V, "hidden_size": H, "intermediate_size": F,
        "num_hidden_layers": 2, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "sliding_window": 4096,
    }
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(0)

    def r(*shape, scale=0.02):
        return (rng.standard_normal(shape, np.float32) * scale).astype(np.float16)

    sd = {"model.embed_tokens.weight": r(V, H), "lm_head.weight": r(V, H),
          "model.norm.weight": np.ones(H, np.float16)}
    for i in range(2):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = np.ones(H, np.float16)
        sd[f"{p}.post_attention_layernorm.weight"] = np.ones(H, np.float16)
        sd[f"{p}.self_attn.q_proj.weight"] = r(H, H)
        sd[f"{p}.self_attn.k_proj.weight"] = r(HKV, H)
        sd[f"{p}.self_attn.v_proj.weight"] = r(HKV, H)
        sd[f"{p}.self_attn.o_proj.weight"] = r(H, H)
        sd[f"{p}.mlp.gate_proj.weight"] = r(F, H)
        sd[f"{p}.mlp.up_proj.weight"] = r(F, H)
        sd[f"{p}.mlp.down_proj.weight"] = r(H, F)
    st_np.save_file(sd, str(d / "model.safetensors"))
    JaxTokenizer.build_synthetic_full().save(str(d))
    (d / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 8192}))


def _write_xlsr_dir(d, kmeans_path):
    """HF Wav2Vec2Model at xlsr2_1b_v2 widths (1280 hidden), 2 layers."""
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    hf_cfg = Wav2Vec2Config(
        vocab_size=32, hidden_size=1280, num_hidden_layers=2,
        num_attention_heads=16, intermediate_size=5120,
        conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
        conv_stride=[5, 2, 2, 2, 2, 2, 2],
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
        apply_spec_augment=False,
    )
    torch.manual_seed(0)
    Wav2Vec2Model(hf_cfg).eval().save_pretrained(d)
    cents = np.random.default_rng(1).standard_normal((10000, 1280)).astype(np.float32)
    np.save(kmeans_path, cents)


def _write_voicebox_dir(d):
    """HubMixin dir at real widths (E=1280, H=1024, F=4096), 2 layers."""
    L, H, F, E, nf = 2, 1024, 4096, 1280, 80
    cfg = {
        "n_feats": nf, "n_tokens": 10000, "embedding_dim": E,
        "hidden_size": H, "intermediate_size": F, "num_attention_heads": 16,
        "num_hidden_layers": L, "convpos_width": 31, "convpos_groups": 16,
        "convpos_depth": 2, "sigma_min": 1e-4,
    }
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg))
    torch.manual_seed(1)

    def r(*shape):
        return torch.randn(*shape) * 0.02

    sd = {
        "estimator.embed.weight": r(10001, E),
        "estimator.proj_in.weight": r(H, 2 * nf + E, 1),
        "estimator.proj_in.bias": r(H),
        "estimator.proj_out.weight": r(nf, H, 1),
        "estimator.proj_out.bias": r(nf),
        "estimator.layer_norm.weight": torch.ones(H),
        "estimator.layer_norm.bias": torch.zeros(H),
    }
    for i in range(2):
        sd[f"estimator.pos_conv_embeds.{i}.conv.weight_g"] = torch.rand(1, 1, 31) + 0.5
        sd[f"estimator.pos_conv_embeds.{i}.conv.weight_v"] = r(H, H // 16, 31)
        sd[f"estimator.pos_conv_embeds.{i}.conv.bias"] = r(H)
    for i in range(L):
        for nm in ["q_proj", "k_proj", "v_proj", "out_proj"]:
            sd[f"estimator.layers.{i}.attention.{nm}.weight"] = r(H, H)
            sd[f"estimator.layers.{i}.attention.{nm}.bias"] = r(H)
        sd[f"estimator.layers.{i}.layer_norm.weight"] = torch.ones(H)
        sd[f"estimator.layers.{i}.layer_norm.bias"] = torch.zeros(H)
        sd[f"estimator.layers.{i}.final_layer_norm.weight"] = torch.ones(H)
        sd[f"estimator.layers.{i}.final_layer_norm.bias"] = torch.zeros(H)
        sd[f"estimator.layers.{i}.feed_forward.intermediate_dense.weight"] = r(F, H)
        sd[f"estimator.layers.{i}.feed_forward.intermediate_dense.bias"] = r(F)
        sd[f"estimator.layers.{i}.feed_forward.output_dense.weight"] = r(H, F)
        sd[f"estimator.layers.{i}.feed_forward.output_dense.bias"] = r(H)
    for i in range(L // 2):
        sd[f"estimator.skip_connections_layers.{i}.weight"] = r(H, 2 * H)
        sd[f"estimator.skip_connections_layers.{i}.bias"] = r(H)
    torch.save(sd, d / "pytorch_model.bin")


def _write_bigvgan_dir(d):
    """nvidia/bigvgan_22khz_80band geometry (1536 initial channels)."""
    from usdm_tpu.core.config import BigVGANConfig

    cfg = BigVGANConfig()
    h = {
        "num_mels": cfg.num_mels,
        "upsample_initial_channel": cfg.upsample_initial_channel,
        "upsample_rates": list(cfg.upsample_rates),
        "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
        "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(x) for x in cfg.resblock_dilation_sizes],
        "resblock": cfg.resblock, "activation": cfg.activation,
        "snake_logscale": cfg.snake_logscale, "sampling_rate": cfg.sampling_rate,
    }
    d.mkdir()
    (d / "config.json").write_text(json.dumps(h))
    torch.manual_seed(2)
    sd = {}
    ch0 = cfg.upsample_initial_channel

    def wn(prefix, shape, bias_dim):
        sd[prefix + ".weight_v"] = torch.randn(*shape) * 0.02
        sd[prefix + ".weight_g"] = torch.rand(shape[0], *([1] * (len(shape) - 1))) + 0.5
        sd[prefix + ".bias"] = torch.randn(bias_dim) * 0.02

    wn("conv_pre", (ch0, cfg.num_mels, 7), ch0)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin, cout = ch0 // (2**i), ch0 // (2 ** (i + 1))
        wn(f"ups.{i}.0", (cin, cout, k), cout)
        for j, kernel in enumerate(cfg.resblock_kernel_sizes):
            r = i * nk + j
            for ci in range(len(cfg.resblock_dilation_sizes[j])):
                wn(f"resblocks.{r}.convs1.{ci}", (cout, cout, kernel), cout)
                wn(f"resblocks.{r}.convs2.{ci}", (cout, cout, kernel), cout)
            for ai in range(2 * len(cfg.resblock_dilation_sizes[j])):
                sd[f"resblocks.{r}.activations.{ai}.act.alpha"] = torch.randn(cout)
                sd[f"resblocks.{r}.activations.{ai}.act.beta"] = torch.randn(cout)
    ch_last = ch0 // (2 ** len(cfg.upsample_rates))
    sd["activation_post.act.alpha"] = torch.randn(ch_last)
    sd["activation_post.act.beta"] = torch.randn(ch_last)
    wn("conv_post", (1, ch_last, 7), 1)
    torch.save({"generator": sd}, d / "bigvgan_generator.pt")


def _bridged(jpipe, dtype):
    host = jax.device_get
    d = jpipe.decoder
    return {"lm": bridge.mistral_from_jax(host(jpipe.lm_params), dtype=dtype),
            "xlsr": bridge.xlsr_from_jax(host(jpipe.xlsr_params)),
            "vb": bridge.voicebox_from_jax(host(d.voicebox_params)),
            "bv": bridge.bigvgan_from_jax(host(d.vocoder_params))}


def _ours(pipe):
    d = pipe.decoder
    return {"lm": pipe.lm_params, "xlsr": pipe.xlsr_params, "vb": d.voicebox_params,
            "bv": d.vocoder_params}


def _same_configs(pipe, jpipe):
    for ours, theirs in ((pipe.lm_cfg, jpipe.lm_cfg), (pipe.xlsr_cfg, jpipe.xlsr_cfg),
                         (pipe.decoder.voicebox_cfg, jpipe.decoder.voicebox_cfg),
                         (pipe.decoder.vocoder_cfg, jpipe.decoder.vocoder_cfg)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert pipe.tokenizer.ts.__dict__ == jpipe.tokenizer.ts.__dict__
    assert pipe.tokenizer.vocab_size == jpipe.tokenizer.vocab_size


def test_from_pretrained_full_geometry(tmp_path):
    """The defaults (bf16 LM, W8A8 Voicebox): every tensor bit-equal to
    usdm_tpu's params through the bridge, the configs and token space the
    same."""
    _write_llm_dir(tmp_path / "llm")
    _write_xlsr_dir(tmp_path / "xlsr", tmp_path / "kmeans.npy")
    _write_voicebox_dir(tmp_path / "vb")
    _write_bigvgan_dir(tmp_path / "bv")
    dirs = dict(llm_dir=str(tmp_path / "llm"), xlsr_dir=str(tmp_path / "xlsr"),
                kmeans_path=str(tmp_path / "kmeans.npy"), voicebox_dir=str(tmp_path / "vb"),
                bigvgan_dir=str(tmp_path / "bv"))
    pipe = UsdmPipeline.from_pretrained(**dirs, device="cpu")
    assert pipe.lm_cfg.vocab_size == 42003 and pipe.lm_params["embed"].dtype == torch.bfloat16
    jpipe = JaxPipeline.from_pretrained(**dirs)
    _same_configs(pipe, jpipe)
    want = _bridged(jpipe, torch.bfloat16)
    del jpipe
    _tree_equal(_ours(pipe), want)


# ------------------------------------------------------------ small turn
@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A tiny random port pipeline and its checkpoint directories: the
    configs of tiny_random, but the full 10,000-unit token space (the one
    UsdmTokenizer.load appends) and a Voicebox that embeds all of it."""
    from usdm_tpu_torch.core import config as C
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer

    root = tmp_path_factory.mktemp("ckpts")
    tok = UsdmTokenizer.build_test(num_units=10000)
    src = UsdmPipeline.random_init(
        tok, C.MistralConfig.tiny(vocab_size=tok.vocab_size),
        C.XlsrConfig.tiny().replace(num_clusters=32),
        C.VoiceboxConfig.tiny().replace(n_tokens=10000, n_feats=80),
        C.BigVGANConfig.tiny().replace(num_mels=80), device="cpu", seed=2, max_new_tokens=16)
    CK.save_mistral_hf(str(root / "llm"), src.lm_params, src.lm_cfg, src.tokenizer,
                       save_dtype="float32")
    save_xlsr(str(root / "xlsr"), src.xlsr_params, src.xlsr_cfg, layout="hf")
    np.save(root / "xlsr" / "kmeans.npy", src.xlsr_params["centroids"].numpy())
    CK.save_voicebox_hub(str(root / "vb"), src.decoder.voicebox_params,
                         src.decoder.voicebox_cfg)
    CK.save_bigvgan_generator(str(root / "bv"), src.decoder.vocoder_params,
                              src.decoder.vocoder_cfg)
    dirs = dict(llm_dir=str(root / "llm"), xlsr_dir=str(root / "xlsr"),
                kmeans_path=str(root / "xlsr" / "kmeans.npy"), voicebox_dir=str(root / "vb"),
                bigvgan_dir=str(root / "bv"))
    wav = str(root / "user.wav")
    write_wav(wav, (np.random.default_rng(5).standard_normal(16000) * 0.1).astype(np.float32),
              16000)
    yield src, dirs, wav
    src.close()


def _tiny(pipe, src_xlsr_cfg):
    """The tiny pipeline's tap layer and stage budget (its configs' own;
    config.json files carry neither)."""
    return dataclasses.replace(pipe, xlsr_cfg=pipe.xlsr_cfg.replace(
        output_layer=src_xlsr_cfg.output_layer), max_new_tokens=16)


def _synth(pipe, units, z):
    return pipe.decoder.synthesize(units, z=torch.from_numpy(z.copy()), n_timesteps=6)


def test_small_turn_round_trip(exported):
    """from_pretrained(device="cpu") on the exported directories: the f32
    stack (vb_int8=False) gives the source pipeline's turn and, from one
    initial noise, its synthesis within 1e-5 of the peak (the folded
    weight norms round each weight by an ulp or so); with the default
    vb_int8=True, usdm_tpu's from_pretrained on the same directories gives
    the same tokens and a synthesis within usdm_tpu's own W8A8 drift from
    its f32 synthesis (the bound of tests/test_torch_quant.py)."""
    src, dirs, wav = exported
    f32 = _tiny(UsdmPipeline.from_pretrained(**dirs, lm_dtype="float32", vb_int8=False,
                                             device="cpu"), src.xlsr_cfg)
    want = src.respond(wav, n_timesteps=4, seed=3)
    got = f32.respond(wav, n_timesteps=4, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.agent_units, "degenerate turn: no agent units"
    units = np.random.default_rng(4).integers(0, 10000, size=60).tolist()
    n = len(expand_and_pool(np.asarray(units))[0])
    z = np.random.default_rng(6).standard_normal(
        (1, 80, ceil_to(n, src.decoder.frame_bucket))).astype(np.float32)
    a, b = _synth(f32, units, z), _synth(src, units, z)
    peak = np.abs(b).max()
    assert peak > 0
    np.testing.assert_allclose(a, b, atol=1e-5 * peak, rtol=0)
    f32.close()

    dflt = _tiny(UsdmPipeline.from_pretrained(**dirs, lm_dtype="float32", device="cpu"),
                 src.xlsr_cfg)
    with jax.default_matmul_precision("highest"):
        jpipe = JaxPipeline.from_pretrained(**dirs, lm_dtype="float32")
        jpipe = dataclasses.replace(jpipe, xlsr_cfg=jpipe.xlsr_cfg.replace(
            output_layer=src.xlsr_cfg.output_layer), max_new_tokens=16)
        jres = jpipe.respond(wav, n_timesteps=4, seed=3)
        key = jax.random.PRNGKey(11)
        jz = np.asarray(jax.random.normal(jax.random.split(key)[0], z.shape, jnp.float32))
        jwav = jpipe.decoder.synthesize(units, key, n_timesteps=6)
        jf32 = JaxPipeline.from_pretrained(**dirs, lm_dtype="float32", vb_int8=False)
        jwav_f32 = jf32.decoder.synthesize(units, key, n_timesteps=6)
    assert dataclasses.asdict(dflt.respond(wav, n_timesteps=4, seed=3)) == \
        dataclasses.asdict(jres)
    assert dataclasses.asdict(jres) == dataclasses.asdict(want)
    _assert_within_int8_drift(_synth(dflt, units, jz), jwav, jwav_f32)
    dflt.close()
    jpipe.close()
    jf32.close()


def _nrms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def _assert_within_int8_drift(got, want, want_f32):
    """The port's W8A8 output against usdm_tpu's `want`, bounded by
    usdm_tpu's own W8A8 drift from its f32 output `want_f32` (the bound of
    tests/test_torch_quant.py: an activation within f32 noise of a .5
    boundary rounds to a neighbouring int8 value on one side)."""
    got, want, want_f32 = (np.asarray(a, np.float64) for a in (got, want, want_f32))
    drift, drift_max = _nrms(want, want_f32), np.abs(want - want_f32).max()
    assert drift > 0
    assert _nrms(got, want) <= drift, (_nrms(got, want), drift)
    assert np.abs(got - want).max() <= drift_max, (np.abs(got - want).max(), drift_max)


def test_from_pretrained_defaults_and_cuda(exported):
    """usdm_tpu's defaults (bf16 LM, W8A8 Voicebox) plus device="cuda",
    which raises without a card."""
    import inspect

    sig = inspect.signature(UsdmPipeline.from_pretrained).parameters
    jsig = inspect.signature(JaxPipeline.from_pretrained).parameters
    for name, p in jsig.items():
        assert sig[name].default == p.default, name
    assert sig["device"].default == "cuda" and sig["vb_int8"].default is True
    if not torch.cuda.is_available():
        _, dirs, _ = exported
        with pytest.raises(RuntimeError, match="CUDA"):
            UsdmPipeline.from_pretrained(**dirs)


def _run_cli(args):
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.modules['usdm_tpu'] = None; "
            "from usdm_tpu_torch.cli import infer; sys.exit(infer.main(sys.argv[1:]))")
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_infer(exported, tmp_path):
    """--demo --device cpu and the exported directories (without usdm_tpu
    importable): a turn, an output wav; --tp 2 on a host without two cards
    raises by name; without a card the default device raises."""
    _, dirs, wav = exported
    out = str(tmp_path / "demo.wav")
    proc = _run_cli(["--input_path", wav, "--output_path", out, "--demo", "--device", "cpu",
                     "--n_timesteps", "2"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "agent_units:" in proc.stdout
    # the LM directory with a stage budget the random LM fills on the CPU in
    # seconds (tokenizer_config.json's model_max_length)
    import shutil

    llm = tmp_path / "llm"
    shutil.copytree(dirs["llm_dir"], llm)
    (llm / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 1024}))
    out = str(tmp_path / "loaded.wav")
    proc = _run_cli(["--input_path", wav, "--output_path", out, "--device", "cpu",
                     "--model_dir", str(llm), "--xlsr_dir", dirs["xlsr_dir"],
                     "--kmeans", dirs["kmeans_path"], "--voicebox_dir", dirs["voicebox_dir"],
                     "--bigvgan_dir", dirs["bigvgan_dir"], "--n_timesteps", "2",
                     "--draft", "ngram"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote:" in proc.stdout
    from usdm_tpu_torch.cli import infer

    if torch.cuda.device_count() < 2:  # --tp 2 asks for two cards, before any process starts
        with pytest.raises(ValueError, match="need 2 devices for tp=2"):
            infer.main(["--input_path", wav, "--output_path", out, "--demo", "--tp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            infer.main(["--input_path", wav, "--output_path", out, "--demo"])


def test_bench_vb_int8_runs_on_cpu():
    """The port of scripts/bench_vb_int8.py at a tiny size on the CPU (the
    plain versions): both ODEs run and the drift stays under its 1e-2 gate;
    `--device cuda`, the default, raises without a card."""
    from usdm_tpu_torch.core.config import VoiceboxConfig
    from usdm_tpu_torch.scripts import bench_vb_int8

    out = bench_vb_int8.run(VoiceboxConfig.tiny().replace(n_feats=80), torch.device("cpu"),
                            frames=40, steps=4, reps=1)
    assert set(out["runs"]) == {"bf16", "int8"} and 0 < out["nrms"] < bench_vb_int8.NRMS_GATE
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_vb_int8.main([])
