"""The port's checkpoint I/O against usdm_tpu's, on the CPU.

The safetensors reader and writer (usdm_tpu_torch/core/safetensors.py)
against the `safetensors` package both ways; each loader against
usdm_tpu's loader of the same file, through core/bridge.py; the port's
exporters against usdm_tpu's, tensor for tensor, and usdm_tpu's loaders on
the port's files.  Every tensor is held bit-equal: the weight-norm folds run
usdm_tpu's numpy expression on the same arrays, and the splits the same
torch reduction over the same strides.  Small widths; weights from seeded
generators.
"""

import json

import jax
import numpy as np
import pytest
import torch

st_pkg = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

from usdm_tpu.core import checkpoint as JCK  # noqa: E402
from usdm_tpu.core.config import BigVGANConfig as JBigVGANConfig  # noqa: E402
from usdm_tpu.core.config import VoiceboxConfig as JVoiceboxConfig  # noqa: E402
from usdm_tpu.core.config import XlsrConfig as JXlsrConfig  # noqa: E402
from usdm_tpu.models import bigvgan as JBV  # noqa: E402
from usdm_tpu.models import voicebox as JVB  # noqa: E402
from usdm_tpu_torch.core import bridge  # noqa: E402
from usdm_tpu_torch.core import checkpoint as CK  # noqa: E402
from usdm_tpu_torch.core import safetensors as ST  # noqa: E402
from usdm_tpu_torch.core.config import BigVGANConfig, VoiceboxConfig, XlsrConfig  # noqa: E402

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
          torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dtype)


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _tree_equal(got, want, rtol=0.0):
    """Two port parameter trees: same structure, every leaf bit-equal (or
    within `rtol` of each value)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _tree_equal(got[k], want[k], rtol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _tree_equal(a, b, rtol)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        if rtol:
            torch.testing.assert_close(got, want, rtol=rtol, atol=0)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("shapes", [[(3, 5)], [()], [(0,), (2, 0, 3)], [(7,), (1,), (4, 4)]],
                         ids=["2d", "0d", "empty", "mixed"])
def test_safetensors_both_ways(tmp_path, shapes):
    """Every dtype at the given shapes, with metadata: the package reads the
    port's file and the port reads the package's, every tensor bit-equal."""
    tensors = {f"t.{d}.{i}".replace("torch.", ""): _tensor(d, s, 7 * i + j)
               for j, d in enumerate(DTYPES) for i, s in enumerate(shapes)}
    meta = {"format": "pt", "note": "x"}
    ours = str(tmp_path / "ours.safetensors")
    n = ST.save_file(tensors, ours, metadata=meta)
    assert n == (tmp_path / "ours.safetensors").stat().st_size
    _assert_same(st_pkg.load_file(ours), tensors)
    from safetensors import safe_open

    with safe_open(ours, "pt") as f:
        assert f.metadata() == meta
    theirs = str(tmp_path / "theirs.safetensors")
    st_pkg.save_file(tensors, theirs, metadata=meta)
    _assert_same(ST.load_file(theirs), tensors)
    assert ST.SafeOpen(theirs).metadata == meta
    # the package pads its header as the port does
    head = open(theirs, "rb").read(8)
    assert int.from_bytes(head, "little") % 8 == 0


def test_safetensors_cast_unaligned_and_unsupported(tmp_path):
    """save_file's dtype casts floating tensors as they are written; a
    tensor at an offset that is no multiple of its item size is copied
    out; an unsupported dtype raises with its name."""
    src = {"w": torch.randn(4, 3, dtype=torch.float32), "i": torch.arange(5)}
    path = str(tmp_path / "c.safetensors")
    ST.save_file(src, path, dtype=torch.bfloat16)
    got = st_pkg.load_file(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], src["w"].bfloat16())
    assert torch.equal(got["i"], src["i"])
    # a u8 tensor first puts the f32 one at an odd offset
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]}}
    blob = json.dumps(header).encode()
    data = bytes([1, 2, 3]) + np.array([1.5, -2.25], np.float32).tobytes()
    odd = tmp_path / "odd.safetensors"
    odd.write_bytes(len(blob).to_bytes(8, "little") + blob + data)
    out = ST.load_file(str(odd))
    assert out["a"].tolist() == [1, 2, 3] and out["b"].tolist() == [1.5, -2.25]
    f8 = str(tmp_path / "f8.safetensors")
    st_pkg.save_file({"x": torch.zeros(2, dtype=torch.float8_e4m3fn)}, f8)
    with pytest.raises(ValueError, match="F8_E4M3"):
        ST.load_file(f8)


def test_read_state_dict_sharded_and_torch(tmp_path):
    """A directory's safetensors shards in sorted order, or its torch
    pickles with the {"generator"}, {"state_dict"}, {"model"} wrappers; the
    same dict as usdm_tpu's reader."""
    shards = tmp_path / "sharded"
    shards.mkdir()
    a = {"x": torch.randn(3, 2), "y": torch.randn(4).bfloat16()}
    b = {"z": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    st_pkg.save_file(a, str(shards / "model-00001-of-00002.safetensors"))
    st_pkg.save_file(b, str(shards / "model-00002-of-00002.safetensors"))
    _assert_same(CK.read_state_dict(str(shards)), {**a, **b})
    for name, wrap in (("gen.pt", lambda sd: {"generator": sd}),
                       ("sd.pt", lambda sd: {"state_dict": sd}),
                       ("fs2.pt", lambda sd: {"model": sd, "step": 3})):
        sd = {"w": torch.randn(2, 3), "b": torch.randn(3).half()}
        torch.save(wrap(sd), tmp_path / name)
        got = CK.read_state_dict(str(tmp_path / name))
        _assert_same(got, sd)
        want = JCK.read_state_dict(str(tmp_path / name))
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k].float().numpy(), want[k].astype(np.float32))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        CK.read_state_dict(str(tmp_path / "empty"))


# ------------------------------------------------------------------ Mistral
def _hf_mistral(tmp_path, file_dtype, tied=False, sliding_window=32):
    from transformers import MistralConfig as HFConfig
    from transformers import MistralForCausalLM

    cfg = HFConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                   sliding_window=sliding_window, tie_word_embeddings=tied)
    torch.manual_seed(0)
    model = MistralForCausalLM(cfg).eval().to(file_dtype)
    d = tmp_path / f"m_{str(file_dtype)[6:]}_{tied}"
    model.save_pretrained(d)
    return str(d)


@pytest.mark.parametrize("file_dtype,lm_dtype,tied", [
    (torch.float16, "bfloat16", False), (torch.bfloat16, "bfloat16", False),
    (torch.float32, "float32", False), (torch.float32, "bfloat16", True)])
def test_load_mistral_matches_jax(tmp_path, file_dtype, lm_dtype, tied):
    """f16, bf16 and f32 files, a tied lm_head: the port's params equal
    usdm_tpu's through the bridge, bit for bit (its f16/f32 -> bf16 cast
    included), and the configs agree field for field."""
    d = _hf_mistral(tmp_path, file_dtype, tied=tied)
    jp, jcfg = JCK.load_mistral(d, dtype=lm_dtype)
    params, cfg = CK.load_mistral(d, dtype=lm_dtype, device="cpu")
    assert cfg.to_json() == jcfg.to_json()
    dt = getattr(torch, lm_dtype)
    _tree_equal(params, bridge.mistral_from_jax(jax.device_get(jp), dtype=dt))
    if tied:
        assert torch.equal(params["lm_head"], params["embed"])


def test_load_mistral_int8_and_null_window(tmp_path):
    """`int8` quantizes each layer as it loads: the same leaves as the
    port's quantize_llm_params after a float load; a null sliding_window
    reads as 4096, usdm_tpu's rule."""
    from usdm_tpu_torch.models.quant import quantize_llm_params

    d = _hf_mistral(tmp_path, torch.float32, sliding_window=None)
    cfg_json = json.loads(open(f"{d}/config.json").read())
    assert cfg_json["sliding_window"] is None
    q, cfg = CK.load_mistral(d, device="cpu", int8=True)
    assert cfg.sliding_window == 4096 == JCK.load_mistral(d)[1].sliding_window
    _tree_equal(q, quantize_llm_params(CK.load_mistral(d, device="cpu")[0]))


def test_save_mistral_hf_matches_jax(tmp_path):
    """The port's export of bridged weights is usdm_tpu's file tensor for
    tensor (bf16 and f32), with the same config.json; usdm_tpu's loader and
    HF's from_pretrained read it back."""
    from transformers import MistralForCausalLM

    d = _hf_mistral(tmp_path, torch.float32)
    jp, jcfg = JCK.load_mistral(d, dtype="float32")
    params, cfg = CK.load_mistral(d, dtype="float32", device="cpu")
    for save_dtype in ("bfloat16", "float32"):
        ours, theirs = tmp_path / f"ours_{save_dtype}", tmp_path / f"theirs_{save_dtype}"
        CK.save_mistral_hf(str(ours), params, cfg, save_dtype=save_dtype)
        JCK.save_mistral_hf(str(theirs), jp, jcfg, save_dtype=save_dtype)
        _assert_same(st_pkg.load_file(str(ours / "model.safetensors")),
                     st_pkg.load_file(str(theirs / "model.safetensors")))
        assert (json.loads((ours / "config.json").read_text())
                == json.loads((theirs / "config.json").read_text()))
    back, _ = JCK.load_mistral(str(tmp_path / "ours_float32"), dtype="float32")
    _tree_equal(bridge.mistral_from_jax(jax.device_get(back)), params)
    hf = MistralForCausalLM.from_pretrained(str(tmp_path / "ours_float32"))
    assert torch.equal(hf.lm_head.weight, params["lm_head"])


# ------------------------------------------------------------------- XLS-R
def _wav2vec2(seed=0):
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    cfg = XlsrConfig.tiny()
    hf_cfg = Wav2Vec2Config(
        vocab_size=32, hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
        conv_dim=[cfg.conv_channels] * len(cfg.conv_kernels),
        conv_kernel=list(cfg.conv_kernels), conv_stride=list(cfg.conv_strides),
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        num_conv_pos_embeddings=cfg.conv_pos_width,
        num_conv_pos_embedding_groups=cfg.conv_pos_groups, apply_spec_augment=False)
    torch.manual_seed(seed)
    return Wav2Vec2Model(hf_cfg).eval()


def _respell_pos_conv(sd, prefix, spelling):
    """The pos conv's weight norm as `spelling`: 'parametrizations' (what
    HF saves), 'weight_g' (torch's old weight_norm) or 'plain' (folded)."""
    g = sd.pop(prefix + ".parametrizations.weight.original0")
    v = sd.pop(prefix + ".parametrizations.weight.original1")
    if spelling == "parametrizations":
        sd[prefix + ".parametrizations.weight.original0"] = g
        sd[prefix + ".parametrizations.weight.original1"] = v
    elif spelling == "weight_g":
        sd[prefix + ".weight_g"], sd[prefix + ".weight_v"] = g, v
    else:
        sd[prefix + ".weight"] = torch._weight_norm(v, g, 2)
    return sd


def _to_fairseq2(sd):
    """HF Wav2Vec2Model names -> fairseq2's xlsr2_1b_v2 names (the rename of
    usdm_tpu's tests/test_checkpoint.py)."""
    import re

    out = {}
    for k, v in sd.items():
        n = k.replace("feature_extractor.conv_layers.", "encoder_frontend.feature_extractor.layers.")
        n = n.replace("feature_projection.layer_norm.", "encoder_frontend.post_extract_layer_norm.")
        n = n.replace("feature_projection.projection.", "encoder_frontend.model_dim_proj.")
        n = n.replace("encoder.pos_conv_embed.conv.", "encoder_frontend.pos_encoder.conv.")
        for a, b in ((r"attention\.out_proj\.", "self_attn.output_proj."),
                     (r"attention\.", "self_attn."), (r"layer_norm\.", "self_attn_layer_norm."),
                     (r"final_layer_norm\.", "ffn_layer_norm."),
                     (r"feed_forward\.intermediate_dense\.", "ffn.inner_proj."),
                     (r"feed_forward\.output_dense\.", "ffn.output_proj.")):
            n = re.sub(r"encoder\.layers\.(\d+)\." + a, r"encoder.layers.\1." + b, n)
        out[n] = v
    return out


@pytest.mark.parametrize("layout", ["parametrizations", "weight_g", "plain", "fairseq2"])
def test_load_xlsr_matches_jax(tmp_path, layout):
    """An HF Wav2Vec2Model directory in all three weight-norm spellings (as
    safetensors) and a fairseq2 {"model": ...} .pt with pretraining-only
    tensors, each with kmeans centroids: the port's params equal usdm_tpu's
    through the bridge, every tensor bit-equal (the fold included)."""
    model = _wav2vec2()
    pc = "encoder.pos_conv_embed.conv"
    sd = _respell_pos_conv({k: v.clone() for k, v in model.state_dict().items()}, pc,
                           "weight_g" if layout == "fairseq2" else layout)
    cfg = XlsrConfig.tiny()
    cents = np.random.default_rng(1).standard_normal(
        (cfg.num_clusters, cfg.hidden_size)).astype(np.float32)
    np.save(tmp_path / "kmeans.npy", cents)
    if layout == "fairseq2":
        sd = _to_fairseq2(sd)
        sd["quantizer.entries"] = torch.zeros(4, 8)
        sd["final_proj.weight"] = torch.zeros(8, cfg.hidden_size)
        path = str(tmp_path / "xlsr2_tiny.pt")
        torch.save({"model": sd}, path)
        kw = {"cfg": cfg}
        jkw = {"cfg": JXlsrConfig(**cfg.__dict__)}
    else:
        d = tmp_path / "x"
        model.config.save_pretrained(d)
        st_pkg.save_file({"wav2vec2." + k: v.contiguous() for k, v in sd.items()},
                         str(d / "model.safetensors"))
        path, kw, jkw = str(d), {}, {}
    jp, jcfg = JCK.load_xlsr(path, str(tmp_path / "kmeans.npy"), **jkw)
    params, pcfg = CK.load_xlsr(path, str(tmp_path / "kmeans.npy"), device="cpu", **kw)
    assert pcfg.to_json() == jcfg.to_json()
    _tree_equal(params, bridge.xlsr_from_jax(jax.device_get(jp)))
    np.testing.assert_array_equal(params["centroids"].numpy(), cents)


# ------------------------------------------------------- Voicebox, BigVGAN
def _jax_voicebox():
    cfg = JVoiceboxConfig.tiny()
    return jax.device_get(JVB.init_params(cfg, jax.random.PRNGKey(4))), cfg


def _jax_bigvgan():
    cfg = JBigVGANConfig.tiny()
    p = jax.device_get(JBV.init_generator(cfg, jax.random.PRNGKey(5)))
    # nonzero snake parameters, so a swapped alpha/beta shows
    k = iter(range(1000))
    return jax.tree.map(lambda a: a + 0.01 * np.random.default_rng(next(k)).standard_normal(
        a.shape).astype(a.dtype), p), cfg


def test_load_voicebox_bigvgan_from_jax_exports(tmp_path):
    """usdm_tpu's own exporters' directories: the port's loaders give
    usdm_tpu's loaders' params through the bridge, bit for bit (the folded
    weight norms included)."""
    jvb, vcfg = _jax_voicebox()
    JCK.save_voicebox_hub(str(tmp_path / "vb"), jvb, vcfg)
    jp, _ = JCK.load_voicebox(str(tmp_path / "vb"))
    params, cfg = CK.load_voicebox(str(tmp_path / "vb"), device="cpu")
    assert cfg == VoiceboxConfig(**vcfg.__dict__)
    _tree_equal(params, bridge.voicebox_from_jax(jax.device_get(jp)))

    jbv, bcfg = _jax_bigvgan()
    JCK.save_bigvgan_generator(str(tmp_path / "bv"), jbv, bcfg)
    jp, _ = JCK.load_bigvgan(str(tmp_path / "bv"))
    params, cfg = CK.load_bigvgan(str(tmp_path / "bv"), device="cpu")
    assert cfg == BigVGANConfig(**bcfg.__dict__)
    _tree_equal(params, bridge.bigvgan_from_jax(jax.device_get(jp)))


def test_exports_match_jax_tensor_for_tensor(tmp_path):
    """save_voicebox_hub and save_bigvgan_generator of bridged weights
    write usdm_tpu's files: the same keys, config.json and every tensor
    bit-equal (the weight-norm splits included); usdm_tpu's loaders read
    the port's files back to the weights, within the fold's rounding."""
    jvb, vcfg = _jax_voicebox()
    pvb = bridge.voicebox_from_jax(jvb)
    CK.save_voicebox_hub(str(tmp_path / "ours_vb"), pvb, VoiceboxConfig(**vcfg.__dict__))
    JCK.save_voicebox_hub(str(tmp_path / "theirs_vb"), jvb, vcfg)
    jbv, bcfg = _jax_bigvgan()
    pbv = bridge.bigvgan_from_jax(jbv)
    CK.save_bigvgan_generator(str(tmp_path / "ours_bv"), pbv, BigVGANConfig(**bcfg.__dict__))
    JCK.save_bigvgan_generator(str(tmp_path / "theirs_bv"), jbv, bcfg)
    for name, f in (("vb", "pytorch_model.bin"), ("bv", "bigvgan_generator.pt")):
        ours = torch.load(tmp_path / f"ours_{name}" / f, weights_only=True)
        theirs = torch.load(tmp_path / f"theirs_{name}" / f, weights_only=True)
        if name == "bv":
            ours, theirs = ours["generator"], theirs["generator"]
        _assert_same(ours, theirs)
        assert (json.loads((tmp_path / f"ours_{name}" / "config.json").read_text())
                == json.loads((tmp_path / f"theirs_{name}" / "config.json").read_text()))
    # the round trip through usdm_tpu's loaders: the fold of g = ||w|| over
    # v = w gives w back within a few f32 ulps (stated rtol 1e-6)
    back, _ = JCK.load_voicebox(str(tmp_path / "ours_vb"))
    _tree_equal(bridge.voicebox_from_jax(jax.device_get(back)), pvb, rtol=1e-6)
    back, _ = JCK.load_bigvgan(str(tmp_path / "ours_bv"))
    _tree_equal(bridge.bigvgan_from_jax(jax.device_get(back)), pbv, rtol=1e-6)


def test_exporters_refuse_w8a8(tmp_path):
    from usdm_tpu_torch.models.quant import quantize_voicebox_params

    jvb, vcfg = _jax_voicebox()
    with pytest.raises(ValueError, match="W8A8"):
        CK.save_voicebox_hub(str(tmp_path / "q"), quantize_voicebox_params(
            bridge.voicebox_from_jax(jvb)), VoiceboxConfig(**vcfg.__dict__))


def test_loaders_default_to_cuda(tmp_path):
    """Without a device the loaders ask for the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jvb, vcfg = _jax_voicebox()
    JCK.save_voicebox_hub(str(tmp_path / "vb"), jvb, vcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        CK.load_voicebox(str(tmp_path / "vb"))


@pytest.mark.parametrize("layout", ["fairseq2", "hf"])
def test_save_xlsr_check_helper(tmp_path, layout):
    """chip_smoke.py's XLS-R writer (a check, not a package feature): both
    layouts load through usdm_tpu's and the port's load_xlsr to the written
    params, bit-equal between the two loaders and within the fold's
    rounding (rtol 1e-6) of the params."""
    from chip_smoke import save_xlsr
    from usdm_tpu_torch.models import xlsr as XL

    cfg = XlsrConfig.tiny()
    params = XL.init_params(cfg, torch.Generator().manual_seed(3))
    path = str(tmp_path / ("x.pt" if layout == "fairseq2" else "x"))
    save_xlsr(path, params, cfg, layout=layout)
    got, gcfg = CK.load_xlsr(path, cfg=cfg if layout == "fairseq2" else None, device="cpu")
    jp, _ = JCK.load_xlsr(path, cfg=JXlsrConfig(**cfg.__dict__) if layout == "fairseq2" else None)
    _tree_equal(got, bridge.xlsr_from_jax(jax.device_get(jp)))
    # the HF config.json carries the geometry, not the tap or the clusters
    assert gcfg == cfg.replace(output_layer=gcfg.output_layer, num_clusters=gcfg.num_clusters)
    zeros = torch.zeros(gcfg.num_clusters, cfg.hidden_size)
    _tree_equal(got, dict(params, centroids=zeros), rtol=1e-6)
