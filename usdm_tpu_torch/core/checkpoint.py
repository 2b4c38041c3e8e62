"""Checkpoints: the reference formats' loaders and exporters, and train state.

Port of usdm_tpu/core/checkpoint.py.  The four external formats load from
local directories (nothing is downloaded) straight into the port's layouts
on `device` (`cuda` unless the caller asks for the CPU):

  * HF causal LM (naver-ai/USDM-DailyTalk): config.json + *.safetensors
    (sharded or not) or pytorch_model.bin -> `load_mistral`;
  * XLS-R: an HF Wav2Vec2Model directory, or fairseq2's xlsr2_1b_v2 `.pt`,
    plus kmeans .npy centroids -> `load_xlsr`;
  * HubMixin token-Voicebox (naver-ai/xlsr-token-Voicebox): config.json +
    pytorch_model.bin of `estimator.*` keys -> `load_voicebox`;
  * BigVGAN (nvidia/bigvgan_22khz_80band): config.json +
    bigvgan_generator.pt ({"generator": ...}) -> `load_bigvgan`.

The exporters `save_mistral_hf`, `save_voicebox_hub` and
`save_bigvgan_generator` write usdm_tpu's files, keys, layouts and
config.json fields.  safetensors files are read and written by
core/safetensors.py, so neither `safetensors` nor `ml_dtypes` is needed.
Loaders move one tensor at a time to the device and release its host pages
as they go, so a 7B checkpoint never sits in host memory.

Train state: each checkpoint is a directory `step_N` holding `state.pt` (the
params tree on the CPU, the optimizer's state dict and the step), written
under a temporary name and renamed into place, so a reader never sees half a
checkpoint (`save_train_state`, `latest_step`, `restore_train_state`,
keep=2).  A state is any object with `params` (a tree of tensors),
`opt_state` (with state_dict / load_state_dict) and `step`: the CFM
trainer's (train/cfm.py, a torch Adam), the LM's and LoRA's (train/lm.py
TrainState, AdamW moments on the device or pinned on the host).  These are
not orbax checkpoints: usdm_tpu's train states cannot be read here, nor the
port's there (core/bridge.py converts usdm_tpu's arrays for the tests).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from usdm_tpu_torch.core import safetensors as st
from usdm_tpu_torch.core.config import BigVGANConfig, MistralConfig, VoiceboxConfig, XlsrConfig

from usdm_tpu_torch.core.tree import tree_leaves, tree_map

def check_device(device) -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and there
    is no card (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


# ---------------------------------------------------------------------------
# Raw state-dict readers (safetensors / torch pickles)
# ---------------------------------------------------------------------------


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A model directory or file -> {name: host tensor}: every
    *.safetensors of a directory in sorted order (a sharded checkpoint),
    else its *.bin / *.pt torch pickles in sorted order; or one such file.
    safetensors tensors are backed by their own mappings of the file, torch
    pickles are mapped when they are zip archives."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        files = [f for f in names if f.endswith(".safetensors")]
        if not files:
            files = [f for f in names if f.endswith((".bin", ".pt"))]
        if not files:
            raise FileNotFoundError(f"no checkpoint files in {path}")
        out: Dict[str, torch.Tensor] = {}
        for f in files:
            out.update(read_state_dict(os.path.join(path, f)))
        return out
    if path.endswith(".safetensors"):
        return st.load_file(path)
    return _read_torch(path)


def _read_torch(path: str) -> Dict[str, torch.Tensor]:
    """A torch pickle (weights only) -> {name: host tensor}, unwrapping
    BigVGAN's {"generator": ...}, {"state_dict": ...} and fairseq2's
    {"model": ...}."""
    obj = torch.load(path, map_location="cpu", weights_only=True,
                     mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict) and "generator" in obj and all(
            isinstance(v, torch.Tensor) for v in obj["generator"].values()):
        obj = obj["generator"]  # BigVGAN checkpoint wrapper
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]  # fairseq2 CheckpointManager wrapper (xlsr2_1b_v2.pt)
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in obj.items()}


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


# ---------------------------------------------------------------------------
# Model loaders (local directories) and exporters
# ---------------------------------------------------------------------------


def load_mistral(path: str, cfg: Optional[MistralConfig] = None, dtype: Optional[str] = None,
                 device="cuda", int8: bool = False, shard: Optional[tuple] = None):
    """Local USDM/Mistral HF dir -> (params on `device`, MistralConfig).

    config.json by usdm_tpu's rules: head_dim falls back to hidden / heads,
    and a null sliding_window becomes 4096 (HF reads null as no window; the
    reference's checkpoint sets 4096).  A missing lm_head takes the
    embedding's values (tied).  `int8` quantizes each layer's projections to
    W8A8 as it is loaded (usdm_tpu's from_pretrained(lm_int8=True)).
    `shard=(tp, rank)` loads only that tensor-parallel rank's slices
    (engine/tp.py), each copied from its mapped file alone."""
    from usdm_tpu_torch.models.mistral import convert_hf_state_dict

    device = check_device(device)
    if cfg is None:
        hf = _read_json(os.path.join(path, "config.json"))
        cfg = MistralConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            sliding_window=hf.get("sliding_window") or 4096,
            dtype=dtype or "bfloat16",
        )
    state = read_state_dict(path)
    if "lm_head.weight" not in state and "model.embed_tokens.weight" in state:
        state["lm_head.weight"] = state["model.embed_tokens.weight"]  # tied
    return convert_hf_state_dict(state, cfg, dtype=dtype, device=device, int8=int8,
                                 shard=shard), cfg


_MISTRAL_NAMES = {
    "ln1": ("input_layernorm.weight", False),
    "ln2": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def save_mistral_hf(path: str, params, cfg: MistralConfig, tokenizer=None,
                    save_dtype: str = "bfloat16") -> None:
    """Export LM params (float, on any device) to an HF-MistralForCausalLM
    directory: config.json, one model.safetensors in `save_dtype`, and the
    tokenizer if given.  The inverse of `load_mistral`: [in, out] back to
    nn.Linear's [out, in]; tensors are written one at a time, each cast and
    copied to the host as it is written."""
    from usdm_tpu_torch.models.mistral import torch_dtype
    from usdm_tpu_torch.models.quant import is_quantized

    if any(is_quantized(v) for lp in params["layers"] for v in lp.values()):
        raise ValueError("save_mistral_hf: W8A8 params cannot be exported; export the float "
                         "params")
    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, "config.json"), {
        "architectures": ["MistralForCausalLM"],
        "model_type": "mistral",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "sliding_window": cfg.sliding_window,
        "tie_word_embeddings": False,
        "torch_dtype": save_dtype,
    })
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"]}
    for i in range(cfg.num_layers):
        lp = params["layers"][i]
        for ours, (theirs, transpose) in _MISTRAL_NAMES.items():
            sd[f"model.layers.{i}.{theirs}"] = lp[ours].t() if transpose else lp[ours]
    st.save_file(sd, os.path.join(path, "model.safetensors"), dtype=torch_dtype(save_dtype))
    if tokenizer is not None:
        tokenizer.save(path)


def load_voicebox(path: str, cfg: Optional[VoiceboxConfig] = None, device="cuda"):
    """Local HubMixin Voicebox dir -> (params on `device`, VoiceboxConfig)."""
    from usdm_tpu_torch.models.voicebox import convert_reference_state_dict

    device = check_device(device)
    if cfg is None:
        rc = _read_json(os.path.join(path, "config.json"))
        cfg = VoiceboxConfig(
            n_feats=rc.get("n_feats", 80),
            n_tokens=rc.get("n_tokens", 10000),
            embedding_dim=rc.get("embedding_dim", 1280),
            hidden_size=rc.get("hidden_size", 1024),
            intermediate_size=rc.get("intermediate_size", 4096),
            num_heads=rc.get("num_attention_heads", 16),
            num_layers=rc.get("num_hidden_layers", 24),
            convpos_width=rc.get("convpos_width", 31),
            convpos_groups=rc.get("convpos_groups", 16),
            convpos_depth=rc.get("convpos_depth", 2),
            sigma_min=rc.get("sigma_min", 1e-4),
        )
    return convert_reference_state_dict(read_state_dict(path), cfg, device), cfg


def _weight_norm_split(w: torch.Tensor, dim: int = 0):
    """Split a folded host weight into torch weight_norm's (g, v) with
    v = w: ||v|| is then g, so g * v / ||v|| gives w back.  `dim` is the
    weight_norm dim (the one g keeps)."""
    dims = [d for d in range(w.dim()) if d != dim]
    g = torch.linalg.vector_norm(w, dim=dims, keepdim=True)
    return g, w.clone()


def _host(x: torch.Tensor) -> torch.Tensor:
    """An f32 copy of `x` on the host, strides kept."""
    return x.detach().to("cpu", torch.float32, copy=True)


def _check_float(params, what: str) -> None:
    from usdm_tpu_torch.core.tree import tree_leaves

    if any(not t.is_floating_point() for t in tree_leaves(params)):
        raise ValueError(f"{what}: W8A8 params cannot be exported; export the float params")


def save_voicebox_hub(path: str, params, cfg: VoiceboxConfig) -> None:
    """Export Voicebox params (float, on any device) as a HubMixin dir:
    config.json + pytorch_model.bin with `estimator.*` keys, the format the
    reference's training saves and `load_voicebox` reads.  Each positional
    conv is written as weight_norm's parametrizations.weight.original0/1
    (dim 2), as the reference module parameterizes it, split on the host in
    f32."""
    _check_float(params, "save_voicebox_hub")
    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, "config.json"), {
        "n_feats": cfg.n_feats, "n_tokens": cfg.n_tokens,
        "embedding_dim": cfg.embedding_dim, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_attention_heads": cfg.num_heads,
        "num_hidden_layers": cfg.num_layers,
        "convpos_width": cfg.convpos_width,
        "convpos_groups": cfg.convpos_groups,
        "convpos_depth": cfg.convpos_depth,
        "sigma_min": cfg.sigma_min,
    })
    p = params
    sd = {
        "estimator.embed.weight": _host(p["embed"]),
        # [in, out] -> Conv1d-1x1 [out, in, 1]
        "estimator.proj_in.weight": _host(p["proj_in_w"].t()[:, :, None]),
        "estimator.proj_in.bias": _host(p["proj_in_b"]),
        "estimator.proj_out.weight": _host(p["proj_out_w"].t()[:, :, None]),
        "estimator.proj_out.bias": _host(p["proj_out_b"]),
        "estimator.layer_norm.weight": _host(p["ln0_w"]),
        "estimator.layer_norm.bias": _host(p["ln0_b"]),
    }
    for i in range(cfg.convpos_depth):
        # [out, in/g, w], laid out as usdm_tpu's [w, in/g, out] array seen
        # through its transpose, so the norm's sum runs in the same order
        w = _host(p["convpos_w"][i].permute(2, 1, 0).contiguous().permute(2, 1, 0))
        g, v = _weight_norm_split(w, dim=2)
        sd[f"estimator.pos_conv_embeds.{i}.conv.parametrizations.weight.original0"] = g
        sd[f"estimator.pos_conv_embeds.{i}.conv.parametrizations.weight.original1"] = v
        sd[f"estimator.pos_conv_embeds.{i}.conv.bias"] = _host(p["convpos_b"][i])
    names = [("wq", "bq", "attention.q_proj"), ("wk", "bk", "attention.k_proj"),
             ("wv", "bv", "attention.v_proj"), ("wo", "bo", "attention.out_proj"),
             ("ffn_w1", "ffn_b1", "feed_forward.intermediate_dense"),
             ("ffn_w2", "ffn_b2", "feed_forward.output_dense")]
    for i in range(cfg.num_layers):
        lp = p["layers"][i]
        for wk_, bk_, nm in names:
            sd[f"estimator.layers.{i}.{nm}.weight"] = _host(lp[wk_].t())
            sd[f"estimator.layers.{i}.{nm}.bias"] = _host(lp[bk_])
        sd[f"estimator.layers.{i}.layer_norm.weight"] = _host(lp["ln1_w"])
        sd[f"estimator.layers.{i}.layer_norm.bias"] = _host(lp["ln1_b"])
        sd[f"estimator.layers.{i}.final_layer_norm.weight"] = _host(lp["ln2_w"])
        sd[f"estimator.layers.{i}.final_layer_norm.bias"] = _host(lp["ln2_b"])
    for i in range(cfg.num_layers // 2):
        sd[f"estimator.skip_connections_layers.{i}.weight"] = _host(p["skip_w"][i].t())
        sd[f"estimator.skip_connections_layers.{i}.bias"] = _host(p["skip_b"][i])
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))


def _bigvgan_config_json(cfg: BigVGANConfig) -> dict:
    return {
        "num_mels": cfg.num_mels,
        "upsample_initial_channel": cfg.upsample_initial_channel,
        "upsample_rates": list(cfg.upsample_rates),
        "upsample_kernel_sizes": list(cfg.upsample_kernel_sizes),
        "resblock_kernel_sizes": list(cfg.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in cfg.resblock_dilation_sizes],
        "resblock": cfg.resblock, "activation": cfg.activation,
        "snake_logscale": cfg.snake_logscale,
        "sampling_rate": cfg.sampling_rate,
    }


def save_bigvgan_generator(path: str, params, cfg: BigVGANConfig) -> None:
    """Export BigVGAN generator params (on any device) as config.json +
    bigvgan_generator.pt ({"generator": state_dict}), the reference layout
    `load_bigvgan` reads.  Every conv is written as weight_norm's
    weight_g/weight_v (dim 0), split on the host in f32, and every
    Activation1d gets its fixed anti-aliasing filters (ratio 2, kernel 12,
    cutoff 0.25, half width 0.3), so a strict load_state_dict into the
    reference generator accepts the file."""
    from usdm_tpu_torch.ops.fused_act import kaiser_sinc_filter1d

    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, "config.json"), _bigvgan_config_json(cfg))
    sd: Dict[str, torch.Tensor] = {}

    def put_wn(key, w):  # torch-layout weight -> weight_g/weight_v
        g, v = _weight_norm_split(_host(w).contiguous(), dim=0)
        sd[key + ".weight_g"] = g
        sd[key + ".weight_v"] = v

    aa_filter = torch.from_numpy(np.ascontiguousarray(
        kaiser_sinc_filter1d(0.25, 0.3, 12)[None, None, :]))

    def put_act(key, act):
        sd[key + ".upsample.filter"] = aa_filter.clone()
        sd[key + ".downsample.lowpass.filter"] = aa_filter.clone()
        sd[key + ".act.alpha"] = _host(act["alpha"])
        if cfg.activation == "snakebeta":
            sd[key + ".act.beta"] = _host(act["beta"])

    p = params
    put_wn("conv_pre", p["conv_pre_w"])
    put_wn("conv_post", p["conv_post_w"])
    sd["conv_pre.bias"] = _host(p["conv_pre_b"])
    sd["conv_post.bias"] = _host(p["conv_post_b"])
    put_act("activation_post", p["act_post"])
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        put_wn(f"ups.{i}.0", p["ups"][i]["w"])
        sd[f"ups.{i}.0.bias"] = _host(p["ups"][i]["b"])
        for j in range(nk):
            r = i * nk + j
            block = p["resblocks"][r]
            for part in ("convs1", "convs2"):
                for ci, c in enumerate(block[part]):
                    put_wn(f"resblocks.{r}.{part}.{ci}", c["w"])
                    sd[f"resblocks.{r}.{part}.{ci}.bias"] = _host(c["b"])
            for ai, act in enumerate(block["acts"]):
                put_act(f"resblocks.{r}.activations.{ai}", act)
    torch.save({"generator": sd}, os.path.join(path, "bigvgan_generator.pt"))


def load_bigvgan(path: str, cfg: Optional[BigVGANConfig] = None, device="cuda"):
    """Local BigVGAN dir (config.json + bigvgan_generator.pt) -> (params on
    `device`, BigVGANConfig)."""
    from usdm_tpu_torch.models.bigvgan import convert_reference_state_dict

    device = check_device(device)
    if cfg is None:
        h = _read_json(os.path.join(path, "config.json"))
        cfg = BigVGANConfig(
            num_mels=h["num_mels"],
            upsample_initial_channel=h["upsample_initial_channel"],
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
            resblock=str(h["resblock"]),
            activation=h["activation"],
            snake_logscale=h["snake_logscale"],
            sampling_rate=h["sampling_rate"],
        )
    return convert_reference_state_dict(read_state_dict(path), cfg, device), cfg


def load_xlsr(path: str, kmeans_path: Optional[str] = None, cfg: Optional[XlsrConfig] = None,
              device="cuda"):
    """Local XLS-R checkpoint -> (params on `device`, XlsrConfig): an HF
    Wav2Vec2Model directory (config.json + weights), or fairseq2's
    xlsr2_1b_v2 `.pt` (`encoder_frontend.*` keys, possibly under
    {"model": ...}), told apart by key prefix.  fairseq2 checkpoints carry
    no config, so XlsrConfig() (xlsr2_1b_v2's geometry) applies unless `cfg`
    is given.  All num_layers layers load, though encode stops at
    output_layer."""
    from usdm_tpu_torch.models.xlsr import (
        convert_fairseq2_state_dict,
        convert_hf_state_dict,
        load_kmeans,
    )

    device = check_device(device)
    state = {k.removeprefix("wav2vec2."): v for k, v in read_state_dict(path).items()}
    is_fairseq2 = any(k.startswith("encoder_frontend.") for k in state)
    if cfg is None:
        cfg_file = os.path.join(path, "config.json") if os.path.isdir(path) else ""
        if not is_fairseq2 and os.path.exists(cfg_file):
            h = _read_json(cfg_file)
            cfg = XlsrConfig(
                conv_channels=h["conv_dim"][0],
                conv_kernels=tuple(h["conv_kernel"]),
                conv_strides=tuple(h["conv_stride"]),
                hidden_size=h["hidden_size"],
                intermediate_size=h["intermediate_size"],
                num_heads=h["num_attention_heads"],
                num_layers=h["num_hidden_layers"],
                conv_pos_width=h["num_conv_pos_embeddings"],
                conv_pos_groups=h["num_conv_pos_embedding_groups"],
            )
        else:
            cfg = XlsrConfig()
    convert = convert_fairseq2_state_dict if is_fairseq2 else convert_hf_state_dict
    params = convert(state, cfg, device)
    if kmeans_path:
        params = load_kmeans(params, kmeans_path)
    return params, cfg


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"
_EXTRA = "extra.json"


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(path))
                  if m and os.path.exists(os.path.join(path, m.group(0), _FILE)))


def _gathered(state):
    """(params, optimizer state dict) of `state` on the host; a sharded
    state (`layout`: a core/mesh.py Sharding per leaf) gathered whole leaf
    by leaf (every rank joins; only rank 0 keeps them)."""
    layout = getattr(state, "layout", None)
    if layout is None:
        return tree_map(lambda a: a.detach().cpu(), state.params), state.opt_state.state_dict()
    it = iter(layout)
    params = tree_map(lambda a: next(it).gather_to_host(a), state.params)
    return params, state.opt_state.state_dict(layout)


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save_train_state(path: str, state, step: int, keep: int = 2,
                     extra: Optional[dict] = None) -> None:
    """Write `state` as `path/step_<step>` (and `extra`, a JSON-able dict such
    as a data loader's position, as its extra.json), then drop all but the
    newest `keep` checkpoints.  In a process group every rank calls it:
    a sharded state is gathered leaf by leaf, rank 0 alone writes the
    single-device format, and the ranks leave together."""
    from usdm_tpu_torch.core.distributed import is_primary

    if getattr(state, "layout", None) is not None or is_primary():
        params, opt = _gathered(state)
    if is_primary():
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, f"step_{step}")
        tmp = os.path.join(path, f".step_{step}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": params, "opt_state": opt, "step": int(state.step)},
                   os.path.join(tmp, _FILE))
        if extra is not None:
            _write_json(os.path.join(tmp, _EXTRA), extra)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in _steps(path)[:-keep]:
            shutil.rmtree(os.path.join(path, f"step_{old}"))
    _barrier()


def latest_step(path: str) -> Optional[int]:
    steps = _steps(os.path.abspath(path))
    return steps[-1] if steps else None


def read_train_extra(path: str, step: int) -> Optional[dict]:
    """The `extra` dict saved with `path/step_<step>`, or None."""
    f = os.path.join(os.path.abspath(path), f"step_{step}", _EXTRA)
    return _read_json(f) if os.path.exists(f) else None


def restore_train_state(path: str, state, step: Optional[int] = None):
    """Load `path/step_<step>` (the latest when None) into `state` in place:
    parameters copied into its tensors, on their device, the optimizer
    state through its load_state_dict.  A sharded state (`layout`) takes
    each leaf's block for its mesh, so a checkpoint restores under any
    dp and tp (the file holds whole leaves)."""
    path = os.path.abspath(path)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no train-state checkpoint under {path}")
    layout = getattr(state, "layout", None)
    saved = torch.load(os.path.join(path, f"step_{step}", _FILE), map_location="cpu",
                       weights_only=True, mmap=layout is not None)
    dst, src = tree_leaves(state.params), tree_leaves(saved["params"])
    if layout is not None and len(src) == len(layout):
        src = [sh.shard(t) for sh, t in zip(layout, src)]
    if len(dst) != len(src) or any(a.shape != b.shape for a, b in zip(dst, src)):
        raise ValueError(f"checkpoint step_{step} does not match the model's parameters")
    with torch.no_grad():
        for a, b in zip(dst, src):
            a.copy_(b)
    if layout is not None:
        state.opt_state.load_state_dict(saved["opt_state"], layout)
    else:
        state.opt_state.load_state_dict(saved["opt_state"])
    state.step = saved["step"]
    return state
