"""XLS-R speech tokenizer: wav2vec2 encoder + k-means unit assignment.

Port of usdm_tpu/models/xlsr.py: conv feature extractor (320x downsample to
50 Hz), feature projection, grouped-conv positional embedding, pre-LN
transformer layers tapped after `output_layer`, nearest-centroid units.
Parameters are a dict of tensors, convolutions in PyTorch's [Cout, Cin, K]
layout, one dict per transformer layer; layers past the tap are never run.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.audio.wav import pad_to_bucket
from usdm_tpu_torch.core.config import XlsrConfig
from usdm_tpu_torch.ops import conv as CV
from usdm_tpu_torch.ops.attention import mha

Params = Dict[str, Any]


def _uniform(generator, device, bound, *shape):
    return (torch.rand(*shape, generator=generator, device=device) * 2.0 - 1.0) * bound


def init_params(cfg: XlsrConfig, generator: torch.Generator, device="cpu") -> Params:
    """Random weights U(+-1/sqrt(fan_in)), biases 0, norms 1, centroids
    N(0, 1): the JAX init's distributions, drawn from `generator`."""
    C, H, F_, L = cfg.conv_channels, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(fan_in, *shape):
        return _uniform(generator, device, 1.0 / math.sqrt(fan_in), *shape)

    def zeros(*shape):
        return torch.zeros(*shape, device=device)

    def ones(*shape):
        return torch.ones(*shape, device=device)

    convs, cin = [], 1
    for kern in cfg.conv_kernels:
        convs.append({"w": dense(cin * kern, C, cin, kern), "b": zeros(C),
                      "ln_w": ones(C), "ln_b": zeros(C)})
        cin = C
    g = cfg.conv_pos_groups
    layers = [{
        "ln1_w": ones(H), "ln1_b": zeros(H),
        "wq": dense(H, H, H), "bq": zeros(H), "wk": dense(H, H, H), "bk": zeros(H),
        "wv": dense(H, H, H), "bv": zeros(H), "wo": dense(H, H, H), "bo": zeros(H),
        "ln2_w": ones(H), "ln2_b": zeros(H),
        "ffn_w1": dense(H, H, F_), "ffn_b1": zeros(F_),
        "ffn_w2": dense(F_, F_, H), "ffn_b2": zeros(H),
    } for _ in range(L)]
    return {
        "convs": convs,
        "feat_ln_w": ones(C), "feat_ln_b": zeros(C),
        "proj_w": dense(C, C, H), "proj_b": zeros(H),
        "pos_conv_w": dense(H * cfg.conv_pos_width // g, H, H // g, cfg.conv_pos_width),
        "pos_conv_b": zeros(H),
        "layers": layers,
        "centroids": torch.randn(cfg.num_clusters, H, generator=generator, device=device),
    }


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def feature_extractor(params: Params, cfg: XlsrConfig, wav: torch.Tensor) -> torch.Tensor:
    """[B, T] waveform -> [B, T', C] (conv -> LayerNorm -> GELU per stage)."""
    x = wav[:, None, :]
    for conv, stride in zip(params["convs"], cfg.conv_strides):
        x = CV.conv(x, conv["w"], conv["b"], stride=stride)
        x = F.gelu(layer_norm(x.transpose(1, 2), conv["ln_w"], conv["ln_b"])).transpose(1, 2)
    return x.transpose(1, 2)


def _pos_conv(params: Params, cfg: XlsrConfig, x: torch.Tensor) -> torch.Tensor:
    """Grouped positional conv (SamePad: an even kernel drops the last step)."""
    width = cfg.conv_pos_width
    y = CV.conv(x.transpose(1, 2), params["pos_conv_w"], params["pos_conv_b"],
                padding=width // 2, groups=cfg.conv_pos_groups)
    if width % 2 == 0:
        y = y[..., :-1]
    return F.gelu(y.transpose(1, 2))


def encode(params: Params, cfg: XlsrConfig, wav: torch.Tensor,
           lengths: Optional[torch.Tensor] = None, output_layer: Optional[int] = None,
           normalize: bool = True, attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (features [B, T', H] after `output_layer` layers, feat_lengths [B])."""
    b, t = wav.shape
    dev = wav.device
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int64, device=dev)
    if normalize:  # per-utterance zero mean / unit variance over valid samples
        valid = (torch.arange(t, device=dev)[None] < lengths[:, None]).to(wav.dtype)
        n = torch.clamp(lengths.to(wav.dtype), min=1.0)[:, None]
        mean = (wav * valid).sum(dim=1, keepdim=True) / n
        var = ((wav - mean) ** 2 * valid).sum(dim=1, keepdim=True) / n
        wav = (wav - mean) * torch.rsqrt(var + 1e-7) * valid

    x = feature_extractor(params, cfg, wav)
    x = layer_norm(x, params["feat_ln_w"], params["feat_ln_b"])
    x = x @ params["proj_w"] + params["proj_b"]

    feat_len = lengths
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        feat_len = torch.clamp(torch.div(feat_len - k, s, rounding_mode="floor") + 1, min=0)
    tp = x.shape[1]
    frame = torch.arange(tp, device=dev)[None]
    # zero the frames past feat_len before the positional conv, so a padded
    # clip's valid frames equal an exact-length run's
    x = x * (frame < feat_len[:, None]).to(x.dtype)[..., None]
    x = x + _pos_conv(params, cfg, x)

    if attn_impl == "auto":  # flash kernel for long clips only, as usdm_tpu
        attn_impl = "flash" if (x.is_cuda and tp >= 2048) else "plain"
    seg = torch.where(frame < feat_len[:, None], 0, -1).expand(b, tp)
    pos = frame.expand(b, tp)
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    n_layers = output_layer if output_layer is not None else cfg.output_layer
    for p in params["layers"][:n_layers]:
        y = layer_norm(x, p["ln1_w"], p["ln1_b"])
        q = (y @ p["wq"] + p["bq"]).reshape(b, tp, nh, hd)
        kk = (y @ p["wk"] + p["bk"]).reshape(b, tp, nh, hd)
        vv = (y @ p["wv"] + p["bv"]).reshape(b, tp, nh, hd)
        attn = mha(q, kk, vv, q_segment_ids=seg, kv_segment_ids=seg, q_positions=pos,
                   kv_positions=pos, causal=False, impl=attn_impl)
        x = x + attn.reshape(b, tp, cfg.hidden_size) @ p["wo"] + p["bo"]
        y = layer_norm(x, p["ln2_w"], p["ln2_b"])
        x = x + F.gelu(y @ p["ffn_w1"] + p["ffn_b1"]) @ p["ffn_w2"] + p["ffn_b2"]
    return x, feat_len


def kmeans_assign(features: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_k ||f - c_k||^2 as argmax(f . c - ||c||^2 / 2)."""
    logits = features @ centroids.T - 0.5 * (centroids * centroids).sum(dim=-1)
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def extract_units(params: Params, cfg: XlsrConfig, wav: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav [B, T] -> (units [B, T'], unit_lengths [B]); 50 Hz, no dedup."""
    feats, feat_len = encode(params, cfg, wav, lengths)
    return kmeans_assign(feats, params["centroids"]), feat_len


def extract_units_bucketed(params: Params, cfg: XlsrConfig, wav, bucket_s: float = 0.5,
                           device=None) -> List[int]:
    """extract_units on the wav zero-padded to a `bucket_s`-second multiple,
    as usdm_tpu does (the padded tail is masked, so the valid units equal an
    exact-length run's)."""
    wav = np.asarray(wav, np.float32)
    if len(wav) < cfg.conv_kernels[0]:
        return []
    device = device or params["proj_w"].device
    padded, n = pad_to_bucket(wav, cfg.sample_rate, bucket_s)
    units, ulen = extract_units(params, cfg, torch.from_numpy(padded[None]).to(device),
                                torch.tensor([n], device=device))
    return units[0, : max(int(ulen[0]), 0)].tolist()


def load_kmeans(params: Params, npy_path: str) -> Params:
    """Attach the k-means centroids of a .npy ([K, D]) on the params'
    device, as f32."""
    out = dict(params)
    out["centroids"] = torch.from_numpy(np.load(npy_path).astype(np.float32)).to(
        params["proj_w"].device)
    return out


# key names of the two checkpoint layouts: HF Wav2Vec2Model (XLS-R,
# do_stable_layer_norm) and fairseq2's (seamless_communication's
# xlsr2_1b_v2, the reference's tokenizer weights); a tuple lists the names
# tried in turn
_HF = {
    "conv": "feature_extractor.conv_layers.{}", "feat_ln": ("feature_projection.layer_norm",),
    "proj": "feature_projection.projection", "pos_conv": "encoder.pos_conv_embed.conv",
    "layer": "encoder.layers.{}", "ln1": "layer_norm", "attn": "attention",
    "out": "attention.out_proj", "ln2": "final_layer_norm",
    "ffn1": "feed_forward.intermediate_dense", "ffn2": "feed_forward.output_dense",
}
_FAIRSEQ2 = {
    "conv": "encoder_frontend.feature_extractor.layers.{}",
    "feat_ln": ("encoder_frontend.post_extract_layer_norm", "encoder_frontend.layer_norm"),
    "proj": "encoder_frontend.model_dim_proj", "pos_conv": "encoder_frontend.pos_encoder.conv",
    "layer": "encoder.layers.{}", "ln1": "self_attn_layer_norm", "attn": "self_attn",
    "out": "self_attn.output_proj", "ln2": "ffn_layer_norm", "ffn1": "ffn.inner_proj",
    "ffn2": "ffn.output_proj",
}


def _convert(state: Dict[str, torch.Tensor], cfg: XlsrConfig, names: dict, device) -> Params:
    from usdm_tpu_torch.core.convert import fold_weight_norm, take, take_linear

    def pick(*keys):
        for k in keys:
            if k in state:
                return k
        raise KeyError(f"xlsr: none of {keys} found; checkpoint keys look like "
                       + ", ".join(sorted(state)[:8]) + " ...")

    def f32(key):
        return take(state, pick(key), device)

    convs = []
    for i in range(len(cfg.conv_kernels)):
        p = names["conv"].format(i)
        convs.append({"w": f32(p + ".conv.weight"), "b": f32(p + ".conv.bias"),
                      "ln_w": f32(p + ".layer_norm.weight"), "ln_b": f32(p + ".layer_norm.bias")})
    feat_ln = pick(*(n + ".weight" for n in names["feat_ln"]))[: -len(".weight")]
    pc = names["pos_conv"]
    pick(pc + ".weight", pc + ".weight_g", pc + ".parametrizations.weight.original0")
    out = {
        "convs": convs,
        "feat_ln_w": f32(feat_ln + ".weight"), "feat_ln_b": f32(feat_ln + ".bias"),
        "proj_w": take_linear(state, pick(names["proj"] + ".weight"), device),
        "proj_b": f32(names["proj"] + ".bias"),
        # weight norm over dims (0, 1), folded in f32
        "pos_conv_w": fold_weight_norm(state, pc, (0, 1), cast_f32=True).to(device,
                                                                             torch.float32),
        "pos_conv_b": f32(pc + ".bias"),
    }
    layers = []
    for i in range(cfg.num_layers):
        p = names["layer"].format(i) + "."
        lp = {"ln1_w": f32(p + names["ln1"] + ".weight"), "ln1_b": f32(p + names["ln1"] + ".bias")}
        for w, b, n in (("wq", "bq", names["attn"] + ".q_proj"),
                        ("wk", "bk", names["attn"] + ".k_proj"),
                        ("wv", "bv", names["attn"] + ".v_proj"), ("wo", "bo", names["out"]),
                        ("ffn_w1", "ffn_b1", names["ffn1"]), ("ffn_w2", "ffn_b2", names["ffn2"])):
            lp[w] = take_linear(state, pick(p + n + ".weight"), device)
            lp[b] = f32(p + n + ".bias")
        lp.update(ln2_w=f32(p + names["ln2"] + ".weight"), ln2_b=f32(p + names["ln2"] + ".bias"))
        layers.append(lp)
    out["layers"] = layers
    out["centroids"] = torch.zeros(cfg.num_clusters, cfg.hidden_size, device=device)
    return out


def convert_hf_state_dict(state: Dict[str, torch.Tensor], cfg: XlsrConfig,
                          device="cpu") -> Params:
    """A HF Wav2Vec2Model state dict (XLS-R layout; host tensors, popped as
    they are converted) -> the port's params on `device`, f32; the
    centroids are zeros until load_kmeans."""
    return _convert(state, cfg, _HF, device)


def convert_fairseq2_state_dict(state: Dict[str, torch.Tensor], cfg: XlsrConfig,
                                device="cpu") -> Params:
    """A fairseq2 Wav2Vec2Model state dict (`encoder_frontend.*`,
    `self_attn.output_proj`, `ffn.inner_proj`/`output_proj`) -> the port's
    params, as convert_hf_state_dict; pretraining-only tensors (masker,
    quantizer, final_proj) are ignored."""
    return _convert(state, cfg, _FAIRSEQ2, device)
