"""Mistral-7B speech-text LLM in PyTorch.

Port of usdm_tpu/models/mistral.py: RMSNorm, HF-convention RoPE, GQA
attention with a sliding window, SiLU MLP.  Parameters are a plain dict of
tensors with one dict per layer (the JAX package stacks layers for
`lax.scan`; here a Python loop walks them):

  embed [V, D]; layers[i]: ln1, ln2 [D], wq [D, H*hd], wk/wv [D, Hkv*hd],
  wo [H*hd, D], w_gate/w_up [D, F], w_down [F, D]; final_norm [D];
  lm_head [V, D]  (transposed from the JAX [D, V], so a vocab slice is a
  contiguous row block for the sliced greedy tail of the paged engine).
The seven projections of a layer may be W8A8 quantized leaves
(models/quant.py); every product with them goes through `qmm`.

`forward` is the dense packed forward, the parity anchor of the paged
engine (engine/paged_ops.py), which is the serving path.  `KVCache`,
`prefill`, `decode_step` and `prefill_extend` are the dense KV-cache path
of engine/generate.py (respond(use_paged=False)): one [L, B, S, Hkv, d]
tensor each for K and V, written in place, a ring over S in decode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.models.quant import qmm
from usdm_tpu_torch.ops.attention import decode_attention, mha

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def init_params(cfg: MistralConfig, generator: torch.Generator, device="cpu",
                dtype: Optional[str] = None) -> Params:
    """Random weights N(0, initializer_range), norms at 1, drawn on `device`
    from `generator` (which must live on that device)."""
    dt = torch_dtype(dtype or cfg.dtype)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = cfg.initializer_range

    def dense(*shape):
        return (torch.randn(*shape, generator=generator, device=device, dtype=dt) * std)

    def ones(n):
        return torch.ones(n, device=device, dtype=dt)

    layers = [{
        "ln1": ones(d), "ln2": ones(d),
        "wq": dense(d, h * hd), "wk": dense(d, hkv * hd), "wv": dense(d, hkv * hd),
        "wo": dense(h * hd, d),
        "w_gate": dense(d, f), "w_up": dense(d, f), "w_down": dense(f, d),
    } for _ in range(cfg.num_layers)]
    return {"embed": dense(v, d), "layers": layers, "final_norm": ones(d),
            "lm_head": dense(v, d)}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _inv_freq(device: torch.device, head_dim: int, theta: float) -> torch.Tensor:
    """RoPE's inverse frequencies on `device`, made once per (device,
    head_dim, theta): the host-to-device copy is not legal inside a CUDA
    graph capture, so a captured decode link finds them here.  Read-only."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    return torch.from_numpy(inv_freq.astype(np.float32)).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-convention cos/sin tables for absolute positions [..., T] ->
    [..., T, head_dim] f32."""
    freqs = positions[..., None].float() * _inv_freq(positions.device, head_dim, theta)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, d]; cos/sin: [B, T, d] (rotate_half convention)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[:, :, None] + rotated.float() * sin[:, :, None]).to(x.dtype)


def mlp(y: torch.Tensor, lp: Params) -> torch.Tensor:
    return qmm(F.silu(qmm(y, lp["w_gate"])) * qmm(y, lp["w_up"]), lp["w_down"])


def _qkv(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin):
    """A layer's normed, projected and rotated q [B, T, H, hd], k and v
    [B, T, Hkv, hd]."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    q = apply_rope(qmm(y, lp["wq"]).reshape(b, t, h, hd), cos, sin)
    kk = apply_rope(qmm(y, lp["wk"]).reshape(b, t, hkv, hd), cos, sin)
    return q, kk, qmm(y, lp["wv"]).reshape(b, t, hkv, hd)


def _finish_layer(cfg: MistralConfig, x: torch.Tensor, attn: torch.Tensor, lp: Params):
    """The attention output's projection and residual, then the MLP block."""
    b, t = x.shape[:2]
    x = x + qmm(attn.reshape(b, t, -1), lp["wo"])
    return x + mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)


def _layer(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin,
           segment_ids: torch.Tensor, positions: torch.Tensor, attn_impl: str) -> torch.Tensor:
    q, kk, vv = _qkv(cfg, x, lp, cos, sin)
    attn = mha(q, kk, vv, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
               q_positions=positions, kv_positions=positions, causal=True,
               sliding_window=cfg.sliding_window, impl=attn_impl)
    return _finish_layer(cfg, x, attn, lp)


def forward(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
            segment_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attn_impl: str = "auto") -> torch.Tensor:
    """Packed full-sequence forward -> logits [B, T, V] f32."""
    b, t = input_ids.shape
    dev = input_ids.device
    if segment_ids is None:
        segment_ids = torch.zeros((b, t), dtype=torch.int32, device=dev)
    if positions is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    x = params["embed"][input_ids]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for lp in params["layers"]:
        x = _layer(cfg, x, lp, cos, sin, segment_ids, positions, attn_impl)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return F.linear(x, params["lm_head"]).float()


# ---------------------------------------------------------------------------
# KV-cache decode (dense cache; the paged engine lives in engine/paged_ops.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S, Hkv, d]
    v: torch.Tensor  # [L, B, S, Hkv, d]
    length: torch.Tensor  # [B] int64 valid entries

    @classmethod
    def create(cls, cfg: MistralConfig, batch: int, max_len: int, device="cpu",
               dtype: Optional[str] = None) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        dt = torch_dtype(dtype or cfg.dtype)
        return cls(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(batch, dtype=torch.int64, device=device))


def _last_logits(params: Params, cfg: MistralConfig, x: torch.Tensor,
                 n: torch.Tensor) -> torch.Tensor:
    """Logits [B, V] f32 of each row's last valid position n - 1."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = torch.clamp(n - 1, 0, x.shape[1] - 1)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return F.linear(x_last, params["lm_head"]).float()


def prefill(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
            input_len: torch.Tensor, cache: KVCache,
            attn_impl: str = "auto") -> Tuple[torch.Tensor, KVCache]:
    """Run the right-padded prompt [B, T], write its K/V into cache slots
    [0, T) in place -> (last valid token's logits [B, V] f32, the cache at
    length input_len)."""
    b, t = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    seg = torch.where(positions < input_len[:, None], 0, -1).to(torch.int32)
    x = params["embed"][input_ids]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        q, kk, vv = _qkv(cfg, x, lp, cos, sin)
        cache.k[li, :, :t] = kk.to(cache.k.dtype)
        cache.v[li, :, :t] = vv.to(cache.v.dtype)
        attn = mha(q, kk, vv, q_segment_ids=seg, kv_segment_ids=seg, q_positions=positions,
                   kv_positions=positions, causal=True, sliding_window=cfg.sliding_window,
                   impl=attn_impl)
        x = _finish_layer(cfg, x, attn, lp)
    length = input_len.to(torch.int64)
    return _last_logits(params, cfg, x, length), KVCache(cache.k, cache.v, length)


def decode_step(params: Params, cfg: MistralConfig, token: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One step: token [B] -> (logits [B, V] f32, the cache one longer).
    The cache is a ring over its S slots: the token at position pos writes
    slot pos % S in place, and attention masks by each slot's position
    pos - (pos - slot) % S, so a cache of the window's size holds exactly
    the last S tokens; while pos < S the ring is the identity.  Reads
    nothing back to the host, so it can be captured in a CUDA graph."""
    b = token.shape[0]
    s = cache.k.shape[2]
    dev = token.device
    pos = cache.length
    widx = pos % s
    slot = torch.arange(s, device=dev)[None]
    slot_pos = pos[:, None] - (pos[:, None] - slot) % s  # < 0: never written
    rows = torch.arange(b, device=dev)
    x = params["embed"][token][:, None, :]
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        q, kk, vv = _qkv(cfg, x, lp, cos, sin)
        cache.k[li, rows, widx] = kk[:, 0].to(cache.k.dtype)
        cache.v[li, rows, widx] = vv[:, 0].to(cache.v.dtype)
        attn = decode_attention(q, cache.k[li], cache.v[li], pos + 1,
                                sliding_window=cfg.sliding_window, kv_positions=slot_pos)
        x = _finish_layer(cfg, x, attn, lp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = F.linear(x[:, 0], params["lm_head"]).float()
    return logits, KVCache(cache.k, cache.v, pos + 1)


def prefill_extend(params: Params, cfg: MistralConfig, cache: KVCache, new_ids: torch.Tensor,
                   new_len: torch.Tensor,
                   attn_impl: str = "auto") -> Tuple[torch.Tensor, KVCache]:
    """Extend the cache with a right-padded chunk [B, T'] of prompt tokens
    at each row's offset (the prefix reuse of the 3-stage dialog): their
    K/V are written in place at [off, off + T'), queries at positions off..
    attend keys 0..S-1 with kv segments -1 from off + new_len on -> (last
    valid token's logits [B, V] f32, the cache at length off + new_len).
    Raises where a row's T' slots would pass the cache's end (usdm_tpu's
    XLA update would clamp its start and overwrite the prefix)."""
    b, t = new_ids.shape
    s = cache.k.shape[2]
    dev = new_ids.device
    off = cache.length
    if int((off + t).max()) > s:
        raise ValueError(f"prefill_extend: {t} tokens at offsets {off.tolist()} pass the "
                         f"cache's {s} slots")
    ar = torch.arange(t, device=dev)[None]
    positions = off[:, None] + ar
    q_seg = torch.where(ar < new_len[:, None], 0, -1).to(torch.int32).expand(b, t)
    kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
    kv_seg = torch.where(kv_pos < (off + new_len)[:, None], 0, -1).to(torch.int32)
    rows = torch.arange(b, device=dev)[:, None]
    x = params["embed"][new_ids]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        q, kk, vv = _qkv(cfg, x, lp, cos, sin)
        cache.k[li, rows, positions] = kk.to(cache.k.dtype)
        cache.v[li, rows, positions] = vv.to(cache.v.dtype)
        attn = mha(q, cache.k[li], cache.v[li], q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                   q_positions=positions, kv_positions=kv_pos, causal=True,
                   sliding_window=cfg.sliding_window, impl=attn_impl)
        x = _finish_layer(cfg, x, attn, lp)
    return _last_logits(params, cfg, x, new_len), KVCache(cache.k, cache.v, off + new_len)


def convert_hf_state_dict(state: Dict[str, torch.Tensor], cfg: MistralConfig, dtype=None,
                          device="cpu", int8: bool = False) -> Params:
    """A HF MistralForCausalLM state dict (host tensors) -> the port's
    params on `device` in `dtype` (default cfg.dtype): nn.Linear's [out, in]
    becomes [in, out], lm_head stays [V, D].  Each tensor is popped from
    `state` as it is converted, and with `int8` each layer's projections are
    quantized to W8A8 as the layer arrives, so the float and int8 copies of
    the model never coexist (usdm_tpu quantizes after the load)."""
    from usdm_tpu_torch.core.convert import take
    from usdm_tpu_torch.models.quant import quantize_weight

    dt = torch_dtype(dtype or cfg.dtype)

    def proj(name):  # [out, in] -> [in, out], or its W8A8 leaf
        w = take(state, name, device, dt).t()
        return quantize_weight(w) if int8 else w.contiguous()

    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {"ln1": take(state, p + "input_layernorm.weight", device, dt),
              "ln2": take(state, p + "post_attention_layernorm.weight", device, dt)}
        lp.update({k: proj(p + v + ".weight") for k, v in names.items()})
        layers.append(lp)
    return {"embed": take(state, "model.embed_tokens.weight", device, dt), "layers": layers,
            "final_norm": take(state, "model.norm.weight", device, dt),
            "lm_head": take(state, "lm_head.weight", device, dt)}
