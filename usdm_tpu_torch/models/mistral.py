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

`forward` is the dense packed forward, kept as the parity anchor of the
paged engine (engine/paged_ops.py), which is the serving path.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.models.quant import qmm
from usdm_tpu_torch.ops.attention import mha

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


def _layer(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin,
           segment_ids: torch.Tensor, positions: torch.Tensor, attn_impl: str) -> torch.Tensor:
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    q = apply_rope(qmm(y, lp["wq"]).reshape(b, t, h, hd), cos, sin)
    kk = apply_rope(qmm(y, lp["wk"]).reshape(b, t, hkv, hd), cos, sin)
    vv = qmm(y, lp["wv"]).reshape(b, t, hkv, hd)
    attn = mha(q, kk, vv, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
               q_positions=positions, kv_positions=positions, causal=True,
               sliding_window=cfg.sliding_window, impl=attn_impl)
    x = x + qmm(attn.reshape(b, t, h * hd), lp["wo"])
    return x + mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)


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
