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
engine (engine/paged_ops.py), which is the serving path.  The training
half (usdm_tpu's): `forward_hidden` with segments, positions, per-layer
remat and LoRA adapters, `loss_fn` (the shifted mean cross-entropy, its
lm_head product chunked and recomputed in backward) and
`extend_embeddings`.  One layer function serves both: it computes in
cfg.dtype, casting a layer's f32 master weights at use, so training from
f32 masters computes in bf16 (usdm_tpu, given an f32 cfg.dtype by its
trainers' checkpoint loads, computes in f32 there).  `KVCache`,
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
import torch.utils.checkpoint

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


def _lora_delta(y: torch.Tensor, lw: Optional[Params], name: str) -> Optional[torch.Tensor]:
    """The low-rank side path y @ A @ B * (alpha / r) of projection `name`,
    its f32 adapters cast to y's (the compute) dtype at use; None when the
    projection is not adapted."""
    if lw is None or name not in lw:
        return None
    a = lw[name]
    return ((y @ a["a"].to(y.dtype)) @ a["b"].to(y.dtype)) * a["scale"].to(y.dtype)


def _proj(y: torch.Tensor, lp: Params, name: str, lw: Optional[Params]) -> torch.Tensor:
    out = qmm(y, lp[name])
    delta = _lora_delta(y, lw, name)
    return out if delta is None else out + delta


def _qkv(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin, lw: Optional[Params] = None):
    """A layer's normed, projected and rotated q [B, T, H, hd], k and v
    [B, T, Hkv, hd]; `lw` the layer's LoRA adapters, if any."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    q = apply_rope(_proj(y, lp, "wq", lw).reshape(b, t, h, hd), cos, sin)
    kk = apply_rope(_proj(y, lp, "wk", lw).reshape(b, t, hkv, hd), cos, sin)
    return q, kk, _proj(y, lp, "wv", lw).reshape(b, t, hkv, hd)


def _finish_layer(cfg: MistralConfig, x: torch.Tensor, attn: torch.Tensor, lp: Params,
                  lw: Optional[Params] = None):
    """The attention output's projection and residual, then the MLP block."""
    b, t = x.shape[:2]
    x = x + _proj(attn.reshape(b, t, -1), lp, "wo", lw)
    return x + mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)


def _layer(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin,
           segment_ids: torch.Tensor, positions: torch.Tensor, attn_impl: str,
           lw: Optional[Params] = None) -> torch.Tensor:
    q, kk, vv = _qkv(cfg, x, lp, cos, sin, lw)
    attn = mha(q, kk, vv, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
               q_positions=positions, kv_positions=positions, causal=True,
               sliding_window=cfg.sliding_window, impl=attn_impl)
    return _finish_layer(cfg, x, attn, lp, lw)


def _compute_leaves(lp: Params, dt: torch.dtype) -> Params:
    """A layer's weights of two or more dimensions in the compute dtype `dt`
    (the norms stay as they are: rms_norm computes in f32; W8A8 leaves stay
    quantized).  No copy where a weight already has that dtype."""
    return {k: v.to(dt) if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in lp.items()}


def forward_hidden(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None, attn_impl: str = "auto",
                   remat: bool = False, lora: Optional[list] = None) -> torch.Tensor:
    """The packed forward up to and including the final norm -> [B, T, D]
    in the compute dtype cfg.dtype.  Weights of another dtype (f32 masters)
    are cast layer by layer inside the layer function, so with `remat`
    (each layer under torch.utils.checkpoint, recomputed in backward) only
    one layer's compute copy exists at a time; `lora` holds each layer's
    adapters (train/lora.py), None for a layer or a projection without.
    `positions` restart at each packed subsample and `segment_ids` (< 0:
    padding) isolate the subsamples."""
    b, t = input_ids.shape
    dev = input_ids.device
    dt = torch_dtype(cfg.dtype)
    if segment_ids is None:
        segment_ids = torch.zeros((b, t), dtype=torch.int32, device=dev)
    if positions is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    # F.embedding: its CUDA backward sums repeated ids in a fixed order
    x = F.embedding(input_ids, params["embed"]).to(dt)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def layer(x, lp, lw):
        return _layer(cfg, x, _compute_leaves(lp, dt), cos, sin, segment_ids, positions,
                      attn_impl, lw)

    for i, lp in enumerate(params["layers"]):
        lw = None if lora is None else lora[i]
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, lp, lw, use_reentrant=False)
        else:
            x = layer(x, lp, lw)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def forward(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
            segment_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attn_impl: str = "auto", lora: Optional[list] = None) -> torch.Tensor:
    """Packed full-sequence forward -> logits [B, T, V] f32."""
    x = forward_hidden(params, cfg, input_ids, segment_ids, positions, attn_impl, lora=lora)
    return F.linear(x, params["lm_head"].to(x.dtype)).float()


def _token_ll(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Sum of the log-likelihoods of `labels` under lm_head `w` [V, D] at
    the valid positions of hidden `h` [B, T, D] (logits and log-softmax f32)."""
    logp = torch.log_softmax(F.linear(h, w).float(), dim=-1)
    return (logp.gather(-1, labels[..., None])[..., 0] * valid).sum()


def loss_fn(params: Params, cfg: MistralConfig, input_ids: torch.Tensor, labels: torch.Tensor,
            segment_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, attn_impl: str = "auto",
            remat: bool = True, lora: Optional[list] = None,
            ce_chunk: int = 1024) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shifted mean cross-entropy over the labels that are not -100 ->
    (loss, {"loss", "ntokens"}), computed in cfg.dtype as forward_hidden.
    The lm_head product and the log-softmax run per `ce_chunk` positions,
    each chunk recomputed in backward (torch.utils.checkpoint), so the full
    [B, T, V] f32 logits never exist; 0 (or T - 1 <= ce_chunk) is one
    chunk, not recomputed.  The same per-token numbers either way."""
    hidden = forward_hidden(params, cfg, input_ids, segment_ids, positions, attn_impl, remat,
                            lora)
    sh = hidden[:, :-1]
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0)
    n = valid.sum().clamp(min=1)
    w = params["lm_head"].to(sh.dtype)
    t1 = sh.shape[1]
    if not ce_chunk or t1 <= ce_chunk:
        total = _token_ll(sh, w, safe, valid)
    else:
        total = sum(torch.utils.checkpoint.checkpoint(
            _token_ll, sh[:, c:c + ce_chunk], w, safe[:, c:c + ce_chunk],
            valid[:, c:c + ce_chunk], use_reentrant=False) for c in range(0, t1, ce_chunk))
    loss = -total / n
    return loss, {"loss": loss.detach(), "ntokens": valid.sum()}


def extend_embeddings(params: Params, cfg: MistralConfig, new_vocab: int,
                      generator: Optional[torch.Generator] = None,
                      new_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Params:
    """Resize embed and lm_head (both [V, D]) to `new_vocab` rows: the new
    rows N(0, initializer_range^2) drawn from `generator` (on the params'
    device), or `new_rows` = (embed rows, lm_head rows), each [n_new, D],
    as given (usdm_tpu draws its rows with jax.random).  Returns a new dict
    sharing the layers."""
    embed, head = params["embed"], params["lm_head"]
    n_new = new_vocab - embed.shape[0]
    if n_new <= 0:
        return params
    if new_rows is None:
        std = cfg.initializer_range
        new_rows = tuple(torch.randn(n_new, embed.shape[1], generator=generator,
                                     device=embed.device) * std for _ in range(2))
    rows_in, rows_out = (r.to(embed.device, embed.dtype) for r in new_rows)
    if rows_in.shape != (n_new, embed.shape[1]) or rows_out.shape != rows_in.shape:
        raise ValueError(f"extend_embeddings: new rows must be [{n_new}, {embed.shape[1]}]")
    return {**params, "embed": torch.cat([embed.detach(), rows_in]),
            "lm_head": torch.cat([head.detach(), rows_out])}


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
                          device="cpu", int8: bool = False,
                          shard: Optional[Tuple[int, int]] = None) -> Params:
    """A HF MistralForCausalLM state dict (host tensors) -> the port's
    params on `device` in `dtype` (default cfg.dtype): nn.Linear's [out, in]
    becomes [in, out], lm_head stays [V, D].  Each tensor is popped from
    `state` as it is converted, and with `int8` each layer's projections are
    quantized to W8A8 as the layer arrives, so the float and int8 copies of
    the model never coexist (usdm_tpu quantizes after the load).

    `shard=(tp, rank)`: only that tensor-parallel rank's slices
    (engine/tp.py shard_params' result), each narrowed on the host before
    its copy, so no rank copies the whole model.  A row-split W8A8 weight
    is quantized whole (its scales run over the whole contraction) and
    then cut."""
    from usdm_tpu_torch.core.convert import take
    from usdm_tpu_torch.engine import tp as TP
    from usdm_tpu_torch.models.quant import quantize_weight

    dt = torch_dtype(dtype or cfg.dtype)
    tp, rank = shard or (1, 0)
    if shard is not None:
        TP.check_tp(cfg, tp)

    def proj(key, name):  # [out, in] -> [in, out], or its W8A8 leaf
        w = state.pop(name)
        if key in TP.COL or not int8:  # the rank's rows (column split) or columns
            w = TP.block(w, 0 if key in TP.COL else 1, tp, rank)
        w = w.to(device=device, dtype=dt).t()
        if not int8:
            return w.contiguous()
        return TP.shard_leaf(key, quantize_weight(w), tp, rank) if key in TP.ROW else \
            quantize_weight(w)

    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {"ln1": take(state, p + "input_layernorm.weight", device, dt),
              "ln2": take(state, p + "post_attention_layernorm.weight", device, dt)}
        lp.update({k: proj(k, p + v + ".weight") for k, v in names.items()})
        layers.append(lp)
    lm_head = TP.shard_vocab(state.pop("lm_head.weight"), tp, rank)
    return {"embed": take(state, "model.embed_tokens.weight", device, dt), "layers": layers,
            "final_norm": take(state, "model.norm.weight", device, dt),
            "lm_head": lm_head.to(device=device, dtype=dt)}
