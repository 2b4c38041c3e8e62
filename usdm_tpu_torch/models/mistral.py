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

from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.models.quant import qmm
from usdm_tpu_torch.ops.attention import decode_attention, mha

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def init_params(cfg: MistralConfig, generator: torch.Generator, device="cpu",
                dtype: Optional[str] = None, shardings: Optional[Params] = None) -> Params:
    """Random weights N(0, initializer_range), norms at 1, drawn on `device`
    from `generator` (which must live on that device).  `shardings`
    (param_shardings): each leaf is cut to this rank's block as soon as it
    is drawn, so no more than one whole leaf exists at a time, and every
    rank draws the single-device model's numbers."""
    dt = torch_dtype(dtype or cfg.dtype)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = cfg.initializer_range

    def place(t, *path):
        if shardings is None:
            return t
        sh = shardings
        for k in path:
            sh = sh[k]
        return sh.shard(t)

    def dense(*shape):
        return (torch.randn(*shape, generator=generator, device=device, dtype=dt) * std)

    def ones(n):
        return torch.ones(n, device=device, dtype=dt)

    layers = []
    for i in range(cfg.num_layers):
        lp = {k: place(ones(d), "layers", i, k) for k in ("ln1", "ln2")}
        for k, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)), ("wv", (d, hkv * hd)),
                         ("wo", (h * hd, d)), ("w_gate", (d, f)), ("w_up", (d, f)),
                         ("w_down", (f, d))):
            lp[k] = place(dense(*shape), "layers", i, k)
        layers.append(lp)
    embed = place(dense(v, d), "embed")
    return {"embed": embed, "layers": layers, "final_norm": place(ones(d), "final_norm"),
            "lm_head": place(dense(v, d), "lm_head")}


# the projections a tensor-parallel rank splits: column-split (heads, FFN
# columns) and row-split (their partial sums are all-reduced)
COL, ROW = ("wq", "wk", "wv", "w_gate", "w_up"), ("wo", "w_down")


LAYER_SPECS = {k: (None,) if k.startswith("ln") else
               (MS.DATA_AXIS, MS.MODEL_AXIS) if k in COL else (MS.MODEL_AXIS, MS.DATA_AXIS)
               for k in ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}


def param_specs(cfg: MistralConfig) -> Params:
    """usdm_tpu's param_specs in the port's layouts: FSDP over `data` on one
    dimension, TP over `model` on the other (projections [Din, Dout]:
    column split on Dout, row split on Din; embed and lm_head [V, D]: the
    vocab over model, D over data); the norms replicated."""
    vocab = (MS.MODEL_AXIS, MS.DATA_AXIS)
    return {"embed": vocab, "layers": [dict(LAYER_SPECS) for _ in range(cfg.num_layers)],
            "final_norm": (None,), "lm_head": vocab}


def param_shardings(cfg: MistralConfig, mesh: "MS.Mesh") -> Params:
    """param_specs as core/mesh.py Shardings over `mesh` with each leaf's
    whole shape; embed and lm_head pad the vocab with zero rows to a
    multiple of tp (engine/tp.py shard_vocab's layout)."""
    from usdm_tpu_torch.engine.tp import check_tp

    check_tp(cfg, mesh.size(MS.MODEL_AXIS))
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"ln1": (d,), "ln2": (d,), "wq": (d, q), "wk": (d, kv), "wv": (d, kv),
              "wo": (q, d), "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    specs = param_specs(cfg)
    out = {"embed": MS.Sharding(mesh, specs["embed"], (v, d), pad=True),
           "layers": [{k: MS.Sharding(mesh, s, shapes[k]) for k, s in lp.items()}
                      for lp in specs["layers"]],
           "final_norm": MS.Sharding(mesh, (None,), (d,)),
           "lm_head": MS.Sharding(mesh, specs["lm_head"], (v, d), pad=True)}
    for sh in (out["embed"], *out["layers"][0].values()):
        sh.check()
    return out


def local_config(cfg: MistralConfig, mesh: Optional["MS.Mesh"]) -> MistralConfig:
    """A tensor-parallel rank's heads and FFN width."""
    if mesh is None:
        return cfg
    tp = mesh.size(MS.MODEL_AXIS)
    return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                       intermediate_size=cfg.intermediate_size // tp)


def _gather_leaves(lp: Params, mesh: "MS.Mesh", dt: Optional[torch.dtype]) -> Params:
    """A layer's FSDP shards gathered over `data` at use (cast to `dt`
    first, None: kept), the norms as they are: inside a rematerialized layer
    function the recompute gathers again, and the backward reduce-scatters
    each weight's gradient."""
    return {k: MS.gather_param(v, mesh, LAYER_SPECS[k].index(MS.DATA_AXIS), dt or v.dtype)
            if MS.DATA_AXIS in LAYER_SPECS[k] else v for k, v in lp.items()}


def _vocab_embed(ids: torch.Tensor, shard: torch.Tensor, mesh: "MS.Mesh") -> torch.Tensor:
    """The embedding lookup over a vocab-split, FSDP-sharded table: the
    rank's rows gathered over data, ids outside them looked up as zeros,
    the rows summed over model (exact: one rank holds each id)."""
    w = MS.gather_param(shard, mesh, 1, shard.dtype)
    rows = w.shape[0]
    local = ids - mesh.coord(MS.MODEL_AXIS) * rows
    inside = (local >= 0) & (local < rows)
    e = F.embedding(torch.where(inside, local, 0), w)
    return MS.reduce_from_model(torch.where(inside[..., None], e, 0.0), mesh)


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


def _qkv(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin, lw: Optional[Params] = None,
         mesh: Optional["MS.Mesh"] = None):
    """A layer's normed, projected and rotated q [B, T, H, hd], k and v
    [B, T, Hkv, hd]; `lw` the layer's LoRA adapters, if any.  Under a
    `mesh` the heads are this rank's (cfg local_config's) and the column-split
    products' input gradient is all-reduced over model."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    y = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    if mesh is not None:
        y = MS.copy_to_model(y, mesh)
    q = apply_rope(_proj(y, lp, "wq", lw).reshape(b, t, h, hd), cos, sin)
    kk = apply_rope(_proj(y, lp, "wk", lw).reshape(b, t, hkv, hd), cos, sin)
    return q, kk, _proj(y, lp, "wv", lw).reshape(b, t, hkv, hd)


def _finish_layer(cfg: MistralConfig, x: torch.Tensor, attn: torch.Tensor, lp: Params,
                  lw: Optional[Params] = None, mesh: Optional["MS.Mesh"] = None):
    """The attention output's projection and residual, then the MLP block;
    under a `mesh` the row-split products' partial sums (wo, w_down) are
    all-reduced over model."""
    b, t = x.shape[:2]
    o = _proj(attn.reshape(b, t, -1), lp, "wo", lw)
    if mesh is None:
        x = x + o
        return x + mlp(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)
    x = x + MS.reduce_from_model(o, mesh)
    y = MS.copy_to_model(rms_norm(x, lp["ln2"], cfg.rms_norm_eps), mesh)
    return x + MS.reduce_from_model(mlp(y, lp), mesh)


def _layer(cfg: MistralConfig, x: torch.Tensor, lp: Params, cos, sin,
           segment_ids: torch.Tensor, positions: torch.Tensor, attn_impl: str,
           lw: Optional[Params] = None, mesh: Optional["MS.Mesh"] = None) -> torch.Tensor:
    q, kk, vv = _qkv(cfg, x, lp, cos, sin, lw, mesh)
    attn = mha(q, kk, vv, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
               q_positions=positions, kv_positions=positions, causal=True,
               sliding_window=cfg.sliding_window, impl=attn_impl)
    return _finish_layer(cfg, x, attn, lp, lw, mesh)


def _compute_leaves(lp: Params, dt: torch.dtype) -> Params:
    """A layer's weights of two or more dimensions in the compute dtype `dt`
    (the norms stay as they are: rms_norm computes in f32; W8A8 leaves stay
    quantized).  No copy where a weight already has that dtype."""
    return {k: v.to(dt) if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in lp.items()}


def forward_hidden(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None, attn_impl: str = "auto",
                   remat: bool = False, lora: Optional[list] = None,
                   mesh: Optional["MS.Mesh"] = None) -> torch.Tensor:
    """The packed forward up to and including the final norm -> [B, T, D]
    in the compute dtype cfg.dtype.  Weights of another dtype (f32 masters)
    are cast layer by layer inside the layer function, so with `remat`
    (each layer under torch.utils.checkpoint, recomputed in backward) only
    one layer's compute copy exists at a time; `lora` holds each layer's
    adapters (train/lora.py), None for a layer or a projection without.
    `positions` restart at each packed subsample and `segment_ids` (< 0:
    padding) isolate the subsamples.  `mesh`: `params` are this rank's
    param_shardings blocks; each layer's weights are gathered over data
    (cast first) inside the layer function, the heads and FFN columns are
    the rank's, and the row-split partial sums are all-reduced over model."""
    b, t = input_ids.shape
    dev = input_ids.device
    dt = torch_dtype(cfg.dtype)
    if segment_ids is None:
        segment_ids = torch.zeros((b, t), dtype=torch.int32, device=dev)
    if positions is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    # F.embedding: its CUDA backward sums repeated ids in a fixed order
    if mesh is None:
        x = F.embedding(input_ids, params["embed"]).to(dt)
    else:
        x = _vocab_embed(input_ids, params["embed"], mesh).to(dt)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    lcfg = local_config(cfg, mesh)

    def layer(x, lp, lw):
        w = _compute_leaves(lp, dt) if mesh is None else _gather_leaves(lp, mesh, dt)
        return _layer(lcfg, x, w, cos, sin, segment_ids, positions, attn_impl, lw, mesh)

    for i, lp in enumerate(params["layers"]):
        lw = None if lora is None else lora[i]
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, lp, lw, use_reentrant=False)
        else:
            x = layer(x, lp, lw)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def lm_head_logits(h: torch.Tensor, w: torch.Tensor, mesh: Optional["MS.Mesh"],
                   vocab: int) -> torch.Tensor:
    """h @ w.T in h's dtype; under a `mesh` (w this rank's vocab rows, h
    after copy_to_model) the vocab blocks are gathered and cut to `vocab`."""
    z = F.linear(h, w)
    return z if mesh is None else MS.gather_vocab(z, mesh, vocab)


def head_weight(params: Params, mesh: Optional["MS.Mesh"], dt: torch.dtype) -> torch.Tensor:
    """lm_head in `dt`: gathered over data under a `mesh` (its vocab rows)."""
    if mesh is None:
        return params["lm_head"].to(dt)
    return MS.gather_param(params["lm_head"], mesh, 1, dt)


def forward(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
            segment_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attn_impl: str = "auto", lora: Optional[list] = None,
            mesh: Optional["MS.Mesh"] = None) -> torch.Tensor:
    """Packed full-sequence forward -> logits [B, T, V] f32 (`mesh`: as
    forward_hidden's, every rank gets the whole logits)."""
    x = forward_hidden(params, cfg, input_ids, segment_ids, positions, attn_impl, lora=lora,
                       mesh=mesh)
    if mesh is not None:
        x = MS.copy_to_model(x, mesh)
    return lm_head_logits(x, head_weight(params, mesh, x.dtype), mesh, cfg.vocab_size).float()


def _token_ll(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor, mesh: Optional["MS.Mesh"] = None,
              vocab: int = 0) -> torch.Tensor:
    """Sum of the log-likelihoods of `labels` under lm_head `w` [V, D] at
    the valid positions of hidden `h` [B, T, D] (logits and log-softmax f32)."""
    logp = torch.log_softmax(lm_head_logits(h, w, mesh, vocab).float(), dim=-1)
    return (logp.gather(-1, labels[..., None])[..., 0] * valid).sum()


def loss_fn(params: Params, cfg: MistralConfig, input_ids: torch.Tensor, labels: torch.Tensor,
            segment_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, attn_impl: str = "auto",
            remat: bool = True, lora: Optional[list] = None,
            ce_chunk: int = 1024, mesh: Optional["MS.Mesh"] = None,
            replicated: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shifted mean cross-entropy over the labels that are not -100 ->
    (loss, {"loss", "ntokens"}), computed in cfg.dtype as forward_hidden.
    The lm_head product and the log-softmax run per `ce_chunk` positions,
    each chunk recomputed in backward (torch.utils.checkpoint), so the full
    [B, T, V] f32 logits never exist; 0 (or T - 1 <= ce_chunk) is one
    chunk, not recomputed.  The same per-token numbers either way.

    `mesh`: the batch is this rank's rows; the loss is the global one,
    usdm_tpu's sum over the global batch over the global count of valid
    tokens: the count is all-reduced over the batch axes first, and each
    rank's sum is divided by it, so the ranks' losses (and gradients) add up
    to the global ones.  The returned `loss` is this rank's part (for
    backward), aux["loss"] and aux["ntokens"] the global values.  The params
    are param_shardings blocks (FSDP + TP), or whole on every rank with
    `replicated` (LoRA's base)."""
    sharded = mesh if mesh is not None and not replicated else None
    hidden = forward_hidden(params, cfg, input_ids, segment_ids, positions, attn_impl, remat,
                            lora, sharded)
    sh = hidden[:, :-1]
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, 0)
    count = valid.sum()
    if mesh is not None:
        count = MS.all_reduce(count.clone(), mesh, mesh.batch_axes)
    n = count.clamp(min=1)
    if sharded is not None:
        sh = MS.copy_to_model(sh, sharded)
    w = head_weight(params, sharded, sh.dtype)
    ll = functools.partial(_token_ll, mesh=sharded, vocab=cfg.vocab_size)
    t1 = sh.shape[1]
    if not ce_chunk or t1 <= ce_chunk:
        total = ll(sh, w, safe, valid)
    else:
        total = sum(torch.utils.checkpoint.checkpoint(
            ll, sh[:, c:c + ce_chunk], w, safe[:, c:c + ce_chunk],
            valid[:, c:c + ce_chunk], use_reentrant=False) for c in range(0, t1, ce_chunk))
    loss = -total / n
    shown = loss.detach()
    if mesh is not None:
        shown = MS.all_reduce(shown.clone(), mesh, mesh.batch_axes)
    return loss, {"loss": shown, "ntokens": count}


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


def _serving_weights(lp: Params, mesh: Optional["MS.Mesh"]) -> Params:
    return lp if mesh is None else _gather_leaves(lp, mesh, None)


def _embed_rows(params: Params, ids: torch.Tensor, mesh: Optional["MS.Mesh"]) -> torch.Tensor:
    return params["embed"][ids] if mesh is None else _vocab_embed(ids, params["embed"], mesh)


def _last_logits(params: Params, cfg: MistralConfig, x: torch.Tensor,
                 n: torch.Tensor, mesh: Optional["MS.Mesh"] = None) -> torch.Tensor:
    """Logits [B, V] f32 of each row's last valid position n - 1."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = torch.clamp(n - 1, 0, x.shape[1] - 1)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    w = params["lm_head"] if mesh is None else head_weight(params, mesh, x.dtype)
    return lm_head_logits(x_last, w, mesh, cfg.vocab_size).float()


def prefill(params: Params, cfg: MistralConfig, input_ids: torch.Tensor,
            input_len: torch.Tensor, cache: KVCache,
            attn_impl: str = "auto",
            mesh: Optional["MS.Mesh"] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run the right-padded prompt [B, T], write its K/V into cache slots
    [0, T) in place -> (last valid token's logits [B, V] f32, the cache at
    length input_len).  `mesh`: params are param_shardings blocks (gathered
    over data per layer), the cache holds this rank's kv heads
    (KVCache.create(local_config(cfg, mesh), ...)), and every rank gets the
    whole logits."""
    b, t = input_ids.shape
    dev = input_ids.device
    lcfg = local_config(cfg, mesh)
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    seg = torch.where(positions < input_len[:, None], 0, -1).to(torch.int32)
    x = _embed_rows(params, input_ids, mesh)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        lp = _serving_weights(lp, mesh)
        q, kk, vv = _qkv(lcfg, x, lp, cos, sin, mesh=mesh)
        cache.k[li, :, :t] = kk.to(cache.k.dtype)
        cache.v[li, :, :t] = vv.to(cache.v.dtype)
        attn = mha(q, kk, vv, q_segment_ids=seg, kv_segment_ids=seg, q_positions=positions,
                   kv_positions=positions, causal=True, sliding_window=cfg.sliding_window,
                   impl=attn_impl)
        x = _finish_layer(lcfg, x, attn, lp, mesh=mesh)
    length = input_len.to(torch.int64)
    return _last_logits(params, cfg, x, length, mesh), KVCache(cache.k, cache.v, length)


def decode_step(params: Params, cfg: MistralConfig, token: torch.Tensor,
                cache: KVCache, mesh: Optional["MS.Mesh"] = None) -> Tuple[torch.Tensor, KVCache]:
    """One step: token [B] -> (logits [B, V] f32, the cache one longer).
    The cache is a ring over its S slots: the token at position pos writes
    slot pos % S in place, and attention masks by each slot's position
    pos - (pos - slot) % S, so a cache of the window's size holds exactly
    the last S tokens; while pos < S the ring is the identity.  Reads
    nothing back to the host, so it can be captured in a CUDA graph
    (without a `mesh`, which is prefill's)."""
    b = token.shape[0]
    s = cache.k.shape[2]
    dev = token.device
    lcfg = local_config(cfg, mesh)
    pos = cache.length
    widx = pos % s
    slot = torch.arange(s, device=dev)[None]
    slot_pos = pos[:, None] - (pos[:, None] - slot) % s  # < 0: never written
    rows = torch.arange(b, device=dev)
    x = _embed_rows(params, token, mesh)[:, None, :]
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        lp = _serving_weights(lp, mesh)
        q, kk, vv = _qkv(lcfg, x, lp, cos, sin, mesh=mesh)
        cache.k[li, rows, widx] = kk[:, 0].to(cache.k.dtype)
        cache.v[li, rows, widx] = vv[:, 0].to(cache.v.dtype)
        attn = decode_attention(q, cache.k[li], cache.v[li], pos + 1,
                                sliding_window=cfg.sliding_window, kv_positions=slot_pos)
        x = _finish_layer(lcfg, x, attn, lp, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)[:, 0]
    w = params["lm_head"] if mesh is None else head_weight(params, mesh, x.dtype)
    return lm_head_logits(x, w, mesh, cfg.vocab_size).float(), KVCache(cache.k, cache.v, pos + 1)


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
        if key in COL or not int8:  # the rank's rows (column split) or columns
            w = TP.block(w, 0 if key in COL else 1, tp, rank)
        w = w.to(device=device, dtype=dt).t()
        if not int8:
            return w.contiguous()
        return TP.shard_leaf(key, quantize_weight(w), tp, rank) if key in ROW else \
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
