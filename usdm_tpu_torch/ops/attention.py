"""Attention with segment ids, positions and sliding windows.

Port of usdm_tpu/ops/attention.py.  Segment ids isolate packed sequences
(negative = padding: attends nothing, attended by nothing); causal and
sliding-window masks come from positions.  GQA contracts queries grouped as
[B, T, Hkv, G, d] against K/V of Hkv heads, with no repeat.

`mha(impl="auto")` takes the flash kernel (K2) for CUDA tensors with no
additive bias and at least 128 queries, as the JAX package takes its Pallas
kernel on a TPU; otherwise the plain path below.  `decode_attention` is the
dense decode loop's one-query attention over a whole (padded or ring) KV
cache, plain PyTorch as usdm_tpu's is plain jnp.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def make_attention_mask(
    q_segment_ids: torch.Tensor,  # [B, Tq]
    kv_segment_ids: torch.Tensor,  # [B, Tk]
    q_positions: torch.Tensor,  # [B, Tq]
    kv_positions: torch.Tensor,  # [B, Tk]
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """[B, Tq, Tk] boolean mask (True = attend)."""
    qs = q_segment_ids[:, :, None]
    mask = (qs == kv_segment_ids[:, None, :]) & (qs >= 0)
    if causal:
        mask = mask & (q_positions[:, :, None] >= kv_positions[:, None, :])
    if sliding_window is not None:
        mask = mask & (q_positions[:, :, None] - kv_positions[:, None, :] <= sliding_window)
    return mask


def plain_attention(
    q: torch.Tensor,  # [B, Tq, H, d]
    k: torch.Tensor,  # [B, Tk, Hkv, d]
    v: torch.Tensor,  # [B, Tk, Hkv, d]
    mask: Optional[torch.Tensor],  # [B, Tq, Tk] bool
    bias: Optional[torch.Tensor] = None,  # [B, H, Tq, Tk] additive
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention in f32 (usdm_tpu's `_xla_attention`)."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.reshape(b, tq, hkv, g, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if bias is not None:
        scores = scores + bias.reshape(b, hkv, g, tq, -1).float()
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, tq, h, d).to(q.dtype)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head attention over [B, T, H, d] tensors with GQA support."""
    b, tq = q.shape[:2]
    tk = k.shape[1]
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(tq, device=dev)[None].expand(b, tq)
    if kv_positions is None:
        kv_positions = torch.arange(tk, device=dev)[None].expand(b, tk)
    if q_segment_ids is None:
        q_segment_ids = torch.zeros((b, tq), dtype=torch.int32, device=dev)
    if kv_segment_ids is None:
        kv_segment_ids = torch.zeros((b, tk), dtype=torch.int32, device=dev)

    if impl == "auto":
        impl = "flash" if (q.is_cuda and bias is None and tq >= 128) else "plain"
    if impl == "flash":
        from usdm_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, q_segment_ids, kv_segment_ids, q_positions,
                               kv_positions, causal=causal, sliding_window=sliding_window,
                               scale=scale)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    mask = make_attention_mask(q_segment_ids, kv_segment_ids, q_positions, kv_positions,
                               causal, sliding_window)
    return plain_attention(q, k, v, mask, bias=bias, scale=scale)


def _scores_f32(qg: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """[N, G, d] x [N, d, S] -> f32 scores from operands of any float type:
    usdm_tpu's preferred_element_type=f32.  bf16 on the card takes bmm's
    out_dtype (f32 accumulation and output, no f32 copy of the cache); on
    the CPU the operands are widened, exactly (bf16 products are exact in
    f32)."""
    if qg.dtype == torch.float32:
        return torch.bmm(qg, kt)
    if qg.is_cuda:
        return torch.bmm(qg, kt, out_dtype=torch.float32)
    return torch.bmm(qg.float(), kt.float())


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, d] one query step
    k_cache: torch.Tensor,  # [B, S, Hkv, d]
    v_cache: torch.Tensor,  # [B, S, Hkv, d]
    cache_len: torch.Tensor,  # [B] valid cache entries, this step's included
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    kv_positions: Optional[torch.Tensor] = None,  # [B, S] absolute position per slot
) -> torch.Tensor:
    """One-token attention against a dense KV cache (usdm_tpu's
    `decode_attention`).  Valid keys are positions [0, cache_len); with a
    window also qpos - pos <= window, qpos = cache_len - 1.  With
    `kv_positions` (a ring cache; negative = never written) validity is by
    each slot's position rather than its index.  Scores and softmax in f32;
    the probabilities are cast to V's type for the second product, as
    usdm_tpu does.  Each batch row reads its K and V in place (one strided
    batched product over the kv heads; nothing is copied)."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    pos = torch.arange(s, device=q.device)[None] if kv_positions is None else kv_positions
    valid = (pos < cache_len[:, None]) & (pos >= 0)
    if sliding_window is not None:
        valid = valid & (cache_len[:, None] - 1 - pos <= sliding_window)
    qg = q.reshape(b, hkv, g, d)
    scores = torch.stack([_scores_f32(qg[i], k_cache[i].permute(1, 2, 0))
                          for i in range(b)]) * scale  # [B, Hkv, G, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.stack([torch.bmm(probs[i], v_cache[i].transpose(0, 1)) for i in range(b)])
    return out.reshape(b, 1, h, d)
