"""Logit masking and token sampling for the 3-stage dialog decode.

Port of usdm_tpu/ops/sampling.py.  Each dialog stage is a static boolean
allow-mask over the vocabulary plus a stage stop token:

  unit2text : ban [continue, vocab)            -> text only;  EOS "\\n"
  text2text : ban [unit_offset, vocab)         -> text + continue/correspond; EOS <|correspond|>
  text2unit : ban [0, unit_offset) except "▁"  -> units only; EOS "▁"

`sample_token` (the dense loop's, one set of hyper-parameters for every
row) and `sample_batched` (the engine's, per row) take their randomness as
explicit Gumbel noise, so a test can feed them the exact noise of the JAX
sampler (jax.random.categorical is argmax(logits + gumbel)); the callers
draw it from torch.Generators.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from usdm_tpu_torch.core.config import TokenSpace

NEG_INF = float(np.finfo(np.float32).min)

STAGE_UNIT2TEXT = "unit2text"
STAGE_TEXT2TEXT = "text2text"
STAGE_TEXT2UNIT = "text2unit"


@lru_cache(maxsize=16)
def stage_allow_mask(stage: str, ts: TokenSpace = TokenSpace()) -> np.ndarray:
    """Boolean [vocab] mask, True = token allowed during generation."""
    v = ts.vocab_size
    mask = np.ones(v, dtype=bool)
    if stage == STAGE_UNIT2TEXT:
        mask[ts.continue_id: v] = False
    elif stage == STAGE_TEXT2TEXT:
        mask[ts.unit_offset: v] = False
    elif stage == STAGE_TEXT2UNIT:
        mask[: ts.unit_offset] = False
        mask[ts.space_id] = True
    else:
        raise ValueError(f"unknown stage {stage}")
    return mask


def stage_eos(stage: str, ts: TokenSpace = TokenSpace()) -> int:
    return {
        STAGE_UNIT2TEXT: ts.newline_id,
        STAGE_TEXT2TEXT: ts.correspond_id,
        STAGE_TEXT2UNIT: ts.space_id,
    }[stage]


def apply_mask(logits: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    return torch.where(allow, logits, NEG_INF)


def sample_token(
    logits: torch.Tensor,  # [B, V] f32, already masked
    noise: Optional[torch.Tensor] = None,  # [B, V] f32 Gumbel noise
    top_k: int = 1,
    top_p: float = 1.0,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Greedy (top_k == 1) or temperature -> top-k -> top-p -> categorical
    sampling, usdm_tpu's `sample_token`.  Divides by a 0-d tensor (IEEE
    division on the card too) and makes it with a fill, so the call can be
    captured in a CUDA graph."""
    if top_k == 1:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        raise ValueError("non-greedy sampling needs its Gumbel noise")
    temp = torch.full((), max(temperature, 1e-6), dtype=torch.float32, device=logits.device)
    logits = logits / temp
    if top_k > 1:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sdesc = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sdesc, dim=-1), dim=-1)
        # the smallest prefix with cumulative probability >= top_p
        cutoff = torch.clamp((cum < top_p).sum(dim=-1), max=logits.shape[-1] - 1)
        logits = torch.where(logits < torch.gather(sdesc, 1, cutoff[:, None]), NEG_INF, logits)
    return torch.argmax(logits + noise, dim=-1)


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """-log(-log(u)), u ~ U(tiny, 1): the noise jax.random.gumbel draws."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min(float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))


def sample_batched(
    logits: torch.Tensor,  # [B, V] f32, already masked
    noise: torch.Tensor,  # [B, V] f32 Gumbel noise
    top_k: torch.Tensor,  # [B] int; 1 = greedy row, <= 0 = no k-filter
    top_p: torch.Tensor,  # [B] f32; >= 1 = no p-filter
    temperature: torch.Tensor,  # [B] f32
) -> torch.Tensor:
    """Per-row top-k -> top-p -> categorical sampling (HF warper order, one
    descending sort); rows with top_k == 1 take the argmax."""
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sdesc = torch.sort(scaled, dim=-1, descending=True).values
    idx = torch.arange(v, device=logits.device)[None]
    k_active = (top_k > 0)[:, None]
    kdesc = torch.where(k_active & (idx >= top_k[:, None]), NEG_INF, sdesc)
    kth = torch.where(
        k_active,
        torch.gather(sdesc, 1, torch.clamp(top_k - 1, 0, v - 1).long()[:, None]),
        NEG_INF,
    )
    probs = torch.softmax(kdesc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = torch.clamp((cum < top_p[:, None]).sum(dim=-1), 0, v - 1)
    pth = torch.where((top_p < 1.0)[:, None], torch.gather(kdesc, 1, cutoff[:, None]), NEG_INF)
    filtered = torch.where(scaled < torch.maximum(kth, pth), NEG_INF, scaled)
    sampled = torch.argmax(filtered + noise, dim=-1)
    return torch.where(top_k == 1, greedy, sampled)
