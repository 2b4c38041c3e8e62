"""Three-stage chain-of-modality dialog: templates and post-processing.

Port of usdm_tpu/engine/dialog.py (`INSTRUCTION`, `default_template`,
`strip_exact_multiple`, `DialogResult`, `run_dialog`, `DialogPolicy`):
given user speech units, run (A) unit2text ASR, (B) text2text response,
(C) text2unit TTS, re-templating the prompt between stages.  Two decode
backends: the paged engine (`engine.server.PagedDialogPolicy`, respond()'s
default) and the dense prefix-reuse loop (`DialogPolicy`,
respond(use_paged=False), engine/generate.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from usdm_tpu_torch.audio.units import parse_units, units_to_string
from usdm_tpu_torch.audio.wav import ceil_to
from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.engine.generate import (
    DenseLoop,
    dense_cache_len,
    generate,
    generate_with_cache,
)
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.ops.sampling import (
    STAGE_TEXT2TEXT,
    STAGE_TEXT2UNIT,
    STAGE_UNIT2TEXT,
    stage_allow_mask,
    stage_eos,
)

INSTRUCTION = (
    "Below is a conversation between the user and the agent. Each turn includes "
    "the user's speech and its corresponding transcript, along with the agent's "
    "response text and the corresponding speech.\n"
)


def default_template(user_unit: str, user_text: Optional[str] = None,
                     agent_text: Optional[str] = None) -> str:
    template = INSTRUCTION + "\n### User\n" + f"{user_unit}<|correspond|>"
    if user_text:
        template += f"{user_text}\n### Agent\n"
    if agent_text:
        template += f"{agent_text}<|correspond|>"
    return template


def strip_exact_multiple(text: str, patterns: List[str]) -> str:
    for pattern in patterns:
        if text.startswith(pattern):
            text = text[len(pattern):]
        if text.endswith(pattern):
            text = text[: -len(pattern)]
    return text


@dataclasses.dataclass
class DialogResult:
    user_text: str
    agent_text: str
    agent_units: List[int]
    stage_tokens: dict


def run_dialog(tok, run_stage, user_units: List[int]) -> DialogResult:
    """`run_stage(stage, prompt) -> List[int]` supplies the decode backend."""
    user_unit_str = units_to_string(user_units)

    out_a = run_stage(STAGE_UNIT2TEXT, default_template(user_unit_str))
    user_text = strip_exact_multiple(tok.decode(out_a).split("<|correspond|>")[-1], ["\n", " "])

    out_b = run_stage(STAGE_TEXT2TEXT, default_template(user_unit_str, user_text=user_text))
    agent_text = strip_exact_multiple(tok.decode(out_b).split("\n")[-1],
                                      ["\n", " ", "<|correspond|>"])

    out_c = run_stage(STAGE_TEXT2UNIT, default_template(user_unit_str, user_text=user_text,
                                                        agent_text=agent_text))
    agent_units = parse_units(tok.decode(out_c).split("<|correspond|>")[-1])

    return DialogResult(
        user_text=user_text,
        agent_text=agent_text,
        agent_units=agent_units,
        stage_tokens={"unit2text": out_a, "text2text": out_b, "text2unit": out_c},
    )


class DialogPolicy:
    """The 3-stage decode over the dense KV cache (usdm_tpu's DialogPolicy).

    With `reuse_prefix` the cache is kept across the stages of a turn and
    each stage prefills only its template's suffix past the common prefix,
    bucketed to a 64-token multiple; where `common + bucket + max_new + 1`
    would pass the cache, it grows to the next multiple of 512 and starts
    fresh (nothing is ever written past the cache).  Without, each stage
    prefills its whole prompt padded to a multiple of 128.  A stage's
    budget is tokenizer.model_max_length - prompt - 1 (capped by
    `max_new_tokens`), bucketed down to a multiple of 256 from 256 on.

    `attn_impl` is the port's (`auto | flash | plain`).  Sampling draws its
    noise from a torch.Generator on the params' device seeded with `seed`.
    `loops` holds the DenseLoops by (device, cache length, eager), so the
    policies of one pipeline share their caches and CUDA graphs; `eager`
    runs the decode steps without graphs."""

    def __init__(self, params: M.Params, cfg: MistralConfig, tokenizer,
                 max_new_tokens: Optional[int] = None, attn_impl: str = "auto",
                 reuse_prefix: bool = True, cache_len: Optional[int] = None, top_k: int = 1,
                 top_p: float = 1.0, temperature: float = 1.0, seed: int = 0,
                 loops: Optional[Dict[tuple, DenseLoop]] = None, eager: bool = False):
        self.params, self.cfg, self.tok = params, cfg, tokenizer
        self.ts = tokenizer.ts
        self.max_new_tokens = max_new_tokens
        self.attn_impl = attn_impl
        self.reuse_prefix = reuse_prefix
        self.cache_len = cache_len or min(cfg.max_seq_len, 8192)
        self.top_k, self.top_p, self.temperature = top_k, top_p, temperature
        self.eager = eager
        self.device = params["embed"].device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._loops = {} if loops is None else loops
        self._live = False  # the cache holds this turn's prefix
        self._cached_ids: List[int] = []
        self._masks = {s: torch.from_numpy(stage_allow_mask(s, self.ts)).to(self.device)
                       for s in (STAGE_UNIT2TEXT, STAGE_TEXT2TEXT, STAGE_TEXT2UNIT)}

    def loop(self, cache_len: int) -> DenseLoop:
        """The DenseLoop over a [1, cache_len] cache, made at first use."""
        key = (self.device, cache_len, self.eager)
        if key not in self._loops:
            self._loops[key] = DenseLoop(
                self.params, self.cfg, M.KVCache.create(self.cfg, 1, cache_len, self.device),
                graphs=not self.eager)
        return self._loops[key]

    def _stage_budget(self, n_prompt: int) -> int:
        budget = self.tok.model_max_length - n_prompt - 1
        if self.max_new_tokens is not None:
            budget = min(budget, self.max_new_tokens)
        budget = max(budget, 1)
        return budget if budget < 256 else (budget // 256) * 256

    def _sampling(self) -> dict:
        return dict(attn_impl=self.attn_impl, top_k=self.top_k, top_p=self.top_p,
                    temperature=self.temperature, generator=self._gen)

    def _ids(self, ids: List[int], width: int) -> torch.Tensor:
        padded = np.full((1, width), self.ts.pad_id, np.int64)
        padded[0, : len(ids)] = ids
        return torch.from_numpy(padded).to(self.device)

    def _run_stage(self, stage: str, prompt: str, max_new: Optional[int] = None) -> List[int]:
        ids = self.tok.encode(prompt)
        max_new = max_new or self._stage_budget(len(ids))
        if self.reuse_prefix:
            return self._run_stage_cached(stage, ids, max_new)
        bucket = ceil_to(len(ids), 128)
        total = dense_cache_len(self.cfg, bucket, max_new)
        tokens, lengths = generate(
            self.params, self.cfg, self._ids(ids, bucket),
            torch.tensor([len(ids)], device=self.device), self._masks[stage],
            stage_eos(stage, self.ts), max_new_tokens=max_new, cache_len=total,
            loop=self.loop(total), **self._sampling())
        return tokens[0, : int(lengths[0])].tolist()

    def _run_stage_cached(self, stage: str, ids: List[int],
                          max_new: Optional[int] = None) -> List[int]:
        """A stage's decode reusing the cached common prompt prefix."""
        max_new = max_new or self._stage_budget(len(ids))
        common = 0
        if self._live:
            limit = min(len(self._cached_ids), len(ids))
            while common < limit and self._cached_ids[common] == ids[common]:
                common += 1
        bucket = ceil_to(len(ids) - common, 64)
        # the bucket-padded suffix and the decode must fit: usdm_tpu's XLA
        # update would clamp its start and overwrite the prefix, and an
        # index past the cache would fault here
        budget = max_new + 1
        if common + bucket + budget > self.cache_len:
            fresh = ceil_to(len(ids), 64) + budget
            self.cache_len = ceil_to(max(common + bucket + budget, fresh), 512)
            self._live = False
        if not self._live or common == 0:
            common = 0
            bucket = ceil_to(len(ids), 64)
        loop = self.loop(self.cache_len)
        # roll the cache back to the shared prefix, then extend with the suffix
        cache = M.KVCache(loop.cache.k, loop.cache.v,
                          torch.tensor([common], dtype=torch.int64, device=self.device))
        tokens, lengths, _ = generate_with_cache(
            self.params, self.cfg, cache, self._ids(ids[common:], bucket),
            torch.tensor([len(ids) - common], device=self.device), self._masks[stage],
            stage_eos(stage, self.ts), max_new_tokens=max_new, loop=loop, **self._sampling())
        self._live = True
        # the generated tokens are not part of the reusable prefix: the next
        # stage's template re-derives them from text
        self._cached_ids = list(ids)
        return tokens[0, : int(lengths[0])].tolist()

    def respond_to_units(self, user_units: List[int]) -> DialogResult:
        self._live = False  # a fresh conversation
        self._cached_ids = []
        return run_dialog(self.tok, self._run_stage, user_units)
