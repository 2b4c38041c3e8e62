"""Constrained autoregressive generation over the dense KV cache, in PyTorch.

Port of usdm_tpu/engine/generate.py (`_pick`, `generate`,
`generate_with_cache`), the decode of respond(use_paged=False).  usdm_tpu
runs the whole decode as one `lax.while_loop` over a `GenState` carry;
here the prompt (or a stage's suffix) is prefilled eagerly and each decode
step is one replay of a CUDA graph (`DenseLoop`, whose persistent buffers
are the carry): decode_step -> _pick -> the frozen-row update -> the token
write at column n -> done -> n + 1.  The host reads `done` once after the
first token and then once every CHECK_EVERY (16) steps.  Steps taken after every row has finished touch
only frozen rows (they emit pad 0, hold the cache length and write a K/V
slot past the valid prefix), so tokens, lengths and the cache's valid
prefix are those of the step-by-step loop and of usdm_tpu's while_loop.

Sampled decoding (top_k != 1) takes Gumbel noise drawn on the host's side
of the graph from a torch.Generator: one [B, V] draw for the first token,
then one per step, in that order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.engine.paged_ops import GraphSet
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.ops.sampling import apply_mask, gumbel_noise, sample_token

CHECK_EVERY = 16


def _pick(logits: torch.Tensor, allow_mask: torch.Tensor, noise: Optional[torch.Tensor],
          top_k: int, top_p: float, temperature: float) -> torch.Tensor:
    """Constrained token choice: greedy when top_k == 1, else sampled."""
    masked = apply_mask(logits, allow_mask[None])
    if top_k == 1:
        return torch.argmax(masked, dim=-1)
    return sample_token(masked, noise, top_k, top_p, temperature)


def dense_cache_len(cfg: MistralConfig, t: int, max_new: int) -> int:
    """usdm_tpu's cache length for a T-token prompt and max_new tokens: t +
    max_new, bounded with a sliding window at max(t, window + 1) (the
    prompt needs its identity slots; window + 1 slots keep every key the
    `qpos - pos <= window` mask can reach, as a ring)."""
    total = t + max_new
    if cfg.sliding_window:
        total = min(total, max(t, cfg.sliding_window + 1))
    return total


class DenseLoop:
    """The decode loop's persistent state over one KV cache ([L, B, S, Hkv,
    d], its own length buffer) and its CUDA graphs: `last` [B] (the token
    each row feeds next), `done` [B], `n` [1] (the column the next step
    writes), a [B, max_new] token buffer per max_new, the stage's `allow`
    mask [V] and `eos`, and sampled steps' Gumbel `noise` [B, V].

    `run` takes the logits that prefill left, picks the first token, and
    decodes until every row has emitted `eos` or max_new tokens are out.
    On the card each step is one replay of the graph of its variant
    (max_new, top_k, top_p, temperature), captured at first use through
    `GraphSet` (eager warm-up on a side stream, `thread_local` capture, a
    failed capture raises, one memory pool); the stage's allow mask and EOS
    are buffers, so one graph serves every stage.  With `graphs=False` or
    on the CPU the same step runs eagerly.  `steps` counts decode steps,
    `replays` the graph replays among them, `syncs` the host's reads of
    `done`."""

    def __init__(self, params: M.Params, cfg: MistralConfig, cache: M.KVCache,
                 graphs: bool = True, mesh=None):
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.cache = M.KVCache(cache.k, cache.v, cache.length.clone())
        b, dev = cache.k.shape[1], cache.k.device
        self.device = dev
        self.last = torch.zeros(b, dtype=torch.int64, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.n = torch.zeros(1, dtype=torch.int64, device=dev)
        vocab = params["lm_head"].shape[0] if mesh is None else cfg.vocab_size
        self.allow = torch.zeros(vocab, dtype=torch.bool, device=dev)
        self.eos = torch.zeros((), dtype=torch.int64, device=dev)
        self.noise: Optional[torch.Tensor] = None
        self._tokens: dict = {}  # max_new -> [B, max_new] int64
        self.graphed = graphs and dev.type == "cuda" and mesh is None
        self._graphs = GraphSet(dev)
        self.steps = self.syncs = 0

    @property
    def replays(self) -> int:
        return self._graphs.replays

    def _draw(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        self.noise.copy_(gumbel_noise(tuple(self.noise.shape), generator, self.device))
        return self.noise

    def _step(self, key) -> None:
        """One decode step over the buffers (the body of usdm_tpu's
        while_loop): frozen rows emit pad 0 and keep their cache length."""
        max_new, top_k, top_p, temperature = key
        tokens, length = self._tokens[max_new], self.cache.length
        logits, _ = M.decode_step(self.params, self.cfg, self.last, self.cache, self.mesh)
        nxt = _pick(logits, self.allow, self.noise, top_k, top_p, temperature)
        nxt = torch.where(self.done, 0, nxt)
        length.copy_(torch.where(self.done, length, length + 1))
        tokens.index_copy_(1, self.n, nxt[:, None])
        self.done.copy_(self.done | (nxt == self.eos))
        self.last.copy_(nxt)
        self.n.add_(1)

    def _go(self, key) -> None:
        self.steps += 1
        if not self.graphed:
            self._step(key)
            return
        # a capture's warm-up runs the step with every row frozen: it writes
        # only the K/V slot at each row's length, which is past the valid
        # prefix and which the first real step overwrites
        carried = [self.last, self.done, self.n, self.cache.length, self._tokens[key[0]]]
        self._graphs.run(key, lambda: self._step(key), carried, self.done)

    def run(self, logits: torch.Tensor, length: torch.Tensor, allow_mask: torch.Tensor,
            eos_id: int, max_new: int, top_k: int = 1, top_p: float = 1.0,
            temperature: float = 1.0,
            generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode from prefill's last-token `logits` [B, V] and the cache's
        `length` [B] -> (tokens [B, max_new] with EOS included then pad 0,
        lengths [B] = tokens emitted up to and including EOS, else n)."""
        if top_k != 1 and self.noise is None:
            self.noise = torch.zeros(tuple(logits.shape), device=self.device)
        noise = self._draw(generator) if top_k != 1 else None
        tokens = self._tokens.get(max_new)
        if tokens is None:
            tokens = self._tokens[max_new] = torch.zeros(
                (logits.shape[0], max_new), dtype=torch.int64, device=self.device)
        tokens.zero_()
        self.cache.length.copy_(length)
        self.allow.copy_(allow_mask)
        self.eos.fill_(eos_id)
        first = _pick(logits, self.allow, noise, top_k, top_p, temperature)
        tokens[:, 0] = first
        self.last.copy_(first)
        self.done.copy_(first == self.eos)
        self.n.fill_(1)
        key = (max_new, top_k, float(top_p), float(temperature))
        n = 1
        while n < max_new:
            self.syncs += 1
            if bool(self.done.all()):
                break
            for _ in range(min(CHECK_EVERY, max_new - n)):
                if top_k != 1:
                    self._draw(generator)
                self._go(key)
                n += 1
        is_eos = tokens == eos_id
        lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, n)
        return tokens.clone(), lengths


def _loop_for(params: M.Params, cfg: MistralConfig, loop: Optional[DenseLoop], batch: int,
              cache_len: int, device, eager: bool, mesh=None) -> DenseLoop:
    if loop is None:
        cache = M.KVCache.create(M.local_config(cfg, mesh), batch, cache_len, device)
        return DenseLoop(params, cfg, cache, graphs=not eager, mesh=mesh)
    if tuple(loop.cache.k.shape[1:3]) != (batch, cache_len):
        raise ValueError(f"loop's cache is [B, S] = {tuple(loop.cache.k.shape[1:3])}, the "
                         f"call needs {(batch, cache_len)}")
    return loop


@torch.no_grad()
def generate(params: M.Params, cfg: MistralConfig, input_ids: torch.Tensor,
             input_len: torch.Tensor, allow_mask: torch.Tensor, eos_id: int,
             max_new_tokens: int = 256, cache_len: Optional[int] = None,
             attn_impl: str = "auto", top_k: int = 1, top_p: float = 1.0,
             temperature: float = 1.0, generator: Optional[torch.Generator] = None,
             loop: Optional[DenseLoop] = None, eager: bool = False,
             mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constrained generation from a right-padded prompt [B, T] (input_len
    [B]) on a fresh cache of `cache_len` slots (default dense_cache_len)
    -> (tokens [B, max_new_tokens], lengths [B]).  `loop`, a DenseLoop of
    that cache geometry, keeps its graphs across calls; `eager` builds a
    loop that runs its steps eagerly.  `mesh` (core/mesh.py): params are
    models/mistral.py param_shardings blocks, every rank passes the same
    prompt, and the steps run eagerly over this rank's kv heads."""
    b, t = input_ids.shape
    total = cache_len or dense_cache_len(cfg, t, max_new_tokens)
    loop = _loop_for(params, cfg, loop, b, total, input_ids.device, eager, mesh)
    logits, cache = M.prefill(params, cfg, input_ids, input_len, loop.cache, attn_impl, mesh)
    return loop.run(logits, cache.length, allow_mask, eos_id, max_new_tokens, top_k, top_p,
                    temperature, generator)


@torch.no_grad()
def generate_with_cache(params: M.Params, cfg: MistralConfig, cache: M.KVCache,
                        suffix_ids: torch.Tensor, suffix_len: torch.Tensor,
                        allow_mask: torch.Tensor, eos_id: int, max_new_tokens: int = 256,
                        attn_impl: str = "auto", top_k: int = 1, top_p: float = 1.0,
                        temperature: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        loop: Optional[DenseLoop] = None, eager: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, M.KVCache]:
    """Constrained generation continuing `cache` (its length is the prefix
    kept): the right-padded suffix [B, T'] is prefilled with
    M.prefill_extend, then decoded -> (tokens, lengths, cache).  The K/V
    are written into cache.k / cache.v in place; `loop`, a DenseLoop over
    those tensors, keeps its graphs across calls."""
    if loop is None:
        loop = DenseLoop(params, cfg, cache, graphs=not eager)
    elif loop.cache.k is not cache.k:
        raise ValueError("loop is not over this cache")
    logits, cache = M.prefill_extend(params, cfg, cache, suffix_ids, suffix_len, attn_impl)
    tokens, lengths = loop.run(logits, cache.length, allow_mask, eos_id, max_new_tokens, top_k,
                               top_p, temperature, generator)
    return tokens, lengths, M.KVCache(cache.k, cache.v, loop.cache.length.clone())
