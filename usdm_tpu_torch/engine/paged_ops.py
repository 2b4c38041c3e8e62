"""Device side of the paged continuous-batching engine.

Port of the parts of usdm_tpu/engine/paged_ops.py that the serving path
runs: the paged KV pool, one decode step, one chained decode step,
chunked prefill, and first-token sampling; and `DecodeLinks`, the static
inputs of a chained decode link, which on the card runs each link as one
CUDA-graph replay (the counterpart of the JAX engine's one jitted dispatch
per link).  The host scheduler is engine/paged.py.

The pool keeps the JAX layout [Hkv, L*N, P, hd]: layer li's page p lives at
li*N + p, and the last page of every layer's region (N - 1) is a trash page
that is never allocated, where inactive slots and padding tokens write.
K/V writes update the pool IN PLACE (index_put_ on the pool tensors); the
JAX engine reaches the same effect with donate_argnums and
dynamic_update_slice on a scan carry.

int8 pools (EngineConfig.kv_dtype="int8") store each token's K and V per
kv head as symmetric int8 with an f32 scale (`quant_kv_token`), the scales
in page-major pools [L*N, Hkv, P]; decode hands them to K1, prefill
dequantizes the gathered context.  Projections go through `qmm`, so W8A8
weights (models/quant.py) and plain ones take the same code; head counts
come from the projections' widths, as in usdm_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import out_dim, qmm
from usdm_tpu_torch.ops.attention import mha
from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
from usdm_tpu_torch.ops.stream_matvec import stream_qmv, symmetric_scale
from usdm_tpu_torch.ops.sampling import NEG_INF, sample_batched

# (gumbel noise [B, V], top_k [B], top_p [B], temperature [B]) for rows that
# sample; None = every row greedy
Sampling = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class PagedKV:
    k_pages: torch.Tensor  # [Hkv, L*N, P, hd]
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor] = None  # [L*N, Hkv, P] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: MistralConfig, n_pages: int, page_size: int, device,
               dtype: Optional[str] = None) -> "PagedKV":
        """Zeroed pools of `dtype` (None = cfg.dtype, or "int8" with zeroed
        scale pools, so no slot ever holds a NaN bit pattern)."""
        shape = (cfg.num_kv_heads, cfg.num_layers * n_pages, page_size, cfg.head_dim)
        if dtype == "int8":
            sshape = (shape[1], shape[0], page_size)
            return cls(*(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(2)),
                       *(torch.zeros(sshape, device=device) for _ in range(2)))
        dt = M.torch_dtype(dtype or cfg.dtype)
        return cls(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def total_pages(self) -> int:
        """Pages of all layer regions, trash pages included (L * N)."""
        return self.k_pages.shape[1]


def quant_kv_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (head_dim) axis -> (q [..., hd] int8,
    scale [...] f32), scale = max(amax / 127, 1e-8)."""
    xf = x.float()
    scale = symmetric_scale(xf.abs().amax(dim=-1))
    return torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8), scale


def _write_kv(kv: PagedKV, base: int, pages: torch.Tensor, offs: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor) -> None:
    """In place: token j's K/V ([Hkv, n, hd]) go to page base + pages[j],
    row offs[j], of every kv head (int8 pools: quantized, with their scales
    at [base + pages[j], :, offs[j]])."""
    if kv.quantized:
        (k, ks), (v, vs) = quant_kv_token(k), quant_kv_token(v)
        kv.k_scales[base + pages, :, offs] = ks.t()
        kv.v_scales[base + pages, :, offs] = vs.t()
    kv.k_pages[:, base + pages, offs] = k.to(kv.k_pages.dtype)
    kv.v_pages[:, base + pages, offs] = v.to(kv.v_pages.dtype)


def _context(kv: PagedKV, base: int, ctx_pages: torch.Tensor, dtype: torch.dtype):
    """The context pages of one request as [1, S_ctx, Hkv, hd] views of the
    head-major gather, int8 pools dequantized in f32 and cast to `dtype`."""
    kc, vc = kv.k_pages[:, base + ctx_pages], kv.v_pages[:, base + ctx_pages]
    if kv.quantized:  # scales [ncp, Hkv, P] -> [Hkv, ncp, P, 1]
        kc = (kc.float() * kv.k_scales[base + ctx_pages].transpose(0, 1)[..., None]).to(dtype)
        vc = (vc.float() * kv.v_scales[base + ctx_pages].transpose(0, 1)[..., None]).to(dtype)
    hkv, hd = kc.shape[0], kc.shape[-1]
    return (kc.reshape(hkv, -1, hd).permute(1, 0, 2)[None],
            vc.reshape(hkv, -1, hd).permute(1, 0, 2)[None])


def _logits_tail(params, x: torch.Tensor, allow_masks: torch.Tensor, active: torch.Tensor,
                 logits_slice: Optional[Tuple[int, int, int]], sampling: Sampling
                 ) -> torch.Tensor:
    """Final hidden [B, D] -> next token [B] (0 for inactive rows)."""
    lm_head = params["lm_head"]
    if logits_slice is not None:
        # greedy over the stage mask's interval [lo, hi) plus one extra
        # column: lm_head is [V, D], so the slice is a contiguous row block
        lo, hi, extra = logits_slice
        logits = torch.where(allow_masks[:, lo:hi], F.linear(x, lm_head[lo:hi]).float(),
                             NEG_INF)
        best = torch.argmax(logits, dim=-1)
        nxt = best + lo
        if extra >= 0:
            ev = F.linear(x, lm_head[extra: extra + 1])[:, 0].float()
            bv = torch.gather(logits, 1, best[:, None])[:, 0]
            # tie-break as the full-vocab argmax: the first index wins
            take = ev >= bv if extra < lo else ev > bv
            nxt = torch.where(take, extra, nxt)
        return torch.where(active, nxt, 0)
    logits = torch.where(allow_masks, F.linear(x, lm_head).float(), NEG_INF)
    if sampling is not None:
        nxt = sample_batched(logits, *sampling)
    else:
        nxt = torch.argmax(logits, dim=-1)
    return torch.where(active, nxt, 0)


def paged_decode_step(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    tokens: torch.Tensor,  # [B] current token per slot
    seq_lens: torch.Tensor,  # [B] int32 tokens already in cache (= this token's position)
    page_table: torch.Tensor,  # [B, maxp] int32, layer-relative page ids
    active: torch.Tensor,  # [B] bool
    allow_masks: torch.Tensor,  # [B, V] bool
    page_size: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    sampling: Sampling = None,
) -> torch.Tensor:
    """One decode step for every slot -> next token [B] (int64).  Writes each
    active slot's K/V in place; inactive slots write to the trash page."""
    if logits_slice is not None and sampling is not None:
        raise ValueError("logits_slice requires greedy decode")
    b = tokens.shape[0]
    hd = cfg.head_dim
    h, hkv = out_dim(params["layers"][0]["wq"]) // hd, out_dim(params["layers"][0]["wk"]) // hd
    maxp = page_table.shape[1]
    n_pages = kv.total_pages // cfg.num_layers
    pos = seq_lens.long()
    rows = torch.arange(b, device=tokens.device)
    page_ids = page_table.long()[rows, torch.clamp(pos // page_size, max=maxp - 1)]
    page_ids = torch.where(active, page_ids, n_pages - 1)  # inactive: trash page
    offs = pos % page_size
    kv_len = (seq_lens + 1).to(torch.int32)
    bases = torch.arange(cfg.num_layers, device=tokens.device, dtype=torch.int32) * n_pages
    tables = (page_table[None] + bases[:, None, None]).contiguous()  # [L, B, maxp]

    x = params["embed"][tokens][:, None, :]  # [B, 1, D]
    cos, sin = M.rope_tables(pos[:, None], hd, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        y = M.rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
        q = M.apply_rope(qmm(y, lp["wq"]).reshape(b, 1, h, hd), cos, sin)
        kk = M.apply_rope(qmm(y, lp["wk"]).reshape(b, 1, hkv, hd), cos, sin)
        vv = qmm(y, lp["wv"]).reshape(b, hkv, hd)
        _write_kv(kv, li * n_pages, page_ids, offs, kk[:, 0].transpose(0, 1),
                  vv.transpose(0, 1))
        attn = paged_decode_attention(q[:, 0].reshape(b, hkv, h // hkv, hd).contiguous(),
                                      kv.k_pages, kv.v_pages, tables[li], kv_len,
                                      sliding_window=cfg.sliding_window,
                                      k_scales=kv.k_scales, v_scales=kv.v_scales)
        x = x + qmm(attn.reshape(b, 1, h * hd), lp["wo"])
        x = x + M.mlp(M.rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)
    x = M.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)[:, 0]
    return _logits_tail(params, x, allow_masks, active, logits_slice, sampling)


def paged_decode_step_chained(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    tokens: torch.Tensor,  # [B] previous link's token
    seq_lens: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,
    active: torch.Tensor,  # [B] bool: slot decodes in this chain
    done: torch.Tensor,  # [B] bool: slot hit its EOS earlier in the chain
    eos_ids: torch.Tensor,  # [B]
    allow_masks: torch.Tensor,
    page_size: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    sampling: Sampling = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One link of a decode chain with the EOS freeze folded in ->
    (token [B], done' [B], seq_lens' [B]).  All on the device: a chain of
    links needs no host sync until its end."""
    nxt = paged_decode_step(params, kv, cfg, tokens, seq_lens, page_table, active & ~done,
                            allow_masks, page_size, logits_slice, sampling)
    nxt = torch.where(done, 0, nxt)
    new_done = done | (nxt == eos_ids)
    new_lens = torch.where(done, seq_lens, seq_lens + 1)
    return nxt, new_done, new_lens


def _link_counters() -> List[Tuple[object, str]]:
    """Every launch counter of the kernels a decode link runs (K1, K6):
    each `*launches` attribute of their wrappers."""
    return [(fn, name) for fn in (paged_decode_attention, stream_qmv)
            for name in sorted(vars(fn)) if name.endswith("launches")]


class DecodeLinks:
    """The static inputs of one chained decode link and the link itself.

    Owns the link's inputs as persistent device buffers, which the engine
    fills in place between links (`load`, `inject`): tok [B] int64, lens
    [B] int32, done [B] bool, active [B] bool, eos [B] int64, table [B,
    maxp] int32, and for sampled links noise [B, V] f32, top_k, top_p,
    temperature.  A link (`run`) is `paged_decode_step_chained` over them;
    it writes its outputs back into tok, done and lens, so the next link
    needs no host work, and its token into the next column of `stacked` [B,
    max_links + 1] (column 0 holds the chain's input, `begin`).

    On the card each link variant (logits slice, sampled or greedy) is
    captured once in a CUDA graph, after one eager warm-up link, and every
    later link of that variant is one replay; all the graphs share one
    memory pool.  A capture that fails raises: there is no eager fallback.
    A replay calls no kernel wrapper, so it adds to the wrappers' launch
    counts what its capture launched (`_link_counters`).  On the CPU, or
    with `graphs=False` (the card tests and chip_smoke.py hold graphs
    against it), every link runs eagerly.

    `fetch` copies `stacked` to one of two pinned host buffers without
    waiting and `wait` blocks on that copy alone, so a chain can be
    dispatched while its predecessor's tokens are still on their way."""

    def __init__(self, params: M.Params, kv: PagedKV, cfg: MistralConfig,
                 allow_masks: torch.Tensor, max_pages: int, page_size: int, max_links: int,
                 graphs: bool = True):
        self.params, self.kv, self.cfg = params, kv, cfg
        self.allow = allow_masks  # [B, V] bool, rewritten in place by the engine
        self.page_size = page_size
        self.max_links = max_links
        b, v = allow_masks.shape
        dev = self.device = allow_masks.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.tok, self.eos = zeros(b, dtype=torch.int64), zeros(b, dtype=torch.int64)
        self.lens = zeros(b, dtype=torch.int32)
        self.done, self.active = zeros(b, dtype=torch.bool), zeros(b, dtype=torch.bool)
        self.table = zeros(b, max_pages, dtype=torch.int32)
        self.noise = zeros(b, v)
        self.top_k = torch.ones(b, dtype=torch.int64, device=dev)
        self.top_p, self.temperature = (torch.ones(b, device=dev) for _ in range(2))
        self.stacked = zeros(b, max_links + 1, dtype=torch.int64)
        self.col = zeros(1, dtype=torch.int64)  # the column the next link writes
        self.graphed = graphs and dev.type == "cuda"
        self.replays = 0
        self._graphs: dict = {}  # (logits_slice, sampled) -> (graph, launches per replay)
        self._pool = self._stream = None
        card = dev.type == "cuda"
        self._host = [torch.empty((b, max_links + 1), dtype=torch.int64, pin_memory=card)
                      for _ in range(2)]
        self._events = [torch.cuda.Event() if card else None for _ in range(2)]
        self._flip = 0

    def load(self, dst: torch.Tensor, values: np.ndarray) -> None:
        """dst <- host values, in stream order; on the card through pinned
        memory without waiting for the device."""
        src = torch.from_numpy(np.ascontiguousarray(values))
        if self.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def inject(self, slot: int, first: torch.Tensor) -> None:
        """A deferred first token (0-d, on the device) becomes the slot's
        chain input; done is set if it already is the slot's EOS."""
        first = first.reshape(1)
        self.tok[slot: slot + 1].copy_(first)
        self.done[slot: slot + 1].copy_(first == self.eos[slot: slot + 1])

    def begin(self) -> None:
        """Start a chain: column 0 of `stacked` holds its input tokens."""
        self.stacked[:, 0].copy_(self.tok)
        self.col.fill_(1)

    def run(self, logits_slice: Optional[Tuple[int, int, int]], sampled: bool) -> None:
        """One link: a graph replay on the card, else the eager link."""
        key = (logits_slice, sampled)
        if not self.graphed:
            self._link(key)
            return
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key)
        graph, launches = entry
        graph.replay()
        for (fn, name), n in zip(_link_counters(), launches):
            setattr(fn, name, getattr(fn, name) + n)
        self.replays += 1

    def _link(self, key) -> None:
        logits_slice, sampled = key
        sampling = (self.noise, self.top_k, self.top_p, self.temperature) if sampled else None
        tok, done, lens = paged_decode_step_chained(
            self.params, self.kv, self.cfg, self.tok, self.lens, self.table, self.active,
            self.done, self.eos, self.allow, self.page_size, logits_slice, sampling)
        self.tok.copy_(tok)
        self.done.copy_(done)
        self.lens.copy_(lens)
        self.stacked.index_copy_(1, self.col, tok[:, None])
        self.col.add_(1)

    def _capture(self, key) -> tuple:
        """One eager warm-up link (libraries loaded, RoPE table made, nothing
        built under capture) and one captured link, on a side stream, with
        every row frozen (done: writes go to the trash page); the carried
        state and the launch counts are restored afterwards."""
        counters = _link_counters()
        counts = [getattr(fn, name) for fn, name in counters]
        saved = [t.clone() for t in (self.tok, self.lens, self.done, self.stacked, self.col)]
        self.done.fill_(True)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self._link(key)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        warm = [getattr(fn, name) for fn, name in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._link(key)
        launches = [getattr(fn, name) - n for (fn, name), n in zip(counters, warm)]
        for (fn, name), n in zip(counters, counts):
            setattr(fn, name, n)
        for t, s in zip((self.tok, self.lens, self.done, self.stacked, self.col), saved):
            t.copy_(s)
        return graph, launches

    def fetch(self) -> int:
        """Start copying `stacked` to the host -> a handle for `wait`."""
        i = self._flip
        self._flip ^= 1
        self._host[i].copy_(self.stacked, non_blocking=True)
        if self._events[i] is not None:
            self._events[i].record()
        return i

    def wait(self, handle: int, n_links: int) -> np.ndarray:
        """The tokens of a fetched chain, [B, n_links + 1] int64."""
        if self._events[handle] is not None:
            self._events[handle].synchronize()
        return self._host[handle][:, : n_links + 1].numpy().copy()


def paged_prefill_chunk(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    chunk_ids: torch.Tensor,  # [C] right-padded chunk of prompt tokens
    start: int,  # tokens already written for this slot
    n_valid: int,  # valid tokens in this chunk
    page_table_row: np.ndarray,  # [maxp] this request's layer-relative pages
    page_size: int,
    n_ctx_pages: int,  # pages gathered as attention context (covers start + C)
) -> torch.Tensor:
    """Prefill one chunk of one request into its pages -> logits of the last
    valid token [V] f32.  Chunk queries attend to the request's pages
    written so far plus the chunk itself (causal, sliding window)."""
    c = chunk_ids.shape[0]
    dev = chunk_ids.device
    hd = cfg.head_dim
    h, hkv = out_dim(params["layers"][0]["wq"]) // hd, out_dim(params["layers"][0]["wk"]) // hd
    p = page_size
    s_ctx = n_ctx_pages * p
    n_pages = kv.total_pages // cfg.num_layers
    maxp = page_table_row.shape[0]

    # write targets: chunk token i lives at global index start + i; padding
    # tokens go to the trash page
    gidx = start + np.arange(c)
    pages_t = np.where(np.arange(c) < n_valid, page_table_row[np.minimum(gidx // p, maxp - 1)],
                       n_pages - 1)
    pages_t = torch.from_numpy(pages_t.astype(np.int64)).to(dev)
    offs_t = torch.from_numpy((gidx % p).astype(np.int64)).to(dev)
    ctx_pages = torch.from_numpy(page_table_row[:n_ctx_pages].astype(np.int64)).to(dev)

    ar = torch.arange(c, device=dev)
    positions = (start + ar)[None]
    # the attention rows as int32, the type the flash kernel reads: made once
    # per chunk, not converted again by each layer's call
    q_pos = positions.to(torch.int32)
    q_seg = torch.where(ar < n_valid, 0, -1)[None].to(torch.int32)
    kv_pos = torch.arange(s_ctx, device=dev, dtype=torch.int32)[None]
    kv_seg = torch.where(kv_pos < start + n_valid, 0, -1).to(torch.int32)

    x = params["embed"][chunk_ids][None]  # [1, C, D]
    cos, sin = M.rope_tables(positions, hd, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        base = li * n_pages
        y = M.rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
        q = M.apply_rope(qmm(y, lp["wq"]).reshape(1, c, h, hd), cos, sin)
        kk = M.apply_rope(qmm(y, lp["wk"]).reshape(1, c, hkv, hd), cos, sin)
        vv = qmm(y, lp["wv"]).reshape(1, c, hkv, hd)
        _write_kv(kv, base, pages_t, offs_t, kk[0].transpose(0, 1), vv[0].transpose(0, 1))
        # context: this request's pages, the chunk just written included
        kc, vc = _context(kv, base, ctx_pages, q.dtype)
        attn = mha(q, kc, vc, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                   q_positions=q_pos, kv_positions=kv_pos, causal=True,
                   sliding_window=cfg.sliding_window, impl="auto")
        x = x + qmm(attn.reshape(1, c, h * hd), lp["wo"])
        x = x + M.mlp(M.rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp)
    x = M.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = min(max(n_valid - 1, 0), c - 1)
    return F.linear(x[0, last], params["lm_head"]).float()


def sample_next(logits: torch.Tensor, allow: torch.Tensor, sampling: Sampling = None
                ) -> torch.Tensor:
    """Mask + pick the first token after prefill -> 0-d int64 tensor."""
    masked = torch.where(allow, logits, NEG_INF)[None]
    if sampling is None:
        return torch.argmax(masked[0])
    return sample_batched(masked, *sampling)[0]
