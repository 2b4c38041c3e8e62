"""Device side of the paged continuous-batching engine.

Port of usdm_tpu/engine/paged_ops.py: the paged KV pool, one decode step,
one chained decode step, the packed prefill chunk, the mixed prefill +
decode link, the multi-step decode, first-token sampling, and speculative
decoding's device side (verification, acceptance, ngram proposals, the
ngram and draft-model rounds); and `DecodeLinks`, the static inputs of a
chained decode link or round, which on the card runs each decode link and
each round as one CUDA-graph replay (the counterpart of the JAX engine's
one jitted dispatch) and each mixed link eagerly.  The host scheduler is
engine/paged.py.

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

Tensor-parallel serving (engine/tp.py) passes the rank's mesh as `tp` to
the bodies that take it (usdm_tpu's `tp_axis`): heads, kv heads and the
vocab block come from the rank's local shapes, the partial sums after wo
and w_down are all-reduced, and the vocab-split logits are gathered (and
cut to the true vocab) before masks and sampling.  The lm_head slice is
refused under TP, as in usdm_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.engine import tp as TP
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import is_quantized, out_dim, qmm
from usdm_tpu_torch.ops.attention import mha
from usdm_tpu_torch.ops.paged_attention import host_split_count, paged_decode_attention
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
               dtype: Optional[str] = None, tp: int = 1) -> "PagedKV":
        """Zeroed pools of `dtype` (None = cfg.dtype, or "int8" with zeroed
        scale pools, so no slot ever holds a NaN bit pattern); with `tp` the
        pool of one of tp ranks, its num_kv_heads / tp heads (what
        engine/tp.py shard_kv keeps of the whole pool)."""
        shape = (cfg.num_kv_heads // tp, cfg.num_layers * n_pages, page_size, cfg.head_dim)
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
    """The context pages of R chunk rows ([R, ncp] layer-relative page ids)
    as [R, S_ctx, Hkv, hd] views of the head-major gather in `dtype` (int8
    pools dequantized in f32 first)."""
    ids = base + ctx_pages
    kc, vc = kv.k_pages[:, ids], kv.v_pages[:, ids]  # [Hkv, R, ncp, P, hd]
    if kv.quantized:  # scales [R, ncp, Hkv, P] -> [Hkv, R, ncp, P, 1]
        kc = kc.float() * kv.k_scales[ids].permute(2, 0, 1, 3)[..., None]
        vc = vc.float() * kv.v_scales[ids].permute(2, 0, 1, 3)[..., None]
    kc, vc = kc.to(dtype), vc.to(dtype)
    hkv, r, hd = kc.shape[0], kc.shape[1], kc.shape[-1]
    return (kc.reshape(hkv, r, -1, hd).permute(1, 2, 0, 3),
            vc.reshape(hkv, r, -1, hd).permute(1, 2, 0, 3))


def _all_reduce(x: torch.Tensor, tp: Optional["TP.TPMesh"]) -> torch.Tensor:
    """A row-split product's partial sums summed over the ranks (usdm_tpu's
    psum); `x` itself without TP."""
    return x if tp is None else TP.all_reduce(x, tp)


def _vocab_logits(logits: torch.Tensor, tp: Optional["TP.TPMesh"], vocab: int) -> torch.Tensor:
    """lm_head products [..., V] (under TP the rank's vocab block) -> the
    whole vocab's logits in f32: one all-gather under TP, the padding rows
    cut off."""
    if tp is not None:
        logits = TP.gather_vocab(logits, tp, vocab)
    return logits.float()


def _pick(logits: torch.Tensor, allow_masks: torch.Tensor, active: torch.Tensor,
          sampling: Sampling) -> torch.Tensor:
    """Masked full-vocab logits [..., B, V] f32 -> next token [..., B] (0
    for inactive rows): argmax, or a sample where `sampling` is given."""
    logits = torch.where(allow_masks, logits, NEG_INF)
    nxt = sample_batched(logits, *sampling) if sampling is not None else torch.argmax(logits, -1)
    return torch.where(active, nxt, 0)


def _logits_tail(params, x: torch.Tensor, allow_masks: torch.Tensor, active: torch.Tensor,
                 logits_slice: Optional[Tuple[int, int, int]], sampling: Sampling,
                 tp: Optional["TP.TPMesh"] = None) -> torch.Tensor:
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
    logits = _vocab_logits(F.linear(x, lm_head), tp, allow_masks.shape[-1])
    return _pick(logits, allow_masks, active, sampling)


def _check_slice(logits_slice, sampling: Sampling, tp) -> None:
    if logits_slice is not None and (sampling is not None or tp is not None):
        raise ValueError("logits_slice requires greedy single-device decode")


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
    tp: Optional["TP.TPMesh"] = None,
) -> torch.Tensor:
    """One decode step for every slot -> next token [B] (int64).  Writes each
    active slot's K/V in place; inactive slots write to the trash page.
    With `tp` (engine/tp.py) it is one rank's step over its slices."""
    _check_slice(logits_slice, sampling, tp)
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
    # a slot that is not live may hold a full table's length (a finished
    # speculative round fills its last page): K1 must not read past the row
    kv_len = torch.clamp(seq_lens + 1, max=maxp * page_size).to(torch.int32)
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
        x = x + _all_reduce(qmm(attn.reshape(b, 1, h * hd), lp["wo"]), tp)
        x = x + _all_reduce(M.mlp(M.rms_norm(x, lp["ln2"], cfg.rms_norm_eps), lp), tp)
    x = M.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)[:, 0]
    return _logits_tail(params, x, allow_masks, active, logits_slice, sampling, tp)


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
    tp: Optional["TP.TPMesh"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One link of a decode chain with the EOS freeze folded in ->
    (token [B], done' [B], seq_lens' [B]).  All on the device: a chain of
    links needs no host sync until its end."""
    nxt = paged_decode_step(params, kv, cfg, tokens, seq_lens, page_table, active & ~done,
                            allow_masks, page_size, logits_slice, sampling, tp)
    nxt = torch.where(done, 0, nxt)
    new_done = done | (nxt == eos_ids)
    new_lens = torch.where(done, seq_lens, seq_lens + 1)
    return nxt, new_done, new_lens


# (device, dtype, weight shape, B, K+1) -> whether a float product's rows
# keep their bits from B to B*(K+1) rows (`_rows_invariant`)
_ROW_INVARIANT: Dict[tuple, bool] = {}


def row_invariance() -> Dict[tuple, bool]:
    """The decisions `_rows_invariant` has made so far: (device, dtype,
    weight shape, B, K+1) -> whether a verify runs that float product as
    one product over every column."""
    return dict(_ROW_INVARIANT)


def rows_probe(y: torch.Tensor, w: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [B*(K+1), 1, Din] @ w as one product, and one column of B rows at
    a time -> (one product, the columns' products)."""
    return y @ w, torch.cat([y[j:j + b] @ w for j in range(0, y.shape[0], b)])


def _rows_invariant(w: torch.Tensor, b: int, k1: int) -> bool:
    """Whether `y @ w` gives each row the same bits over B*(K+1) rows as
    over B, decided once per (device, dtype, shape, B, K+1) from random
    rows.  This assumes the library picks its GEMM (and with it the
    summation order) from the shapes and dtype alone: not from the
    operands' values, their pointers' alignment, or whether the call is
    being captured into a CUDA graph.  The probe runs eagerly (a verify's
    warm-up comes before its capture); tests/test_torch_cuda.py holds each
    cached decision against a probe made under capture.  On an H100 bf16
    rows at B 1 keep their bits at the 7B shapes and f32 rows at B 4 do
    not (chip_smoke.py phase 9 logs the table)."""
    key = (w.device, w.dtype, tuple(w.shape), b, k1)
    if key not in _ROW_INVARIANT:
        g = torch.Generator(device=w.device).manual_seed(0)
        y = torch.randn(b * k1, 1, w.shape[0], generator=g, device=w.device).to(w.dtype)
        _ROW_INVARIANT[key] = torch.equal(*rows_probe(y, w, b))
    return _ROW_INVARIANT[key]


def _qmm_cols(y: torch.Tensor, w, k1: int) -> torch.Tensor:
    """qmm over a verify activation's K+1 columns of B rows: one product,
    reading the weight once, where its rows do not depend on the row count
    (W8A8: exact integer sums at any M; a float weight where
    `_rows_invariant` finds so); else one product a column, at the decode
    link's B rows."""
    b = y.shape[0] // k1
    if is_quantized(w) or _rows_invariant(w, b, k1):
        return qmm(y, w)
    return torch.cat([qmm(y[j * b:(j + 1) * b], w) for j in range(k1)])


def _rms_norm_cols(x: torch.Tensor, w: torch.Tensor, eps: float, k1: int) -> torch.Tensor:
    """M.rms_norm of a verify activation [K1*B, D] (rows j*B + b) one column
    of B rows at a time, each as a decode link's [B, 1, D] call: a CUDA
    reduction's summation order depends on how many rows share the call."""
    xc = x.reshape(k1, -1, 1, x.shape[-1])
    return torch.cat([M.rms_norm(xc[j], w, eps) for j in range(k1)]).reshape(x.shape)


def paged_verify_step(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    tokens: torch.Tensor,  # [B, K+1]: [current, draft_0, ..., draft_{K-1}]
    seq_lens: torch.Tensor,  # [B] int32: position of tokens[:, 0]
    page_table: torch.Tensor,  # [B, maxp] int32
    active: torch.Tensor,  # [B] bool
    allow_masks: torch.Tensor,  # [B, V] bool
    page_size: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    tp: Optional["TP.TPMesh"] = None,
) -> torch.Tensor:
    """Speculative verification: one target forward over K+1 tokens per
    slot -> the greedy token after each position [B, K+1] (0 for inactive
    slots), with the K/V of all K+1 positions written in place first.

    Column j of slot b is computed as the decode link that consumes
    tokens[b, j] at position seq_lens[b] + j computes it: the activation
    holds the K+1 columns of B rows one after another, norms and the logits
    tail run per column at B rows, and attention is K1 over all B*(K+1)
    rows (row j*B + b reads slot b's pages up to kv_len seq_lens[b] + j + 1)
    with the split count K1 picks for B rows, so each row is cut as in the
    decode link.  The seven projections take all B*(K+1) rows in one
    product, reading each weight once, where that gives each row the link's
    bits (W8A8 always; float weights as `_rows_invariant` finds), else one
    product a column.  So the tokens are the decode links' by construction.
    Rejected positions leave stale K/V that kv_len masking hides and the
    next round overwrites (usdm_tpu's paged_verify_step; it gathers the
    context and runs plain attention over it instead).  Under `tp` the
    K+1 columns' vocab blocks are gathered in one all-gather."""
    _check_slice(logits_slice, None, tp)
    b, k1 = tokens.shape
    n = b * k1
    dev = tokens.device
    hd = cfg.head_dim
    h, hkv = out_dim(params["layers"][0]["wq"]) // hd, out_dim(params["layers"][0]["wk"]) // hd
    maxp = page_table.shape[1]
    n_pages = kv.total_pages // cfg.num_layers
    pos = seq_lens.long()[None, :] + torch.arange(k1, device=dev)[:, None]  # [K1, B]
    slots = torch.arange(b, device=dev)[None, :]
    w_pages = page_table.long()[slots, torch.clamp(pos // page_size, max=maxp - 1)]
    w_pages = torch.where(active[None, :], w_pages, n_pages - 1).reshape(-1)  # trash
    w_offs = (pos % page_size).reshape(-1)
    kv_len = torch.clamp(pos + 1, max=maxp * page_size).to(torch.int32).reshape(-1)
    bases = torch.arange(cfg.num_layers, device=dev, dtype=torch.int32) * n_pages
    tables = (page_table[None] + bases[:, None, None]).repeat(1, k1, 1)  # [L, K1*B, maxp]
    n_splits = host_split_count(b, hkv, maxp, page_size, dev)
    eps = cfg.rms_norm_eps

    x = params["embed"][tokens.t().reshape(-1)][:, None, :]  # [K1*B, 1, D]
    cos, sin = M.rope_tables(pos.reshape(-1, 1), hd, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        y = _rms_norm_cols(x, lp["ln1"], eps, k1)
        q = M.apply_rope(_qmm_cols(y, lp["wq"], k1).reshape(n, 1, h, hd), cos, sin)
        kk = M.apply_rope(_qmm_cols(y, lp["wk"], k1).reshape(n, 1, hkv, hd), cos, sin)
        vv = _qmm_cols(y, lp["wv"], k1).reshape(n, hkv, hd)
        _write_kv(kv, li * n_pages, w_pages, w_offs, kk[:, 0].transpose(0, 1),
                  vv.transpose(0, 1))
        attn = paged_decode_attention(q[:, 0].reshape(n, hkv, h // hkv, hd).contiguous(),
                                      kv.k_pages, kv.v_pages, tables[li], kv_len,
                                      sliding_window=cfg.sliding_window,
                                      k_scales=kv.k_scales, v_scales=kv.v_scales,
                                      n_splits=n_splits)
        x = x + _all_reduce(_qmm_cols(attn.reshape(n, 1, h * hd), lp["wo"], k1), tp)
        y = _rms_norm_cols(x, lp["ln2"], eps, k1)
        gate = F.silu(_qmm_cols(y, lp["w_gate"], k1))
        x = x + _all_reduce(_qmm_cols(gate * _qmm_cols(y, lp["w_up"], k1), lp["w_down"], k1),
                            tp)
    xn = _rms_norm_cols(x, params["final_norm"], eps, k1)[:, 0].reshape(k1, b, -1)
    if logits_slice is not None:
        return torch.stack([_logits_tail(params, xn[j], allow_masks, active, logits_slice, None)
                            for j in range(k1)], dim=1)
    # one lm_head product a column, at the decode link's B rows
    logits = torch.stack([F.linear(xn[j], params["lm_head"]) for j in range(k1)])
    return _pick(_vocab_logits(logits, tp, allow_masks.shape[-1]), allow_masks, active,
                 None).t()


def paged_spec_accept(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    ver_in: torch.Tensor,  # [B, K+1]: [current, drafts...]
    seq_lens: torch.Tensor,  # [B] int32
    done: torch.Tensor,  # [B] bool: frozen (EOS'd earlier in these rounds)
    eos_ids: torch.Tensor,  # [B]
    page_table: torch.Tensor,
    active: torch.Tensor,  # [B] bool
    allow_masks: torch.Tensor,
    page_size: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    tp: Optional["TP.TPMesh"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verification and acceptance on the device -> (tokens [B, K+1],
    n_emit [B], next_cur [B], done' [B], seq_lens' [B]): the drafts that
    match the target's tokens as a prefix are accepted, plus the target's
    token after them; the run ends at its first EOS.  Rounds chain with no
    host sync between them."""
    k1 = ver_in.shape[1]
    live = active & ~done
    out = paged_verify_step(params, kv, cfg, ver_in, seq_lens, page_table, live, allow_masks,
                            page_size, logits_slice, tp)
    # accepted prefix: drafts d_j (= ver_in[:, j+1]) matching the target's out[:, j]
    n_acc = torch.cumprod((ver_in[:, 1:] == out[:, :-1]).long(), dim=1).sum(dim=1)
    cols = torch.arange(k1, device=ver_in.device)[None]
    # emitted tokens are out[:, :n_acc + 1], cut after the first EOS inside
    is_eos = (out == eos_ids[:, None]) & (cols <= n_acc[:, None])
    has_eos = is_eos.any(dim=1)
    n_emit = torch.where(has_eos, is_eos.long().argmax(dim=1) + 1, n_acc + 1)
    n_emit = torch.where(live, n_emit, 0)
    out = torch.where(cols < n_emit[:, None], out, 0)
    last = torch.gather(out, 1, torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
    next_cur = torch.where(live, last, ver_in[:, 0])
    return out, n_emit, next_cur, done | has_eos, (seq_lens + n_emit).to(seq_lens.dtype)


def ngram_propose(
    history: torch.Tensor,  # [B, S] token history (prompt + emitted)
    hist_len: torch.Tensor,  # [B] valid tokens; history[:, hist_len - 1] == cur
    cur: torch.Tensor,  # [B] current token (the last emitted)
    k: int,  # proposal length
    max_n: int,  # longest suffix n-gram to match
) -> torch.Tensor:
    """Draft-free prompt-lookup proposal (vLLM's ngram method): the K tokens
    that followed the most recent, longest (<= max_n) earlier occurrence of
    the current suffix in the sequence's own history -> [B, K].  Falls back
    to repeating `cur` where no suffix recurs or the continuation runs past
    the history (50 Hz unit streams repeat: that is the right guess there).
    Rows of inactive slots are garbage; verification masks them."""
    b, s = history.shape
    dev = history.device
    hist_len = hist_len.long()
    pos = torch.arange(s, device=dev)[None]  # candidate continuation start i
    match_n = torch.zeros((b, s), dtype=torch.long, device=dev)
    all_eq = torch.ones((b, s), dtype=torch.bool, device=dev)
    for j in range(1, max_n + 1):
        shifted = F.pad(history, (j, 0))[:, :s]  # history[:, i - j] at column i
        suf_j = torch.gather(history, 1, torch.clamp(hist_len - j, min=0)[:, None])
        all_eq = all_eq & (shifted == suf_j)
        ok = all_eq & (pos >= j) & (hist_len > j)[:, None]
        match_n = torch.where(ok, j, match_n)
    # i < hist_len: at least one real continuation token, and the trivial
    # self-match at i == hist_len excluded
    valid = (pos < hist_len[:, None]) & (match_n >= 1)
    # longest match wins; ties go to the most recent occurrence
    score = torch.where(valid, match_n * s + pos, -1)
    best = score.argmax(dim=1)
    found = torch.gather(score, 1, best[:, None])[:, 0] >= 0
    idx = best[:, None] + torch.arange(k, device=dev)[None]
    cont = torch.gather(history, 1, torch.clamp(idx, max=s - 1))
    take = (idx < hist_len[:, None]) & found[:, None]
    return torch.where(take, cont, cur[:, None])


def paged_ngram_round(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    history: torch.Tensor,  # [B, S] int64, appended in place
    cur: torch.Tensor,  # [B] current token
    seq_lens: torch.Tensor,  # [B] int32
    done: torch.Tensor,  # [B] bool
    eos_ids: torch.Tensor,
    page_table: torch.Tensor,
    active: torch.Tensor,
    allow_masks: torch.Tensor,
    page_size: int,
    k: int,
    max_n: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    tp: Optional["TP.TPMesh"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One draft-free speculative round: propose K tokens from each
    sequence's own history (`ngram_propose`), verify and accept them
    (`paged_spec_accept`), and append the emitted tokens to `history` in
    place -> (tokens [B, K+1], n_emit [B], next_cur [B], done', seq_lens').
    A round runs one target forward over K+1 positions and emits 1 to K+1
    tokens."""
    b, s = history.shape
    hist_len = seq_lens.long() + 1  # prompt + emitted tokens (cur is the last)
    props = ngram_propose(history, hist_len, cur, k, max_n)
    ver_in = torch.cat([cur[:, None], props], dim=1)
    out, n_emit, next_cur, new_done, new_lens = paged_spec_accept(
        params, kv, cfg, ver_in, seq_lens, done, eos_ids, page_table, active, allow_masks,
        page_size, logits_slice, tp)
    cols = torch.arange(k + 1, device=history.device)[None]
    # emitted tokens land at hist_len + j; the rest go to a dropped column s
    w_idx = torch.where(cols < n_emit[:, None], hist_len[:, None] + cols, s)
    padded = F.pad(history, (0, 1))
    padded.scatter_(1, torch.clamp(w_idx, max=s), out)
    history.copy_(padded[:, :s])
    return out, n_emit, next_cur, new_done, new_lens


def paged_draft_round(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    draft: Tuple[M.Params, PagedKV, MistralConfig],  # the draft model and its pool
    cur: torch.Tensor,  # [B] current token
    seq_lens: torch.Tensor,  # [B] int32
    done: torch.Tensor,  # [B] bool
    eos_ids: torch.Tensor,
    page_table: torch.Tensor,
    active: torch.Tensor,
    allow_masks: torch.Tensor,
    page_size: int,
    k: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    tp: Optional["TP.TPMesh"] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One speculative round with a draft model (the body of usdm_tpu's
    step_spec loop): K+1 greedy draft decode steps over the draft's pool,
    sharing the target's page table (the last writes the draft K/V of the
    final proposal, so full acceptance leaves no hole), then verification
    and acceptance -> as `paged_spec_accept`."""
    d_params, d_kv, d_cfg = draft
    live = active & ~done
    cols, d = [cur], cur
    for i in range(k + 1):
        d = paged_decode_step(d_params, d_kv, d_cfg, d, seq_lens + i, page_table, live,
                              allow_masks, page_size, logits_slice, None, tp)
        if i < k:
            cols.append(d)
    return paged_spec_accept(params, kv, cfg, torch.stack(cols, dim=1), seq_lens, done, eos_ids,
                             page_table, active, allow_masks, page_size, logits_slice, tp)


def _link_counters() -> List[Tuple[object, str]]:
    """Every launch counter of the kernels a decode link runs (K1, K6):
    each `*launches` attribute of their wrappers."""
    return [(fn, name) for fn in (paged_decode_attention, stream_qmv)
            for name in sorted(vars(fn)) if name.endswith("launches")]


class GraphSet:
    """CUDA graphs of one owner's step variants, each captured at its first
    use and replayed after.  `run(key, fn, carried, done)` replays the graph
    of `key`, capturing `fn` first if there is none: one eager warm-up (the
    libraries loaded, tables made: nothing is built under capture) and one
    capture on a side stream, with `done` set (every row frozen) while they
    run; the `carried` tensors and the kernel wrappers' launch counts are
    restored afterwards.  All graphs share one memory pool.  A capture that
    fails raises: there is no eager fallback.  A replay calls no kernel
    wrapper, so it adds to the wrappers' counts what its capture launched
    (`_link_counters`); `replays` counts replays."""

    def __init__(self, device: torch.device):
        self.device = device
        self.replays = 0
        self._graphs: dict = {}  # key -> (graph, launches per replay)
        self._pool = self._stream = None

    def run(self, key, fn, carried: List[torch.Tensor], done: torch.Tensor) -> None:
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(fn, carried, done)
        graph, launches = entry
        graph.replay()
        for (f, name), n in zip(_link_counters(), launches):
            setattr(f, name, getattr(f, name) + n)
        self.replays += 1

    def _capture(self, fn, carried: List[torch.Tensor], done: torch.Tensor) -> tuple:
        counters = _link_counters()
        counts = [getattr(f, name) for f, name in counters]
        saved = [t.clone() for t in carried]
        done.fill_(True)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        warm = [getattr(f, name) for f, name in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            fn()
        launches = [getattr(f, name) - n for (f, name), n in zip(counters, warm)]
        for (f, name), n in zip(counters, counts):
            setattr(f, name, n)
        for t, v in zip(carried, saved):
            t.copy_(v)
        return graph, launches


class DecodeLinks:
    """The static inputs of one chained decode link and the link itself.

    Owns the link's inputs as persistent device buffers, which the engine
    fills in place between links (`load`, `inject`): tok [B] int64, lens
    [B] int32, done [B] bool, active [B] bool, eos [B] int64, table [B,
    maxp] int32, and for sampled links noise [B, V] f32, top_k, top_p,
    temperature.  A link (`run`) is `paged_decode_step_chained` over them;
    it writes its outputs back into tok, done and lens, so the next link
    needs no host work, and its token into the next column of `stacked` [B,
    max_links + 2] (column 0 holds the chain's input, `begin`; a mixed burst's
    last column the first tokens of prompts it completed, `append`).  A
    mixed prefill + decode link (`mixed`) reads and writes the same buffers,
    eagerly.  With a draft model (`draft` = its params, pool and config) a
    link may also mirror its step into the draft's pool (`run(mirror=True)`,
    token discarded), so the draft's K/V has no holes when rounds resume.

    Speculative rounds (`spec_k` > 0, `round`) read and write the same tok
    (the current token), lens and done: a "draft" round is
    `paged_draft_round`, an "ngram" round `paged_ngram_round` over the
    token history `hist` [B, S] int64, which it appends in place.  A round
    writes its tokens and n_emit into the next row of `rounds_out` [B,
    max_rounds, K + 2] (`begin_rounds` resets the row counter).

    On the card each variant (a link's logits slice, sampled or greedy and
    mirror; a round's kind and logits slice) is captured once in a CUDA
    graph (`GraphSet`), and every later link or round of that variant is
    one replay.  On the CPU, with `graphs=False` (the card tests and
    chip_smoke.py hold graphs against it), or under tensor parallelism
    (`tp`, the rank's mesh, passed to every body), everything runs eagerly;
    `eager` counts those links and rounds.

    `fetch` copies `stacked` (or `rounds_out`) to one of two pinned host
    buffers without waiting and `wait` (`wait_rounds`) blocks on that copy
    alone, so a chain can be dispatched while its predecessor's tokens are
    still on their way."""

    def __init__(self, params: M.Params, kv: PagedKV, cfg: MistralConfig,
                 allow_masks: torch.Tensor, max_pages: int, page_size: int, max_links: int,
                 graphs: bool = True,
                 draft: Optional[Tuple[M.Params, PagedKV, MistralConfig]] = None,
                 spec_k: int = 0, ngram_max_n: int = 0, max_rounds: int = 0,
                 tp: Optional["TP.TPMesh"] = None):
        self.params, self.kv, self.cfg = params, kv, cfg
        self.tp = tp
        self.allow = allow_masks  # [B, V] bool, rewritten in place by the engine
        self.page_size = page_size
        self.max_links = max_links
        self.draft = draft
        self.spec_k, self.ngram_max_n = spec_k, ngram_max_n
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
        self.stacked = zeros(b, max_links + 2, dtype=torch.int64)
        self.col = zeros(1, dtype=torch.int64)  # the column the next link writes
        card = dev.type == "cuda"
        self._host = [torch.empty((b, max_links + 2), dtype=torch.int64, pin_memory=card)
                      for _ in range(2)]
        self.hist = self.rounds_out = self.rcol = None
        self._round_host: List[torch.Tensor] = []
        if spec_k > 0:
            if draft is None:  # ngram proposals read the token history
                self.hist = zeros(b, max_pages * page_size, dtype=torch.int64)
            self.rounds_out = zeros(b, max_rounds, spec_k + 2, dtype=torch.int64)
            self.rcol = zeros(1, dtype=torch.int64)  # the row the next round writes
            self._round_host = [torch.empty(tuple(self.rounds_out.shape), dtype=torch.int64,
                                            pin_memory=card) for _ in range(2)]
        self.graphed = graphs and card and tp is None
        self.eager = 0
        self._graphs = GraphSet(dev)
        self._events = [torch.cuda.Event() if card else None for _ in range(2)]
        self._fetched: List[Optional[torch.Tensor]] = [None, None]
        self._flip = 0

    def load(self, dst: torch.Tensor, values: np.ndarray) -> None:
        """dst <- host values, in stream order; on the card through pinned
        memory without waiting for the device."""
        dst.copy_(_host(values, self.device), non_blocking=True)

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

    def begin_rounds(self) -> None:
        """Start a run of speculative rounds: the next round writes row 0."""
        self.rcol.fill_(0)

    def run(self, logits_slice: Optional[Tuple[int, int, int]], sampled: bool,
            mirror: bool = False) -> None:
        """One link: a graph replay on the card, else the eager link."""
        self._go(("link", logits_slice, sampled, mirror))

    def round(self, kind: str, logits_slice: Optional[Tuple[int, int, int]]) -> None:
        """One speculative round ("draft" or "ngram"): a graph replay on the
        card, else the eager round."""
        self._go(("round", kind, logits_slice))

    @property
    def replays(self) -> int:
        return self._graphs.replays

    @property
    def captured(self) -> int:
        """CUDA graphs captured so far (one per link or round variant)."""
        return len(self._graphs._graphs)

    def _go(self, key) -> None:
        if not self.graphed:
            self.eager += 1
            self._eager(key)
            return
        # the carried state: a capture's warm-up runs the link with every
        # row frozen (writes go to the trash pages, rounds emit nothing)
        carried = [t for t in (self.tok, self.lens, self.done, self.stacked, self.col,
                               self.hist, self.rounds_out, self.rcol) if t is not None]
        self._graphs.run(key, lambda: self._eager(key), carried, self.done)

    def _eager(self, key) -> None:
        if key[0] == "round":
            self._round(key)
        else:
            self._link(key)

    def _link(self, key) -> None:
        _, logits_slice, sampled, mirror = key
        if mirror:  # the draft model's step on the same inputs, token discarded
            d_params, d_kv, d_cfg = self.draft
            paged_decode_step(d_params, d_kv, d_cfg, self.tok, self.lens, self.table,
                              self.active & ~self.done, self.allow, self.page_size, logits_slice,
                              None, self.tp)
        sampling = (self.noise, self.top_k, self.top_p, self.temperature) if sampled else None
        tok, done, lens = paged_decode_step_chained(
            self.params, self.kv, self.cfg, self.tok, self.lens, self.table, self.active,
            self.done, self.eos, self.allow, self.page_size, logits_slice, sampling, self.tp)
        self._advance(tok, done, lens)

    def _round(self, key) -> None:
        _, kind, logits_slice = key
        common = (self.tok, self.lens, self.done, self.eos, self.table, self.active, self.allow,
                  self.page_size, self.spec_k)
        if kind == "ngram":
            out, n_emit, cur, done, lens = paged_ngram_round(
                self.params, self.kv, self.cfg, self.hist, *common, self.ngram_max_n,
                logits_slice, self.tp)
        else:
            out, n_emit, cur, done, lens = paged_draft_round(
                self.params, self.kv, self.cfg, self.draft, *common, logits_slice, self.tp)
        self.tok.copy_(cur)
        self.done.copy_(done)
        self.lens.copy_(lens)
        self.rounds_out.index_copy_(1, self.rcol, torch.cat([out, n_emit[:, None]], 1)[:, None])
        self.rcol.add_(1)

    def _advance(self, tok: torch.Tensor, done: torch.Tensor, lens: torch.Tensor) -> None:
        """A link's outputs become the next link's inputs; its token goes to
        the next column of `stacked`."""
        self.tok.copy_(tok)
        self.done.copy_(done)
        self.lens.copy_(lens)
        self.append(tok)

    def append(self, col: torch.Tensor) -> None:
        """Write [B] values into the next column of `stacked`."""
        self.stacked.index_copy_(1, self.col, col[:, None])
        self.col.add_(1)

    def mixed(self, packed: np.ndarray, n_ctx_pages: int, c: int,
              logits_slice: Optional[Tuple[int, int, int]], sampled: bool,
              sample_chunk: bool) -> Optional[torch.Tensor]:
        """One mixed prefill + decode link (`paged_mixed_step`) over the
        packed chunk rows [NPF, C + 2 + maxp] (one host-to-device copy) and
        the link buffers, run eagerly -> the rows' chunk logits when
        `sample_chunk`."""
        sampling = (self.noise, self.top_k, self.top_p, self.temperature) if sampled else None
        logits, tok, done, lens = paged_mixed_step(
            self.params, self.kv, self.cfg, to_device(packed, self.device), self.tok, self.lens,
            self.table, self.active, self.done, self.eos, self.allow, self.page_size,
            n_ctx_pages, c, sample_chunk, logits_slice, sampling)
        self._advance(tok, done, lens)
        return logits

    def fetch(self, rounds: bool = False) -> int:
        """Start copying `stacked` (`rounds_out` when `rounds`) to the host
        -> a handle for `wait` (`wait_rounds`)."""
        i = self._flip
        self._flip ^= 1
        src, host = ((self.rounds_out, self._round_host[i]) if rounds
                     else (self.stacked, self._host[i]))
        host.copy_(src, non_blocking=True)
        self._fetched[i] = host
        if self._events[i] is not None:
            self._events[i].record()
        return i

    def _synced(self, handle: int) -> torch.Tensor:
        if self._events[handle] is not None:
            self._events[handle].synchronize()
        return self._fetched[handle]

    def wait(self, handle: int, n_links: int) -> np.ndarray:
        """The tokens of a fetched chain, [B, n_links + 1] int64."""
        return self._synced(handle)[:, : n_links + 1].numpy().copy()

    def wait_rounds(self, handle: int, rounds: int) -> np.ndarray:
        """The rows of fetched rounds, [B, rounds, K + 2] int64: each
        round's K+1 tokens, then its n_emit."""
        return self._synced(handle)[:, :rounds].numpy().copy()


def _host(values: np.ndarray, device) -> torch.Tensor:
    """`values` as a host tensor, pinned when it is bound for the card."""
    src = torch.from_numpy(np.ascontiguousarray(values))
    return src.pin_memory() if torch.device(device).type == "cuda" else src


def to_device(values: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy of `values`, on the card through pinned
    memory without waiting for the device."""
    return _host(values, device).to(device, non_blocking=True)


def _rms_norm_parts(x: torch.Tensor, w: torch.Tensor, eps: float, nc: int) -> torch.Tensor:
    """M.rms_norm of the chunk rows x[:nc] and the decode rows x[nc:] in two
    calls.  A CUDA reduction's summation order depends on how many rows
    share the call (below 16 rows it changes), so each row is normalized as
    the alternating schedule normalizes it, in a prefill chunk or in a decode
    link of the same B slots, and greedy tokens do not depend on whether a
    link was mixed."""
    if nc in (0, x.shape[0]):
        return M.rms_norm(x, w, eps)
    return torch.cat([M.rms_norm(x[:nc], w, eps), M.rms_norm(x[nc:], w, eps)])


def _qmm_parts(y: torch.Tensor, w, nc: int, c: int) -> torch.Tensor:
    """qmm over a mixed link's NPF chunk rows of C tokens (y[:nc]) and its
    decode rows (y[nc:]).  W8A8 products are exact integer sums with an
    elementwise epilogue, the same bits at any row count, so they take one
    call.  A float GEMM's summation order depends on its row count (cuBLAS
    picks its kernel by shape: on an H100, f32 rows at Mistral-7B's shapes
    differ between 256 and up to 2,048 rows), so each chunk row and the
    decode rows are multiplied apart, at the shapes of a lone prefill chunk
    and of a decode link."""
    if is_quantized(w) or y.shape[0] <= c:
        return qmm(y, w)
    parts = [y[i: i + c] for i in range(0, nc, c)]
    if nc < y.shape[0]:
        parts.append(y[nc:])
    return torch.cat([qmm(x, w) for x in parts])


def _mlp_parts(y: torch.Tensor, lp: M.Params, nc: int, c: int) -> torch.Tensor:
    """M.mlp with its products split as `_qmm_parts` splits them."""
    gate = F.silu(_qmm_parts(y, lp["w_gate"], nc, c))
    return _qmm_parts(gate * _qmm_parts(y, lp["w_up"], nc, c), lp["w_down"], nc, c)


def _mixed_layers(params: M.Params, kv: PagedKV, cfg: MistralConfig, packed: torch.Tensor,
                  c: int, page_size: int, n_ctx_pages: int,
                  decode: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
                  tp: Optional["TP.TPMesh"] = None) -> torch.Tensor:
    """The layers over NPF packed chunk rows and, with `decode` = (tokens
    [B], seq_lens [B] int32, page_table [B, maxp] int32, live [B] bool), B
    decode rows in one [NPF*C + B, D] activation -> its final hidden state
    (before the final norm).  Writes every row's K/V in place first (chunk
    padding and rows that are not live go to the trash page), then gathers
    each chunk row's context: consecutive chunks of one prompt may share a
    link."""
    npf = packed.shape[0]
    dev = packed.device
    hd = cfg.head_dim
    h, hkv = out_dim(params["layers"][0]["wq"]) // hd, out_dim(params["layers"][0]["wk"]) // hd
    p = page_size
    s_ctx = n_ctx_pages * p
    n_pages = kv.total_pages // cfg.num_layers
    trash = n_pages - 1
    nc = npf * c

    # chunk side: token i of row r lives at start[r] + i; padding -> trash
    ids = packed[:, :c].long()
    start, n_valid = packed[:, c: c + 1], packed[:, c + 1: c + 2]  # [NPF, 1]
    rows = packed[:, c + 2:].long()
    maxp = rows.shape[1]
    ar = torch.arange(c, device=dev, dtype=torch.int32)[None]
    q_pos = start + ar  # [NPF, C] int32, the type the flash kernel reads
    valid = ar < n_valid
    q_seg = torch.where(valid, 0, -1).to(torch.int32)
    w_pages = torch.gather(rows, 1, torch.clamp(q_pos.long() // p, max=maxp - 1))
    w_pages = torch.where(valid, w_pages, trash).reshape(-1)
    w_offs = (q_pos.long() % p).reshape(-1)
    ctx_pages = rows[:, :n_ctx_pages]
    kv_pos = torch.arange(s_ctx, device=dev, dtype=torch.int32)[None].expand(npf, s_ctx)
    kv_seg = torch.where(kv_pos < start + n_valid, 0, -1).to(torch.int32)
    kv_pos = kv_pos.contiguous()
    cos_c, sin_c = M.rope_tables(q_pos, hd, cfg.rope_theta)
    xa = params["embed"][ids.reshape(-1)]  # [NPF*C, D]

    b = 0
    if decode is not None:  # decode side, as paged_decode_step
        tokens, seq_lens, page_table, live = decode
        b = tokens.shape[0]
        pos_d = seq_lens.long()
        d_pages = page_table.long()[torch.arange(b, device=dev),
                                    torch.clamp(pos_d // p, max=maxp - 1)]
        w_pages = torch.cat([w_pages, torch.where(live, d_pages, trash)])
        w_offs = torch.cat([w_offs, pos_d % p])
        kv_len = (seq_lens + 1).to(torch.int32)
        bases = torch.arange(cfg.num_layers, device=dev, dtype=torch.int32) * n_pages
        tables = (page_table[None] + bases[:, None, None]).contiguous()  # [L, B, maxp]
        cos_d, sin_d = M.rope_tables(pos_d[:, None], hd, cfg.rope_theta)
        xa = torch.cat([xa, params["embed"][tokens]])

    for li, lp in enumerate(params["layers"]):
        base = li * n_pages
        ya = _rms_norm_parts(xa, lp["ln1"], cfg.rms_norm_eps, nc)
        qa, ka, va = (_qmm_parts(ya, lp[k], nc, c) for k in ("wq", "wk", "wv"))
        q_c = M.apply_rope(qa[:nc].reshape(npf, c, h, hd), cos_c, sin_c)
        k_c = M.apply_rope(ka[:nc].reshape(npf, c, hkv, hd), cos_c, sin_c)
        k_w, v_w = k_c.reshape(nc, hkv, hd), va[:nc].reshape(nc, hkv, hd)
        if b:
            q_d = M.apply_rope(qa[nc:].reshape(b, 1, h, hd), cos_d, sin_d)
            k_d = M.apply_rope(ka[nc:].reshape(b, 1, hkv, hd), cos_d, sin_d)
            k_w = torch.cat([k_w, k_d[:, 0]])
            v_w = torch.cat([v_w, va[nc:].reshape(b, hkv, hd)])
        # every row's K/V lands before any row reads its context
        _write_kv(kv, base, w_pages, w_offs, k_w.transpose(0, 1), v_w.transpose(0, 1))
        kc, vc = _context(kv, base, ctx_pages, q_c.dtype)
        attn = mha(q_c, kc, vc, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                   q_positions=q_pos, kv_positions=kv_pos, causal=True,
                   sliding_window=cfg.sliding_window, impl="auto").reshape(nc, h * hd)
        if b:
            attn_d = paged_decode_attention(
                q_d[:, 0].reshape(b, hkv, h // hkv, hd).contiguous(), kv.k_pages, kv.v_pages,
                tables[li], kv_len, sliding_window=cfg.sliding_window,
                k_scales=kv.k_scales, v_scales=kv.v_scales)
            attn = torch.cat([attn, attn_d.reshape(b, h * hd)])
        xa = xa + _all_reduce(_qmm_parts(attn, lp["wo"], nc, c), tp)
        xa = xa + _all_reduce(
            _mlp_parts(_rms_norm_parts(xa, lp["ln2"], cfg.rms_norm_eps, nc), lp, nc, c), tp)
    return xa


def _chunk_logits(params: M.Params, cfg: MistralConfig, xc: torch.Tensor,
                  n_valid: torch.Tensor, c: int, tp: Optional["TP.TPMesh"] = None
                  ) -> torch.Tensor:
    """Chunk rows' final hidden [NPF*C, D] -> each row's last-valid-position
    logits [NPF, V] f32, one lm_head product per row (the shape of a lone
    prefill chunk's, so a mixed link's first tokens are the alternating
    schedule's)."""
    npf = xc.shape[0] // c
    xn = M.rms_norm(xc, params["final_norm"], cfg.rms_norm_eps).reshape(npf, c, -1)
    last = torch.clamp(n_valid.long() - 1, 0, c - 1)
    x_last = xn[torch.arange(npf, device=xc.device), last]
    logits = torch.cat([F.linear(x_last[r: r + 1], params["lm_head"]) for r in range(npf)])
    return _vocab_logits(logits, tp, cfg.vocab_size)


def paged_prefill_chunk_packed(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    packed: torch.Tensor,  # [C + 2 + maxp] int32 on the device: ids | start | n_valid | table row
    page_size: int,
    n_ctx_pages: int,  # pages gathered as attention context (covers start + C)
    c: int,
    tp: Optional["TP.TPMesh"] = None,
) -> torch.Tensor:
    """Prefill one chunk of one request into its pages -> logits of the last
    valid token [V] f32.  Every per-chunk host input rides in `packed`, one
    host-to-device copy.  Chunk queries attend to the request's pages written
    so far plus the chunk itself (causal, sliding window).  With `tp`, one
    rank's chunk over its slices."""
    packed = packed[None]
    xc = _mixed_layers(params, kv, cfg, packed, c, page_size, n_ctx_pages, None, tp)
    return _chunk_logits(params, cfg, xc, packed[:, c + 1], c, tp)[0]


def paged_mixed_step(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    packed: torch.Tensor,  # [NPF, C + 2 + maxp] int32 rows: ids | start | n_valid | table row
    tokens: torch.Tensor,  # [B] decode input token per slot
    seq_lens: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,  # [B, maxp] int32
    active: torch.Tensor,  # [B] bool: slots decoding in this burst
    done: torch.Tensor,  # [B] bool: EOS'd earlier in the burst
    eos_ids: torch.Tensor,  # [B]
    allow_masks: torch.Tensor,  # [B, V] bool
    page_size: int,
    n_ctx_pages: int,
    c: int,
    sample_chunk: bool = False,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    sampling: Sampling = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mixed prefill + decode: one link advances NPF prefill chunk rows AND
    every decoding slot by one token -> (chunk_logits [NPF, V] f32 | None,
    token [B], done' [B], seq_lens' [B]).

    The chunk rows' NPF*C tokens and the B decode rows share one activation,
    so each W8A8 projection and FFN weight is read once for all of them
    (float weights once per chunk row and once for the decode rows,
    `_qmm_parts`); attention splits: chunk rows run masked attention over their gathered
    context (the flash kernel on the card), decode rows the paged decode
    kernel.  Rows may be different requests or consecutive chunks of one
    prompt; fully padded rows (n_valid 0, every table entry the trash page)
    bucket NPF.  The decode side carries the chained bookkeeping (EOS freeze
    and lengths, as paged_decode_step_chained).  `sample_chunk` (some row
    completes its prompt) also returns each row's last-valid-position
    logits; otherwise no chunk logits are computed."""
    if logits_slice is not None and sampling is not None:
        raise ValueError("logits_slice requires greedy decode")
    live = active & ~done
    xa = _mixed_layers(params, kv, cfg, packed, c, page_size, n_ctx_pages,
                       (tokens, seq_lens, page_table, live))
    nc = packed.shape[0] * c
    x_d = M.rms_norm(xa[nc:], params["final_norm"], cfg.rms_norm_eps)
    nxt = _logits_tail(params, x_d, allow_masks, live, logits_slice, sampling)
    nxt = torch.where(done, 0, nxt)
    new_done = done | (nxt == eos_ids)
    new_lens = torch.where(done | ~active, seq_lens, seq_lens + 1)
    chunk_logits = None
    if sample_chunk:
        chunk_logits = _chunk_logits(params, cfg, xa[:nc], packed[:, c + 1], c)
    return chunk_logits, nxt, new_done, new_lens


def paged_decode_multi(
    params: M.Params,
    kv: PagedKV,
    cfg: MistralConfig,
    tokens: torch.Tensor,  # [B]
    seq_lens: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,  # [B, maxp] int32
    active: torch.Tensor,  # [B] bool
    allow_masks: torch.Tensor,  # [B, V] bool
    eos_ids: torch.Tensor,  # [B]
    page_size: int,
    n_steps: int,
    logits_slice: Optional[Tuple[int, int, int]] = None,
    sampling: Sampling = None,  # its noise [n_steps, B, V]: one draw per link
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n_steps` chained decode links with no host sync between them ->
    (tokens [B, n_steps], n_emitted [B]); rows freeze at their own EOS.
    usdm_tpu's fused multi-step decode, which `PagedEngine.step_multi` calls
    where its links run without CUDA graphs; on the card it replays the same
    links from graphs through DecodeLinks."""
    tok, lens, done = tokens, seq_lens, ~active
    out = []
    for i in range(n_steps):
        link = None if sampling is None else (sampling[0][i], *sampling[1:])
        tok, done, lens = paged_decode_step_chained(params, kv, cfg, tok, lens, page_table,
                                                    active, done, eos_ids, allow_masks,
                                                    page_size, logits_slice, link)
        out.append(tok)
    out = torch.stack(out, dim=1)
    is_eos = out == eos_ids[:, None]
    n_emitted = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, n_steps)
    return out, torch.where(active, n_emitted, 0)


def sample_next(logits: torch.Tensor, allow: torch.Tensor, sampling: Sampling = None
                ) -> torch.Tensor:
    """Mask + pick the first token after prefill -> 0-d int64 tensor."""
    masked = torch.where(allow, logits, NEG_INF)[None]
    if sampling is None:
        return torch.argmax(masked[0])
    return sample_batched(masked, *sampling)[0]
