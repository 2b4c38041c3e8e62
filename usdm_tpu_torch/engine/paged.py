"""Paged-KV continuous-batching engine: the host-side scheduler.

Port of usdm_tpu/engine/paged.py: admission with best-fit page allocation,
session prefix reuse (a finished request of a session HOLDs its pages; the
session's next request prefills only from its page-aligned common prefix),
chunked prefill, greedy or sampled decode as CHAINS of device-side links
with one host sync per chain, sliding-window page reclaim, request
cancellation, mixed prefill + decode bursts (`step_mixed_burst`: while
prompts wait and at least `EngineConfig.mixed_min_decode` slots decode,
each link packs up to `mixed_prefill_rows` prefill chunks with every
decoding slot, one sync per burst), the fused multi-step decode
(`multi_impl="fused"`, `step_multi`), streaming consumers (`Request.stream`),
and the JAX engine's two latency hiders:

  * first-token deferral: after the last prefill chunk of a quiet engine
    the first token stays on the device, the next chain takes it as its
    input, and the host learns it at that chain's sync;
  * depth-1 chain run-ahead (`EngineConfig.runahead`): in the quiet state
    the next chain is dispatched from the carried device state before the
    previous chain's sync, so the sync and the host's bookkeeping overlap
    the device's work.

Greedy speculative decoding: `draft=(params, cfg)` drafts `spec_k` tokens
per round with a draft model over its own KV pool (which shares the
target's page table), `draft="ngram"` proposes them from each sequence's
own token history; one target forward verifies a round and acceptance runs
on the device, so R rounds take one host sync (`step_spec`,
`step_spec_ngram`).  The tokens are plain greedy decode's for any draft.

Every decode link, chained, fused or per-token (`step`), and every
speculative round runs through `DecodeLinks`: on the card one CUDA-graph
replay per link or round; on the CPU, or with `eager_links=True`, eagerly.
Mixed links run eagerly everywhere.  The params may hold W8A8 projections
(models/quant.py) and the KV pool may be int8
(`EngineConfig.kv_dtype="int8"`).

Tensor-parallel serving (`mesh=`, engine/tp.py): each rank's engine holds
its slices of the params, the pool and the draft, and takes usdm_tpu's TP
branches: no lm_head slice, no mixed bursts, `step_multi` as per-token
steps; chains (with run-ahead), rounds and prefill run as on one device,
with every link and round eager.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.engine import tp as TP
from usdm_tpu_torch.engine.paged_ops import (
    DecodeLinks,
    PagedKV,
    paged_decode_multi,
    paged_prefill_chunk_packed,
    sample_next,
    to_device,
)
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.ops.sampling import gumbel_noise

# slot states (HOLD: finished request whose pages are kept for prefix reuse
# by the next request of the same session)
FREE, PREFILL, DECODE, HOLD = 0, 1, 2, 3


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_ids: List[int]
    allow_mask: np.ndarray  # [V] bool
    eos_id: int
    max_new_tokens: int = 256
    top_k: int = 1  # 1 = greedy
    top_p: float = 1.0
    temperature: float = 1.0
    seed: int = 0
    session: Optional[int] = None  # requests of one session reuse KV prefixes
    # a streaming consumer reads output_ids as they grow
    # (EngineServer.generate_stream): its first token is never deferred
    stream: bool = False
    # filled by the engine:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    t_submit: float = 0.0
    ttft_s: Optional[float] = None
    error: Optional[str] = None  # set instead of raising (the engine runs on
    # EngineServer's loop thread)
    cancelled: bool = False

    @property
    def sampled(self) -> bool:
        return self.top_k != 1


def _mask_slice(mask) -> Optional[tuple]:
    """(lo, hi, extra) if `mask` is an interval of allowed ids plus at most
    one isolated extra column (the dialog stage masks) — enables the lossless
    sliced-lm_head greedy tail.  None if no such structure or if it allows
    nearly everything."""
    idx = np.flatnonzero(np.asarray(mask))
    n = len(idx)
    if n == 0 or n > 0.9 * len(mask):
        return None
    if idx[-1] - idx[0] + 1 == n:  # pure interval
        return (int(idx[0]), int(idx[-1]) + 1, -1)
    if n >= 2 and idx[-1] - idx[1] + 1 == n - 1:  # isolated low + interval
        return (int(idx[1]), int(idx[-1]) + 1, int(idx[0]))
    if n >= 2 and idx[-2] - idx[0] + 1 == n - 1:  # interval + isolated high
        return (int(idx[0]), int(idx[-2]) + 1, int(idx[-1]))
    return None


def _ctx_pages_bucket(n_pages: int, maxp: int) -> int:
    """Context-gather page count rounded up to a power of two, capped at
    maxp (the JAX engine bounds its compiled variants this way; here it keeps
    the prefill context shapes identical to the reference's)."""
    b = 1
    while b < n_pages:
        b *= 2
    return min(b, maxp)


class PagedEngine:
    """Continuous-batching engine over the paged KV pool, on one device or
    (`mesh`, engine/tp.py make_tp_mesh) as one rank of a tensor-parallel
    group: the params (whole, or already the rank's slices), the pool and
    the draft are sharded as usdm_tpu's engine shards them, and every rank
    must run the same calls (EngineServer and engine/tp.py follow see to
    it).

    `draft=(draft_params, draft_cfg)` enables greedy speculative decoding
    (ecfg.spec_k tokens drafted per round, verified by one target forward);
    the draft shares the target's page tables and keeps its own KV pool.
    `draft="ngram"` enables draft-free prompt-lookup speculation: proposals
    come from matching the current suffix against the sequence's own token
    history on the device, with no draft model or pool, and turns that do
    not speculate keep chained decode (a model draft makes them single-step,
    mirroring each step into its pool).  The tokens are plain greedy
    decode's for any draft; only speed depends on the draft's agreement.

    `eager_links=True` runs every decode link and round eagerly on the card
    too, instead of replaying it from a CUDA graph: for the card tests and
    chip_smoke.py, which hold the graphs against it (the tokens are the
    same).  On the CPU links are always eager."""

    def __init__(self, params: M.Params, cfg: MistralConfig, ecfg: EngineConfig,
                 device=None, mesh=None, draft=None, eager_links: bool = False):
        self.ngram = isinstance(draft, str) and draft == "ngram"
        if isinstance(draft, str) and not self.ngram:
            raise ValueError(f"draft must be (params, cfg) or 'ngram', got {draft!r}")
        if self.ngram:
            draft = None
        if ecfg.kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {ecfg.kv_dtype!r}")
        self.cfg = cfg
        self.ecfg = ecfg
        self.mesh = mesh
        if mesh is not None and not isinstance(mesh, TP.TPMesh):
            raise TypeError(f"mesh must be engine/tp.py's TPMesh (make_tp_mesh), got "
                            f"{type(mesh).__name__}")
        tp = 1 if mesh is None else mesh.size
        if mesh is not None:
            params = TP.local_params(params, cfg, mesh)
            device = mesh.device
        self.params = params
        self.device = torch.device(device) if device is not None else params["embed"].device
        ps = ecfg.page_size
        # +1: the last page is the trash target of inactive slots
        n_pages = (ecfg.n_pages or ecfg.max_batch_size * ecfg.max_pages_per_seq) + 1
        self.n_pages = n_pages
        self.kv = PagedKV.create(cfg, n_pages, ps, self.device, ecfg.kv_dtype, tp)
        self.draft_params = self.draft_cfg = self.draft_kv = None
        if draft is not None:
            self.draft_params, self.draft_cfg = draft
            if self.draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft vocab must match the target's")
            if mesh is not None:  # the draft shards like the target
                self.draft_params = TP.local_params(self.draft_params, self.draft_cfg, mesh)
            # the draft's pool in its own dtype (not the target's int8), as usdm_tpu
            self.draft_kv = PagedKV.create(self.draft_cfg, n_pages, ps, self.device, tp=tp)
        self.free_pages: List[int] = list(range(n_pages - 1))
        b = ecfg.max_batch_size
        self.page_table = np.zeros((b, ecfg.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros(b, np.int32)
        self.tokens = np.zeros(b, np.int64)
        self.status = np.zeros(b, np.int32)
        self.eos = np.zeros(b, np.int64)
        self.top_k = np.ones(b, np.int64)
        self.top_p = np.ones(b, np.float32)
        self.temp = np.ones(b, np.float32)
        # per-slot vocab masks live on the device, rewritten only on admission
        self._allow_dev = torch.ones((b, cfg.vocab_size), dtype=torch.bool, device=self.device)
        self._mask_cache: dict = {}
        # the decode link's static device inputs (and, on the card, its CUDA
        # graphs); a chain holds at most decode_horizon links, a mixed burst
        # at most its link budget
        self._burst_links = -(-ecfg.prefill_chunks_per_tick // max(1, ecfg.mixed_prefill_rows))
        speculates = (self.ngram or draft is not None) and ecfg.spec_k > 0
        self.links = DecodeLinks(
            params, self.kv, cfg, self._allow_dev, ecfg.max_pages_per_seq, ps,
            max(ecfg.decode_horizon, self._burst_links, 1), graphs=not eager_links,
            draft=None if draft is None else (self.draft_params, self.draft_kv, self.draft_cfg),
            spec_k=ecfg.spec_k if speculates else 0, ngram_max_n=ecfg.ngram_max_n,
            max_rounds=max(1, ecfg.decode_horizon), tp=mesh)
        # slot state mirrored in the links' buffers (table, eos, sampling
        # parameters) changes only at admission and window reclaim: it is
        # re-uploaded only when dirty
        self._dev_dirty = True
        # the links' tok/lens/done carried between chains: the previous
        # chain's outputs ARE the next chain's inputs, so steady-state decode
        # uploads nothing.  False = host state changed; re-upload.
        self._hot = False
        # deferred post-prefill first tokens: slot -> 0-d device tensor,
        # consumed by the next chain (_dispatch_chain); any other decode path
        # flushes them synchronously first (_flush_pending)
        self._pending_first: Dict[int, torch.Tensor] = {}
        # depth-1 chain run-ahead: the dispatched but unsynced chain
        self._inflight: Optional[dict] = None
        # ngram speculation's token history lives in the links' `hist`; it is
        # rebuilt from host state when a path other than an ngram round
        # emitted tokens or a slot was (re)admitted (_ensure_hist)
        self._hist_dirty = True
        # per-slot admission generation: a chain dispatched for generation g
        # is never absorbed into a slot re-admitted at g + 1
        self.slot_gen = np.zeros(b, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_slice: List[Optional[tuple]] = [None] * b
        self.slot_pages: List[List[int]] = [[] for _ in range(b)]
        self.slot_rng: List[Optional[torch.Generator]] = [None] * b  # sampled slots
        self.released = np.zeros(b, np.int32)  # leading pages reclaimed by the window
        self.prefill_pos = np.zeros(b, np.int32)
        self.prefill_order: List[int] = []
        self.waiting: List[Request] = []
        self.session_slots: dict = {}
        self.slot_history: List[List[int]] = [[] for _ in range(b)]
        self._hold_order: List[int] = []
        self.decode_horizon = ecfg.decode_horizon
        # multi-token decode: "chain" (step_chain: ramped chains, run-ahead,
        # first-token deferral) or "fused" (step_multi: one horizon of links
        # and one sync per tick, first tokens flushed before it)
        self.multi_impl = "chain"
        self._chain_streak = 0
        self.steps = 0  # decode links and mixed links
        self.mixed_links = 0
        self.mixed_rows = 0  # prefill chunk rows carried by mixed links
        self.prefill_chunks = 0
        self.total_emitted = 0
        self.total_finished = 0
        self.total_cancelled = 0
        self.runahead_chains = 0  # chains dispatched before their predecessor's sync
        self.spec_rounds = 0  # speculative rounds run, and the tokens they emitted
        self.spec_emitted = 0
        self._ttfts: Deque[float] = deque(maxlen=200)  # recent times to first token
        # wall seconds per scheduler phase (stats()["perf_s"]): dispatch,
        # host sync, bookkeeping
        self.perf: Dict[str, float] = {}

    def _acc(self, key: str, dt: float) -> None:
        self.perf[key] = self.perf.get(key, 0.0) + dt

    # ------------------------------------------------------------ scheduling
    @property
    def active(self) -> np.ndarray:
        return self.status == DECODE

    @property
    def busy(self) -> bool:
        """Work pending (HOLD slots are idle capacity, not work)."""
        return bool(self.waiting or ((self.status == PREFILL) | (self.status == DECODE)).any())

    def submit(self, req: Request) -> None:
        if not req.t_submit:
            req.t_submit = time.time()
        self.waiting.append(req)

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.ecfg.page_size)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.ecfg.max_batch_size) if self.status[s] == FREE]

    def _occupied(self) -> int:
        return int((self.status != FREE).sum())

    def _reuse_start(self, req: Request) -> int:
        """Page-aligned prefill resume point of a session request against its
        held predecessor (the common prefix of the new prompt and the held
        prompt + output, clipped to the kv-written length), or 0."""
        slot = self.session_slots.get(req.session)
        if slot is None or self.status[slot] != HOLD or int(self.released[slot]) != 0:
            return 0
        hist = self.slot_history[slot]
        limit = min(len(req.prompt_ids), len(hist), int(self.seq_lens[slot]))
        common = 0
        while common < limit and req.prompt_ids[common] == hist[common]:
            common += 1
        ps = self.ecfg.page_size
        return (common // ps) * ps

    def _admit_into(self, req: Request, slot: int, start: int, extra: List[int]) -> None:
        self.slot_pages[slot] = self.slot_pages[slot] + extra
        self.slot_gen[slot] += 1
        row = np.full(self.ecfg.max_pages_per_seq, self.n_pages - 1, np.int32)
        row[: len(self.slot_pages[slot])] = self.slot_pages[slot]
        row[: int(self.released[slot])] = self.n_pages - 1
        self.page_table[slot] = row
        self.slot_req[slot] = req
        self.slot_history[slot] = []
        self.status[slot] = PREFILL
        self._chain_streak = 0
        self.prefill_pos[slot] = start
        self.prefill_order.append(slot)
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        self.temp[slot] = req.temperature
        self.eos[slot] = req.eos_id
        self.slot_slice[slot] = _mask_slice(req.allow_mask)
        self.slot_rng[slot] = None
        if req.sampled:
            self.slot_rng[slot] = torch.Generator(device=self.device).manual_seed(req.seed)
        key = req.allow_mask.tobytes()
        mask_dev = self._mask_cache.get(key)
        if mask_dev is None:
            mask_dev = torch.as_tensor(np.asarray(req.allow_mask, bool), device=self.device)
            if len(self._mask_cache) < 16:
                self._mask_cache[key] = mask_dev
        self._allow_dev[slot] = mask_dev
        self._dev_dirty = True
        self._hot = False
        self._hist_dirty = True

    def _try_admit(self) -> None:
        """FCFS with skip: assign waiting requests to free slots and pages;
        session requests resume on their held slot; HOLD slots are evicted
        LRU when capacity is needed."""
        i = 0
        while i < len(self.waiting):
            req = self.waiting[i]
            need = self._pages_needed(len(req.prompt_ids) + req.max_new_tokens)
            if need > self.ecfg.max_pages_per_seq:
                req.error = (f"request needs {need} pages > "
                             f"max_pages_per_seq={self.ecfg.max_pages_per_seq}")
                req.finished = True
                self.waiting.pop(i)
                continue
            start = self._reuse_start(req) if req.session is not None else 0
            if start > 0:
                slot = self.session_slots[req.session]
                extra_need = need - len(self.slot_pages[slot])
                if extra_need <= len(self.free_pages):
                    del self.session_slots[req.session]
                    self._hold_order.remove(slot)
                    extra = [self.free_pages.pop() for _ in range(max(extra_need, 0))]
                    self.waiting.pop(i)
                    self._admit_into(req, slot, start, extra)
                    continue
            slots = self._free_slots()
            if not slots and self._hold_order:
                self._release_hold(self._hold_order[0])
                slots = self._free_slots()
            while need > len(self.free_pages) and self._hold_order:
                self._release_hold(self._hold_order[0])
            if not slots or need > len(self.free_pages):
                i += 1
                continue
            if req.session is not None:  # stale hold that didn't match
                slot_h = self.session_slots.get(req.session)
                if slot_h is not None:
                    self._release_hold(slot_h)
            self.waiting.pop(i)
            slot = slots[0]
            self.released[slot] = 0
            self.slot_pages[slot] = []
            extra = [self.free_pages.pop() for _ in range(need)]
            self._admit_into(req, slot, 0, extra)

    def _first_sampling(self, slot: int):
        """Sampling state of a slot's first token (prefill), or None when
        its request is greedy."""
        req = self.slot_req[slot]
        if not req.sampled:
            return None
        as_t = lambda val, dt: torch.tensor([val], dtype=dt, device=self.device)  # noqa: E731
        return (gumbel_noise((1, self.cfg.vocab_size), self.slot_rng[slot], self.device),
                as_t(req.top_k, torch.int64), as_t(req.top_p, torch.float32),
                as_t(req.temperature, torch.float32))

    def _prefill_tick(self) -> Optional[int]:
        """Advance the oldest prefilling request by one chunk; returns the
        slot when this call completed its prompt (first token sampled)."""
        if not self.prefill_order:
            return None
        self.prefill_chunks += 1
        slot = self.prefill_order[0]
        req = self.slot_req[slot]
        start = int(self.prefill_pos[slot])
        c = self.ecfg.prefill_chunk
        n = min(c, len(req.prompt_ids) - start)
        ncp = _ctx_pages_bucket(self._pages_needed(start + c), self.ecfg.max_pages_per_seq)
        # every per-chunk input rides one host-to-device copy
        packed = to_device(self._pack_rows([(slot, req, start, n)], 1)[0], self.device)
        logits = paged_prefill_chunk_packed(self.params, self.kv, self.cfg, packed,
                                            self.ecfg.page_size, ncp, c, self.mesh)
        if self.draft_params is not None:
            # the draft prefills the same chunk into its pool: without a
            # prompt-conditioned draft cache its proposals are garbage (the
            # tokens stay right, acceptance collapses)
            paged_prefill_chunk_packed(self.draft_params, self.draft_kv, self.draft_cfg, packed,
                                       self.ecfg.page_size, ncp, c, self.mesh)
        self.prefill_pos[slot] = start + n
        if start + n < len(req.prompt_ids):
            return None
        self.prefill_order.pop(0)
        first = sample_next(logits, self._allow_dev[slot], self._first_sampling(slot))
        self.seq_lens[slot] = len(req.prompt_ids)
        self.status[slot] = DECODE
        self._hot = False
        if self._defer_first_ok(req):
            # no host sync here: the next chain injects the device scalar as
            # this slot's input token and the host learns it at that sync
            self._pending_first[slot] = first
            return slot
        t0 = time.perf_counter()
        tok = int(first)
        self._acc("first_tok_sync", time.perf_counter() - t0)
        self._record_first(slot, tok)
        return slot

    def _multi_next(self) -> bool:
        """The next tick's decode is multi-token: deferring a post-prefill
        per-token step to it saves that step's sync.  Not with a draft or
        ngram: the next tick is a speculative round (or a mirroring step),
        which reads the host's tokens."""
        return self.decode_horizon > 1 and self.draft_params is None and not self.ngram

    def _defer_first_ok(self, req: Request) -> bool:
        """First-token deferral gate: only a chain absorbs a pending device
        token without an extra sync (the fused multi-step decode and step()
        flush first), only in the quiet state (under load the scheduler keeps
        prefilling other prompts first, so a deferred sync would sit on this
        request's TTFT), and never for a streaming consumer, whose first
        visible token would wait a whole chain."""
        return (self._multi_next() and self.multi_impl == "chain" and not self.waiting
                and not self.prefill_order and not req.stream)

    def _pack_rows(self, rows, npf: int) -> np.ndarray:
        """Chunk rows [(slot, request, start, n_valid)] -> [npf, C + 2 + maxp]
        int32: ids | start | n_valid | page-table row.  Rows past the given
        ones are padding: no valid token, every table entry the trash page."""
        c = self.ecfg.prefill_chunk
        packed = np.zeros((npf, c + 2 + self.page_table.shape[1]), np.int32)
        packed[:, c + 2:] = self.n_pages - 1
        for ri, (slot, req, start, n) in enumerate(rows):
            packed[ri, :n] = req.prompt_ids[start: start + n]
            packed[ri, c], packed[ri, c + 1] = start, n
            packed[ri, c + 2:] = self.page_table[slot]
        return packed

    def _record_first(self, slot: int, first: int) -> None:
        """Host bookkeeping of a post-prefill first token."""
        req = self.slot_req[slot]
        req.ttft_s = time.time() - req.t_submit
        self._ttfts.append(req.ttft_s)
        req.output_ids.append(first)
        self.tokens[slot] = first
        self._hist_dirty = True
        if first == req.eos_id or len(req.output_ids) >= req.max_new_tokens:
            self._finish(slot)

    def _flush_pending(self) -> None:
        """Synchronously absorb deferred first tokens (step() reads
        self.tokens on the host)."""
        for slot, tok in list(self._pending_first.items()):
            t0 = time.perf_counter()
            first = int(tok)
            self._acc("first_tok_sync", time.perf_counter() - t0)
            self._record_first(slot, first)
        self._pending_first.clear()

    def _slot_state_dev(self) -> None:
        """Upload table, eos and the sampling parameters into the links'
        buffers when host-side slot state changed."""
        if self._dev_dirty:
            lk = self.links
            for dst, src in ((lk.table, self.page_table), (lk.eos, self.eos),
                             (lk.top_k, self.top_k), (lk.top_p, self.top_p),
                             (lk.temperature, self.temp)):
                lk.load(dst, src)
            self._dev_dirty = False

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        self._chain_streak = 0
        self._hot = False
        if req is not None:
            req.finished = True
            self.total_finished += 1
            self.total_emitted += len(req.output_ids)
        if req is not None and req.session is not None:
            # keep the pages: the session's next request reuses the KV of its
            # common prefix with (prompt + output); seq_lens[slot] stays the
            # kv-written length (the last emitted token has no KV)
            self.slot_history[slot] = list(req.prompt_ids) + list(req.output_ids)
            old = self.session_slots.get(req.session)
            if old is not None and old != slot:
                self._release_hold(old)
            self.session_slots[req.session] = slot
            self.status[slot] = HOLD
            self.slot_req[slot] = None
            self._hold_order.append(slot)
            return
        self.free_pages.extend(self.slot_pages[slot][int(self.released[slot]):])
        self.slot_pages[slot] = []
        self.released[slot] = 0
        self.status[slot] = FREE
        self.slot_req[slot] = None

    def _release_hold(self, slot: int) -> None:
        if self.status[slot] != HOLD:
            return
        self.free_pages.extend(self.slot_pages[slot][int(self.released[slot]):])
        self.slot_pages[slot] = []
        self.released[slot] = 0
        self.slot_history[slot] = []
        self.status[slot] = FREE
        if slot in self._hold_order:
            self._hold_order.remove(slot)
        for s, sl in list(self.session_slots.items()):
            if sl == slot:
                del self.session_slots[s]

    def release_session(self, session: int) -> None:
        """Dialog over: free the session's held pages (no-op if none)."""
        slot = self.session_slots.get(session)
        if slot is not None:
            self._release_hold(slot)

    def cancel(self, req_id: int) -> bool:
        """Abort one request (waiting or slot-resident); its pages return to
        the pool or, for a session, go to HOLD with only the kv-written
        prefix advertised.  Runs on the thread that ticks the engine.  False
        if the request already finished (the in-flight chain's sync may
        finish it first) or is unknown."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                self.waiting.pop(i)
                r.cancelled = r.finished = True
                self.total_cancelled += 1
                return True
        for slot, r in enumerate(self.slot_req):
            if r is None or r.req_id != req_id:
                continue
            # the run-ahead chain writes into this slot at its sync: absorb it
            # first, so the finish below retires consistent state
            self.drain_inflight()
            if self.slot_req[slot] is not r or r.finished:
                return False
            r.cancelled = True
            if self.status[slot] == PREFILL:
                if slot in self.prefill_order:
                    self.prefill_order.remove(slot)
                self.seq_lens[slot] = int(self.prefill_pos[slot])
            self._pending_first.pop(slot, None)
            self._finish(slot)
            self._dev_dirty = True
            self.total_cancelled += 1
            return True
        return False

    def _reclaim_window(self, slot: int) -> None:
        """Return pages wholly below the sliding window to the pool and point
        their table entries at the trash page."""
        w = self.cfg.sliding_window
        if not w:
            return
        ps = self.ecfg.page_size
        first_needed = max(int(self.seq_lens[slot]) - w, 0) // ps
        r = int(self.released[slot])
        while r < first_needed and r < len(self.slot_pages[slot]):
            self.free_pages.append(self.slot_pages[slot][r])
            self.page_table[slot, r] = self.n_pages - 1
            r += 1
        if r != int(self.released[slot]):
            self._dev_dirty = True
        self.released[slot] = r

    def _sampled(self, dec: np.ndarray) -> bool:
        return any(self.slot_req[s].sampled for s in np.flatnonzero(dec))

    def _active_slice(self, dec: np.ndarray, sampled: bool) -> Optional[tuple]:
        """The lm_head slice shared by every decoding slot; None when any row
        samples (the slice is a greedy-only tail) and under TP (lm_head is
        split over the vocab)."""
        if sampled or self.mesh is not None:
            return None
        slices = {self.slot_slice[i] for i in np.flatnonzero(dec)}
        return slices.pop() if len(slices) == 1 else None

    # ------------------------------------------------------------------ run
    def step(self, _defer_chain: bool = False) -> int:
        """Admit + one prefill chunk + one decode link (one host sync).
        `_defer_chain` (tick only): when this step's chunk drained the
        queue, leave decode to the next tick's chain."""
        if self._inflight is not None:  # absorb any run-ahead chain first
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)
        t0 = time.perf_counter()
        self._try_admit()
        self._acc("admit", time.perf_counter() - t0)
        t0 = time.perf_counter()
        done_slot = self._prefill_tick()
        self._acc("prefill", time.perf_counter() - t0)
        dec = self.status == DECODE
        if not dec.any():
            return self._occupied()
        if (_defer_chain and done_slot is not None and not self.prefill_order
                and not self.waiting and self._multi_next()):
            return self._occupied()
        self._flush_pending()  # the link below starts from self.tokens
        dec = self.status == DECODE  # a pending EOS may have finished a slot
        if not dec.any():
            return self._occupied()
        # a chain of one link from the host's state: done = ~active gives
        # paged_decode_step's tokens; with a draft the link mirrors its step
        # into the draft's pool
        self._hot = False
        self._sync_chain(self._dispatch_chain(1, dec, "step",
                                              mirror=self.draft_params is not None))
        self._hot = False
        return self._occupied()

    def _safe_horizon(self, n_steps: int, dec: np.ndarray) -> int:
        """Clamp a chain so no slot decodes past its token budget or its page
        allocation."""
        n = n_steps
        ps = self.ecfg.page_size
        for slot in np.flatnonzero(dec):
            req = self.slot_req[slot]
            # a deferred first token spends one unit of the budget when the
            # chain absorbs it
            pend = 1 if slot in self._pending_first else 0
            n = min(n, req.max_new_tokens - len(req.output_ids) - pend)
            n = min(n, len(self.slot_pages[slot]) * ps - (int(self.seq_lens[slot]) + 1))
        return max(n, 1)

    def step_multi(self, n_steps: int) -> int:
        """One prefill chunk, then up to n_steps decode links with ONE host
        sync (`multi_impl="fused"`, usdm_tpu's fused fori_loop): no ramp, no
        run-ahead, and pending first tokens are flushed before the links (the
        links start from the host's tokens).  On the card each link is a
        CUDA-graph replay, as in a chain; links without graphs (the CPU,
        `eager_links`) are one call of `paged_decode_multi`, as in usdm_tpu.
        Under TP it is one per-token `step`, as in usdm_tpu."""
        if self.mesh is not None:
            return self.step()
        if self._inflight is not None:  # absorb any run-ahead chain first
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)
        t0 = time.perf_counter()
        self._try_admit()
        self._acc("admit", time.perf_counter() - t0)
        t0 = time.perf_counter()
        self._prefill_tick()
        self._acc("prefill", time.perf_counter() - t0)
        self._flush_pending()
        dec = self.status == DECODE
        if not dec.any():
            return self._occupied()
        n_steps = min(n_steps, self.links.max_links)
        if self.waiting:
            n_steps = min(n_steps, 8)  # the capacity-wait cap of step_chain
        self._hot = False
        n_steps = self._safe_horizon(n_steps, dec)
        if self.links.graphed:
            self._sync_chain(self._dispatch_chain(n_steps, dec, "multi"))
        else:
            self._decode_multi(n_steps, dec)
        self._hot = False
        return self._occupied()

    def _decode_multi(self, n_steps: int, dec: np.ndarray) -> int:
        """step_multi's links as one `paged_decode_multi` call from the
        host's tokens and lengths; a sampled slot draws its noise link by
        link, as a chain draws it."""
        t0 = time.perf_counter()
        lk = self.links
        sampled = self._sampled(dec)
        lk.load(lk.active, dec)
        lk.load(lk.tok, self.tokens)
        lk.load(lk.lens, self.seq_lens)
        self._slot_state_dev()
        sampling = None
        if sampled:
            noise = torch.zeros((n_steps, *lk.noise.shape), device=self.device)
            v = self.cfg.vocab_size
            for i in range(n_steps):
                for s in np.flatnonzero(dec):
                    if self.slot_req[s].sampled:
                        noise[i, s] = gumbel_noise((v,), self.slot_rng[s], self.device)
            sampling = (noise, lk.top_k, lk.top_p, lk.temperature)
        toks, n_emitted = paged_decode_multi(
            self.params, self.kv, self.cfg, lk.tok, lk.lens, lk.table, lk.active, lk.allow,
            lk.eos, self.ecfg.page_size, n_steps, self._active_slice(dec, sampled), sampling)
        self._acc("multi_dispatch", time.perf_counter() - t0)
        t0 = time.perf_counter()
        toks, n_emitted = toks.cpu().numpy(), n_emitted.cpu().numpy()
        self._acc("multi_sync", time.perf_counter() - t0)
        self.steps += n_steps
        t0 = time.perf_counter()
        try:
            return self._absorb_multi(dec, toks, n_emitted)
        finally:
            self._acc("absorb", time.perf_counter() - t0)

    def step_chain(self, n_steps: int) -> int:
        """Multi-token decode: n_steps chained links with ONE host sync.
        Chains ramp 8 -> 16 -> ... up to n_steps while the decoding set is
        unchanged, so an early EOS wastes at most the current short chain's
        tail.  In the quiet state (nothing waiting or prefilling, and
        `ecfg.runahead`) chains run ahead depth-1: the successor is
        dispatched from the carried device state before this chain's sync."""
        t0 = time.perf_counter()
        self._try_admit()
        self._acc("admit", time.perf_counter() - t0)
        t0 = time.perf_counter()
        self._prefill_tick()
        self._acc("prefill", time.perf_counter() - t0)
        n_steps = min(n_steps, self.links.max_links, 8 << min(self._chain_streak, 8))
        self._chain_streak += 1
        if self.waiting:
            n_steps = min(n_steps, 8)
        dec = self.status == DECODE
        fl, self._inflight = self._inflight, None
        if not dec.any():
            if fl is not None:
                self._sync_chain(fl)  # tail chain of a drained decode set
            return self._occupied()
        # no run-ahead with a draft: its rounds read the host's tokens
        quiet = (self.ecfg.runahead and not self.waiting and not self.prefill_order
                 and self.draft_params is None)
        if fl is not None:
            meta = None
            if quiet and self._hot:
                # length assumes the in-flight chain emits fully: if it emits
                # less it hit EOS, and `done` freezes the slot on the device
                n = self._runahead_len(n_steps, dec, fl)
                if n > 0:
                    meta = self._dispatch_chain(n, dec)
                    self.runahead_chains += 1
            self._sync_chain(fl)
            if meta is not None:
                self._inflight = meta
                return self._occupied()
            # nothing ran ahead: dispatch from the just-absorbed state
            dec = self.status == DECODE
            if not dec.any():
                return self._occupied()
        meta = self._dispatch_chain(self._safe_horizon(n_steps, dec), dec)
        if quiet and self._runahead_len(self.decode_horizon, dec, meta) > 0:
            # a successor exists: the next tick dispatches it, then syncs this
            self._inflight = meta
            return self._occupied()
        self._sync_chain(meta)
        return self._occupied()

    def _runahead_len(self, n_steps: int, dec: np.ndarray, fl: dict) -> int:
        """Longest chain dispatchable after the in-flight chain `fl`,
        assuming it emits fully; <= 0 means no run-ahead (a slot's budget
        or page allocation would run out)."""
        n = n_steps
        ps = self.ecfg.page_size
        for slot in np.flatnonzero(dec):
            req = self.slot_req[slot]
            n = min(n, req.max_new_tokens - len(req.output_ids) - int(fl["full_emit"][slot]))
            n = min(n, len(self.slot_pages[slot]) * ps
                    - (int(self.seq_lens[slot]) + fl["n_steps"] + 1))
        return n

    def _dispatch_chain(self, n_steps: int, dec: np.ndarray, kind: str = "chain",
                        mirror: bool = False) -> dict:
        """Dispatch one chain of `n_steps` links without a host sync ->
        what _sync_chain needs to absorb it later.  `mirror`: each link also
        runs the draft model's step (step() with a draft)."""
        t0 = time.perf_counter()
        lk = self.links
        sampled = self._sampled(dec)
        lslice = self._active_slice(dec, sampled)
        lk.load(lk.active, dec)
        if not self._hot:
            lk.load(lk.tok, self.tokens)
            lk.load(lk.lens, self.seq_lens)
            torch.logical_not(lk.active, out=lk.done)
        self._slot_state_dev()
        # deferred first tokens ride this chain as their slots' inputs; the
        # host learns them at the sync, as column 0
        pend = sorted(self._pending_first)
        for slot in pend:
            lk.inject(slot, self._pending_first[slot])
        self._pending_first.clear()
        lk.begin()
        sampled_slots = [s for s in np.flatnonzero(dec) if self.slot_req[s].sampled]
        v = self.cfg.vocab_size
        for _ in range(n_steps):
            for s in sampled_slots:  # fresh noise every link, as the eager chain drew it
                lk.noise[s].copy_(gumbel_noise((v,), self.slot_rng[s], self.device))
            lk.run(lslice, sampled, mirror)
        self._hot = True
        handle = lk.fetch()
        self._acc(f"{kind}_dispatch", time.perf_counter() - t0)
        full = np.where(dec, n_steps, 0)
        for slot in pend:
            full[slot] += 1
        return {"handle": handle, "dec": dec, "pend": pend, "n_steps": n_steps,
                "gen": self.slot_gen.copy(), "full_emit": full, "kind": kind}

    def _sync_chain(self, meta: dict) -> int:
        """ONE host sync for a dispatched chain (its tokens' copy alone),
        then absorb them."""
        t0 = time.perf_counter()
        toks_all = self.links.wait(meta["handle"], meta["n_steps"])
        self._acc(f"{meta['kind']}_sync", time.perf_counter() - t0)
        return self._absorb_chain(meta, toks_all)

    def _absorb_chain(self, meta: dict, toks_all: np.ndarray) -> int:
        """Absorb a synced chain.  Slots re-admitted since the dispatch
        (generation bump) or finished by an earlier absorb are skipped:
        their links were frozen or trash-routed on the device."""
        n_steps = meta["n_steps"]
        pend = meta["pend"]
        self.steps += n_steps
        dec = meta["dec"] & (self.status == DECODE) & (self.slot_gen == meta["gen"])
        b = self.ecfg.max_batch_size
        # pending slots emit their deferred first token as column 0 (their
        # chain input); everyone else's column 0 was emitted already, so
        # their window starts at column 1
        em = np.zeros((b, n_steps + 1), np.int64)
        em[:, :n_steps] = toks_all[:, 1:]
        valid = np.full(b, n_steps)
        for slot in pend:
            em[slot] = toks_all[slot]
            valid[slot] = n_steps + 1
        cols = np.arange(n_steps + 1)[None]
        is_eos = (em == self.eos[:, None]) & (cols < valid[:, None])
        n_emitted = np.where(dec, np.where(is_eos.any(axis=1), is_eos.argmax(axis=1) + 1, valid),
                             0)
        t0 = time.perf_counter()
        try:
            return self._absorb_multi(dec, em, n_emitted, pend_slots=pend)
        finally:
            self._acc("absorb", time.perf_counter() - t0)

    def step_mixed_burst(self) -> int:
        """Drain prefill chunks where every link also advances every decoding
        slot by one token (`paged_mixed_step`): up to `mixed_prefill_rows`
        chunk rows, packed FCFS (consecutive chunks of one prompt may share a
        link), ride each link with the decode rows, so a prefill burst no
        longer stalls the decodes.  The burst holds
        ceil(prefill_chunks_per_tick / mixed_prefill_rows) links at most and
        absorbs its decode tokens, and the first tokens of prompts it
        completed, with ONE host sync; a streaming request's first token is
        synced at its link instead."""
        if self._inflight is not None:
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)
        dec = self.status == DECODE
        # _safe_horizon runs before the pending first tokens are injected
        budget = self._safe_horizon(self._burst_links, dec)
        gen = self.slot_gen.copy()
        sampled = self._sampled(dec)
        lslice = self._active_slice(dec, sampled)
        sampled_slots = [s for s in np.flatnonzero(dec) if self.slot_req[s].sampled]
        c, maxp, v = self.ecfg.prefill_chunk, self.ecfg.max_pages_per_seq, self.cfg.vocab_size
        npf_max = max(1, self.ecfg.mixed_prefill_rows)
        t0 = time.perf_counter()
        # the burst starts from the host's state: an admission since the last
        # chain (prefill_order is not empty) made it stale
        lk = self.links
        lk.load(lk.active, dec)
        lk.load(lk.tok, self.tokens)
        lk.load(lk.lens, self.seq_lens)
        torch.logical_not(lk.active, out=lk.done)
        self._slot_state_dev()
        pend = sorted(self._pending_first)
        for slot in pend:
            lk.inject(slot, self._pending_first[slot])
        self._pending_first.clear()
        lk.begin()
        # first tokens of prompts completed mid-burst ride the burst's sync
        first_col = torch.zeros(self.ecfg.max_batch_size, dtype=torch.int64, device=self.device)
        pf_slots: List[int] = []
        n_links = 0
        while self.prefill_order and n_links < budget:
            rows, oi = [], 0
            while len(rows) < npf_max and oi < len(self.prefill_order):
                slot = self.prefill_order[oi]
                req = self.slot_req[slot]
                start = int(self.prefill_pos[slot])
                n = min(c, len(req.prompt_ids) - start)
                rows.append((slot, req, start, n))
                self.prefill_pos[slot] = start + n
                if start + n >= len(req.prompt_ids):
                    oi += 1  # the next row serves the next queued prompt
            npf = 1
            while npf < len(rows):
                npf *= 2
            npf = min(npf, npf_max)
            ncp = max(_ctx_pages_bucket(self._pages_needed(r[2] + c), maxp) for r in rows)
            completes = [r[2] + r[3] >= len(r[1].prompt_ids) for r in rows]
            for s in sampled_slots:  # one draw per link the slot decodes in
                lk.noise[s].copy_(gumbel_noise((v,), self.slot_rng[s], self.device))
            logits = lk.mixed(self._pack_rows(rows, npf), ncp, c, lslice, sampled,
                              any(completes))
            n_links += 1
            self.mixed_links += 1
            self.mixed_rows += len(rows)
            self.prefill_chunks += len(rows)
            for ri, (slot, req, _, _) in enumerate(rows):
                if not completes[ri]:
                    continue
                assert self.prefill_order[0] == slot
                self.prefill_order.pop(0)
                first = sample_next(logits[ri], self._allow_dev[slot], self._first_sampling(slot))
                self.seq_lens[slot] = len(req.prompt_ids)
                self.status[slot] = DECODE
                if req.stream:
                    # a streaming consumer's first token does not wait for
                    # the burst's sync
                    ts = time.perf_counter()
                    tok = int(first)
                    self._acc("first_tok_sync", time.perf_counter() - ts)
                    self._record_first(slot, tok)
                else:
                    first_col[slot: slot + 1].copy_(first.reshape(1))
                    pf_slots.append(slot)
            self._try_admit()  # a completed prompt may free pages
            self._slot_state_dev()
        lk.append(first_col)
        handle = lk.fetch()
        self._acc("mixed_dispatch", time.perf_counter() - t0)
        full = np.where(dec, n_links, 0)
        for slot in pend:
            full[slot] += 1
        meta = {"dec": dec, "pend": pend, "n_steps": n_links, "gen": gen, "full_emit": full}
        t0 = time.perf_counter()
        toks = lk.wait(handle, n_links + 1)  # ONE sync for the burst
        self._acc("mixed_sync", time.perf_counter() - t0)
        self._absorb_chain(meta, toks[:, : n_links + 1])
        # the carried rows of slots that completed mid-burst are stale: the
        # host's state is the truth after the sync
        self._hot = False
        for slot in pf_slots:
            self._record_first(slot, int(toks[slot, n_links + 1]))
        return self._occupied()

    def _absorb_multi(self, dec: np.ndarray, toks: np.ndarray, n_emitted: np.ndarray,
                      pend_slots=(), hist_synced: bool = False) -> int:
        """Append each decoding slot's emitted tokens; finish on EOS, budget
        or page capacity; otherwise reclaim pages below the window.
        `hist_synced`: ngram rounds appended these tokens to the device
        history already."""
        if not hist_synced:
            self._hist_dirty = True
        cap = self.ecfg.max_pages_per_seq * self.ecfg.page_size
        for slot in np.flatnonzero(dec):
            n = int(n_emitted[slot])
            req = self.slot_req[slot]
            emitted = toks[slot, :n].tolist()
            if req.ttft_s is None and emitted:  # a deferred first token
                req.ttft_s = time.time() - req.t_submit
                self._ttfts.append(req.ttft_s)
            req.output_ids.extend(emitted)
            # a pending slot's column 0 was its chain input: the chain wrote
            # its KV, but it never counted in seq_lens (the kv-written
            # length), so the slot's kv grows by n - 1
            self.seq_lens[slot] += n - (1 if slot in pend_slots and n > 0 else 0)
            if emitted:
                self.tokens[slot] = emitted[-1]
            hit_eos = n > 0 and emitted[-1] == req.eos_id
            if (hit_eos or len(req.output_ids) >= req.max_new_tokens
                    or int(self.seq_lens[slot]) + 1 >= cap):
                del req.output_ids[req.max_new_tokens:]
                self._finish(slot)
            else:
                self._reclaim_window(slot)
        return self._occupied()

    def _can_spec(self) -> bool:
        """Speculate only when a draft (model or ngram) is configured,
        spec_k > 0, no admission or prefill is pending, and every decoding
        slot is greedy with room for a full K+1-token round (tails take plain
        steps)."""
        if ((self.draft_params is None and not self.ngram) or self.ecfg.spec_k < 1
                or self.waiting or self.prefill_order):
            return False
        dec = self.status == DECODE
        if not dec.any():
            return False
        k1 = self.ecfg.spec_k + 1
        ps = self.ecfg.page_size
        for slot in np.flatnonzero(dec):
            req = self.slot_req[slot]
            if req.sampled:
                return False  # greedy-only speculation
            if req.max_new_tokens - len(req.output_ids) < k1:
                return False
            if len(self.slot_pages[slot]) * ps - (int(self.seq_lens[slot]) + k1) < 0:
                return False
        return True

    def _spec_rounds_cap(self, dec: np.ndarray) -> int:
        """Full K+1-token rounds every decoding slot can run within its
        token budget and page allocation."""
        k1 = self.ecfg.spec_k + 1
        ps = self.ecfg.page_size
        cap = 1 << 30
        for slot in np.flatnonzero(dec):
            req = self.slot_req[slot]
            cap = min(cap, (req.max_new_tokens - len(req.output_ids)) // k1)
            cap = min(cap, (len(self.slot_pages[slot]) * ps - int(self.seq_lens[slot])) // k1)
        return max(cap, 0)

    def step_spec(self) -> int:
        """R speculative rounds with a draft model and ONE host sync.  Each
        round runs K+1 draft decode steps and one target verification over
        K+1 positions with acceptance on the device (`paged_draft_round`):
        the accepted count, the EOS freeze, the next input token and the
        lengths stay on the device, so rounds chain like a chain's links.
        The tokens are greedy decode's for any draft; tokens/s grows with the
        draft's agreement, since the target runs once a round."""
        if self._inflight is not None:  # absorb any run-ahead chain first
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)
        self._flush_pending()  # rounds read self.tokens (a no-op: drafts never defer)
        k = self.ecfg.spec_k
        dec = self.status == DECODE
        rounds = min(self._spec_rounds_cap(dec), max(1, self.decode_horizon // (k + 1)),
                     1 << min(self._chain_streak, 5))
        self._chain_streak += 1
        if rounds < 1:
            return self.step()
        return self._spec_rounds("draft", rounds, dec)

    def _ensure_hist(self) -> None:
        """The device token history [B, S] of ngram proposals, rebuilt from
        host state (prompt + output ids of each decoding slot) when stale:
        one upload per transition into ngram rounds; consecutive rounds
        append to it on the device."""
        if not self._hist_dirty:
            return
        lk = self.links
        hist = np.zeros(tuple(lk.hist.shape), np.int64)
        s = hist.shape[1]
        for slot in np.flatnonzero(self.status == DECODE):
            req = self.slot_req[slot]
            row = (req.prompt_ids + req.output_ids)[:s]
            hist[slot, : len(row)] = row
        lk.load(lk.hist, hist)
        self._hist_dirty = False

    def step_spec_ngram(self) -> int:
        """R draft-free speculative rounds with ONE host sync: each round
        proposes spec_k tokens by matching the current suffix against the
        sequence's own history on the device (`ngram_propose`), verifies and
        accepts them, and appends what it emitted to the history
        (`paged_ngram_round`).  No draft model or pool; lookup accepts most
        where the stream repeats, as the 50 Hz unit streams of stage C do."""
        if self._inflight is not None:  # absorb any run-ahead chain first
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)
        self._flush_pending()  # the history and lengths start from the host's tokens
        k = self.ecfg.spec_k
        dec = self.status == DECODE
        # a round runs the target alone (no K+1 draft links): the rounds per
        # sync ramp as step_chain's links do
        rounds = min(self._spec_rounds_cap(dec), max(1, self.decode_horizon),
                     2 << min(self._chain_streak, 5))
        self._chain_streak += 1
        if rounds < 1:
            return self.step()
        self._ensure_hist()
        return self._spec_rounds("ngram", rounds, dec)

    def _spec_rounds(self, kind: str, rounds: int, dec: np.ndarray) -> int:
        """Dispatch `rounds` rounds of `kind` from the host's state (each a
        graph replay on the card), sync their tokens once, absorb them."""
        t0 = time.perf_counter()
        k1 = self.ecfg.spec_k + 1
        lk = self.links
        lslice = self._active_slice(dec, False)
        lk.load(lk.active, dec)
        lk.load(lk.tok, self.tokens)
        lk.load(lk.lens, self.seq_lens)
        torch.logical_not(lk.active, out=lk.done)
        self._slot_state_dev()
        lk.begin_rounds()
        for _ in range(rounds):
            lk.round(kind, lslice)
        handle = lk.fetch(rounds=True)
        self._acc("spec_dispatch", time.perf_counter() - t0)
        t0 = time.perf_counter()
        rows = lk.wait_rounds(handle, rounds)  # ONE sync: [B, R, K + 2]
        self._acc("spec_sync", time.perf_counter() - t0)
        self.steps += rounds
        self.spec_rounds += rounds
        b = self.ecfg.max_batch_size
        flat = np.zeros((b, rounds * k1), np.int64)
        total = np.zeros(b, np.int64)
        for slot in np.flatnonzero(dec):
            for r in range(rounds):
                n = int(rows[slot, r, k1])
                flat[slot, total[slot]: total[slot] + n] = rows[slot, r, :n]
                total[slot] += n
            self.spec_emitted += int(total[slot])
        self._hot = False  # the links' tok/lens/done hold the rounds' state
        t0 = time.perf_counter()
        try:
            return self._absorb_multi(dec, flat, total, hist_synced=kind == "ngram")
        finally:
            self._acc("absorb", time.perf_counter() - t0)

    def tick(self) -> int:
        """One scheduler turn: while prompts are pending, a mixed burst when
        `ecfg.mixed_prefill`, no draft model is loaded and at least
        `mixed_min_decode` slots decode on one device, else drain up to
        prefill_chunks_per_tick chunks (then one per-token step unless the
        queue just drained); otherwise speculative rounds when a draft is
        configured and every decoding slot can take them, one per-token step
        when a draft model is loaded but cannot (the step mirrors into its
        pool), or one per-token step (decode_horizon 1), one decode chain or
        one fused multi-step decode."""
        if self.waiting and self._inflight is not None:
            # the pending sync may free slots and pages (EOS or budget ends),
            # which admission below can only see after it
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)
        if self.waiting or self.prefill_order:
            if self.waiting:
                # new arrivals end the quiet state a deferral was granted in
                # (EngineServer hands them over between ticks, so the gate
                # could not see them): learn the deferred first tokens now
                # instead of behind the newcomers' prefill chunks
                self._flush_pending()
            self._try_admit()
            if (self.prefill_order and self.ecfg.mixed_prefill and self.draft_params is None
                    and self.mesh is None
                    and int((self.status == DECODE).sum()) >= max(1, self.ecfg.mixed_min_decode)):
                return self.step_mixed_burst()
            if self.prefill_order:
                t0 = time.perf_counter()
                deferred = False
                for _ in range(self.ecfg.prefill_chunks_per_tick - 1):
                    done_slot = self._prefill_tick()
                    self._try_admit()
                    if (done_slot is not None and not self.prefill_order
                            and not self.waiting and self._multi_next()):
                        deferred = True  # the queue drained: the next tick runs a chain
                        break
                    if not self.prefill_order:
                        break
                self._acc("prefill", time.perf_counter() - t0)
                if deferred:
                    return self._occupied()
                return self.step(_defer_chain=True)
        if self._can_spec():
            return self.step_spec_ngram() if self.ngram else self.step_spec()
        if self.draft_params is not None:
            # a draft is loaded but cannot speculate (a sampled slot, a budget
            # tail): single-step, so the draft's pool mirrors the decode; a
            # chain would leave holes in it that collapse later acceptance
            return self.step()
        if self.decode_horizon == 1:
            return self.step()
        if self.multi_impl == "chain":
            return self.step_chain(self.decode_horizon)
        return self.step_multi(self.decode_horizon)

    def drain_inflight(self) -> None:
        """Sync and absorb the run-ahead chain, if any.  The last request of
        a burst can finish at the in-flight chain's sync with the successor
        still dispatched: its tokens are frozen or trash-routed, but until it
        is absorbed `steps` and `perf_s` undercount.  run() and an idle
        EngineServer call this."""
        if self._inflight is not None:
            fl, self._inflight = self._inflight, None
            self._sync_chain(fl)

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.busy:
            self.tick()
        self.drain_inflight()
        return requests

    def stats(self) -> dict:
        """Serving telemetry.  `steps`: decode links, speculative rounds and
        mixed links; `mixed_links`: mixed prefill + decode links (eager),
        carrying `mixed_rows` prefill chunk rows between them;
        `spec_rounds`: speculative rounds, which emitted `spec_emitted`
        tokens (`spec_accept_per_round` a round); `graph_replays`: decode
        links and rounds run as CUDA-graph replays (on the card every one:
        steps - mixed_links, on one device); `eager_links`: decode links and
        rounds run eagerly (on the CPU, with eager_links, and under TP:
        steps - mixed_links); `tp`: under TP the group's size, this rank,
        and the all-reduces and vocab gathers the bodies ran over it (each
        decode link or prefill chunk 2 a layer and 1; a draft round adds
        its K+1 draft steps'); `runahead_chains`: chains dispatched before
        their predecessor's sync; `graphs_captured`: CUDA graphs captured
        so far (a capture runs its link eagerly first); `perf_s`: wall
        seconds by scheduler phase (admit, prefill, chain/multi/step/mixed/
        spec dispatch and sync, absorb, first_tok_sync)."""
        return {
            "steps": self.steps,
            "mixed_links": self.mixed_links,
            "mixed_rows": self.mixed_rows,
            "prefill_chunks": self.prefill_chunks,
            "total_emitted": self.total_emitted,
            "total_finished": self.total_finished,
            "total_cancelled": self.total_cancelled,
            "active_slots": int(((self.status == PREFILL) | (self.status == DECODE)).sum()),
            "held_sessions": len(self.session_slots),
            "waiting": len(self.waiting),
            "free_pages": len(self.free_pages),
            "spec_rounds": self.spec_rounds,
            "spec_emitted": self.spec_emitted,
            "spec_accept_per_round": (round(self.spec_emitted / self.spec_rounds, 3)
                                      if self.spec_rounds else None),
            "graph_replays": self.links.replays,
            "eager_links": self.links.eager,
            "graphs_captured": self.links.captured,
            "tp": None if self.mesh is None else {
                "size": self.mesh.size, "rank": self.mesh.rank,
                "all_reduces": self.mesh.all_reduces, "gathers": self.mesh.gathers},
            "runahead_chains": self.runahead_chains,
            "perf_s": {k: round(v, 4) for k, v in sorted(self.perf.items())},
        }
