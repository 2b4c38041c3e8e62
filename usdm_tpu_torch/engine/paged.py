"""Paged-KV continuous-batching engine: the host-side scheduler.

Port of the part of usdm_tpu/engine/paged.py that respond() runs:
admission with best-fit page allocation, session prefix reuse (a finished
request of a session HOLDs its pages; the session's next request prefills
only from its page-aligned common prefix), chunked prefill, greedy or
sampled decode as CHAINS of device-side steps with one host sync per chain
(`step_chain`: N asynchronous launches, then one `.tolist()`), sliding-window
page reclaim, and request cancellation.

The params may hold W8A8 projections (models/quant.py) and the KV pool may
be int8 (`EngineConfig.kv_dtype="int8"`).  Not ported, because each
changes scheduling but not tokens: depth-1 chain run-ahead, first-token
deferral, mixed prefill+decode bursts, `step_multi`.  Not ported and
refused: speculative decoding (a draft or "ngram"), tensor-parallel serving.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.engine.paged_ops import (
    PagedKV,
    paged_decode_step,
    paged_decode_step_chained,
    paged_prefill_chunk,
    sample_next,
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
    """Continuous-batching engine over the paged KV pool, on one device."""

    def __init__(self, params: M.Params, cfg: MistralConfig, ecfg: EngineConfig,
                 device=None, mesh=None, draft=None):
        if draft is not None:
            raise NotImplementedError("speculative decoding is not ported to usdm_tpu_torch")
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving is not ported to usdm_tpu_torch")
        if ecfg.kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {ecfg.kv_dtype!r}")
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = torch.device(device) if device is not None else params["embed"].device
        ps = ecfg.page_size
        # +1: the last page is the trash target of inactive slots
        n_pages = (ecfg.n_pages or ecfg.max_batch_size * ecfg.max_pages_per_seq) + 1
        self.n_pages = n_pages
        self.kv = PagedKV.create(cfg, n_pages, ps, self.device, ecfg.kv_dtype)
        self.free_pages: List[int] = list(range(n_pages - 1))
        b = ecfg.max_batch_size
        self.page_table = np.zeros((b, ecfg.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros(b, np.int32)
        self.tokens = np.zeros(b, np.int64)
        self.status = np.zeros(b, np.int32)
        self.eos = np.zeros(b, np.int64)
        # per-slot vocab masks live on the device, rewritten only on admission
        self._allow_dev = torch.ones((b, cfg.vocab_size), dtype=torch.bool, device=self.device)
        self._mask_cache: dict = {}
        self._table_dev: Optional[torch.Tensor] = None  # None = re-upload
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_slice: List[Optional[tuple]] = [None] * b
        self.slot_pages: List[List[int]] = [[] for _ in range(b)]
        self.slot_gen: List[Optional[torch.Generator]] = [None] * b  # sampled slots
        self.released = np.zeros(b, np.int32)  # leading pages reclaimed by the window
        self.prefill_pos = np.zeros(b, np.int32)
        self.prefill_order: List[int] = []
        self.waiting: List[Request] = []
        self.session_slots: dict = {}
        self.slot_history: List[List[int]] = [[] for _ in range(b)]
        self._hold_order: List[int] = []
        self.decode_horizon = ecfg.decode_horizon
        self._chain_streak = 0
        self.steps = 0
        self.prefill_chunks = 0
        self.total_emitted = 0
        self.total_finished = 0
        self.total_cancelled = 0
        self._ttfts: Deque[float] = deque(maxlen=200)  # recent times to first token

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
        row = np.full(self.ecfg.max_pages_per_seq, self.n_pages - 1, np.int32)
        row[: len(self.slot_pages[slot])] = self.slot_pages[slot]
        row[: int(self.released[slot])] = self.n_pages - 1
        self.page_table[slot] = row
        self._table_dev = None
        self.slot_req[slot] = req
        self.slot_history[slot] = []
        self.status[slot] = PREFILL
        self._chain_streak = 0
        self.prefill_pos[slot] = start
        self.prefill_order.append(slot)
        self.eos[slot] = req.eos_id
        self.slot_slice[slot] = _mask_slice(req.allow_mask)
        self.slot_gen[slot] = None
        if req.sampled:
            self.slot_gen[slot] = torch.Generator(device=self.device).manual_seed(req.seed)
        key = req.allow_mask.tobytes()
        mask_dev = self._mask_cache.get(key)
        if mask_dev is None:
            mask_dev = torch.as_tensor(np.asarray(req.allow_mask, bool), device=self.device)
            if len(self._mask_cache) < 16:
                self._mask_cache[key] = mask_dev
        self._allow_dev[slot] = mask_dev

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

    def _sampling_for(self, slots) -> Optional[tuple]:
        """Per-row sampling state of a decode launch, or None when every
        listed slot is greedy (the sliced greedy tail then applies)."""
        reqs = [self.slot_req[s] if s is not None else None for s in slots]
        if not any(r is not None and r.sampled for r in reqs):
            return None
        v = self.cfg.vocab_size
        noise = torch.zeros((len(reqs), v), device=self.device)
        for i, (s, r) in enumerate(zip(slots, reqs)):
            if r is not None and r.sampled:
                noise[i] = gumbel_noise((v,), self.slot_gen[s], self.device)
        as_t = lambda vals, dt: torch.tensor(vals, dtype=dt, device=self.device)  # noqa: E731
        return (noise,
                as_t([r.top_k if r else 1 for r in reqs], torch.int64),
                as_t([r.top_p if r else 1.0 for r in reqs], torch.float32),
                as_t([r.temperature if r else 1.0 for r in reqs], torch.float32))

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
        ids = np.zeros(c, np.int64)
        ids[:n] = req.prompt_ids[start: start + n]
        logits = paged_prefill_chunk(self.params, self.kv, self.cfg,
                                     torch.from_numpy(ids).to(self.device), start, n,
                                     self.page_table[slot], self.ecfg.page_size, ncp)
        self.prefill_pos[slot] = start + n
        if start + n < len(req.prompt_ids):
            return None
        self.prefill_order.pop(0)
        sampling = self._sampling_for([slot])
        first = int(sample_next(logits, self._allow_dev[slot], sampling))
        self.seq_lens[slot] = len(req.prompt_ids)
        self.status[slot] = DECODE
        req.ttft_s = time.time() - req.t_submit
        self._ttfts.append(req.ttft_s)
        req.output_ids.append(first)
        self.tokens[slot] = first
        if first == req.eos_id or len(req.output_ids) >= req.max_new_tokens:
            self._finish(slot)
        return slot

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        self._chain_streak = 0
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
        prefix advertised.  Runs on the thread that ticks the engine."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                self.waiting.pop(i)
                r.cancelled = r.finished = True
                self.total_cancelled += 1
                return True
        for slot, r in enumerate(self.slot_req):
            if r is None or r.req_id != req_id or r.finished:
                continue
            r.cancelled = True
            if self.status[slot] == PREFILL:
                if slot in self.prefill_order:
                    self.prefill_order.remove(slot)
                self.seq_lens[slot] = int(self.prefill_pos[slot])
            self._finish(slot)
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
            self._table_dev = None
            r += 1
        self.released[slot] = r

    def _active_slice(self, dec: np.ndarray, sampling) -> Optional[tuple]:
        """The lm_head slice shared by every decoding slot; None when any row
        samples (the slice is a greedy-only tail)."""
        if sampling is not None:
            return None
        slices = {self.slot_slice[i] for i in np.flatnonzero(dec)}
        return slices.pop() if len(slices) == 1 else None

    def _table(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self.page_table.copy()).to(self.device)
        return self._table_dev

    # ------------------------------------------------------------------ run
    def step(self, _defer_chain: bool = False) -> int:
        """Admit + one prefill chunk + one decode step (one host sync).
        `_defer_chain` (tick only): when this step's chunk drained the
        queue, leave decode to the next tick's chain."""
        self._try_admit()
        done_slot = self._prefill_tick()
        dec = self.status == DECODE
        if not dec.any():
            return self._occupied()
        if (_defer_chain and done_slot is not None and not self.prefill_order
                and not self.waiting and self.decode_horizon > 1):
            return self._occupied()
        b = self.ecfg.max_batch_size
        sampling = self._sampling_for([s if dec[s] else None for s in range(b)])
        dev = self.device
        nxt = paged_decode_step(
            self.params, self.kv, self.cfg, torch.from_numpy(self.tokens).to(dev),
            torch.from_numpy(self.seq_lens).to(dev), self._table(),
            torch.from_numpy(dec).to(dev), self._allow_dev, self.ecfg.page_size,
            logits_slice=self._active_slice(dec, sampling), sampling=sampling,
        ).tolist()  # the step's one host sync
        self.steps += 1
        toks = np.asarray(nxt, np.int64)[:, None]
        return self._absorb(dec, toks, np.where(dec, 1, 0))

    def _safe_horizon(self, n_steps: int, dec: np.ndarray) -> int:
        """Clamp a chain so no slot decodes past its token budget or its page
        allocation."""
        n = n_steps
        ps = self.ecfg.page_size
        for slot in np.flatnonzero(dec):
            req = self.slot_req[slot]
            n = min(n, req.max_new_tokens - len(req.output_ids))
            n = min(n, len(self.slot_pages[slot]) * ps - (int(self.seq_lens[slot]) + 1))
        return max(n, 1)

    def step_chain(self, n_steps: int) -> int:
        """Multi-token decode: n_steps chained single-step launches with ONE
        host sync at the end.  Chains ramp 8 -> 16 -> ... up to n_steps
        while the decoding set is unchanged, so an early EOS wastes at most
        the current short chain's tail."""
        self._try_admit()
        self._prefill_tick()
        n_steps = min(n_steps, 8 << min(self._chain_streak, 8))
        self._chain_streak += 1
        if self.waiting:
            n_steps = min(n_steps, 8)
        dec = self.status == DECODE
        if not dec.any():
            return self._occupied()
        n_steps = self._safe_horizon(n_steps, dec)
        b = self.ecfg.max_batch_size
        dev = self.device
        tok = torch.from_numpy(self.tokens).to(dev)
        lens = torch.from_numpy(self.seq_lens).to(dev)
        active = torch.from_numpy(dec).to(dev)
        done = ~active
        eos = torch.from_numpy(self.eos).to(dev)
        table = self._table()
        slots = [s if dec[s] else None for s in range(b)]
        outs = []
        for _ in range(n_steps):
            sampling = self._sampling_for(slots)  # fresh noise every link
            tok, done, lens = paged_decode_step_chained(
                self.params, self.kv, self.cfg, tok, lens, table, active, done, eos,
                self._allow_dev, self.ecfg.page_size,
                logits_slice=self._active_slice(dec, sampling), sampling=sampling)
            outs.append(tok)
        toks = np.asarray(torch.stack(outs, dim=1).tolist(), np.int64)  # ONE host sync
        self.steps += n_steps
        is_eos = toks == self.eos[:, None]
        n_emitted = np.where(dec, np.where(is_eos.any(axis=1), is_eos.argmax(axis=1) + 1,
                                           n_steps), 0)
        return self._absorb(dec, toks, n_emitted)

    def _absorb(self, dec: np.ndarray, toks: np.ndarray, n_emitted: np.ndarray) -> int:
        """Append each decoding slot's emitted tokens; finish on EOS, budget
        or page capacity; otherwise reclaim pages below the window."""
        cap = self.ecfg.max_pages_per_seq * self.ecfg.page_size
        for slot in np.flatnonzero(dec):
            n = int(n_emitted[slot])
            req = self.slot_req[slot]
            emitted = toks[slot, :n].tolist()
            req.output_ids.extend(emitted)
            self.seq_lens[slot] += n
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

    def tick(self) -> int:
        """One scheduler turn: while prompts are pending, drain up to
        prefill_chunks_per_tick chunks (then one per-token step unless the
        queue just drained); otherwise one decode chain."""
        if self.waiting or self.prefill_order:
            self._try_admit()
            if self.prefill_order:
                for _ in range(self.ecfg.prefill_chunks_per_tick - 1):
                    done_slot = self._prefill_tick()
                    self._try_admit()
                    if (done_slot is not None and not self.prefill_order
                            and not self.waiting and self.decode_horizon > 1):
                        # the queue drained: the next tick runs a chain
                        return self._occupied()
                    if not self.prefill_order:
                        break
                return self.step(_defer_chain=True)
        if self.decode_horizon == 1:
            return self.step()
        return self.step_chain(self.decode_horizon)

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.busy:
            self.tick()
        return requests

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "prefill_chunks": self.prefill_chunks,
            "total_emitted": self.total_emitted,
            "total_finished": self.total_finished,
            "total_cancelled": self.total_cancelled,
            "active_slots": int(((self.status == PREFILL) | (self.status == DECODE)).sum()),
            "held_sessions": len(self.session_slots),
            "waiting": len(self.waiting),
            "free_pages": len(self.free_pages),
        }
