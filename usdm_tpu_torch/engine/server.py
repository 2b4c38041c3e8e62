"""Serving front door: a background thread owns the PagedEngine loop.

Port of usdm_tpu/engine/server.py (`EngineServer.generate`,
`generate_stream`, `PagedDialogPolicy` with its streaming hooks).  Caller
threads submit requests and block until they finish, or read their tokens
as the engine's syncs deliver them; one loop thread ticks the engine outside
the lock and wakes every waiter after each tick.  A failure in a tick sets
`error` on every in-flight request, wakes every caller with it, and makes
later submissions fail fast.

Over a tensor-parallel engine (PagedEngine(mesh=), engine/tp.py) the
server runs on rank 0 and sends each loop turn's admissions, cancels and
session releases to the other ranks before it runs the turn
(`serve_turn`); they run the same turns (engine/tp.py follow) until
`close`.  When to tick, and the idle drain, are rank 0's decisions; while
idle it sends an empty turn every `idle_wait_s`, so no rank waits out its
group's timeout.
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine import tp as TP
from usdm_tpu_torch.engine.dialog import DialogResult, run_dialog
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.ops.sampling import stage_allow_mask, stage_eos


def serve_turn(engine: PagedEngine, inbox: List[Request], cancels: List[int],
               releases: List[int]) -> None:
    """One turn of the serving loop: admissions, then cancels before
    session releases (a cancelled session request goes to HOLD, and its
    dialog's release, queued right after the cancel (DialogAborted), must
    find it there), one tick while work is pending, and, once work has
    drained, the run-ahead chain absorbed (so telemetry is exact before the
    callers wake).  Every rank of a tensor-parallel engine runs the same
    turns."""
    for req in inbox:
        engine.submit(req)
    for rid in cancels:
        engine.cancel(rid)
    for s in releases:
        engine.release_session(s)
    if engine.busy:
        engine.tick()
    if not engine.busy:
        engine.drain_inflight()


class EngineServer:
    """Thread-safe front door to a PagedEngine (rank 0's, under TP)."""

    def __init__(self, engine: PagedEngine, idle_wait_s: float = 10.0):
        self.engine = engine
        self._cv = threading.Condition()
        self._events: Dict[int, threading.Event] = {}
        self._reqs: Dict[int, Request] = {}
        # submissions land here under the lock; only the loop thread touches
        # the engine, and it ticks outside the lock
        self._inbox: List[Request] = []
        self._releases: List[int] = []
        self._cancels: List[int] = []
        self._ids = itertools.count()
        self._session_ids = itertools.count(1)
        self._running = True
        self._idle_wait_s = idle_wait_s
        self._fatal: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name="paged-engine")
        self._thread.start()

    def generate(self, prompt_ids: List[int], allow_mask: np.ndarray, eos_id: int,
                 max_new_tokens: int, top_k: int = 1, top_p: float = 1.0,
                 temperature: float = 1.0, seed: int = 0, timeout: Optional[float] = None,
                 session: Optional[int] = None) -> List[int]:
        """Submit one generation; blocks until it finishes, returns tokens."""
        rid, req = self._submit(prompt_ids, allow_mask, eos_id, max_new_tokens, top_k, top_p,
                                temperature, seed, session)
        finished = self._events[rid].wait(timeout)
        if not finished:
            self.cancel(rid)  # stop decoding for a caller that gave up
        with self._cv:
            self._events.pop(rid, None)
            self._reqs.pop(rid, None)
        if not finished:
            raise TimeoutError(f"request {rid} timed out after {timeout}s")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.output_ids

    def generate_stream(self, prompt_ids: List[int], allow_mask: np.ndarray, eos_id: int,
                        max_new_tokens: int, top_k: int = 1, top_p: float = 1.0,
                        temperature: float = 1.0, seed: int = 0,
                        timeout: Optional[float] = None,
                        session: Optional[int] = None) -> Iterator[List[int]]:
        """Streaming `generate`: yields each batch of new token ids as the
        engine's syncs deliver them; the yields concatenated equal
        `generate()`'s tokens for the same arguments.  `timeout` bounds each
        wait for progress (on the monotonic clock), not the whole generation.
        Closing the generator early cancels the request on the engine: its
        slot and pages free at the loop's next turn."""
        rid, req = self._submit(prompt_ids, allow_mask, eos_id, max_new_tokens, top_k, top_p,
                                temperature, seed, session, stream=True)
        seen = 0
        try:
            while True:
                # the loop thread notifies after every tick, also when this
                # request made no progress: only new tokens restart the clock
                deadline = None if timeout is None else time.monotonic() + timeout
                with self._cv:
                    while len(req.output_ids) <= seen and not req.finished:
                        remaining = None if deadline is None else deadline - time.monotonic()
                        if remaining is not None and remaining <= 0:
                            raise TimeoutError(f"request {rid}: no progress in {timeout}s")
                        self._cv.wait(remaining)
                    # the loop ticks outside _cv and the engine appends a
                    # request's last tokens before it finishes it: read
                    # `finished` first, so a True read sees every token
                    done = req.finished
                    new = list(req.output_ids[seen:])
                seen += len(new)
                if new:
                    yield new
                if done:
                    break
            if req.error is not None:
                raise RuntimeError(req.error)
        finally:
            abandoned = not req.finished
            with self._cv:
                self._events.pop(rid, None)
                self._reqs.pop(rid, None)
            if abandoned:
                self.cancel(rid)

    def _submit(self, prompt_ids, allow_mask, eos_id, max_new_tokens, top_k, top_p,
                temperature, seed, session, stream: bool = False):
        """Queue one request for the loop thread -> (its id, the Request)."""
        rid = next(self._ids)
        req = Request(rid, list(prompt_ids), allow_mask, eos_id, max_new_tokens, top_k=top_k,
                      top_p=top_p, temperature=temperature, seed=seed, session=session,
                      stream=stream)
        req.t_submit = time.time()  # the TTFT clock starts at the caller's submit
        with self._cv:
            if not self._running:
                raise RuntimeError("EngineServer is closed")
            if self._fatal is not None:
                raise RuntimeError(f"EngineServer failed: {self._fatal!r}") from self._fatal
            self._events[rid] = threading.Event()
            self._reqs[rid] = req
            self._inbox.append(req)
            self._cv.notify_all()
        return rid, req

    def new_session(self) -> int:
        """Fresh id for a chain of prefix-sharing requests."""
        with self._cv:
            return next(self._session_ids)

    def release_session(self, session: int) -> None:
        with self._cv:
            self._releases.append(session)
            self._cv.notify_all()

    def cancel(self, rid: int) -> None:
        with self._cv:
            self._cancels.append(rid)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def __enter__(self) -> "EngineServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        mesh = self.engine.mesh
        try:
            self._serve(mesh)
        finally:
            if mesh is not None:
                TP.send(mesh, None)  # the other ranks' follow() returns

    def _serve(self, mesh) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return
                inbox, self._inbox = self._inbox, []
                releases, self._releases = self._releases, []
                cancels, self._cancels = self._cancels, []
                if not (inbox or releases or cancels or self.engine.busy):
                    # under TP an idle wait that times out sends an empty turn
                    if self._cv.wait(timeout=self._idle_wait_s) or mesh is None:
                        continue
            try:
                if mesh is not None:
                    TP.send(mesh, TP.turn_message(inbox, cancels, releases))
                serve_turn(self.engine, inbox, cancels, releases)
            except Exception as e:  # device failure: fail the requests, not the callers
                tb = traceback.format_exc()
                with self._cv:
                    self._fatal = e
                    for req in self._reqs.values():
                        if not req.finished:
                            req.error = f"engine failure: {type(e).__name__}: {e}\n{tb}"
                            req.finished = True
                    for ev in self._events.values():
                        ev.set()
                    self._cv.notify_all()
                return  # engine state is unknown; stop ticking
            with self._cv:
                for rid, req in list(self._reqs.items()):
                    if req.finished and rid in self._events:
                        self._events[rid].set()
                # wakes generate_stream callers too: a tick may have extended
                # output_ids without finishing anything
                self._cv.notify_all()


class DialogAborted(RuntimeError):
    """The caller went away mid-dialog (`abort_check` returned True); the
    stage's request was cancelled on the engine."""


class PagedDialogPolicy:
    """3-stage dialog driver over an EngineServer: one engine session across
    the three stages, so stages B and C prefill only their new suffix.

    `on_tokens(stage, new_ids)` is called as the engine delivers each
    stage's tokens, and `abort_check()` is polled between deliveries (True
    cancels the stage's request and raises DialogAborted); with either, the
    stages run through `generate_stream`, whose tokens are `generate`'s."""

    def __init__(self, server: EngineServer, tokenizer: UsdmTokenizer,
                 max_new_tokens: Optional[int] = None, top_k: int = 1, top_p: float = 1.0,
                 temperature: float = 1.0, seed: int = 0,
                 on_tokens: Optional[Callable[[str, List[int]], None]] = None,
                 abort_check: Optional[Callable[[], bool]] = None):
        self.server = server
        self.tok = tokenizer
        self.ts = tokenizer.ts
        self.max_new_tokens = max_new_tokens
        self.top_k = top_k
        self.top_p = top_p
        self.temperature = temperature
        self.seed = seed
        self.on_tokens = on_tokens
        self.abort_check = abort_check
        self._stage_idx = 0
        self._session: Optional[int] = None

    def _budget(self, n_prompt: int) -> int:
        ecfg = self.server.engine.ecfg
        cap = ecfg.max_pages_per_seq * ecfg.page_size
        budget = min(self.tok.model_max_length, cap) - n_prompt - 1
        if self.max_new_tokens is not None:
            budget = min(budget, self.max_new_tokens)
        return max(budget, 1)

    def _run_stage(self, stage: str, prompt: str) -> List[int]:
        ids = self.tok.encode(prompt)
        self._stage_idx += 1
        args = (ids, stage_allow_mask(stage, self.ts), stage_eos(stage, self.ts),
                self._budget(len(ids)))
        kwargs = dict(top_k=self.top_k, top_p=self.top_p, temperature=self.temperature,
                      # distinct deterministic stream per stage of this conversation
                      seed=self.seed * 1000003 + self._stage_idx, session=self._session)
        if self.on_tokens is None and self.abort_check is None:
            return self.server.generate(*args, **kwargs)
        out: List[int] = []
        for delta in self.server.generate_stream(*args, **kwargs):
            out.extend(delta)
            if self.on_tokens is not None:
                self.on_tokens(stage, delta)
            if self.abort_check is not None and self.abort_check():
                # leaving the loop closes the generator, which cancels the
                # request on the engine
                raise DialogAborted(f"caller gone during stage {stage}")
        return out

    def respond_to_units(self, user_units: List[int]) -> DialogResult:
        self._stage_idx = 0
        self._session = self.server.new_session()
        try:
            return run_dialog(self.tok, self._run_stage, user_units)
        finally:
            self.server.release_session(self._session)
            self._session = None
