"""Closed-loop dialog serving: N conversations, each sending its next turn
as soon as the last one is answered, through the port's EngineServer and
PagedDialogPolicy (the three stages of a turn share one engine session).

Set-up makes the seed's weights on the card, quantizes them as the
configuration says (the program's own quantizer), builds the engine, runs
one conversation alone at short budgets to capture each stage's decode
link, then starts the measured conversations and lets them run for the
mix's lead-in, so that the window opens on a loop already running, its
conversations drifted apart from their common start.  The window then
runs for `seconds`; a stage still running when it closes is cancelled at
its next delivery (the policy's abort hook), so the run waits only for
first tokens.  Every stage request's submission, first token and
deliveries are stamped on the host clock."""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.lib import weights as W
from benchmark.lib.registry import generator


class StageRec:
    __slots__ = ("conv", "rnd", "stage", "t_submit", "t_first", "arrivals", "prompt", "output",
                 "finished", "error", "prev")

    def __init__(self, conv, rnd, stage, prev):
        self.conv, self.rnd, self.stage = conv, rnd, stage
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.arrivals: List[tuple] = []
        self.prompt: List[int] = []
        self.output: List[int] = []
        self.finished = False
        self.error: Optional[str] = None
        self.prev = prev  # the session's previous prompt + output (its cached prefix)


def _lm_config(cfg: dict):
    from usdm_tpu_torch.core.config import MistralConfig

    return MistralConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                         intermediate_size=cfg["intermediate_size"],
                         num_layers=cfg["num_hidden_layers"],
                         num_heads=cfg["num_attention_heads"],
                         num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                         rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
                         sliding_window=cfg["sliding_window"],
                         max_seq_len=cfg["max_position_embeddings"], dtype="bfloat16")


def tokenizer(cfg: dict):
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer

    spec = cfg["tokenizer"]
    if spec["kind"] == "synthetic_full":
        return UsdmTokenizer.build_synthetic_full(spec["base_vocab_size"], spec["num_units"])
    return UsdmTokenizer.build_test(num_units=spec["num_units"])


def build_server(cfg: dict, mix: dict, seed: int, device):
    """The program under test: the engine over the seed's weights, W8A8 as
    configured, on its serving thread."""
    import torch
    from usdm_tpu_torch.core.config import EngineConfig
    from usdm_tpu_torch.engine.paged import PagedEngine
    from usdm_tpu_torch.engine.server import EngineServer
    from usdm_tpu_torch.models.quant import quantize_llm_params

    params = W.make_params(cfg, seed, device, torch.bfloat16)
    if cfg["weights"] == "w8a8":
        quantize_llm_params(params)
    ecfg = EngineConfig(**mix["engine"], kv_dtype=cfg["kv_dtype"])
    return EngineServer(PagedEngine(params, _lm_config(cfg), ecfg, device=device))


class _Recorder:
    """The policy's view of the server: records each stage's prompt ids as
    the policy submits it."""

    def __init__(self, server, policy):
        self._s, self._p = server, policy

    def __getattr__(self, k):
        return getattr(self._s, k)

    def generate_stream(self, prompt_ids, *a, **kw):
        self._p.cur.prompt = list(prompt_ids)
        return self._s.generate_stream(prompt_ids, *a, **kw)


def _policy_class():
    from usdm_tpu_torch.engine.server import PagedDialogPolicy

    class BenchPolicy(PagedDialogPolicy):
        """PagedDialogPolicy with the turn's budgets pinned per stage (as
        chip_smoke.py's BudgetedPolicy pins them) and every stage stamped."""

        def __init__(self, server, tok, budgets, deadline, log, conv, rnd, seed):
            super().__init__(_Recorder(server, self), tok, seed=seed, on_tokens=self._on,
                             abort_check=self._abort)
            self.budgets, self.deadline, self.log = budgets, deadline, log
            self.conv, self.rnd, self.cur = conv, rnd, None

        def _run_stage(self, stage, prompt):
            from usdm_tpu_torch.engine.server import DialogAborted

            self.max_new_tokens = self.budgets[stage]
            prev = None if self.cur is None else self.cur.prompt + self.cur.output
            self.cur = rec = StageRec(self.conv, self.rnd, stage, prev)
            self.log.append(rec)
            try:
                import torch

                with torch.profiler.record_function(f"bench.stage.{stage}"):
                    rec.output = super()._run_stage(stage, prompt)
            except DialogAborted:
                raise
            except Exception as e:  # counted as a failed request
                rec.error = f"{type(e).__name__}: {e}"
                raise
            rec.finished = True
            return rec.output

        def _on(self, stage, new):
            now = time.perf_counter()
            if self.cur.t_first is None:
                self.cur.t_first = now
            self.cur.arrivals.append((now, len(new)))
            self.cur.output = self.cur.output + list(new)

        def _abort(self):
            return time.perf_counter() >= self.deadline

    return BenchPolicy


def start_loop(server, tok, mix, seed, deadline, log, rounds=None, cap=None):
    """Start the conversations, which run until `deadline` (or `rounds`
    turns each) -> (their threads, the list their errors go to)."""
    from usdm_tpu_torch.engine.server import DialogAborted

    gen = generator(mix["generator"])
    Policy = _policy_class()
    errors: List[str] = []

    def conversation(c):
        rnd = 0
        while time.perf_counter() < deadline and (rounds is None or rnd < rounds):
            t = gen.turn(mix, seed, c, rnd)
            budgets = {s: min(b, cap) if cap else b for s, b in t["budgets"].items()}
            pol = Policy(server, tok, budgets, deadline, log, c, rnd, seed=(seed + c) % (1 << 31))
            try:
                pol.respond_to_units(t["units"])
            except DialogAborted:
                return
            except Exception as e:
                errors.append(f"conversation {c}: {type(e).__name__}: {e}")
                return
            rnd += 1

    threads = [threading.Thread(target=conversation, args=(c,), daemon=True)
               for c in range(mix["conversations"])]
    for th in threads:
        th.start()
    return threads, errors


def join_loop(threads, errors, deadline) -> List[str]:
    for th in threads:
        th.join(timeout=max(deadline - time.perf_counter(), 0) + 180)
    if any(th.is_alive() for th in threads):
        errors.append("a conversation did not end within 180 s of the window's close")
    return errors


def closed_loop(server, tok, mix, seed, deadline, log, rounds=None, cap=None) -> List[str]:
    """Run the conversations to their end -> the errors of those that failed."""
    threads, errors = start_loop(server, tok, mix, seed, deadline, log, rounds, cap)
    return join_loop(threads, errors, deadline)


class EngineMarks:
    """Hooks the engine's tick, on the engine's own thread (the one that
    launches the card's work and captures its graphs): reads its counters
    at the first tick at or after each time of `at` (name -> time), and
    with `trace_at` runs the profiler from the first tick at or after that
    time for `trace_s` seconds, or up to `trace_by` if that comes first,
    started and stopped between two ticks, with the counters read at both
    of its ends ("trace0", "trace1")."""

    def __init__(self, engine, at: Dict[str, float], trace_at: Optional[float] = None,
                 trace_s: float = 0.0, trace_by: float = float("inf")):
        self.stats: Dict[str, dict] = {}
        self.win, self._at, self._stopped = None, at, threading.Event()
        if trace_at is not None:
            from benchmark.lib.trace import Window

            self.win = Window(host_ops=False)
        self._engine, self._tick = engine, engine.tick

        def tick():
            now = time.perf_counter()
            for name, t in at.items():
                if name not in self.stats and now >= t:
                    self.stats[name] = engine.stats()
            if self.win is not None and "trace0" not in self.stats and now >= trace_at:
                self.stats["trace0"] = engine.stats()
                self.win.start()
            self._tick()
            if "trace0" in self.stats and "trace1" not in self.stats and \
                    time.perf_counter() >= min(self.win.t0 + trace_s, trace_by):
                self.win.stop()
                self.stats["trace1"] = engine.stats()
                self._stopped.set()

        engine.tick = tick

    def close(self) -> Optional[dict]:
        """Once the conversations have ended -> the reduced trace, or None
        if no profiler window opened or the engine's thread did not close
        it (the profiler stops only on the thread that started it).  A
        mark the engine never ticked past is read now."""
        del self._engine.tick  # the class's own tick again
        for name in self._at:
            if name not in self.stats:
                self.stats[name] = self._engine.stats()
        if "trace0" not in self.stats or not self._stopped.wait(timeout=60):
            return None
        return self.win.reduce()


def warm_profiler(engine) -> None:
    """Start and stop the profiler once on the engine's thread, at its next
    tick: the first use in a process sets up the card's tracing, which can
    take seconds and would otherwise stall the traced slice."""
    from benchmark.lib.trace import Window

    def once():
        del engine.tick  # the class's own tick again
        w = Window(host_ops=False)
        w.start()
        w.stop()
        return engine.tick()

    engine.tick = once


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        fault: Optional[str] = None, control: bool = False) -> dict:
    """One run of the cell; `fault` plants a fault (the benchmark's own
    test), `control` also reads the int4 control on the checked sample
    (benchmark/calibrate.py)."""
    import torch

    cfg, mix = cell["config"], cell["traffic"]
    tok = tokenizer(cfg)
    server = build_server(cfg, mix, seed, device)
    if fault == "token":
        _plant_token_fault(server.engine)
    traced = trace and device.type == "cuda"
    if traced:
        warm_profiler(server.engine)
    # warm-up: one conversation alone at short budgets (another seed), so
    # each stage's own lm_head slice decodes and its link is captured
    warm: List[StageRec] = []
    errs = closed_loop(server, tok, dict(mix, conversations=1), seed + 2,
                       time.perf_counter() + 600, warm, rounds=mix["warmup"]["solo_rounds"],
                       cap=mix["warmup"]["budget"])
    if errs:
        raise RuntimeError(f"warm-up failed: {errs[:3]}")
    # the measured conversations start now; the window opens on them after
    # the lead-in (set-up too), once rows of several stages share links and
    # that link is captured
    log: List[StageRec] = []
    w0 = time.perf_counter() + mix["warmup"]["lead_in_s"]
    deadline = w0 + seconds
    trace_at = w0 + seconds * mix["trace"]["start_share"]
    marks = EngineMarks(server.engine, {"open": w0, "close": deadline},
                        trace_at if traced else None, mix["trace"]["seconds"], deadline)
    threads, errs = start_loop(server, tok, mix, seed, deadline, log)
    time.sleep(max(w0 - time.perf_counter(), 0.0))
    setup_s = w0 - t0
    errs = join_loop(threads, errs, deadline)
    w1 = time.perf_counter()
    tr = marks.close()
    st = marks.stats
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    server.close()
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    in_window = [r for r in log if w0 <= r.t_submit < deadline]
    failed = sum(1 for r in in_window if r.error is not None or r.t_first is None)
    # the part of the window the profiler leaves alone: all of it untraced,
    # up to the profiler's start when traced (stopping it stalls the engine)
    calm = (w0, deadline if tr is None else marks.win.t0)
    rec = {"kind": "dialog", "config": cfg, "traffic": mix, "window": (w0, deadline),
           "seconds": seconds, "requests": log, "calm": calm,
           "calm_stats": (st["open"], st["close"] if tr is None else st["trace0"]),
           "setup_s": setup_s, "trace": tr,
           "trace_window": None if tr is None else (marks.win.t0, marks.win.t1),
           "trace_stats": None if tr is None else (st["trace0"], st["trace1"]), "tok": tok}
    checks = check(cfg, mix, seed, in_window, tok, device, control)
    notes_worst = getattr(check, "worst", None)
    return {"rec": rec, "attempted": len(in_window), "failed": failed + len(errs),
            "errors": errs, "memory_peak_bytes": peak, "checks": checks,
            "notes": [f"stage requests submitted in the window: {len(in_window)} "
                      f"(first tokens: {sum(r.t_first is not None for r in in_window)}), "
                      f"window closed after {w1 - w0:.3f} s with the drain",
                      f"CUDA graphs captured in the window: "
                      f"{st['close']['graphs_captured'] - st['open']['graphs_captured']} "
                      f"(after set-up: {st['open']['graphs_captured']})",
                      f"check: {notes_worst}"]}


def _plant_token_fault(engine) -> None:
    """A fault for the benchmark's own test: every decode chain's first
    emitted token of each slot is replaced by its neighbour id."""
    orig = engine._absorb_multi

    def absorb(dec, toks, n_emitted, *a, **kw):
        toks = np.array(toks, copy=True)
        for slot in np.flatnonzero(dec):
            if int(n_emitted[slot]) > 0:
                toks[slot, 0] = toks[slot, 0] + 1 if toks[slot, 0] % 2 == 0 else toks[slot, 0] - 1
        return orig(dec, toks, n_emitted, *a, **kw)

    engine._absorb_multi = absorb


def sample(log: List[StageRec], mix: dict, seed: int) -> List[StageRec]:
    """The finished requests the check reads: the one that served the most
    tokens, and more drawn from the seed up to `check.requests`."""
    done = [r for r in log if r.finished and r.output]
    if not done:
        return []
    done.sort(key=lambda r: (r.conv, r.rnd, r.stage))
    longest = max(range(len(done)), key=lambda i: len(done[i].output))
    rng = np.random.default_rng([seed % (1 << 63), 99])
    rest = [i for i in rng.permutation(len(done)) if i != longest]
    pick = [longest] + rest[:mix["check"]["requests"] - 1]
    return [done[i] for i in pick]


def check(cfg: dict, mix: dict, seed: int, log: List[StageRec], tok, device,
          control: bool = False) -> Dict[str, dict]:
    """The served tokens of a sample of finished requests against the plain
    reference: the widest gap by which a served token's logit lies below
    the reference's best allowed logit."""
    import torch

    from benchmark.reference.mistral import control_gap, served_gap, serve_logits

    picked = sample(log, mix, seed)
    limit = mix["limits"]["served_logit_gap"]
    if not picked:
        return {"served_logit_gap": {"value": float("inf"), "limit": limit}}
    seqs = [r.prompt + r.output for r in picked]
    starts = [len(r.prompt) for r in picked]
    logits = serve_logits(cfg, seed, seqs, starts, device)
    gap, where = 0.0, None
    for r, lg in zip(picked, logits):
        allow = torch.from_numpy(allow_mask(r.stage, tok.ts)).to(lg.device)
        g = served_gap(lg, r.output, allow)
        if g >= gap:
            gap, where = g, (r.stage, len(r.prompt), len(r.output))
    check.worst = {"stage, prompt, served": where,
                   "served tokens checked": sum(len(r.output) for r in picked)}
    if control:
        low = serve_logits(cfg, seed, seqs, starts, device, weight_bits=4)
        check.worst["control_gap"] = max(
            control_gap(ref, lo, torch.from_numpy(allow_mask(r.stage, tok.ts)).to(ref.device))
            for r, ref, lo in zip(picked, logits, low))
    return {"served_logit_gap": {"value": gap, "limit": limit}}


def allow_mask(stage: str, ts) -> np.ndarray:
    """The ids a stage may emit, from the token space's numbers (USDM's
    generation constraints): unit->text and text->text the base vocabulary
    (text->text also <|continue|> and <|correspond|>, its end), text->unit
    the units, <pad> and the bare space that ends it."""
    base = ts.base_vocab_size
    m = np.zeros(ts.vocab_size, bool)
    if stage == "unit2text":
        m[:base] = True
    elif stage == "text2text":
        m[:base + 2] = True
    else:
        m[base + 2:] = True
        m[ts.space_id] = True
    return m
