"""Decode horizon x chain run-ahead sweep of b = 1 engine decode over the W8A8 7B, and run-ahead's EOS overshoot.

    python -m usdm_tpu_torch.scripts.bench_runahead          # the sweep, on the card
    python -m usdm_tpu_torch.scripts.bench_runahead --eos    # the EOS-overshoot check
    python -m usdm_tpu_torch.scripts.bench_runahead --device cpu --tiny

Port of scripts/bench_runahead.py.  A `PagedEngine` over the W8A8 7B
(random weights from seed 0, quantized as `from_pretrained(lm_int8=True)`
does) with EngineConfig(page_size=64, max_pages_per_seq=24,
max_batch_size=1, prefill_chunk=256), at decode horizons 8, 16, 32 and 64
with depth-1 chain run-ahead and at 32 without, decodes 256 new tokens
after a 1,219-token prompt, EOS masked out.  Each configuration first runs
one warm-up request of the same prompt length and budget (every CUDA graph
of the path captured there), then 3 timed requests, rep i's prompt
drawn from seed + 1 + i so that every configuration sees the same prompts;
each rep is the host's wall time around `engine.run`.  Every rep and the
median are printed.  Checks, each raising: no rep captures a CUDA graph
(the engine's `graphs_captured` before and after it), every rep emits its
budget, and every configuration gives the first configuration's tokens
(run-ahead and the horizon are lossless).

`--eos` (`eos_overshoot`): a probe request (horizon 16, run-ahead on, 200
new tokens) picks the token whose first greedy occurrence comes earliest
at or after position 100; the same prompt then runs with that token as EOS
with run-ahead on and off (warm-up, then 3 reps each), so each
request ends on EOS rather than its budget and run-ahead's in-flight chain
overshoots.  Both must give the probe's tokens up to the EOS.  Without a
card it raises; `--device cpu --tiny` runs the plain versions at toy size
(a plumbing check: its times are no device metric).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import numpy as np
import torch

from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import quantize_llm_params
from usdm_tpu_torch.scripts.common import device, device_info

CONFIGS = ((8, True), (16, True), (32, True), (64, True), (32, False))
GEOMETRY = {"page_size": 64, "max_pages_per_seq": 24, "max_batch_size": 1,
            "prefill_chunk": 256}
PROMPT_LEN, NEW_TOKENS, EOS_NEW_TOKENS, REPS = 1219, 256, 200, 3


def _allow(cfg: MistralConfig) -> np.ndarray:
    allow = np.ones(cfg.vocab_size, bool)
    allow[:3] = False  # the default EOS (2) unreachable: a request runs its budget
    return allow


def _prompt(seed: int, plen: int, cfg: MistralConfig) -> list:
    return np.random.default_rng(seed).integers(3, min(32000, cfg.vocab_size), plen).tolist()


def _engine(params, cfg, dev, geometry: dict, horizon: int, runahead: bool) -> PagedEngine:
    return PagedEngine(params, cfg, EngineConfig(**geometry, decode_horizon=horizon,
                                                 runahead=runahead), device=dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _timed(eng: PagedEngine, dev: torch.device, prompts: list, allow: np.ndarray, eos_id: int,
           n_new: int, label: str) -> tuple:
    """One request a prompt, each timed alone -> (seconds, tokens) a rep.
    Raises if a rep captured a CUDA graph or its request failed."""
    times, tokens = [], []
    for i, prompt in enumerate(prompts):
        req = Request(100 + i, prompt, allow, eos_id=eos_id, max_new_tokens=n_new)
        captured = eng.stats()["graphs_captured"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng.run([req])
        times.append(time.perf_counter() - t0)
        if req.error is not None or not req.finished:
            raise RuntimeError(f"bench_runahead {label}: rep {i} failed: {req.error}")
        if eng.stats()["graphs_captured"] != captured:
            raise AssertionError(f"bench_runahead {label}: rep {i} captured a CUDA graph "
                                 f"(the warm-up did not cover its path)")
        tokens.append(list(req.output_ids))
    return times, tokens


def _summary(times: list, n_tokens: list) -> dict:
    med = statistics.median(times)
    return {"reps_s": times, "median_s": med,
            "tok_s_reps": [n / t for n, t in zip(n_tokens, times)],
            "tok_s_median": statistics.median(n / t for n, t in zip(n_tokens, times))}


def sweep(params: dict, cfg: MistralConfig, dev: torch.device, configs=CONFIGS, reps: int = REPS,
          n_new: int = NEW_TOKENS, plen: int = PROMPT_LEN, seed: int = 0,
          geometry: dict = GEOMETRY) -> list:
    """Every (horizon, run-ahead) configuration, each printed as one JSON
    line -> the lines.  Raises if a configuration's tokens differ from the
    first one's."""
    allow = _allow(cfg)
    prompts = [_prompt(seed + 1 + i, plen, cfg) for i in range(reps)]
    lines, want = [], None
    for horizon, runahead in configs:
        label = f"horizon {horizon} runahead={int(runahead)}"
        eng = _engine(params, cfg, dev, geometry, horizon, runahead)
        warm = Request(0, _prompt(seed, plen, cfg), allow, eos_id=2, max_new_tokens=n_new)
        eng.run([warm])
        before = eng.stats()
        times, tokens = _timed(eng, dev, prompts, allow, 2, n_new, label)
        after = eng.stats()
        del eng
        _free(dev)
        if any(len(t) != n_new for t in tokens):
            raise AssertionError(f"bench_runahead {label}: a rep emitted "
                                 f"{[len(t) for t in tokens]} tokens, not its {n_new}")
        if want is None:
            want = tokens
        elif tokens != want:
            raise AssertionError(f"bench_runahead {label}: the tokens differ from "
                                 f"horizon {configs[0][0]} runahead={int(configs[0][1])}'s")
        line = {"horizon": horizon, "runahead": runahead, "prompt_len": plen, "n_new": n_new,
                **_summary(times, [n_new] * reps),
                **{k: after[k] - before[k] for k in ("steps", "graph_replays",
                                                     "runahead_chains")},
                "graphs_captured": after["graphs_captured"], "tokens_equal": True}
        lines.append(line)
        print(json.dumps({"bench_runahead": line}), flush=True)
    return lines


def eos_overshoot(params: dict, cfg: MistralConfig, dev: torch.device, reps: int = REPS,
                  n_new: int = EOS_NEW_TOKENS, plen: int = PROMPT_LEN, seed: int = 7,
                  geometry: dict = GEOMETRY, horizon: int = 16) -> list:
    """The probe, then EOS-ended requests with run-ahead on and off, each
    printed as one JSON line -> the lines."""
    allow = _allow(cfg)
    prompt = _prompt(seed, plen, cfg)
    eng = _engine(params, cfg, dev, geometry, horizon, True)
    probe = Request(0, list(prompt), allow, eos_id=2, max_new_tokens=n_new)
    eng.run([probe])
    del eng
    first_at = {}
    for i, t in enumerate(probe.output_ids):
        first_at.setdefault(t, i)
    min_pos = n_new // 2
    late = sorted((i, t) for t, i in first_at.items() if i >= min_pos)
    if not late:
        raise RuntimeError(f"bench_runahead --eos: no token of the probe's "
                           f"{len(probe.output_ids)} is first emitted at position >= {min_pos}, "
                           f"so none can serve as a mid-run EOS")
    stop_at, eos_id = late[0]
    want = probe.output_ids[:stop_at + 1]
    lines = []
    for runahead in (True, False):
        label = f"EOS-ended runahead={int(runahead)}"
        eng = _engine(params, cfg, dev, geometry, horizon, runahead)
        eng.run([Request(1, list(prompt), allow, eos_id=eos_id, max_new_tokens=n_new)])
        times, tokens = _timed(eng, dev, [list(prompt)] * reps, allow, eos_id, n_new, label)
        stats = eng.stats()
        del eng
        _free(dev)
        if any(t != want for t in tokens):
            raise AssertionError(f"bench_runahead {label}: the tokens are not the probe's up to "
                                 f"its EOS {eos_id} at position {stop_at}")
        line = {"eos_id": eos_id, "stop_at": stop_at, "runahead": runahead, "horizon": horizon,
                "n_tokens": len(want), **_summary(times, [len(want)] * reps),
                "runahead_chains": stats["runahead_chains"]}
        lines.append(line)
        print(json.dumps({"bench_runahead_eos": line}), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--eos", action="store_true", help="the EOS-overshoot check instead")
    ap.add_argument("--tiny", action="store_true", help="MistralConfig.tiny() (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    if args.tiny:
        cfg = MistralConfig.tiny().replace(dtype="bfloat16", head_dim=16)
        geo = {"geometry": {"page_size": 16, "max_pages_per_seq": 8, "max_batch_size": 1,
                            "prefill_chunk": 16}, "plen": 40}
        n_new = {"n_new": 24}
    else:
        cfg, geo, n_new = MistralConfig(), {}, {}
    params = quantize_llm_params(
        M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    if args.eos:
        lines = eos_overshoot(params, cfg, dev, **geo, **n_new)
    else:
        lines = sweep(params, cfg, dev, **geo, **n_new)
    print(json.dumps({"device": device_info(dev)}))
    return lines


if __name__ == "__main__":
    main()
