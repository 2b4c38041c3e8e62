"""Draft-free ngram (prompt-lookup) speculation against plain chained decode.

Port of scripts/bench_ngram.py: the W8A8 Mistral-7B engine (`--bf16`: its
projections in bf16) at batch 1 with a 1219-token prompt and 256 new tokens
(page 64, 24 pages a sequence, chunk 512, horizon 16, spec_k 4; EOS masked
out, so every request runs its budget), plain (no draft) and with
draft="ngram", in two weight regimes:

  zero    zero weights: greedy emits one token over and over (the
          acceptance ceiling);
  random  seeded random weights (N(0, 0.02^2), W8A8 unless --bf16):
          greedy falls into whatever cycle it finds.

Each engine runs a 16-token warm-up request, then 2 timed requests (the
faster kept, as the JAX script keeps it); acceptance counts the timed
requests alone.  The verdict on the tokens: "exact" when the ngram run's
tokens are the plain run's; otherwise the first divergence is classified
by the JAX script's rule (`classify_divergence`): under an independent
dense forward (models/mistral.forward) at the divergent position, both
tokens must lie within 0.5 logit-std of the argmax (a tie-flip of the
arithmetic), which a real acceptance fault, emitting a token far below the
top, fails.  Zero weights must be exact.

    python -m usdm_tpu_torch.scripts.bench_ngram               # on the card
    python -m usdm_tpu_torch.scripts.bench_ngram --device cpu --tiny

`--device cuda` (the default) raises without a card; `--device cpu --tiny`
runs MistralConfig.tiny() at a short prompt through the plain versions, a
plumbing check whose times are no device metric.  `--profile` runs one more
request of 48 new tokens on each engine under torch.profiler and adds, per
link or round, its device time and kernel count and the kernels that take
the most device time (the prefill's kernels included).  Prints a line per regime and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import quantize_llm_params
from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
from usdm_tpu_torch.ops.stream_matvec import stream_qmv
from usdm_tpu_torch.scripts.common import device, device_info

FULL = dict(prompt=1219, new=256, warm=16, page=64, pages=24, chunk=512)
PROFILED = 48  # new tokens of the profiled request (--profile)
TINY = dict(prompt=40, new=24, warm=4, page=16, pages=8, chunk=16)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def counters(eng: PagedEngine) -> dict:
    """The engine's links, rounds and replays and the K1 (bf16 and int8
    pools) and K6 launch counts: the difference of two readings is what
    the requests between them ran."""
    st = eng.stats()
    return {"steps": st["steps"], "spec_rounds": st["spec_rounds"],
            "graph_replays": st["graph_replays"], "k1": paged_decode_attention.launches,
            "k1_int8": paged_decode_attention.int8_launches, "k6": stream_qmv.launches}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def classify_divergence(params, cfg: MistralConfig, prompt: List[int], plain: List[int],
                        spec: List[int], allow: np.ndarray, dev: torch.device) -> dict:
    """The first position where `spec` leaves `plain`, judged by the JAX
    script's rule: the dense forward's logits at that position (the stage
    mask applied), the gap of each of the two tokens below the top, in
    units of the logits' std over the allowed ids; a tie-flip when both
    gaps are under 0.5.  -> {"divergences": 0} when the two agree."""
    div = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b), None)
    if div is None:
        if len(plain) != len(spec):
            return {"divergences": 1, "at": min(len(plain), len(spec)), "tie_flip": False,
                    "why": f"lengths {len(plain)} and {len(spec)}"}
        return {"divergences": 0}
    ids = torch.tensor([prompt + plain[:div]], device=dev)
    with torch.no_grad():
        logits = M.forward(params, cfg, ids)[0, -1].double().cpu().numpy()
    logits[~allow] = -np.inf
    std = float(np.std(logits[allow]))
    top = float(logits.max())
    a, b = plain[div], spec[div]
    gaps = [top - float(logits[t]) for t in (a, b)]
    order = np.argsort(-logits)
    ranks = [int(np.flatnonzero(order == t)[0]) for t in (a, b)]
    worst = max(gaps) / std
    return {"divergences": 1, "at": div, "tokens": [a, b], "ranks": ranks,
            "gap_std": worst, "tie_flip": worst < 0.5}


def random_weights(cfg: MistralConfig, dev: torch.device, w8a8: bool = True, seed: int = 0):
    """Seeded N(0, 0.02^2) weights (MistralConfig's initializer range), in
    cfg.dtype, with W8A8 projections (quantized layer by layer) unless
    `w8a8` is False."""
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return quantize_llm_params(params) if w8a8 else params


def _profile_summary(prof, steps: int, top: int = 12) -> dict:
    """Device time (ms) and kernel launches per link or round of a profiled
    run, and the `top` kernels by device time per link or round."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kern.sort(key=lambda e: -e.self_device_time_total)
    return {"device_ms_per_step": sum(e.self_device_time_total for e in kern) / 1e3 / steps,
            "kernels_per_step": sum(e.count for e in kern) / steps,
            "top": [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                     "per_step": e.count / steps} for e in kern[:top]]}


def _run(params, cfg: MistralConfig, geo: dict, prompt: List[int], allow: np.ndarray,
         draft, dev: torch.device, reps: int = 2, profile: bool = False) -> dict:
    ecfg = EngineConfig(page_size=geo["page"], max_pages_per_seq=geo["pages"],
                        max_batch_size=1, prefill_chunk=geo["chunk"], decode_horizon=16,
                        spec_k=4)
    eng = PagedEngine(params, cfg, ecfg, device=dev, draft=draft)
    eng.run([Request(0, list(prompt), allow, eos_id=2, max_new_tokens=geo["warm"])])
    eng.spec_rounds = eng.spec_emitted = 0  # acceptance of the timed requests alone
    before = counters(eng)
    times, out = [], None
    for i in range(reps):
        r = Request(10 + i, list(prompt), allow, eos_id=2, max_new_tokens=geo["new"])
        t0 = time.perf_counter()
        eng.run([r])
        _sync(dev)
        times.append(time.perf_counter() - t0)
        out = r.output_ids
    st = eng.stats()
    res = {"best_s": min(times), "times_s": times, "tok_s": geo["new"] / min(times),
           "accept_per_round": st["spec_accept_per_round"],
           "timed": delta(counters(eng), before), "tokens": out}
    if profile:  # one more, short request under the profiler (not timed)
        start = counters(eng)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            eng.run([Request(20, list(prompt), allow, eos_id=2, max_new_tokens=PROFILED)])
            _sync(dev)
        res["profile"] = _profile_summary(prof, delta(counters(eng), start)["steps"])
    return res


def run(dev: torch.device, tiny: bool = False, regimes=("zero", "random"),
        profile: bool = False, w8a8: bool = True) -> dict:
    """Plain and ngram runs in each weight regime -> per regime tok/s,
    rounds, acceptance, the verdict and the tail's period; raises when zero
    weights are not exact or a divergence is not a tie-flip.  `w8a8=False`
    keeps the projections bf16."""
    cfg = MistralConfig.tiny() if tiny else MistralConfig()
    geo = TINY if tiny else FULL
    rng = np.random.default_rng(0)
    allow = np.ones(cfg.vocab_size, bool)
    allow[:3] = False  # EOS unreachable: the budget-bound steady state
    prompt = rng.integers(3, min(32000, cfg.vocab_size), geo["prompt"]).tolist()
    out = {"device": device_info(dev),
           "config": ("tiny" if tiny else "mistral-7b") + (" w8a8" if w8a8 else " bf16"),
           "geometry": geo, "regimes": {}}
    rand = random_weights(cfg, dev, w8a8)
    for name in regimes:
        params = tree_map(torch.zeros_like, rand) if name == "zero" else rand
        plain = _run(params, cfg, geo, prompt, allow, None, dev, profile=profile)
        ngram = _run(params, cfg, geo, prompt, allow, "ngram", dev, profile=profile)
        verdict = classify_divergence(params, cfg, prompt, plain["tokens"], ngram["tokens"],
                                      allow, dev)
        tail = plain["tokens"][-128:]
        period = next((p for p in range(1, 65) if tail[p:] == tail[:-p]), None)
        res = {"plain_tok_s": plain["tok_s"], "ngram_tok_s": ngram["tok_s"],
               "speedup": plain["best_s"] / ngram["best_s"],
               "plain_times_s": plain["times_s"], "ngram_times_s": ngram["times_s"],
               "accept_per_round": ngram["accept_per_round"], "plain_timed": plain["timed"],
               "ngram_timed": ngram["timed"], "tail_period": period, "verdict": verdict}
        if profile:
            res["plain_profile"], res["ngram_profile"] = plain["profile"], ngram["profile"]
        out["regimes"][name] = res
        match = ("exact" if not verdict["divergences"] else
                 f"{'tie-flip' if verdict['tie_flip'] else 'NOT a tie-flip'} at "
                 f"{verdict['at']} ({verdict})")
        print(f"{name:7s} plain {res['plain_tok_s']:7.1f} tok/s | ngram "
              f"{res['ngram_tok_s']:7.1f} tok/s ({res['speedup']:.2f}x) | accept/round "
              f"{res['accept_per_round']} | tail period {period} | vs plain: {match}",
              flush=True)
        if name == "zero" and verdict["divergences"]:
            raise AssertionError(f"zero weights: ngram tokens differ from plain greedy: {verdict}")
        if verdict["divergences"] and not verdict["tie_flip"]:
            raise AssertionError(f"{name}: the divergence is not a tie-flip: {verdict}")
        del params
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="MistralConfig.tiny(), a 40-token prompt and 24 new tokens")
    ap.add_argument("--profile", action="store_true",
                    help="profile the timed requests: device ms and kernels per link or round")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 projections instead of W8A8 (the tie-flip rule then may apply)")
    args = ap.parse_args(argv)
    out = run(device(args.device), args.tiny, profile=args.profile, w8a8=not args.bf16)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
