"""Scheduler stress at the kernels' geometry: every feature of the engine at once.

Port of scripts/stress_engine.py: a small model with head_dim 128 (2
layers, width 256, GQA 2/2, FFN 512, vocab 512, window 384) served with
page 128, 6 pages a sequence, batch 4, chunk 128, horizon 8 and int8 KV
pages, so decode runs K1 (with window reclaim) and prefill K2.  Each round
builds an engine and drives it with staggered arrivals (three requests,
1-5 ticks, three more), greedy and sampled requests, sessions whose
follow-ups reuse their predecessor's pages, run-ahead chains and (the
EngineConfig default) mixed prefill + decode links.  Per round it checks:

  * every greedy request's tokens equal a fresh solo engine's of the same
    config, draft included (a session follow-up's solo engine first
    replays its predecessor, so its reused K/V has the same provenance);
  * no request is left unfinished, and every page returns to the pool
    once the sessions are released.

`--draft model` (the JAX script's choice) attaches a draft every third
round, the target itself in even rounds (full acceptance) and a
random-weight model in odd ones (constant rejection); `--draft ngram`
makes every round's engine an ngram engine; `--draft none` none.
`--dtype bfloat16` runs the weights in bf16 (float32 as the JAX script).
Mixed links engage as soon as one slot decodes (mixed_min_decode 1), so
each round takes some.

    python -m usdm_tpu_torch.scripts.stress_engine --rounds 6            # on the card
    python -m usdm_tpu_torch.scripts.stress_engine --device cpu --rounds 1

Prints a line per round and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.scripts.common import device, device_info


def run(dev: torch.device, rounds: int = 6, draft_mode: str = "model",
        dtype: str = "float32") -> dict:
    """The stress rounds -> per-round request and token counts and the
    engines' stats; raises on the first broken invariant."""
    cfg = MistralConfig.tiny(vocab_size=512).replace(
        hidden_size=256, num_heads=2, num_kv_heads=2, head_dim=128, num_layers=2,
        intermediate_size=512, sliding_window=384, max_seq_len=768, dtype=dtype)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ecfg = EngineConfig(page_size=128, max_pages_per_seq=6, max_batch_size=4,
                        prefill_chunk=128, decode_horizon=8, kv_dtype="int8",
                        # mixed links as soon as one slot decodes
                        mixed_min_decode=1)
    rng = np.random.default_rng(0)
    # the JAX script's draft rounds: even ones the target itself (high
    # acceptance), odd ones a random model (constant rejection)
    draft_random = M.init_params(cfg, torch.Generator(device=dev).manual_seed(9), dev)

    def mk(rid, n, max_new, sampled=False, session=None):
        allow = np.ones(cfg.vocab_size, bool)
        allow[:3] = False
        return Request(rid, rng.integers(3, cfg.vocab_size, n).tolist(), allow, eos_id=2,
                       max_new_tokens=max_new, top_k=8 if sampled else 1,
                       temperature=1.2 if sampled else 1.0, seed=rid, session=session)

    out = {"device": device_info(dev), "draft": draft_mode, "dtype": dtype, "rounds": []}
    t0 = time.perf_counter()
    for rnd in range(rounds):
        draft = None
        if draft_mode == "ngram":
            draft = "ngram"
        elif draft_mode == "model" and rnd % 3 == 2:
            draft = (params if rnd % 2 == 0 else draft_random, cfg)
        eng = PagedEngine(params, cfg, ecfg, device=dev, draft=draft)
        total_pages = len(eng.free_pages)
        reqs, sessions = [], []
        for i in range(6):
            # sessions and sampled requests disjoint: the solo baseline
            # replays session predecessors greedily
            session = None
            if i % 2 == 0:
                session = 100 + i
                sessions.append(session)
            reqs.append(mk(i, int(rng.integers(40, 400)), int(rng.integers(8, 48)),
                           sampled=i in (1, 5), session=session))
        for r in reqs[:3]:  # staggered arrival: a few, some ticks, the rest
            eng.submit(r)
        for _ in range(int(rng.integers(1, 6))):
            if eng.busy:
                eng.tick()
        for r in reqs[3:]:
            eng.submit(r)
        while eng.busy:
            eng.tick()
        rid = len(reqs)
        for s in sessions:  # session follow-ups reuse their predecessor's pages
            prev = next(r for r in reqs if r.session == s)
            r = mk(rid, 0, int(rng.integers(8, 32)), session=s)
            r.prompt_ids = (list(prev.prompt_ids) + list(prev.output_ids)
                            + rng.integers(3, cfg.vocab_size, 37).tolist())
            reqs.append(r)
            eng.submit(r)
            rid += 1
        while eng.busy:
            eng.tick()
        eng.drain_inflight()
        if not all(r.finished for r in reqs):
            raise AssertionError(f"round {rnd}: unfinished request")
        for r in reqs:
            if r.sampled or r.error:
                continue
            solo = PagedEngine(params, cfg, ecfg, device=dev, draft=draft)
            if r.session is not None and r.req_id >= 6:  # a follow-up: replay its predecessor
                prev = next(p for p in reqs if p.session == r.session and p.req_id < r.req_id)
                replay = Request(998, list(prev.prompt_ids), prev.allow_mask, prev.eos_id,
                                 prev.max_new_tokens, session=r.session)
                solo.run([replay])
                if replay.output_ids != prev.output_ids:
                    raise AssertionError(f"round {rnd}: replay of {prev.req_id} != batched")
            clone = Request(999, list(r.prompt_ids), r.allow_mask, r.eos_id, r.max_new_tokens,
                            session=r.session)
            solo.run([clone])
            if clone.output_ids != r.output_ids:
                raise AssertionError(f"round {rnd} req {r.req_id}: batched != solo")
        for s in sessions:
            eng.release_session(s)
        if len(eng.free_pages) != total_pages:
            raise AssertionError(f"round {rnd}: leaked {total_pages - len(eng.free_pages)} pages")
        st = eng.stats()
        kind = "ngram" if eng.ngram else ("model" if eng.draft_params is not None else "none")
        info = {"round": rnd, "draft": kind, "requests": len(reqs),
                "tokens": sum(len(r.output_ids) for r in reqs), "steps": st["steps"],
                "mixed_links": st["mixed_links"], "spec_rounds": st["spec_rounds"],
                "runahead_chains": st["runahead_chains"], "graph_replays": st["graph_replays"]}
        out["rounds"].append(info)
        print(f"round {rnd}: {info['requests']} requests ok ({info['tokens']} tokens; "
              f"draft {kind}, {info['mixed_links']} mixed links, {info['spec_rounds']} "
              f"speculative rounds)", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"STRESS OK ({rounds} rounds, {out['seconds']:.0f} s)", flush=True)
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--draft", choices=("model", "ngram", "none"), default="model")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args(argv)
    out = run(device(args.device), args.rounds, args.draft, args.dtype)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
