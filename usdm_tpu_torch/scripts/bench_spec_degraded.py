"""Speculative decoding with imperfect drafts: the cost of rejected rounds.

Port of scripts/bench_spec_degraded.py: the W8A8 Mistral-7B engine at
batch 1 (page 256, 3 pages a sequence, horizon 32, spec_k 4) on a
384-token prompt, 96 new tokens with EOS masked out, three ways: plain
chained decode (no draft), the early-exit:4 self-draft (the target's first
4 layers, sharing its tensors) and an independently random 4-layer draft
(near-zero agreement, so nearly every round is a rejection).  Weights as
the JAX script makes them: every int8 leaf uniform in [-127, 127], every
other leaf N(0, 0.02^2) (scales included), the draft from another seed.
Each engine runs one warm-up request, then one timed one.  The speculative
runs' tokens must be the plain run's (W8A8 products are exact at any row
count; the verdict is printed as "identical" or raises).

    python -m usdm_tpu_torch.scripts.bench_spec_degraded            # on the card
    python -m usdm_tpu_torch.scripts.bench_spec_degraded --device cpu --tiny

`--device cpu --tiny` runs MistralConfig.tiny() through the plain versions
(a plumbing check; its times are no device metric).  Prints a line per run
and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import early_exit_draft, quantize_llm_params
from usdm_tpu_torch.scripts.bench_ngram import counters, delta
from usdm_tpu_torch.scripts.common import device, device_info

FULL = dict(prompt=384, new=96, page=256, pages=3, draft_layers=4)
TINY = dict(prompt=24, new=16, page=16, pages=3, draft_layers=1)


def random_quantized(cfg: MistralConfig, dev: torch.device, seed: int):
    """The W8A8 tree's shapes filled as the JAX script fills them: int8
    leaves uniform in [-127, 127], the rest N(0, 0.02^2) in their dtype."""
    shapes = quantize_llm_params(M.init_params(cfg, torch.Generator(), device="meta"))
    g = torch.Generator(device=dev).manual_seed(seed)

    def fill(s: torch.Tensor) -> torch.Tensor:
        if s.dtype == torch.int8:
            return torch.randint(-127, 128, tuple(s.shape), generator=g, device=dev,
                                 dtype=torch.int8)
        return (torch.randn(tuple(s.shape), generator=g, device=dev) * 0.02).to(s.dtype)

    return tree_map(fill, shapes)


def _run(label, params, cfg, geo, prompt, allow, draft, dev) -> dict:
    ecfg = EngineConfig(page_size=geo["page"], max_pages_per_seq=geo["pages"],
                        max_batch_size=1, decode_horizon=32, spec_k=4)
    eng = PagedEngine(params, cfg, ecfg, device=dev, draft=draft)

    def once():
        req = Request(0, list(prompt), allow, eos_id=2, max_new_tokens=geo["new"])
        t0 = time.perf_counter()
        eng.run([req])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, req.output_ids

    once()  # warm-up: graphs captured
    emitted0, before = eng.spec_emitted, counters(eng)
    wall, toks = once()
    timed = delta(counters(eng), before)
    rounds, emitted = timed["spec_rounds"], eng.spec_emitted - emitted0
    res = {"tok_s": len(toks) / wall, "wall_s": wall, "spec_rounds": rounds,
           "accept_per_round": emitted / rounds if rounds else None, "timed": timed,
           "draft_layers": eng.draft_cfg.num_layers if eng.draft_cfg is not None else 0,
           "tokens": toks}
    print(f"{label:28s}: {res['tok_s']:7.1f} tok/s  (rounds={rounds}, accept/round="
          f"{res['accept_per_round'] and round(res['accept_per_round'], 2)})", flush=True)
    return res


def run(dev: torch.device, tiny: bool = False) -> dict:
    """Plain, early-exit and random-draft runs -> tok/s, rounds, acceptance
    and the identity verdict of each speculative run; raises when one
    differs from the plain run."""
    cfg = MistralConfig.tiny() if tiny else MistralConfig()
    geo = TINY if tiny else FULL
    prompt = np.random.default_rng(0).integers(3, min(32000, cfg.vocab_size),
                                               geo["prompt"]).tolist()
    allow = np.ones(cfg.vocab_size, bool)
    allow[:3] = False  # EOS unreachable: a fixed-length run
    params = random_quantized(cfg, dev, 0)
    n = geo["draft_layers"]
    small = cfg.replace(num_layers=n)
    runs = {"plain": _run("plain chained (no draft)", params, cfg, geo, prompt, allow, None, dev),
            f"early_exit_{n}": _run(f"early-exit:{n} self-draft", params, cfg, geo, prompt,
                                    allow, (early_exit_draft(params, n), small), dev),
            f"random_{n}_layer": _run(f"random {n}-layer draft", params, cfg, geo, prompt, allow,
                                      (random_quantized(small, dev, 7), small), dev)}
    plain = runs["plain"]["tokens"]
    for name, r in runs.items():
        if name != "plain":
            r["identical"] = r["tokens"] == plain
            print(f"{name}: tokens {'identical to' if r['identical'] else 'DIFFER from'} "
                  f"plain greedy", flush=True)
            if not r["identical"]:
                raise AssertionError(f"{name}: speculative tokens differ from plain greedy")
        r["tokens"] = len(r["tokens"])
    return {"device": device_info(dev), "config": "tiny" if tiny else "mistral-7b w8a8",
            "geometry": geo, "runs": runs}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="MistralConfig.tiny() at short lengths")
    args = ap.parse_args(argv)
    out = run(device(args.device), args.tiny)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
