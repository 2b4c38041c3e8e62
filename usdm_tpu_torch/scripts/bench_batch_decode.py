"""Batched decode-step throughput of the W8A8 7B at b 8, 16 and 32, bf16 against int8 KV pages.

    python -m usdm_tpu_torch.scripts.bench_batch_decode      # on the card
    python -m usdm_tpu_torch.scripts.bench_batch_decode --device cpu --tiny

Port of scripts/bench_batch_decode.py.  At a large batch the KV pages a
step reads rival the weights it reads once for all rows: at b 32 and a
1,219-token context, 5.12 GB of bf16 K/V against 6.98 GB of W8A8 layers.
For b in (8, 16, 32) and bf16 or int8 pools, at the serving geometry (page
256, ctx 1,219, (ctx + 1 + 255) // 256 + 1 = 6 pages a sequence), one
`paged_decode_step` of every slot is timed eagerly (20 steps between two
synchronizations, the TPU script's loop) and from a CUDA graph (median of
20 replays, `profile_decode_step.replay_ms`).  Each line gives ms a
step, tok/s, tok/s a sequence, the step's bound (the weights the step
reads, the lm_head's rows and b embedding rows included, plus every slot's
ctx + 1 K/V rows, over 3.35 TB/s), and the launches of one eager step by
route: K6 (`qmm` at <= 16 rows), `torch._int_mm` (more rows: the rows
quantized and the epilogue run as plain ops) and K1.  A case that raises
prints a line with "failed" (the TPU script's FAILED line) and the run goes
on; `main` raises at its end if any failed.  Zero W8A8 weights (scales
1e-8), as the TPU script uses; `run()` takes a pipeline's own.  Without a
card it raises; `--device cpu --tiny` runs the plain versions at toy size
(a plumbing check: its times are no device metric).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback

import torch

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.engine.paged_ops import PagedKV, paged_decode_step
from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
from usdm_tpu_torch.ops.stream_matvec import stream_qmv
from usdm_tpu_torch.scripts import profile_decode_step as PDS
from usdm_tpu_torch.scripts.common import device, device_info

PAGE, CTX = 256, 1219
BATCHES = (8, 16, 32)
KV_DTYPES = (None, "int8")
EAGER_STEPS = 20


def pages_per_seq(ctx: int = CTX, page: int = PAGE) -> int:
    """The TPU script's pages a sequence: ctx + 1 tokens rounded up to pages, plus one."""
    return (ctx + 1 + page - 1) // page + 1


def kv_bytes(cfg: MistralConfig, b: int, ctx: int = CTX, kv_dtype=None) -> int:
    """The K/V bytes one step reads: ctx + 1 rows a slot (the new token's
    included) of every layer and kv head, K and V; int8 pools read one f32
    scale a row beside its int8 values."""
    row = cfg.head_dim + 4 if kv_dtype == "int8" else cfg.head_dim * (
        2 if cfg.dtype == "bfloat16" else 4)
    return 2 * cfg.num_layers * cfg.num_kv_heads * row * (ctx + 1) * b


def weight_bytes(params: dict, b: int) -> int:
    """The weights one step reads: profile_decode_step's link bytes (every
    layer, the final norm, the lm_head, one embedding row) and b - 1 more
    embedding rows."""
    emb = params["embed"]
    return PDS.link_bytes(params) + (b - 1) * emb.shape[1] * emb.element_size()


@contextlib.contextmanager
def counting_int_mm():
    """Counts the calls of torch._int_mm (`qmm`'s route beyond 16 rows)
    while the block runs: -> a one-element list holding the count."""
    calls = [0]
    orig = torch._int_mm

    def counted(a, b):
        calls[0] += 1
        return orig(a, b)

    torch._int_mm = counted
    try:
        yield calls
    finally:
        torch._int_mm = orig


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def case(params: dict, cfg: MistralConfig, dev: torch.device, b: int, kv_dtype=None,
         ctx: int = CTX, page: int = PAGE, replays: int = 20) -> dict:
    """One (b, pool dtype) case -> its line's dict."""
    maxp = pages_per_seq(ctx, page)
    kv = PagedKV.create(cfg, b * maxp + 1, page, dev, dtype=kv_dtype)
    table = torch.arange(b * maxp, dtype=torch.int32, device=dev).reshape(b, maxp)
    tok = torch.zeros(b, dtype=torch.long, device=dev)
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    act = torch.ones(b, dtype=torch.bool, device=dev)
    allow = torch.ones(b, cfg.vocab_size, dtype=torch.bool, device=dev)

    def step():
        return paged_decode_step(params, kv, cfg, tok, lens, table, act, allow, page)

    before = (stream_qmv.launches, paged_decode_attention.launches)
    with counting_int_mm() as int_mm:
        step()
    launches = {"stream_qmv": stream_qmv.launches - before[0], "torch_int_mm": int_mm[0],
                "paged_decode_attention": paged_decode_attention.launches - before[1]}
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(EAGER_STEPS):
        nxt = step()
    nxt.tolist()
    eager_ms = (time.perf_counter() - t0) / EAGER_STEPS * 1e3
    graph_ms = PDS.replay_ms(step, dev, replays)
    bound = (weight_bytes(params, b) + kv_bytes(cfg, b, ctx, kv_dtype)) / PDS.HBM_BYTES_PER_S
    return {"b": b, "kv": kv_dtype or ("bf16" if cfg.dtype == "bfloat16" else cfg.dtype),
            "ctx": ctx, "page": page, "pages_per_seq": maxp,
            "eager_ms": eager_ms, "graph_ms": graph_ms,
            "tok_s": b / graph_ms * 1e3, "tok_s_per_seq": 1e3 / graph_ms,
            "eager_tok_s": b / eager_ms * 1e3,
            "kv_gb": kv_bytes(cfg, b, ctx, kv_dtype) / 1e9,
            "weight_gb": weight_bytes(params, b) / 1e9, "bound_ms": bound * 1e3,
            "launches_per_step": launches}


def run(params: dict, cfg: MistralConfig, dev: torch.device, batches=BATCHES,
        ctx: int = CTX, page: int = PAGE, replays: int = 20) -> list:
    """Every (b, pool dtype) case, each printed as one JSON line as it ends;
    a case that raises gives a line with "failed"."""
    lines = []
    for b in batches:
        for kv_dtype in KV_DTYPES:
            try:
                line = case(params, cfg, dev, b, kv_dtype, ctx, page, replays)
            except Exception as e:  # noqa: BLE001 -- the TPU script's FAILED line
                traceback.print_exc()
                line = {"b": b, "kv": kv_dtype or "bf16", "failed": f"{type(e).__name__}: {e}"}
            lines.append(line)
            print(json.dumps({"bench_batch_decode": line}), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="MistralConfig.tiny() (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    if args.tiny:
        cfg = MistralConfig.tiny().replace(dtype="bfloat16", head_dim=16)
        geo = dict(batches=(2, 4), ctx=40, page=16)
    else:
        cfg, geo = MistralConfig(), {}
    params = PDS.zero_params(cfg, dev, True)
    lines = run(params, cfg, dev, **geo)
    print(json.dumps({"device": device_info(dev)}))
    failed = [ln for ln in lines if "failed" in ln]
    if failed:
        raise RuntimeError(f"bench_batch_decode: {len(failed)} cases failed: {failed}")
    return lines


if __name__ == "__main__":
    main()
