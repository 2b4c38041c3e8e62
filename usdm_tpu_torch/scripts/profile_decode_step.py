"""Split one b = 1 paged decode link of the 7B into its parts, on the card.

Port of scripts/profile_decode_step.py.  At the dialog geometry (page 64,
a 1,219-token context over 20 of 24 pages), for bf16 and W8A8 weights:

- the whole link (`engine/paged_ops.py::paged_decode_step`) over bf16 and
  int8 KV pools, and over bf16 pools with the text2unit stage's sliced
  lm_head (32002, 42003, 31999);
- its parts: the weights-only projection scan (the 7 products of each of
  the 32 layers through `qmm`: K6 at M 1 for W8A8), the lm_head product,
  the mask and argmax tail (lm_head included), K1 over the 32 layer regions
  (bf16 pools), and embed + RoPE; `rest_ms` is the link less the scan, the
  tail, K1 and embed + RoPE (the norms, residual adds, K/V writes, QKV
  reshapes and RoPE of each layer).

Each is captured once in a CUDA graph and timed as replays (CUDA events
around each replay, median of --replays), so the host's dispatch is not in
the numbers.  `bound_ms` is the link's weight bytes (every layer's weights,
the lm_head rows the link reads, one embedding row) over 3.35 TB/s.  Prints
one JSON line per weight kind, then the device line.  Zero weights, as the
TPU script uses (`run()` also takes a pipeline's own).  Without a card it
raises; `--device cpu --tiny` runs the plain versions at toy size (a
plumbing check: its times are no device metric).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Optional

import torch

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.engine.paged_ops import GraphSet, PagedKV, paged_decode_step
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import is_quantized, qmm
from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
from usdm_tpu_torch.scripts.common import device, device_info

HBM_BYTES_PER_S = 3.35e12
PAGE, MAX_PAGES, CTX = 64, 24, 1219  # the dialog server's page; ctx 1,219 -> 20 pages
LOGITS_SLICE = (32002, 42003, 31999)  # text2unit: the unit ids and </s>


def zero_params(cfg: MistralConfig, dev: torch.device, w8a8: bool) -> dict:
    """Zero weights of `cfg`'s shapes in cfg.dtype (norms at 1), the layer
    projections W8A8 when `w8a8`."""
    dt = M.torch_dtype(cfg.dtype)
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd), "wo": (h * hd, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}

    def proj(shape):
        if not w8a8:
            return torch.zeros(shape, dtype=dt, device=dev)
        return {"q": torch.zeros(shape[::-1], dtype=torch.int8, device=dev),
                "s": torch.full((shape[1],), 1e-8, dtype=torch.bfloat16, device=dev)}

    def ones():
        return torch.ones(d, dtype=dt, device=dev)

    layers = [{"ln1": ones(), "ln2": ones(), **{k: proj(s) for k, s in shapes.items()}}
              for _ in range(cfg.num_layers)]
    return {"embed": torch.zeros(v, d, dtype=dt, device=dev), "layers": layers,
            "final_norm": ones(),
            "lm_head": torch.zeros(v, d, dtype=dt, device=dev)}


def _nbytes(x) -> int:
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, list):
        return sum(_nbytes(v) for v in x)
    return x.numel() * x.element_size()


def link_bytes(params: dict, logits_slice=None) -> int:
    """The weight bytes one link reads: every layer, the final norm, the
    lm_head rows it multiplies, one embedding row."""
    head = params["lm_head"]
    rows = head.shape[0]
    if logits_slice is not None:
        lo, hi, extra = logits_slice
        rows = hi - lo + (extra >= 0)
    return (_nbytes(params["layers"]) + _nbytes(params["final_norm"])
            + rows * head.shape[1] * head.element_size()
            + params["embed"].shape[1] * params["embed"].element_size())


def replay_ms(fn: Callable[[], object], dev: torch.device, replays: int) -> float:
    """fn captured once in a CUDA graph (after one eager call) -> the median
    of `replays` replays' CUDA-event times in ms.  The capture goes through
    the engine's `paged_ops.GraphSet`, so K1's and K6's launch counts grow
    by what each replay launches, as a decode link's replays count them.
    On the CPU: the median of eager calls on the host clock (no device
    metric)."""
    fn()
    if dev.type != "cuda":
        times = []
        for _ in range(replays):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(dev)
    graphs = GraphSet(dev)
    unused = torch.zeros(1, dtype=torch.bool, device=dev)  # GraphSet freezes rows here
    graphs.run("fn", fn, [], unused)  # the capture, then its first replay
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graphs.run("fn", fn, [], unused)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graphs
    return statistics.median(times)


def run(params: dict, cfg: MistralConfig, dev: torch.device, replays: int = 30,
        ctx: int = CTX, page: int = PAGE, max_pages: int = MAX_PAGES,
        logits_slice: Optional[tuple] = LOGITS_SLICE) -> dict:
    """The link and its parts for `params` (bf16/f32 or W8A8 layers) ->
    the JSON line's dict."""
    w8a8 = is_quantized(params["layers"][0]["wq"])
    b = 1
    tok = torch.zeros(b, dtype=torch.long, device=dev)
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    table = torch.arange(max_pages, dtype=torch.int32, device=dev)[None].contiguous()
    act = torch.ones(b, dtype=torch.bool, device=dev)
    allow = torch.ones(b, cfg.vocab_size, dtype=torch.bool, device=dev)
    out = {"weights": "w8a8" if w8a8 else cfg.dtype, "batch": b, "ctx": ctx, "page": page,
           "replays": replays, "link_ms": {}}
    pools = {}
    for kv_dtype in (None, "int8"):
        kv = PagedKV.create(cfg, max_pages + 1, page, dev, dtype=kv_dtype)
        pools[kv_dtype] = kv
        name = "int8" if kv_dtype else "bf16" if cfg.dtype == "bfloat16" else cfg.dtype
        out["link_ms"][f"kv_{name}"] = replay_ms(lambda: paged_decode_step(
            params, kv, cfg, tok, lens, table, act, allow, page), dev, replays)
    kv = pools[None]
    if logits_slice is not None and logits_slice[1] <= cfg.vocab_size:
        out["link_ms"]["kv_bf16_sliced_lm_head"] = replay_ms(lambda: paged_decode_step(
            params, kv, cfg, tok, lens, table, act, allow, page, logits_slice=logits_slice),
            dev, replays)
    del pools

    dt = M.torch_dtype(cfg.dtype)
    x0 = torch.zeros(b, 1, cfg.hidden_size, dtype=dt, device=dev)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def weights_only():
        x = x0
        for lp in params["layers"]:
            y = qmm(x, lp["wq"])
            kvy = qmm(x, lp["wk"]) + qmm(x, lp["wv"])
            y = y + torch.nn.functional.pad(kvy, (0, y.shape[-1] - kvy.shape[-1]))
            x = x + qmm(y, lp["wo"])
            x = x + M.mlp(x, lp)
        return x

    def lm_head():
        return x0[:, 0] @ params["lm_head"].t()

    def tail():
        logits = torch.where(allow, (x0[:, 0] @ params["lm_head"].t()).float(), -1e30)
        return torch.argmax(logits, dim=-1)

    n_pages = max_pages + 1
    q0 = torch.zeros(b, hkv, h // hkv, hd, dtype=kv.k_pages.dtype, device=dev)
    tables = [(table + li * n_pages).contiguous() for li in range(cfg.num_layers)]
    kv_len = lens + 1

    def attention():  # one call a layer, each over its own layer region
        for t in tables:
            paged_decode_attention(q0, kv.k_pages, kv.v_pages, t, kv_len,
                                   sliding_window=cfg.sliding_window)

    def embed_rope():
        x = params["embed"][tok][:, None, :]
        cos, sin = M.rope_tables(lens.long()[:, None], hd, cfg.rope_theta)
        return x, cos, sin

    parts = {"weights_only_scan_ms": weights_only, "lm_head_ms": lm_head,
             "tail_ms": tail, "k1_32_layers_ms": attention, "embed_rope_ms": embed_rope}
    out["parts"] = {k: replay_ms(fn, dev, replays) for k, fn in parts.items()}
    p = out["parts"]
    link = out["link_ms"]["kv_bf16" if cfg.dtype == "bfloat16" else f"kv_{cfg.dtype}"]
    out["parts"]["rest_ms"] = link - (p["weights_only_scan_ms"] + p["tail_ms"]
                                      + p["k1_32_layers_ms"] + p["embed_rope_ms"])
    out["weight_bytes"] = link_bytes(params)
    out["bound_ms"] = out["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    if logits_slice is not None and logits_slice[1] <= cfg.vocab_size:
        out["bound_ms_sliced_lm_head"] = link_bytes(params, logits_slice) / HBM_BYTES_PER_S * 1e3
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--replays", type=int, default=30)
    ap.add_argument("--tiny", action="store_true", help="MistralConfig.tiny() (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    if args.tiny:
        cfg = MistralConfig.tiny().replace(dtype="bfloat16", head_dim=16)
        geo = dict(ctx=40, page=16, max_pages=4)
    else:
        cfg, geo = MistralConfig(), {}
    lines = []
    for w8a8 in (False, True):
        params = zero_params(cfg, dev, w8a8)
        line = run(params, cfg, dev, args.replays, **geo)
        del params
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"device": device_info(dev)}))
    return lines


if __name__ == "__main__":
    main()
