"""Where a b = 1 W8A8 decode step of the 7B goes, with the fused-product and int8-head options.

    python -m usdm_tpu_torch.scripts.exp_decode              # on the card
    python -m usdm_tpu_torch.scripts.exp_decode --device cpu --tiny

Port of scripts/exp_decode.py.  Its keys, at the TPU script's geometry
(b 1, a 1,219-token context, page 256, 6 pages), each from a CUDA graph
(median of 30 replays):

  full_ms            the whole step (`paged_decode_step`, bf16 pool)
  mm_only_ms         the 7 products of each layer through `qmm` (K6 at M 1)
  mm_fused_ms        the same with qkv and gate|up fused: 4 products a layer
  lm_head_bf16_ms    the [1, 4096] x [4096, 42003] bf16 lm_head product
  lm_head_int8_ms    the same product with the head W8A8 (K6 at M 1)
  mask_argmax_ms     the mask and argmax over the 42,003 logits
  attn_x4_ms         K1 over 4 layer regions
  attn_per_layer_us  K1 over one layer region

All but mm_fused_ms and lm_head_int8_ms come from
`profile_decode_step.run` at this geometry (its line is kept under
"profile_decode_step"): full_ms is its link over bf16 pools, mm_only_ms
its weights-only scan, lm_head_bf16_ms its lm_head, mask_argmax_ms its
tail less its lm_head, and the K1 numbers its 32-region K1 time scaled to
4 and 1 regions.  Neither scan carries the two RMSNorms a layer that the
TPU script's scans do, so mm_only_ms and mm_fused_ms compare with each
other.  Zero W8A8 weights (scales 1e-8), as the TPU script uses; `run()`
takes a pipeline's own.  Prints one JSON line, then the device line.
Without a card it raises; `--device cpu --tiny` runs the plain versions at
toy size (a plumbing check: its times are no device metric).
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import qmm
from usdm_tpu_torch.scripts import profile_decode_step as PDS
from usdm_tpu_torch.scripts.common import device, device_info
from usdm_tpu_torch.scripts.exp_decode2 import MAX_PAGES, PAGE, fuse_weights

KEYS = ("full_ms", "mm_only_ms", "mm_fused_ms", "lm_head_bf16_ms", "lm_head_int8_ms",
        "mask_argmax_ms", "attn_x4_ms", "attn_per_layer_us")


def run(params: dict, cfg: MistralConfig, dev: torch.device, replays: int = 30,
        ctx: int = PDS.CTX, page: int = PAGE, max_pages: int = MAX_PAGES) -> dict:
    """The keys of KEYS for `params` -> the JSON line's dict."""
    prof = PDS.run(params, cfg, dev, replays, ctx=ctx, page=page, max_pages=max_pages,
                   logits_slice=None)
    fused = fuse_weights(params)
    dt = M.torch_dtype(cfg.dtype)
    x0 = torch.zeros(1, 1, cfg.hidden_size, dtype=dt, device=dev)
    hd, f = cfg.head_dim, cfg.intermediate_size
    qdim = cfg.num_heads * hd

    def mm_fused():  # profile_decode_step's weights-only scan with 4 products a layer
        x = x0
        for lp in fused["layers"]:
            qkv = qmm(x, lp["wqkv"])
            q, kvy = qkv[..., :qdim], qkv[..., qdim:]
            half = kvy.shape[-1] // 2
            y = q + F.pad(kvy[..., :half] + kvy[..., half:], (0, qdim - half))
            x = x + qmm(y, lp["wo"])
            gu = qmm(x, lp["w_gu"])
            x = x + qmm(F.silu(gu[..., :f]) * gu[..., f:], lp["w_down"])
        return x

    def lm_head_int8():
        return qmm(x0[:, 0], fused["lm_head_q"])

    p, link = prof["parts"], prof["link_ms"]
    k1_layer = p["k1_32_layers_ms"] / cfg.num_layers
    out = {"weights": prof["weights"], "batch": 1, "ctx": ctx, "page": page,
           "replays": replays,
           "full_ms": link["kv_bf16" if cfg.dtype == "bfloat16" else f"kv_{cfg.dtype}"],
           "mm_only_ms": p["weights_only_scan_ms"],
           "mm_fused_ms": PDS.replay_ms(mm_fused, dev, replays),
           "lm_head_bf16_ms": p["lm_head_ms"],
           "lm_head_int8_ms": PDS.replay_ms(lm_head_int8, dev, replays),
           "mask_argmax_ms": p["tail_ms"] - p["lm_head_ms"],
           "attn_x4_ms": 4 * k1_layer, "attn_per_layer_us": 1e3 * k1_layer,
           "profile_decode_step": prof}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="MistralConfig.tiny() (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    if args.tiny:
        cfg = MistralConfig.tiny().replace(dtype="bfloat16", head_dim=16)
        geo = dict(ctx=40, page=16, max_pages=4)
    else:
        cfg, geo = MistralConfig(), {}
    params = PDS.zero_params(cfg, dev, True)
    line = run(params, cfg, dev, **geo)
    print(json.dumps({"exp_decode": line}), flush=True)
    print(json.dumps({"device": device_info(dev)}))
    return line


if __name__ == "__main__":
    main()
