"""Ablations of one b = 1 paged decode step of the 7B, each from a CUDA graph.

    python -m usdm_tpu_torch.scripts.exp_decode2             # on the card
    python -m usdm_tpu_torch.scripts.exp_decode2 --device cpu --tiny

Port of scripts/exp_decode2.py.  `step_variant` is an ablatable copy of the
greedy body of `engine/paged_ops.py::paged_decode_step` over the port's
layer list; its flags drop or change one part of the step:

  full            the step as paged_decode_step runs it
  no_head         stop at the final norm (no lm_head, mask or argmax)
  no_attn         K1 skipped: the attention output is q itself
  no_write        the K/V page writes skipped
  fused           qkv and gate|up as one product each (4 products a layer;
                  `fuse_weights` concatenates the weights on Dout)
  fused_nohead    fused and no_head
  head_int8       the lm_head as a W8A8 product (`quantize_weight` of the
                  [42003, 4096] head, per output row; K6 at M 1 on the card)
  fused_int8head  fused and head_int8

At the TPU script's geometry (b 1, a 1,219-token context, page 256, 6
pages), for zero W8A8 weights (the TPU script's; scales 1e-8) and zero bf16
weights (the port's turns run bf16 too), each variant is captured once in a
CUDA graph and timed as replays (CUDA events around each replay, median of
30; `profile_decode_step.replay_ms`), so the host's dispatch is not in the
numbers.  Each case also runs every variant once
eagerly and reports its token, its K6 launches, and whether the fused
variants give the unfused ones' tokens (W8A8: the same bits by
construction, each output row's integer product is exact; bf16: the
products' summation order may differ).  Prints one JSON line per weight
kind, then the device line.  Without a card it raises; `--device cpu
--tiny` runs the plain versions at toy size (a plumbing check: its times
are no device metric).
"""

from __future__ import annotations

import argparse
import json
from typing import List

import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.engine.paged_ops import PagedKV, _write_kv
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import is_quantized, out_dim, qmm, quantize_weight
from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
from usdm_tpu_torch.ops.sampling import NEG_INF
from usdm_tpu_torch.ops.stream_matvec import stream_qmv
from usdm_tpu_torch.scripts.common import device, device_info
from usdm_tpu_torch.scripts.profile_decode_step import CTX, replay_ms, zero_params

PAGE, MAX_PAGES = 256, 6  # the TPU script's EngineConfig(page_size=256, max_pages_per_seq=6)
HEADS = ("bf16", "int8", "none")
VARIANTS = {
    "full": {}, "no_head": {"head": "none"}, "no_attn": {"use_attn": False},
    "no_write": {"use_write": False}, "fused": {"fuse": True},
    "fused_nohead": {"fuse": True, "head": "none"}, "head_int8": {"head": "int8"},
    "fused_int8head": {"fuse": True, "head": "int8"},
}
# (unfused, fused) variants that must give one token on W8A8 weights
FUSED_PAIRS = (("full", "fused"), ("no_head", "fused_nohead"), ("head_int8", "fused_int8head"))


def _cat(ws: List, dim_plain: int):
    """Projection weights concatenated on their output dimension: plain
    [Din, Dout] leaves on dim 1, W8A8 {"q": [Dout, Din], "s": [Dout]} on
    dim 0."""
    if is_quantized(ws[0]):
        return {"q": torch.cat([w["q"] for w in ws]), "s": torch.cat([w["s"] for w in ws])}
    return torch.cat(ws, dim=dim_plain)


def fuse_weights(params: dict) -> dict:
    """A copy of `params` (the tensors shared, the containers new) whose
    layers also hold "wqkv" (wq | wk | wv) and "w_gu" (w_gate | w_up), and
    with "lm_head_q", the lm_head [V, D] quantized per output row (K6's
    "oi" layout, q [V, D]).  `params` itself is left as it is."""
    layers = [{**lp, "wqkv": _cat([lp["wq"], lp["wk"], lp["wv"]], 1),
               "w_gu": _cat([lp["w_gate"], lp["w_up"]], 1)} for lp in params["layers"]]
    return {**params, "layers": layers, "lm_head_q": quantize_weight(params["lm_head"].t())}


def step_variant(params: dict, kv: PagedKV, cfg: MistralConfig, tokens: torch.Tensor,
                 seq_lens: torch.Tensor, page_table: torch.Tensor, active: torch.Tensor,
                 allow_masks: torch.Tensor, page_size: int, use_attn: bool = True,
                 use_write: bool = True, fuse: bool = False, head: str = "bf16") -> torch.Tensor:
    """paged_decode_step's greedy body with its parts switchable -> the next
    token [B] (0 for inactive rows); K/V written in place unless
    `use_write` is off.  `fuse` and head "int8" need `fuse_weights(params)`."""
    if head not in HEADS:
        raise ValueError(f"head must be one of {HEADS}, got {head!r}")
    b = tokens.shape[0]
    hd = cfg.head_dim
    lp0 = params["layers"][0]
    h, hkv = out_dim(lp0["wq"]) // hd, out_dim(lp0["wk"]) // hd
    qdim, kvdim, f = h * hd, hkv * hd, out_dim(lp0["w_gate"])
    maxp = page_table.shape[1]
    n_pages = kv.total_pages // cfg.num_layers
    pos = seq_lens.long()
    rows = torch.arange(b, device=tokens.device)
    page_ids = page_table.long()[rows, torch.clamp(pos // page_size, max=maxp - 1)]
    page_ids = torch.where(active, page_ids, n_pages - 1)  # inactive: trash page
    offs = pos % page_size
    kv_len = torch.clamp(seq_lens + 1, max=maxp * page_size).to(torch.int32)
    bases = torch.arange(cfg.num_layers, device=tokens.device, dtype=torch.int32) * n_pages
    tables = (page_table[None] + bases[:, None, None]).contiguous()

    x = params["embed"][tokens][:, None, :]
    cos, sin = M.rope_tables(pos[:, None], hd, cfg.rope_theta)
    for li, lp in enumerate(params["layers"]):
        y = M.rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
        if fuse:
            qkv = qmm(y, lp["wqkv"])
            q, kk, vv = qkv[..., :qdim], qkv[..., qdim:qdim + kvdim], qkv[..., qdim + kvdim:]
        else:
            q, kk, vv = qmm(y, lp["wq"]), qmm(y, lp["wk"]), qmm(y, lp["wv"])
        q = M.apply_rope(q.reshape(b, 1, h, hd), cos, sin)
        kk = M.apply_rope(kk.reshape(b, 1, hkv, hd), cos, sin)
        vv = vv.reshape(b, hkv, hd)
        if use_write:
            _write_kv(kv, li * n_pages, page_ids, offs, kk[:, 0].transpose(0, 1),
                      vv.transpose(0, 1))
        if use_attn:
            attn = paged_decode_attention(q[:, 0].reshape(b, hkv, h // hkv, hd).contiguous(),
                                          kv.k_pages, kv.v_pages, tables[li], kv_len,
                                          sliding_window=cfg.sliding_window,
                                          k_scales=kv.k_scales, v_scales=kv.v_scales)
            attn = attn.reshape(b, 1, qdim)
        else:
            attn = q.reshape(b, 1, qdim)
        x = x + qmm(attn, lp["wo"])
        y2 = M.rms_norm(x, lp["ln2"], cfg.rms_norm_eps)
        if fuse:
            gu = qmm(y2, lp["w_gu"])
            x = x + qmm(F.silu(gu[..., :f]) * gu[..., f:], lp["w_down"])
        else:
            x = x + M.mlp(y2, lp)
    x = M.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)[:, 0]
    if head == "none":
        nxt = x[:, :1].float().sum(-1).to(torch.int64)
    else:
        if head == "int8":
            logits = qmm(x, params["lm_head_q"]).float()
        else:
            logits = F.linear(x, params["lm_head"]).float()
        nxt = torch.argmax(torch.where(allow_masks, logits, NEG_INF), dim=-1)
    return torch.where(active, nxt, 0)


def run(params: dict, cfg: MistralConfig, dev: torch.device, replays: int = 30,
        ctx: int = CTX, page: int = PAGE, max_pages: int = MAX_PAGES) -> dict:
    """Every variant of VARIANTS for `params` (bf16/f32 or W8A8 layers) ->
    the JSON line's dict."""
    w8a8 = is_quantized(params["layers"][0]["wq"])
    fused = fuse_weights(params)
    b = 1
    tok = torch.zeros(b, dtype=torch.long, device=dev)
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    table = torch.arange(max_pages, dtype=torch.int32, device=dev)[None].contiguous()
    act = torch.ones(b, dtype=torch.bool, device=dev)
    allow = torch.ones(b, cfg.vocab_size, dtype=torch.bool, device=dev)
    kv = PagedKV.create(cfg, max_pages + 1, page, dev)
    out = {"weights": "w8a8" if w8a8 else cfg.dtype, "batch": b, "ctx": ctx, "page": page,
           "replays": replays, "ms": {}, "tokens": {}, "k6_launches": {}}
    for name, kw in VARIANTS.items():
        def step(kw=kw):
            return step_variant(fused, kv, cfg, tok, lens, table, act, allow, page, **kw)

        n0 = stream_qmv.launches
        out["tokens"][name] = step().tolist()
        out["k6_launches"][name] = stream_qmv.launches - n0
        out["ms"][f"{name}_ms"] = replay_ms(step, dev, replays)
    out["fused_tokens_equal"] = all(out["tokens"][a] == out["tokens"][c] for a, c in FUSED_PAIRS)
    return out


def main(argv=None) -> list:
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
    lines = []
    for w8a8 in (True, False):
        params = zero_params(cfg, dev, w8a8)
        line = run(params, cfg, dev, **geo)
        del params
        if w8a8 and not line["fused_tokens_equal"]:
            raise AssertionError(f"exp_decode2: the fused W8A8 variants' tokens differ: "
                                 f"{line['tokens']}")
        lines.append(line)
        print(json.dumps({"exp_decode2": line}), flush=True)
    print(json.dumps({"device": device_info(dev)}))
    return lines


if __name__ == "__main__":
    main()
