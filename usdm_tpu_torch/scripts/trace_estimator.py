"""A device trace of the Voicebox estimator at the ODE's shape, split by op group.

    python -m usdm_tpu_torch.scripts.trace_estimator [--out-dir DIR]   # on the card
    python -m usdm_tpu_torch.scripts.trace_estimator --device cpu --tiny

Port of scripts/trace_estimator.py.  One call of `models/voicebox.py::
estimator` at [B 2, T 449] (respond()'s CFG batch of one 5.2 s answer) is
warmed up, then 5 calls run under torch.profiler, for three weight kinds:
"zero_bf16" (every leaf zero in bf16, as the TPU script), "float" (f32
random weights, the bf16 turn's Voicebox) and "w8a8" (those weights
through `quantize_voicebox_params`, the W8A8 turn's).  The inputs are the
same seeded units and mels for all three.  Each kind writes its Chrome
trace, gzipped, to `<out-dir>/trace_estimator_<kind>.json.gz` and prints
one JSON line: per call, the device ms of each op group and of all device
ops ("clock": "device"), the device's busy share of the wall time of the
5 calls, and the device ops (kernels, copies, fills) run.  The groups are profiler spans
around the estimator's calls, the device time of a span that of the device
ops its ops launched:

  products    `qmm`: a cuBLAS product for float weights; for W8A8 the
              rows quantized, torch._int_mm and the epilogue (more than 16
              rows: the estimator never reaches K6)
  layer_norm  the post-LN LayerNorms, plain (B * (T + 1) = 900 is under
              K4's gate of 3,072: `add_mask_ln` when it passes)
  attention   K2 (flash_attention; bf16 or f32 3xTF32 by the dtype)
  convpos     the two grouped 31-wide positional convolutions with their
              GELU and mask (`ops/conv.py`)
  other       the rest: proj_in/out, the skip concatenations, residual
              adds, masks, GELUs, casts

The TPU script's split is the question: the ODE calls the estimator 49
times a turn, and the W8A8 ODE is slower than the float one.  Without a
card it raises; `--device cpu --tiny` runs the plain versions at toy size
under the profiler's CPU activity (a plumbing check: "clock": "host", its
spans' host times, no device metric).
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import shutil
import time

import torch

from usdm_tpu_torch.core.config import VoiceboxConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.models.quant import quantize_voicebox_params
from usdm_tpu_torch.scripts.common import device, device_info

B, T, CALLS = 2, 449, 5
KINDS = ("zero_bf16", "float", "w8a8")
# the estimator's module-level names each group wraps (looked up at call time)
GROUPS = {"products": ("qmm",), "layer_norm": ("layer_norm", "add_mask_ln"),
          "attention": ("flash_attention", "plain_attention"), "convpos": ("_conv_pos_embed",)}
SPAN = "trace_estimator::"


@contextlib.contextmanager
def group_spans():
    """While the block runs, each of the estimator's calls named in GROUPS
    runs inside a profiler span named after its group."""
    saved = {}

    def spanned(fn, group):
        def call(*a, **kw):
            with torch.profiler.record_function(SPAN + group):
                return fn(*a, **kw)
        return call

    for group, names in GROUPS.items():
        for name in names:
            saved[name] = getattr(VB, name)
            setattr(VB, name, spanned(saved[name], group))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(VB, name, fn)


def weights(cfg: VoiceboxConfig, dev: torch.device, kind: str) -> dict:
    """The estimator's weights of `kind` (one of KINDS) on `dev`."""
    if kind == "zero_bf16":
        shapes = VB.init_params(cfg, torch.Generator(), device="meta")
        return tree_map(lambda s: torch.zeros(tuple(s.shape), dtype=torch.bfloat16, device=dev),
                        shapes)
    params = VB.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return quantize_voicebox_params(params) if kind == "w8a8" else params


def inputs(cfg: VoiceboxConfig, dev: torch.device, b: int = B, t: int = T) -> tuple:
    """Seeded units [b, t], noisy and conditioning mels [b, n_feats, t] in
    f32 (the estimator casts them), flow times [b], lengths [b]."""
    gen = torch.Generator(device=dev).manual_seed(1)
    return (torch.randint(0, cfg.n_tokens + 1, (b, t), generator=gen, device=dev),
            torch.randn(b, cfg.n_feats, t, generator=gen, device=dev),
            torch.randn(b, cfg.n_feats, t, generator=gen, device=dev),
            torch.rand(b, generator=gen, device=dev),
            torch.full((b,), t, dtype=torch.long, device=dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def split(prof, calls: int, on_card: bool) -> dict:
    """The profile's time by group, per call, in ms: on the card the device
    time of the ops each span launched, all device ops' time and their
    count; on the CPU the spans' host time."""
    from torch.autograd import DeviceType

    groups = {g: 0.0 for g in GROUPS}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith(SPAN):
            us = ev.device_time_total if on_card else ev.cpu_time_total
            groups[ev.name[len(SPAN):]] += us / 1e3 / calls
    if not on_card:
        return {"clock": "host", "groups_ms": groups, "total_ms": sum(groups.values()),
                "device_ops": None}
    ops = [ev for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
    total = sum(ev.self_device_time_total for ev in ops) / 1e3 / calls
    return {"clock": "device", "groups_ms": {**groups, "other": total - sum(groups.values())},
            "total_ms": total, "device_ops": len(ops) / calls}


def run(params: dict, cfg: VoiceboxConfig, dev: torch.device, kind: str, out_dir: str,
        calls: int = CALLS, b: int = B, t: int = T) -> dict:
    """One weight kind: warm-up, then `calls` profiled calls -> the JSON
    line's dict; the trace goes to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile

    args = inputs(cfg, dev, b, t)
    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with torch.no_grad(), group_spans():
        out = VB.estimator(params, cfg, *args)
        _sync(dev)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                out = VB.estimator(params, cfg, *args)
            _sync(dev)
            wall = time.perf_counter() - t0
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"trace_estimator {kind}: non-finite output")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_estimator_{kind}.json")
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    line = {"weights": kind, "batch": b, "frames": t, "calls": calls,
            "dtype": str(params["proj_in_w"].dtype)[6:], "wall_ms": wall / calls * 1e3,
            **split(prof, calls, on_card), "trace": path + ".gz",
            "output_shape": list(out.shape)}
    line["busy"] = line["total_ms"] / line["wall_ms"] if on_card else None
    return line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--out-dir", default="trace_estimator_out",
                    help="where the gzipped Chrome traces are written")
    ap.add_argument("--tiny", action="store_true", help="VoiceboxConfig.tiny() (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    cfg = VoiceboxConfig.tiny() if args.tiny else VoiceboxConfig()
    geo = {"b": 2, "t": 40} if args.tiny else {}
    lines = []
    for kind in KINDS:
        params = weights(cfg, dev, kind)
        lines.append(run(params, cfg, dev, kind, args.out_dir, **geo))
        del params
        print(json.dumps({"trace_estimator": lines[-1]}), flush=True)
    print(json.dumps({"device": device_info(dev)}))
    return lines


if __name__ == "__main__":
    main()
