"""Parity and RTF of BigVGAN with K3 (the fused anti-aliased snake) off and on.

Port of scripts/bench_fused_act.py, the gate that earned
`BigVGANConfig.fused_act=True`: BigVGAN at the full 22khz_80band width
(`BigVGANConfig()`), bf16 weights from numpy seed 0 (std 0.02; every leaf
drawn from a fresh generator of that seed, as the JAX script draws them, in
the port's layouts) and a 10 s mel from numpy seed 1 (1 x 80 x 861 frames),
run with `fused_act` off, then on.  Each run makes one warm-up call, then
5 timed calls (host clock around a call that ends in a synchronise).
It prints every time, the minimum (the JAX script's rule, unmarked there) and
the median, each as RTF = time / audio seconds; then parity max|d|, mean|d|
and rel = mean|d| / mean|unfused| between the two waveforms, and asserts
rel < 6e-2, the JAX script's own gate.  On the card it also counts K3's
launches in one generator call, which must be one per activation (109 at
this width: 6 stages x 3 AMP blocks x 3 dilations x 2, plus the last).

    python -m usdm_tpu_torch.scripts.bench_fused_act          # on the card
    python -m usdm_tpu_torch.scripts.bench_fused_act --device cpu --tiny --seconds 0.5

`--device cuda` (the default) raises without a card; `--device cpu` runs the
plain versions (K3 does not launch there), a plumbing check whose times are
no device metric.  Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from usdm_tpu_torch.core.config import BigVGANConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.ops.fused_act import fused_activation1d
from usdm_tpu_torch.scripts.common import device, device_info

REL_GATE = 6e-2


def k3_launches_per_call(cfg: BigVGANConfig) -> int:
    """Activations in one generator call: each AMP block runs 2 per dilation
    (resblock "1") or 1 ("2"), then the last activation."""
    per_block = sum((2 if cfg.resblock == "1" else 1) * len(d)
                    for d in cfg.resblock_dilation_sizes)
    return len(cfg.upsample_rates) * per_block + 1


def random_bf16_params(cfg: BigVGANConfig, dev: torch.device) -> dict:
    """The generator's tree with every leaf N(0, 0.02^2) from
    np.random.default_rng(0), in bf16."""
    shapes = BV.init_generator(cfg, torch.Generator(), device="meta")
    return tree_map(lambda s: torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(s.shape)) * 0.02)
        .to(dev, torch.bfloat16), shapes)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device) -> tuple:
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return time.perf_counter() - t0, out


def run(cfg: BigVGANConfig, dev: torch.device, seconds: float = 10.0, reps: int = 5) -> dict:
    """Both runs, parity and K3's launches per call; raises if the parity
    gate or (on the card) the launch count fails."""
    frames = int(seconds * cfg.sampling_rate) // 256
    params = random_bf16_params(cfg, dev)
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, cfg.num_mels, frames))).to(dev, torch.bfloat16)
    out = {"device": device_info(dev), "seconds": seconds, "frames": frames, "reps": reps,
           "runs": {}}
    wavs = {}
    for fused in (False, True):
        c = cfg.replace(fused_act=fused)
        first_s, _ = _timed(lambda: BV.generator(params, c, mel), dev)
        times = []
        for _ in range(reps):
            before = fused_activation1d.launches
            dt, w = _timed(lambda: BV.generator(params, c, mel), dev)
            times.append(dt)
            launches = fused_activation1d.launches - before
        wavs[fused] = w.float().cpu().numpy()
        key = "fused" if fused else "unfused"
        r = {"first_call_s": first_s, "times_s": times, "min_s": min(times),
             "median_s": statistics.median(times), "rtf_min": min(times) / seconds,
             "rtf_median": statistics.median(times) / seconds, "k3_launches_per_call": launches}
        out["runs"][key] = r
        print(f"fused_act={fused}: rtf {r['rtf_min']:.4f} (min of {reps}), "
              f"{r['rtf_median']:.4f} (median); first call {first_s:.3f} s; runs "
              f"{[round(t, 4) for t in times]} s; K3 launches per call {launches}", flush=True)
    d = np.abs(wavs[True] - wavs[False])
    rel = float(d.mean() / (np.abs(wavs[False]).mean() + 1e-9))
    out["parity"] = {"max_abs": float(d.max()), "mean_abs": float(d.mean()), "rel": rel}
    unf, fus = out["runs"]["unfused"], out["runs"]["fused"]
    out["speedup_min"] = unf["min_s"] / fus["min_s"]
    out["speedup_median"] = unf["median_s"] / fus["median_s"]
    print(f"parity: max|d|={d.max():.3e} mean|d|={d.mean():.3e} rel={rel:.3e}")
    print(f"speedup: {out['speedup_min']:.3f}x by the minimum ({unf['rtf_min']:.4f} -> "
          f"{fus['rtf_min']:.4f}), {out['speedup_median']:.3f}x by the median "
          f"({unf['rtf_median']:.4f} -> {fus['rtf_median']:.4f})", flush=True)
    if not rel < REL_GATE:
        raise AssertionError(f"fused/unfused parity broke: rel={rel:.3e} (gate {REL_GATE})")
    print(f"parity gate: OK (rel < {REL_GATE})")
    if dev.type == "cuda":
        want = k3_launches_per_call(cfg)
        if fus["k3_launches_per_call"] != want or unf["k3_launches_per_call"] != 0:
            raise AssertionError(f"K3 launched {fus['k3_launches_per_call']} times in a fused "
                                 f"call ({unf['k3_launches_per_call']} unfused), want {want}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--seconds", type=float, default=10.0, help="clip length (JAX script: 10)")
    ap.add_argument("--tiny", action="store_true", help="BigVGANConfig.tiny() (CPU checks)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    cfg = BigVGANConfig.tiny() if args.tiny else BigVGANConfig()
    out = run(cfg, dev, args.seconds)
    out["config"] = "tiny" if args.tiny else "22khz_80band"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
