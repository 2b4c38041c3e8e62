"""ODE wall time and drift of the W8A8 Voicebox estimator.

Port of scripts/bench_vb_int8.py, the drift gate behind
`from_pretrained(vb_int8=True)`: the full 50-step Heun CFG ODE
(models/voicebox.py `generate`) at product geometry — `VoiceboxConfig()`,
one row CFG-doubled to 2, 430 frames (5 s at 86.13 Hz), bf16 master weights
(every leaf N(0, 0.02^2) from a torch generator of seed 0) — with and
without `quantize_voicebox_params`.  Each runs one warm-up call, then 5
timed calls (host clock around a call that ends in a synchronise).  It
prints every time, the minimum (the JAX script's rule) and the median, each
also as RTF = time / audio seconds, then the drift nRMS of the W8A8 mel
against the bf16 one, and asserts nRMS < 1e-2, the JAX script's gate.
Beside the drift it prints `ode_share`, RMS(mel - z) / RMS(mel) of the bf16
run: how much of the mel the estimator's velocity moved away from the
shared initial noise z, the part that quantization can reach.

    python -m usdm_tpu_torch.scripts.bench_vb_int8

`--device cuda` (the default) raises without a card; `--device cpu` runs
the plain versions, whose times are no device metric.  Prints one JSON line
last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from usdm_tpu_torch.core.config import VoiceboxConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.models.quant import quantize_voicebox_params
from usdm_tpu_torch.scripts.common import device, device_info

NRMS_GATE = 1e-2


def random_bf16_params(cfg: VoiceboxConfig, dev: torch.device) -> dict:
    """The estimator's tree with every leaf N(0, 0.02^2), in bf16."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = VB.init_params(cfg, torch.Generator(), device="meta")
    return tree_map(lambda s: (torch.randn(tuple(s.shape), generator=gen, device=dev) * 0.02)
                    .to(torch.bfloat16), shapes)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: VoiceboxConfig, dev: torch.device, frames: int = 430, steps: int = 50,
        reps: int = 5) -> dict:
    """Both runs and the drift; raises if the drift gate fails."""
    seconds = frames * 256 / 22050.0
    params = random_bf16_params(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, cfg.n_tokens, (1, frames), generator=gen, device=dev)
    cond = torch.zeros((1, cfg.n_feats, frames), device=dev)
    z = torch.randn(cond.shape, generator=gen, device=dev)
    lengths = torch.tensor([frames], device=dev)
    out = {"device": device_info(dev), "frames": frames, "audio_s": seconds, "steps": steps,
           "reps": reps, "runs": {}}
    mels = {}
    trees = (("bf16", params),
             ("int8", lambda: quantize_voicebox_params(tree_map(lambda t: t.clone(), params))))
    for name, p in trees:
        p = p() if callable(p) else p

        def call():
            with torch.no_grad():
                mel = VB.generate(p, cfg, x, cond, lengths, n_timesteps=steps, solver="heun",
                                  gradient_scale=1.0, z=z)
            _sync(dev)
            return mel

        t0 = time.perf_counter()
        call()
        first = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            mel = call()
            times.append(time.perf_counter() - t0)
        mels[name] = mel.double().cpu()
        out["runs"][name] = {"first_s": first, "ode_s": times, "min_s": min(times),
                             "median_s": statistics.median(times),
                             "rtf_min": min(times) / seconds,
                             "rtf_median": statistics.median(times) / seconds}
        print(f"{name}: ode min {min(times):.4f} s median {statistics.median(times):.4f} s "
              f"(first {first:.2f} s, runs {[round(t, 4) for t in times]})", flush=True)
    d = mels["int8"] - mels["bf16"]
    nrms = float(d.square().mean().sqrt() / (mels["bf16"].square().mean().sqrt() + 1e-9))
    z64 = z.double().cpu()
    out["nrms"] = nrms
    out["ode_share"] = float((mels["bf16"] - z64).square().mean().sqrt()
                             / mels["bf16"].square().mean().sqrt())
    out["speedup_min"] = out["runs"]["bf16"]["min_s"] / out["runs"]["int8"]["min_s"]
    print(f"drift: normalized RMS {nrms:.6f} (ode_share {out['ode_share']:.4f}); speedup "
          f"{out['speedup_min']:.3f}x", flush=True)
    if not nrms < NRMS_GATE:
        raise AssertionError(f"int8 estimator drift broke: nRMS={nrms:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    args = ap.parse_args(argv)
    out = run(VoiceboxConfig(), device(args.device))
    print(json.dumps({"bench_vb_int8": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
