"""`train/lm.py::memory_budget` against the measured peak of a resident LM train step, on one card.

    python -m usdm_tpu_torch.scripts.validate_memory_budget  # on the card
    python -m usdm_tpu_torch.scripts.validate_memory_budget --device cpu --tiny

Port of scripts/validate_memory_budget.py.  memory_budget is closed-form
arithmetic; this holds it against `torch.cuda.max_memory_allocated` over
one resident train step of `train/lm.py::make_train_step` (dp 1, batch 1,
f32 masters and AdamW moments on the card, bf16 compute, per-layer remat,
the CE in 1,024-token chunks: `TrainConfig()`).  The TPU script's three
geometries: the 7B's layer structure shrunk to hidden 1024, FFN 3584, GQA
8/2, head_dim 128, with the full 42,003 vocab (the logits term at real
scale), at 8 and 16 layers and 8,192 tokens, and at 8 layers and 4,096
tokens, so each term is isolated by one change.  For each: the peak device
memory of the state's creation and two steps (peak statistics reset
first, the card's prior allocation subtracted), the second step's wall
time, and memory_budget(cfg, dp=1, seq_len, batch_per_chip=1, hbm_gb=80)'s
device_gb, fwd_bwd_peak_gb and update_peak_gb with model / measured.  The
steps run K2 and K5 bf16 at d 128 (GQA 8/2, causal, window 4,096).  The TPU
script's 7B dp 8 AOT branch: with eight cards, one step of the sharded
trainer (train/lm.py, FSDP over 8 ranks, the full-width 7B, one 8,192-token
row a rank) and its measured peak on rank 0 against memory_budget(dp=8);
with fewer, one line refuses by name ("needs eight cards").  Prints one JSON
line per geometry.  Without a card it
raises; `--device cpu --tiny` runs three toy geometries (a plumbing check:
no memory is measured on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import torch

from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.scripts.common import device, device_info
from usdm_tpu_torch.train import lm as T

GiB = 1 << 30
HBM_GB = 80.0
_BASE = {"hidden_size": 1024, "intermediate_size": 3584, "num_heads": 8, "num_kv_heads": 2}
GEOMETRIES = ({**_BASE, "num_layers": 8}, {**_BASE, "num_layers": 16},
              {**_BASE, "num_layers": 8, "max_seq_len": 4096})
TINY_GEOMETRIES = tuple({**dataclasses.asdict(MistralConfig.tiny()), "dtype": "bfloat16", **g}
                        for g in ({}, {"num_layers": 4}, {"max_seq_len": 128}))
BUDGET_KEYS = ("device_gb", "fwd_bwd_peak_gb", "update_peak_gb")


def budget(cfg: MistralConfig, hbm_gb: float = HBM_GB) -> dict:
    """memory_budget at one card, the geometry's sequence, batch 1."""
    return T.memory_budget(cfg, dp=1, seq_len=cfg.max_seq_len, batch_per_chip=1, hbm_gb=hbm_gb)


def _batch(seq: int, dev: torch.device) -> dict:
    """One row of `seq` zero tokens, one segment (the TPU script's batch)."""
    zeros = torch.zeros(1, seq, dtype=torch.int32, device=dev)
    return {"input_ids": zeros, "labels": zeros.clone(), "segment_ids": zeros.clone(),
            "positions": torch.arange(seq, dtype=torch.int32, device=dev)[None]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cfg: MistralConfig, dev: torch.device, seed: int = 0) -> dict:
    """One geometry: its budget against the measured peak -> its line."""
    tc = TrainConfig()
    gc.collect()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state = T.init_state(cfg, tc, dev, torch.Generator(device=dev).manual_seed(seed))
    step = T.make_train_step(cfg, tc)
    batch = _batch(cfg.max_seq_len, dev)
    metrics = step(state, batch)
    _sync(dev)
    t0 = time.perf_counter()
    metrics = step(state, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    measured = (torch.cuda.max_memory_allocated(dev) - base) / GiB if on_card else None
    b = budget(cfg)
    del state, step, metrics
    gc.collect()
    line = {"hidden": cfg.hidden_size, "layers": cfg.num_layers, "vocab": cfg.vocab_size,
            "seq": cfg.max_seq_len, "step_s": step_s, "loss": loss,
            "measured_peak_gb": measured, **{k: b[k] for k in BUDGET_KEYS},
            "model_over_measured": b["device_gb"] / measured if measured else None}
    if not loss == loss:  # NaN
        raise AssertionError(f"validate_memory_budget: NaN loss at {line}")
    return line


def dp8_rank(rank: int, seq: int) -> dict:
    """One rank of the 7B dp 8 step: the sharded resident state, two steps
    on one row of `seq` zero tokens a rank -> rank 0's line."""
    from usdm_tpu_torch.core import mesh as MS

    mesh = MS.create_mesh(dp=8, tp=1, device="cuda")
    dev = mesh.device
    cfg = MistralConfig().replace(dtype=T.COMPUTE_DTYPE, max_seq_len=seq)
    tc = TrainConfig()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    state = T.init_state(cfg, tc, dev, torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    step = T.make_train_step(cfg, tc, mesh)
    batch = _batch(seq, dev)
    step(state, batch)
    _sync(dev)
    t0 = time.perf_counter()
    loss = float(step(state, batch)["loss"])
    step_s = time.perf_counter() - t0
    measured = (torch.cuda.max_memory_allocated(dev) - base) / GiB
    b = T.memory_budget(cfg, dp=8, seq_len=seq, batch_per_chip=1, hbm_gb=HBM_GB)
    return {"hidden": cfg.hidden_size, "layers": cfg.num_layers, "vocab": cfg.vocab_size,
            "seq": seq, "dp": 8, "step_s": step_s, "loss": loss, "measured_peak_gb": measured,
            **{k: b[k] for k in BUDGET_KEYS}, "model_over_measured": b["device_gb"] / measured}


def dp8_line(dev: torch.device) -> dict:
    """The 7B dp 8 branch: run on eight cards, else refused by name."""
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n < 8:
        return {"7B_dp8": f"not run: needs eight cards, this host has {n}"}
    from usdm_tpu_torch.engine import tp as TP

    return {"7B_dp8": TP.launch(8, "cuda", dp8_rank, 8192)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true", help="toy geometries (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    lines = []
    for g in TINY_GEOMETRIES if args.tiny else GEOMETRIES:
        lines.append(measure(MistralConfig(**g), dev))
        print(json.dumps({"validate_memory_budget": lines[-1]}), flush=True)
    print(json.dumps({"validate_memory_budget": dp8_line(dev)}))
    print(json.dumps({"device": device_info(dev)}))
    return lines


if __name__ == "__main__":
    main()
