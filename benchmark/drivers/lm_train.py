"""LM fine-tuning steps: one trainer object, built as the port's CLIs build
it (cli/lm_trainer.py: full training with the AdamW moments offloaded to
pinned host memory, or LoRA adapters over the frozen base), fed packed
rows through the trainer's own feed (`to_device`).

Set-up makes the seed's f32 masters on the card and drives the trainer
through its first two steps, which the check reads (each step's loss, the
first gradient from the optimizer's moments, the change after step 2),
then hands the same object to the window, which runs steps back to back
until `seconds` have passed, each ended by reading its loss."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.lib import weights as W
from benchmark.lib.registry import generator


def _configs(cfg: dict, mix: dict):
    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig

    lm = MistralConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                       intermediate_size=cfg["intermediate_size"],
                       num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
                       num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                       rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
                       sliding_window=cfg["sliding_window"],
                       max_seq_len=cfg["max_position_embeddings"], dtype="bfloat16")
    tc = TrainConfig(**mix["train"])
    return lm, tc


def opt_of(mix: dict) -> dict:
    """The optimizer's numbers as the reference takes them, from the mix's
    file (the trainer's defaults, written out)."""
    t = mix["train"]
    return {"lr": t["learning_rate"], "warmup": max(int(t["max_steps"] * t["warmup_ratio"]), 1),
            "total": t["max_steps"], "b1": t["adam_b1"], "b2": t["adam_b2"],
            "eps": mix["adam_eps"], "wd": t["weight_decay"], "clip": t["grad_clip"]}


def lora_spec(cfg: dict, mix: dict) -> Optional[dict]:
    lo = mix.get("lora")
    if lo is None:
        return None
    q, kv = cfg["num_attention_heads"] * cfg["head_dim"], cfg["num_key_value_heads"] * cfg["head_dim"]
    shapes = {"wq": (cfg["hidden_size"], q), "wk": (cfg["hidden_size"], kv),
              "wv": (cfg["hidden_size"], kv), "wo": (q, cfg["hidden_size"])}
    return {"r": lo["r"], "alpha": lo["alpha"], "b_std": lo["b_std"],
            "targets": {t: shapes[t] for t in lo["targets"]}}


def build_trainer(cfg: dict, mix: dict, seed: int, device):
    """The program under test -> (step(batch) -> metrics, the leaves in
    tree order, the optimizer state)."""
    import torch
    from usdm_tpu_torch.cli import lm_trainer as LT
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.train import lm as T
    from usdm_tpu_torch.train import lora as LO

    lm, tc = _configs(cfg, mix)
    params = W.make_params(cfg, seed, device, torch.float32)
    lo = lora_spec(cfg, mix)
    if lo is None:
        trainer = LT.make_trainer(lm, tc, device, None, base=params,
                                  offload=mix["offload_moments"])
        del params
        return trainer.step, tree_leaves(trainer.state.params), trainer.state.opt_state, trainer
    adapters = W.make_lora(cfg, seed, lo["r"], lo["alpha"], lo["targets"], lo["b_std"], device)
    for t in tree_leaves(adapters):
        t.requires_grad_(True)
    step, opt = LO.make_lora_train_step(lm, tc)
    state = T.TrainState(adapters, opt.init(adapters), 0)
    return (lambda batch: step(params, state, batch)), tree_leaves(adapters), state.opt_state, state


def _leaf_names(cfg: dict, lo: Optional[dict]) -> List[str]:
    from benchmark.reference.mistral import _leaf_order

    return _leaf_order(cfg, None if lo is None else list(lo["targets"]))


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        fault: Optional[str] = None) -> dict:
    import torch
    from usdm_tpu_torch.cli.lm_trainer import to_device

    from benchmark.lib.trace import Window

    cfg, mix = cell["config"], cell["traffic"]
    gen = generator(mix["generator"])
    vocab = cfg["vocab_size"]
    lo = lora_spec(cfg, mix)
    names = _leaf_names(cfg, lo)
    step, leaves, opt_state, keep = build_trainer(cfg, mix, seed, device)
    if fault is not None:
        step = _plant_fault(step, fault, leaves)

    def feed(k):
        return to_device(gen.row(mix, vocab, seed, k), device)

    # the checked steps: 1 and 2, through the window's own call and feed
    losses = []
    out = step(feed(0))
    losses.append(float(out["loss"]))
    sync(device)
    b1 = mix["train"]["adam_b1"]
    grad_norms = {n: float(m.to(device, non_blocking=True).double().norm()) / (1 - b1)
                  for n, m in zip(names, opt_state.m)}
    out = step(feed(1))
    losses.append(float(out["loss"]))
    sync(device)
    change = _change_norms(cfg, mix, seed, leaves, names, lo, device)
    setup_s = time.perf_counter() - t0

    steps: List[tuple] = []
    k = 2
    w0 = time.perf_counter()
    deadline = w0 + seconds
    win, tr, traced = None, None, 0
    while time.perf_counter() < deadline or (win is not None and win.t1 is None):
        if trace and device.type == "cuda" and win is None and k - 2 == mix["trace"]["skip_steps"]:
            win = Window()
            win.start()
        a = time.perf_counter()
        with torch.profiler.record_function("bench.train_step"):
            out = step(feed(k))
            loss = float(out["loss"])
        b = time.perf_counter()
        steps.append((a, b, mix["row_tokens"], loss))
        k += 1
        if win is not None and win.t1 is None:
            traced += 1
            if traced == mix["trace"]["steps"]:
                win.stop()
    w1 = time.perf_counter()
    if win is not None:
        tr = win.reduce()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    failed = sum(1 for s in steps if not np.isfinite(s[3]))
    del step, leaves, opt_state, keep, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec = {"kind": "lm_train", "config": cfg, "traffic": mix, "window": (w0, w1),
           "seconds": seconds, "steps": steps, "setup_s": setup_s, "trace": tr,
           "traced_steps": traced if tr is not None else 0,
           "doc_lengths": gen.doc_lengths(mix), "lora": lo}
    checks = check(cfg, mix, seed, losses, grad_norms, change, lo, gen, device)
    return {"rec": rec, "attempted": len(steps), "failed": failed, "errors": [],
            "memory_peak_bytes": peak, "checks": checks,
            "notes": [f"steps in the window: {len(steps)}, {w1 - w0:.3f} s",
                      f"worst leaves (gap, leaf, program, reference): {check.worst}"]}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _change_norms(cfg, mix, seed, leaves, names, lo, device) -> Dict[str, float]:
    """Each leaf's change from the seed's starting value, made again here."""
    import torch

    out = {}
    with torch.no_grad():
        if lo is not None:
            start = W.make_lora(cfg, seed, lo["r"], lo["alpha"], lo["targets"], lo["b_std"], device)
            ref = [a[t][p] for a in start for t in a for p in ("a", "b", "scale")]
            for n, p, p0 in zip(names, leaves, ref):
                out[n] = float((p.detach().double() - p0.double()).norm())
            return out
        by_name = dict(zip(names, leaves))
        outer = W.make_outer(cfg, seed, device, torch.float32)
        for k in ("embed", "final_norm", "lm_head"):
            out[k] = float((by_name[k].detach() - outer[k]).double().norm())
        del outer
        for i in range(cfg["num_hidden_layers"]):
            layer = W.make_layer(cfg, seed, i, device, torch.float32)
            for k, v in layer.items():
                n = f"layers.{i}.{k}"
                out[n] = float((by_name[n].detach() - v).double().norm())
    return out


def _plant_fault(step, fault: str, leaves):
    """Faults for the benchmark's own test: `unchanged`, a step that leaves
    the state as it was; `half_batch`, the second half of the row's labels
    left out (the mean taken over the rest)."""
    import torch

    if fault == "unchanged":
        def frozen(batch):
            saved = [p.detach().clone() for p in leaves]
            out = step(batch)
            with torch.no_grad():
                for p, s in zip(leaves, saved):
                    p.copy_(s)
            return out
        return frozen
    if fault == "half_batch":
        def half(batch):
            lab = batch["labels"].clone()
            lab[:, lab.shape[1] // 2:] = -100
            return step({**batch, "labels": lab})
        return half
    raise ValueError(f"unknown fault {fault!r}")


def compare(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float],
            stat: str = "worst", worst_of: Optional[list] = None) -> float:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's; leaves
    whose reference gradient is under a thousandth of the median leaf's are
    left out (they move by round-off alone).  -> the worst leaf's gap, or
    with `stat` "median" the median leaf's (the mix's file says which)."""
    med_g = float(np.median(list(ref_grad.values())))
    keep = [n for n in ref if ref_grad[n] >= 1e-3 * med_g]
    med = float(np.median([ref[n] for n in keep]))
    gaps = [(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n, prog[n], ref[n]) for n in keep]
    if worst_of is not None:
        worst_of.extend(sorted(gaps, reverse=True)[:3])
    values = [g[0] for g in gaps]
    return max(values) if stat == "worst" else float(np.median(values))


def check(cfg, mix, seed, losses, grad_norms, change, lo, gen, device) -> Dict[str, dict]:
    """Steps 1 and 2 against the plain reference: each step's loss
    (relative), the first gradient's and the change's leaf gaps (the worst
    leaf's, or the median leaf's where the mix says so); the mix's limits
    name the numbers compared."""
    import torch

    from benchmark.reference.mistral import train_readings

    batches = [{k: torch.from_numpy(v).to(device) for k, v in gen.row(mix, cfg["vocab_size"],
                                                                         seed, j).items()}
               for j in (0, 1)]
    ref = train_readings(cfg, seed, batches, device, opt_of(mix), lora=lo)
    lim = mix["limits"]
    wg, wc = [], []
    stat = mix["leaf_stat"]
    readings = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
                "grad_gap": compare(grad_norms, ref["grad"], ref["grad"], stat, wg),
                "change_gap": compare(change, ref["change"], ref["grad"], stat, wc)}
    # a number the mix gives no limit is read and printed, not compared
    out = {k: {"value": v, "limit": lim[k]} for k, v in readings.items() if k in lim}
    check.worst = {"losses": [losses, ref["losses"]], "grad": wg, "change": wc,
                   "not compared": {k: v for k, v in readings.items() if k not in lim}}
    return out
