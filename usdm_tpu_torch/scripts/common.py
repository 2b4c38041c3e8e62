"""Shared parts of the matvec probes (exp_matvec, exp_int4, exp_stream_variants).

The probes time MLP chains of L distinct layers (D 4096, F 14336, L 16 as in
scripts/exp_*.py: 2 x 56 MB of int8 weights per layer, so nothing stays in
the card's 50 MB L2) under different matvec formulations and report the
effective rate over the weight bytes.  On the card (`--device cuda`, the
default; it raises without one) times are CUDA-event medians; `--device cpu`
runs the kernels' plain versions at small `--layers/--d/--f`, a plumbing
check whose times are no device metric.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict

import torch

from usdm_tpu_torch.ops.stream_matvec import quantize_rows

D, F, L = 4096, 14336, 16
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--layers", type=int, default=L)
    ap.add_argument("--d", type=int, default=D, help="model width")
    ap.add_argument("--f", type=int, default=F, help="MLP width")
    return ap


def device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available (pass --device cpu to run "
                           "the plain versions on the CPU)")
    return dev


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "plain versions", "count": 1}


def timeit(fn: Callable[[], object], dev: torch.device) -> float:
    """Milliseconds per call of fn(): median of 16 calls (the TPU scripts
    time 16) after one warm-up, each between CUDA events on the card (host
    clock on the CPU)."""
    fn()
    times = []
    for _ in range(16):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


quant_act = quantize_rows  # the TPU scripts' per-row symmetric int8: (qy, ys [M, 1])


def int_mm(qy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """qy [M, K] int8 @ w [K, N] int8 -> [M, N] int32 through torch._int_mm,
    with the rows zero-padded to 17 first: torch._int_mm on CUDA takes more
    than 16 rows, so a decode row runs as a 17-row product."""
    m = qy.shape[0]
    if m < INT_MM_MIN_ROWS:
        qy = torch.cat([qy, qy.new_zeros(INT_MM_MIN_ROWS - m, qy.shape[1])])
    return torch._int_mm(qy, w)[:m]


def rate(ms: float, n_bytes: int) -> Dict[str, float]:
    return {"ms": ms, "gbps": n_bytes / (ms / 1e3) / 1e9}


def counted_wrappers() -> tuple:
    """The kernel wrappers a probe chain calls; each counts its launches in
    `.launches`."""
    from usdm_tpu_torch.ops import int4_matvec, matvec_io, stream_matvec, stream_probe

    return (stream_matvec.stream_qmv, matvec_io.mv_io_bf16, matvec_io.mv_io_i8,
            int4_matvec.qmv4, stream_probe.stream_probe)


def graphed(fn: Callable[[], object], dev: torch.device) -> Callable[[], object]:
    """On the card: call fn once (kernels built, libraries initialized),
    capture one call in a CUDA graph and return its replay, so a chain of
    eager ops is timed as the device runs it, as the TPU scripts time their
    jitted chains.  The capture launches nothing, so it leaves the wrappers'
    launch counts as they were; every replay launches the captured kernels
    again and adds them to the counts.  On the CPU: fn itself."""
    if dev.type != "cuda":
        return fn
    fn()
    torch.cuda.synchronize(dev)
    wrappers = counted_wrappers()
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    captured = [w.launches - n for w, n in zip(wrappers, before)]
    for w, n in zip(wrappers, before):
        w.launches = n

    def replay() -> None:
        graph.replay()
        for w, k in zip(wrappers, captured):
            w.launches += k

    return replay


def device_time(replay: Callable[[], object]) -> dict:
    """Where a chain's time goes on the card: torch.profiler over 4 replays;
    `busy_ms` is the device time of all its kernels per call, `kernels` the
    three largest kernels' per call, by name."""
    from torch.profiler import ProfilerActivity, profile

    reps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            replay()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3 / reps
        if ms > 0:
            per[ev.key[:80]] = per.get(ev.key[:80], 0.0) + ms
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return {"busy_ms": sum(per.values()), "kernels": dict(ranked)}


def run(results: dict, name: str, fn: Callable[[], object], dev: torch.device,
        n_bytes: int) -> None:
    """Time fn (graphed) into results[name], with its device time by kernel
    on the card."""
    replay = graphed(fn, dev)
    results[name] = rate(timeit(replay, dev), n_bytes)
    if dev.type == "cuda":
        results[name]["device"] = device_time(replay)
    print(name, json.dumps(results[name]), flush=True)


def emit(probe: str, dev: torch.device, args, results: dict) -> dict:
    """Print the probe's one JSON line and return it."""
    out = {"probe": probe, "device": device_info(dev),
           "shape": {"d": args.d, "f": args.f, "layers": args.layers}, "results": results}
    print(json.dumps(out), flush=True)
    return out
