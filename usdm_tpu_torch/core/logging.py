"""Metrics logging: a JSONL stream, TensorBoard through torch's
SummaryWriter when it is installed and asked for, audio smoke tests
(usdm_tpu's MetricsLogger), and `profile_trace` around chosen steps."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    """`enabled` False (a rank other than 0 of a process group): writes
    nothing."""

    def __init__(self, out_dir: str, use_tensorboard: bool = True, enabled: bool = True):
        self.enabled = enabled
        if not enabled:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "train") -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[f"{prefix}/{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def log_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """An audible smoke test: to TensorBoard when it is on, else a wav
        file `audio_<tag>_<step>.wav` in the output directory."""
        import numpy as np

        if not self.enabled:
            return
        if self._tb is not None:
            import torch

            self._tb.add_audio(tag, torch.from_numpy(np.asarray(wav))[None], step, sample_rate)
        else:
            from usdm_tpu_torch.audio.wav import write_wav

            path = os.path.join(self.out_dir, f"audio_{tag.replace('/', '_')}_{step}.wav")
            write_wav(path, np.asarray(wav), sample_rate)

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in µs."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Trace the enclosed steps with torch.profiler (host, and CUDA when
    there is a card) and write under `out_dir`: the Chrome trace
    `trace.json`, the table `kernels.txt` (self time by name) and
    `summary.json` {wall_s, device_sum_s, copy_sum_s, kernel_sum_s, busy_s,
    kernel_busy_s, device_busy}: the window's wall time (ended by a device
    synchronize); the summed time of its device events, split into memory
    copies and kernels (copies on side streams overlap the kernels, so the
    sum can pass the wall time); the time the device ran any event, and any
    kernel (the union of their intervals in the trace); and busy_s / wall_s.
    usdm_tpu's counterpart writes a jax.profiler trace there."""
    import torch
    from torch.autograd import DeviceType

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    events = prof.key_averages()
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total" if cuda else "self_cpu_time_total",
                             row_limit=50))
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_s = sum(e.self_device_time_total for e in device) / 1e6
    copy_s = sum(e.self_device_time_total for e in device if e.key.startswith("Memcpy")) / 1e6
    with open(trace) as f:
        spans = [(e.get("cat"), e["ts"], e["ts"] + e["dur"]) for e in json.load(f)["traceEvents"]
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy = union_seconds((a, b) for _, a, b in spans)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"wall_s": wall, "device_sum_s": device_s, "copy_sum_s": copy_s,
                   "kernel_sum_s": device_s - copy_s, "busy_s": busy,
                   "kernel_busy_s": union_seconds((a, b) for c, a, b in spans if c == "kernel"),
                   "device_busy": busy / wall}, f)
