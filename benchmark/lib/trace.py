"""A torch.profiler window over the card, reduced to what the readers use:
the window's length, the union of the device's busy intervals, every
device operation's name, start and end, the host's events (operators and
the benchmark's own spans, or the CUDA runtime's calls alone), and the
longest idle gaps with what the host was doing then."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def union_s(intervals: List[Interval]) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Window:
    """Profile the card between start() and stop(), both called on the
    thread that launches the card's work; reduce(), called once the
    measured window is over, -> the reduced trace (times in seconds on the
    trace's clock).  `t0`, `t1`: start and stop on the host clock.  With
    `host_ops` False only the card's activity and the CUDA runtime's calls
    are recorded, not every operator of every host thread (whose recording
    slows a host-bound program and whose collection at stop() stalls it)."""

    def __init__(self, host_ops: bool = True):
        self.host_ops = host_ops
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host_ops else [])
        self.prof = profile(activities=acts, record_shapes=self.host_ops)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        return reduce(self.prof.profiler.kineto_results.events())


def reduce(events) -> dict:
    """The profiler's raw events (no event tree is built: it is slow for
    many threads) -> the reduced trace."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        start = e.start_ns() / 1e9
        end = start + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not e.name().startswith("bench."):
                device.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), start, end))
    if not device:
        return {"device_ops": 0}
    lo = min(min(s for _, s, _ in device), min((s for _, s, _ in host), default=1e30))
    hi = max(max(e for _, _, e in device), max((e for _, _, e in host), default=-1e30))
    busy = [(s, e) for _, s, e in device]
    return {"device_ops": len(device), "window_s": hi - lo, "busy_s": union_s(busy),
            "lo": lo, "hi": hi, "device": device, "host": host}


def kernel_time(tr: dict, match) -> Tuple[float, int]:
    """(summed seconds, launches) of the device operations whose name
    `match(name)` accepts."""
    sel = [(s, e) for n, s, e in tr.get("device", []) if match(n)]
    return sum(e - s for s, e in sel), len(sel)


def breakdown(tr: dict, spans: List[Tuple[str, float, float]] = ()) -> dict:
    """The ten device operations that took most time (summed by name), and
    the ten longest idle gaps, each named by the shortest host event or
    benchmark span that covers its middle ("host" when none does)."""
    by: Dict[str, float] = {}
    for n, s, e in tr["device"]:
        by[n] = by.get(n, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps([(s, e) for _, s, e in tr["device"]], tr["lo"], tr["hi"]),
                  key=lambda g: g[0] - g[1])[:10]
    cover = list(tr["host"]) + list(spans)
    named = []
    for a, b in idle:
        mid = (a + b) / 2
        inside = [(e - s, n) for n, s, e in cover if s <= mid <= e]
        named.append([min(inside)[1] if inside else "host", b - a])
    return {"device_ops": [[n, t] for n, t in top], "idle_gaps": named}
