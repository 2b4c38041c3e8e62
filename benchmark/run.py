"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic by name, sets up the program
under test (counted in setup_s, from the process's start to the first timed
request or step), measures for `--seconds`, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output.  With --trace 0 its metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
torch.profiler window and the program's counters.  Exits non-zero with no
result without the cards the cell asks for, or if JAX or the JAX package
was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import env  # noqa: E402

env.prepare_process()

from benchmark.lib import registry  # noqa: E402


def _card(device) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True,
                             timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             fault: str = None, t0: float = None) -> dict:
    """Drive one run of `cell` (registry.find_cell's) on `device` -> the
    result line's dict, without the card check (the benchmark's own tests
    call this on the CPU at a small size)."""
    import torch

    device = torch.device(device)
    drv = registry.driver(cell["traffic"]["driver"])
    res = drv.run(cell, seed, seconds, trace, device, T_START if t0 is None else t0, fault=fault)
    rec = res["rec"]
    if device.type == "cuda":
        rec["card"] = _card(device)
    metrics = registry.read_metrics(cell["per_layer"] if trace else cell["end_to_end"], rec)
    checks = res["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    correct = correct and res["failed"] == 0 and res["attempted"] > 0
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu",
                       "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}}
    if device.type == "cuda":
        line["device"]["power_limit"] = rec["card"]["power_limit"]
    tr = rec.get("trace")
    if trace and tr and tr.get("device_ops"):
        from benchmark.lib.trace import breakdown

        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = breakdown(tr)
    line["notes"] = res.get("notes", []) + res.get("errors", [])[:5]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = registry.load_spec()
    cell = registry.find_cell(spec, args.workload)
    env.require_cards(cell["workload"]["chips"])
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = env.forbidden_modules()
    if found:
        sys.stderr.write(f"benchmark: the measuring process loaded {found}; no result\n")
        return 4
    for note in line["notes"]:
        sys.stderr.write(f"note: {note}\n")
    for name, c in line["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} limit {c['limit']!r}\n")
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # the serving threads are daemons; nothing else is left running
