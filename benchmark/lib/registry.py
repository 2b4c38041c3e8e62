"""Finds everything by the names in BENCHMARK.json: a cell's configuration
file, its traffic file, the traffic's generator and driver, and one reader
per metric.  A new cell, mix or metric is a new file; nothing here lists
them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Optional

from benchmark.lib.env import ROOT

BENCH = ROOT / "benchmark"


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _load_module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """-> {"workload", "config" (the file's JSON plus its entry), "traffic"
    (the mix's JSON), "end_to_end", "per_layer"} for cell `workload`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return m.get("workloads") is None or workload in m["workloads"]

    return {"workload": w, "config": config, "config_entry": entry, "traffic": traffic,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def driver(name: str, root: Path = ROOT):
    return _load_module(root / "benchmark" / "drivers" / f"{name}.py", f"bench_driver_{name}")


def generator(name: str, root: Path = ROOT):
    return _load_module(root / "benchmark" / "traffic" / "generators" / f"{name}.py",
                        f"bench_gen_{name}")


def metric_reader(name: str, root: Path = ROOT):
    """The reader of metric `name`: benchmark/metrics/<name>.py's `read(rec)`,
    which returns a number or None when the run holds nothing to read."""
    return _load_module(root / "benchmark" / "metrics" / f"{name}.py",
                        "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def read_metrics(metrics: list, rec: dict, root: Path = ROOT) -> dict:
    out = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], root)(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
