"""The harness finds a cell, a traffic mix and a metric added as new files,
with no edit to any file that is there."""

import json
import shutil

from benchmark.lib import registry


def test_new_cell_mix_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = registry.load_spec()
    # a new mix (data only), a new cell and a new per-layer metric with its reader
    mix = json.loads((root / "benchmark/traffic/dialog-c32.json").read_text())
    mix["conversations"] = 8
    (root / "benchmark/traffic/dialog-c8.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/turns_per_s.dialog.py").write_text(
        "def read(rec):\n    return len(rec['requests']) / 2.0\n")
    spec["workloads"].append({"name": "s2s.dialog-c8", "config": "usdm-s2s-w8a8lm",
                              "traffic": "dialog-c8", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "turns_per_s.dialog", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "dialog serving",
                              "moves": "dialog_tok_s", "workloads": ["s2s.dialog-c8"]})
    for m in spec["end_to_end"]:
        if "s2s.dialog-c32" in m.get("workloads", []):
            m["workloads"].append("s2s.dialog-c8")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.find_cell(registry.load_spec(root), "s2s.dialog-c8", root)
    assert cell["traffic"]["conversations"] == 8
    assert cell["config"]["hidden_size"] == 4096
    assert [m["name"] for m in cell["per_layer"]] == ["turns_per_s.dialog"]
    assert {m["name"] for m in cell["end_to_end"]} == {"dialog_tok_s", "setup_s"}
    got = registry.read_metrics(cell["per_layer"], {"requests": [1, 2, 3]}, root)
    assert got == {"turns_per_s.dialog": {"value": 1.5, "unit": "1/s"}}
    assert registry.generator(cell["traffic"]["generator"], root).turn
    assert registry.driver(cell["traffic"]["driver"], root).run


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    spec = registry.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
    for w in spec["workloads"]:
        cell = registry.find_cell(spec, w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
