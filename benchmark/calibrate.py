"""The readings the limits that decide `correct` are set from (not run by
the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 45

Dialog cells: per seed, one run of the cell (the program's widest served-
logit gap against the reference, the lower reading) and, on the same
served requests, the control: the reference at int4 weights, the gap of
the token it puts first (the upper reading).  Training cells: per seed, the
reference put in the program's place at the next precision down (fp8
products) and with half of each row's labels left out, each compared with
the reference as the program is.  Prints one JSON line per seed."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import env  # noqa: E402

env.prepare_process()

from benchmark.lib import registry  # noqa: E402


def train_controls(cell: dict, seed: int, device) -> dict:
    """The fp8 control's and the half-batch fault's readings on the cell's
    first two rows, against the reference."""
    import torch

    from benchmark.drivers import lm_train as LT
    from benchmark.reference.mistral import train_readings

    cfg, mix = cell["config"], cell["traffic"]
    gen = registry.generator(mix["generator"])
    lo = LT.lora_spec(cfg, mix)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in
                gen.row(mix, cfg["vocab_size"], seed, j).items()} for j in (0, 1)]
    ref = train_readings(cfg, seed, batches, device, LT.opt_of(mix), lora=lo)
    out = {}
    for name, kw in (("control_fp8", {"precision": "fp8"}), ("fault_half_batch",
                                                             {"half_batch": True})):
        got = train_readings(cfg, seed, batches, device, LT.opt_of(mix), lora=lo, **kw)
        out[name] = {
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": LT.compare(got["grad"], ref["grad"], ref["grad"], mix["leaf_stat"]),
            "change_gap": LT.compare(got["change"], ref["change"], ref["grad"], mix["leaf_stat"]),
            "grad_gap_worst": LT.compare(got["grad"], ref["grad"], ref["grad"], "worst"),
            "change_gap_worst": LT.compare(got["change"], ref["change"], ref["grad"], "worst")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=45.0)
    args = p.parse_args(argv)
    cell = registry.find_cell(registry.load_spec(), args.workload)
    env.require_cards(cell["workload"]["chips"])
    import torch

    device = torch.device("cuda:0")
    drv = registry.driver(cell["traffic"]["driver"])
    for s in args.seeds.split(","):
        seed = int(s)
        t0 = time.perf_counter()
        if cell["traffic"]["driver"] == "dialog":
            res = drv.run(cell, seed, args.seconds, False, device, t0, control=True)
            line = {"seed": seed, "program": res["checks"], "detail": drv.check.worst}
        else:
            line = {"seed": seed, **train_controls(cell, seed, device)}
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
