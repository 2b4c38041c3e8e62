"""Each traffic generator gives every seed the same work (the quantile
lengths) in another order and with other contents."""

import numpy as np

from benchmark.lib import registry
from benchmark.traffic.generators import closed_loop_dialog as CL
from benchmark.traffic.generators import packed_rows as PR
from benchmark.traffic.generators import quantiles as Q

SEEDS = (1, 2, 2**31 + 12345, 987654321987)


def _mix(name):
    return registry.find_cell(registry.load_spec(), name)["traffic"]


def test_quantile_points_fixed_and_in_range():
    spec = {"dist": "lognormal", "median": 200, "sigma": 0.45, "min": 100, "max": 500}
    pts = Q.points(spec, 32)
    assert pts == sorted(pts) and min(pts) >= 100 and max(pts) <= 500
    assert pts[15] <= 200 <= pts[16]
    assert Q.points({"dist": "uniform", "min": 16, "max": 48}, 4) == [20, 28, 36, 44]


def test_dialog_round_work_same_for_every_seed():
    mix = _mix("s2s.dialog-c32")
    n = mix["conversations"]
    for rnd in range(3):
        per_seed = []
        for seed in SEEDS:
            turns = [CL.turn(mix, seed, c, rnd) for c in range(n)]
            per_seed.append((sorted(len(t["units"]) for t in turns),
                             {s: sorted(t["budgets"][s] for t in turns) for s in CL.STAGES},
                             [len(t["units"]) for t in turns], turns[0]["units"][:8]))
        assert all(p[0] == per_seed[0][0] and p[1] == per_seed[0][1] for p in per_seed)
        assert len({tuple(p[2]) for p in per_seed}) > 1  # the order follows the seed
        assert len({tuple(p[3]) for p in per_seed}) == len(SEEDS)  # so do the contents
    work = CL.round_work(mix)
    turns = [CL.turn(mix, SEEDS[0], c, 0) for c in range(n)]
    assert work["user_units"] == sum(len(t["units"]) for t in turns)
    assert work["text2unit"] == sum(t["budgets"]["text2unit"] for t in turns)


def test_packed_rows_same_work_other_order_and_ids():
    for name in ("lm.sft-8k", "lm.lora-8k"):
        mix = _mix(name)
        lengths = PR.doc_lengths(mix)
        assert sum(lengths) == mix["row_tokens"] and len(lengths) == mix["docs_per_row"]
        rows = [PR.row(mix, 42003, s, k) for s in SEEDS for k in (0, 1)]
        orders = set()
        for r in rows:
            seg, pos, lab = r["segment_ids"][0], r["positions"][0], r["labels"][0]
            starts = np.flatnonzero(pos == 0)
            docs = np.diff(np.append(starts, len(pos)))
            assert sorted(docs.tolist()) == lengths
            assert (lab[starts] == -100).all() and (lab != -100).sum() == len(pos) - len(starts)
            assert (np.diff(seg) >= 0).all() and seg[starts].tolist() == list(range(len(starts)))
            orders.add(tuple(docs))
        assert len(orders) > 1
        assert not np.array_equal(rows[0]["input_ids"], rows[2]["input_ids"])
