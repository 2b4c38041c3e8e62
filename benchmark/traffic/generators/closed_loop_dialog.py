"""Turns for a closed loop of conversations over the three dialog stages.

Each round gives every conversation one turn: the user's unit count and
the three stages' budgets are the mix's fixed quantile points, dealt to the
conversations by a permutation drawn from the seed (one per round and per
quantity), and the units are drawn from the seed.  So every round holds the same work whatever the seed."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

try:
    from benchmark.traffic.generators.quantiles import points
except ImportError:  # loaded by file path
    from quantiles import points  # type: ignore

STAGES = ("unit2text", "text2text", "text2unit")


def turn(mix: dict, seed: int, conv: int, rnd: int) -> Dict:
    """Conversation `conv`'s turn in round `rnd` -> {"units": [...],
    "budgets": {stage: n}}."""
    n = mix["conversations"]

    def deal(name: str, values: List[int]) -> int:
        perm = np.random.default_rng([seed % (1 << 63), rnd, len(name), sum(map(ord, name))])
        return values[perm.permutation(n)[conv]]

    n_units = deal("user_units", points(mix["user_units"], n))
    budgets = {s: deal(s, points(mix["budgets"][s], n)) for s in STAGES}
    rng = np.random.default_rng([seed % (1 << 63), conv, rnd, 1])
    units = rng.integers(0, mix["num_units"], n_units).tolist()
    return {"units": units, "budgets": budgets}


def round_work(mix: dict) -> Dict[str, int]:
    """The work every round holds: user units and each stage's budget,
    summed over the conversations (the same for every seed)."""
    n = mix["conversations"]
    out = {"user_units": sum(points(mix["user_units"], n))}
    out.update({s: sum(points(mix["budgets"][s], n)) for s in STAGES})
    return out
