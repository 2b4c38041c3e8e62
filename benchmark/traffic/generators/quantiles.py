"""Lengths at fixed quantiles of a distribution: the same multiset for
every seed, so a seed changes the order and the contents, never the work."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List


def points(spec: dict, n: int) -> List[int]:
    """n values at the quantiles (i + 0.5) / n of `spec`: {"dist":
    "lognormal", "median", "sigma", "min", "max"} (clipped to [min, max])
    or {"dist": "uniform", "min", "max"}; rounded to integers."""
    out = []
    for i in range(n):
        p = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            v = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(p))
        elif spec["dist"] == "uniform":
            v = spec["min"] + p * (spec["max"] - spec["min"])
        else:
            raise ValueError(f"unknown distribution {spec['dist']!r}")
        out.append(int(round(min(max(v, spec["min"]), spec["max"]))))
    return out
