"""Packed training rows: every row holds the mix's documents at fixed
quantile lengths (scaled to fill the row exactly), in an order and with
token ids drawn from the seed and the step, so every row is the same work.
Each document attends to itself only (segment ids), its positions restart,
and its first token is not a label (nothing predicts it across documents)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

try:
    from benchmark.traffic.generators.quantiles import points
except ImportError:  # loaded by file path
    from quantiles import points  # type: ignore


def doc_lengths(mix: dict) -> List[int]:
    """The row's document lengths, sorted: quantile points scaled to sum to
    row_tokens, the rounding taken up by the longest."""
    raw = points(mix["doc_lengths"], mix["docs_per_row"])
    total = mix["row_tokens"]
    scaled = [max(1, int(round(v * total / sum(raw)))) for v in raw]
    scaled[-1] += total - sum(scaled)
    return sorted(scaled)


def row(mix: dict, vocab: int, seed: int, k: int) -> Dict[str, np.ndarray]:
    """Step k's batch [1, row_tokens]: input_ids, labels, segment_ids,
    positions (int32, the trainer's collators' layout)."""
    rng = np.random.default_rng([seed % (1 << 63), k, 7])
    lengths = [doc_lengths(mix)[i] for i in rng.permutation(mix["docs_per_row"])]
    ids = rng.integers(0, vocab, mix["row_tokens"]).astype(np.int32)
    labels = ids.copy()
    seg = np.empty(mix["row_tokens"], np.int32)
    pos = np.empty(mix["row_tokens"], np.int32)
    o = 0
    for j, n in enumerate(lengths):
        seg[o:o + n] = j
        pos[o:o + n] = np.arange(n)
        labels[o] = -100
        o += n
    return {"input_ids": ids[None], "labels": labels[None], "segment_ids": seg[None],
            "positions": pos[None]}
