"""Batch collators for LM pre-training and SFT (numpy only).

Port of usdm_tpu/data/collators.py.  Pre-training rows pack many subsamples;
positions restart at every BOS and segment ids count the subsamples of a
row (padding: segment -1, label IGNORE_INDEX), which the segmented
attention (ops/attention.py, K2/K5) consumes directly.  SFT right-pads
pre-tokenized (input_ids, labels) pairs; the labels already carry -100
masks from the DailyTalk preprocessing.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100


def pack_collate(
    batch_ids: Sequence[Sequence[int]],
    pad_id: int,
    bos_id: int = 1,
    pad_to: int | None = None,
) -> Dict[str, np.ndarray]:
    """Packed rows -> {input_ids, labels, positions, segment_ids} [B, T] int32.

    positions restart at each BOS (index - index of the last BOS at or
    before it; padding 1, as the reference pads them); segment_ids number
    the subsamples 0, 1, 2, ... per row (a first token that is not a BOS
    still starts segment 0); padding gets segment -1 and IGNORE_INDEX."""
    b = len(batch_ids)
    t = max(len(x) for x in batch_ids)
    if pad_to:
        t = max(t, pad_to)
    input_ids = np.full((b, t), pad_id, np.int32)
    labels = np.full((b, t), IGNORE_INDEX, np.int32)
    positions = np.ones((b, t), np.int32)
    segment_ids = np.full((b, t), -1, np.int32)
    for i, ids in enumerate(batch_ids):
        ids = np.asarray(ids, np.int32)
        n = len(ids)
        input_ids[i, :n] = ids
        labels[i, :n] = ids
        is_bos = ids == bos_id
        seg = np.cumsum(is_bos)
        if not is_bos[0]:
            seg = seg + 1
        segment_ids[i, :n] = seg - seg[0]
        idx = np.arange(n)
        positions[i, :n] = idx - np.maximum.accumulate(np.where(is_bos, idx, 0))
    return {"input_ids": input_ids, "labels": labels, "positions": positions,
            "segment_ids": segment_ids}


def sft_collate(
    batch: Sequence[Tuple[Sequence[int], Sequence[int]]],
    pad_id: int,
    pad_to: int | None = None,
) -> Dict[str, np.ndarray]:
    """(input_ids, labels) pairs -> the right-padded batch, one segment per
    row (padding: segment -1, label IGNORE_INDEX, position 0)."""
    b = len(batch)
    t = max(len(ids) for ids, _ in batch)
    if pad_to:
        t = max(t, pad_to)
    input_ids = np.full((b, t), pad_id, np.int32)
    labels = np.full((b, t), IGNORE_INDEX, np.int32)
    positions = np.zeros((b, t), np.int32)
    segment_ids = np.full((b, t), -1, np.int32)
    for i, (ids, labs) in enumerate(batch):
        n = len(ids)
        input_ids[i, :n] = np.asarray(ids, np.int32)
        labels[i, :n] = np.asarray(labs, np.int32)
        positions[i, :n] = np.arange(n)
        segment_ids[i, :n] = 0
    return {"input_ids": input_ids, "labels": labels, "positions": positions,
            "segment_ids": segment_ids}
