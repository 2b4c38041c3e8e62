"""Speech-unit <-> mel-rate resampling and unit-string parsing.

Port of usdm_tpu/audio/units.py.  Units are 50 Hz ids; to condition the mel
decoder they are repeated by sr // 50, truncated to a hop multiple, and
mode-pooled per hop to the mel frame rate.  Host-side numpy: the arrays are
a few hundred rows.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

_UNIT_RE = re.compile(r"<\|unit(\d+)\|>")


def units_to_string(units: Sequence[int]) -> str:
    return "".join(f"<|unit{int(u)}|>" for u in units)


def parse_units(text: str) -> List[int]:
    """Extract `<|unitN|>` ids from decoded text."""
    return [int(x) for x in _UNIT_RE.findall(text)]


def rowwise_mode(rows: np.ndarray) -> np.ndarray:
    """Mode of each row of an int array [N, W] -> [N]; ties resolve to the
    smallest value (as usdm_tpu.audio.units.rowwise_mode).  Each sorted row's
    runs are measured at their last element; the first maximal run is the
    smallest of the most frequent values."""
    s = np.sort(np.asarray(rows), axis=-1)
    n, w = s.shape
    idx = np.broadcast_to(np.arange(w), (n, w))
    starts = np.concatenate([np.ones((n, 1), bool), s[:, 1:] != s[:, :-1]], axis=1)
    run_start = np.maximum.accumulate(np.where(starts, idx, 0), axis=1)
    best = np.argmax(idx - run_start, axis=1)  # end of the first longest run
    return s[np.arange(n), best].astype(np.int32)


def expand_and_pool(units: np.ndarray, sample_rate: int = 22050, token_sr: int = 50,
                    hop: int = 256) -> Tuple[np.ndarray, int]:
    """50 Hz units -> mel-rate units -> (pooled_units [n_frames],
    new_length_in_samples)."""
    units = np.asarray(units, dtype=np.int32)
    expanded = np.repeat(units, sample_rate // token_sr)
    new_length = len(expanded) // hop * hop
    return rowwise_mode(expanded[:new_length].reshape(-1, hop)), new_length


def expand_durations_and_pool(units: Sequence[int], durations: Sequence[int],
                              sample_rate: int = 22050, token_sr: int = 50,
                              hop: int = 256) -> Tuple[np.ndarray, int]:
    """Duration-weighted variant for the training dataset: unit u with
    duration d occupies d * round(sr / token_sr) samples -> (pooled_units
    [n_frames], new_length_in_samples)."""
    reps = int(round(sample_rate / token_sr))
    durations = np.asarray(durations, dtype=np.int64) * reps
    expanded = np.repeat(np.asarray(units, dtype=np.int32), durations)
    new_length = len(expanded) // hop * hop
    return rowwise_mode(expanded[:new_length].reshape(-1, hop)), new_length


def dedup_units(units: Sequence[int]) -> Tuple[List[int], List[int]]:
    """Run-length encode a unit stream -> (unique-run units, durations).

    The decoder filelists keep every unit with duration 1 (as usdm_tpu's
    preprocess does); this produces the (units, durations) form for
    duration-aware decoder training data and compact unit transport.
    `expand_durations_and_pool` inverts it."""
    units = [int(u) for u in units]
    if not units:
        return [], []
    out_u = [units[0]]
    out_d = [1]
    for u in units[1:]:
        if u == out_u[-1]:
            out_d[-1] += 1
        else:
            out_u.append(u)
            out_d.append(1)
    return out_u, out_d
