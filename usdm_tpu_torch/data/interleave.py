"""Interleaved speech-text pre-training data generation (USTM recipe).

Port of usdm_tpu/data/interleave.py (pure Python, kept as a copy so the port
imports nothing of usdm_tpu): from MFA word alignments and unit sequences,
build token streams that stochastically alternate between text spans and
unit spans with `<|continue|>` transitions and 50% `<|correspond|>` paired
re-emission, the core cross-modal objective.

Pipeline per utterance:
  1. parse the TextGrid 'words' tier (minimal Praat parser, no external dep)
  2. redistribute blank intervals into their neighbors
  3. rescale word times to unit-frame indices (ratio = n_units / maxTime)
  4. merge zero-width intervals into neighbors
  5. per epoch: sample ~10 s segment boundaries from truncated normals over
     word starts, then emit each segment as text or units (p=0.5), inserting
     `<|continue|>` at modality switches and re-emitting the other modality
     after `<|correspond|>` with p=0.5
"""

from __future__ import annotations

import dataclasses
import random
import re
from typing import List, Optional, Sequence, Tuple

SEGMENT_SECONDS = 10
TOKEN_SR = 50


@dataclasses.dataclass
class Interval:
    mark: str
    min_time: float
    max_time: float


# ---------------------------------------------------------------------------
# Minimal Praat TextGrid parser ('words' item, IntervalTier)
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"(xmin|xmax)\s*=\s*([0-9.eE+-]+)")
_TEXT_RE = re.compile(r'text\s*=\s*"(.*)"')
_NAME_RE = re.compile(r'name\s*=\s*"(.*)"')


def parse_textgrid_words(path: str, tier: str = "words") -> List[Interval]:
    """Parse the named interval tier of a (long-format) TextGrid file."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    # split into items; find the tier whose name matches
    items = re.split(r"item\s*\[\d+\]\s*:", text)
    for item in items[1:]:
        m = _NAME_RE.search(item)
        if not m or m.group(1) != tier:
            continue
        intervals: List[Interval] = []
        for chunk in re.split(r"intervals\s*\[\d+\]\s*:", item)[1:]:
            nums = dict(_NUM_RE.findall(chunk))
            tm = _TEXT_RE.search(chunk)
            intervals.append(
                Interval(tm.group(1) if tm else "", float(nums["xmin"]), float(nums["xmax"]))
            )
        return intervals
    raise ValueError(f"tier {tier!r} not found in {path}")


# ---------------------------------------------------------------------------
# Alignment normalization
# ---------------------------------------------------------------------------


def redistribute_blanks(intervals: List[Interval]) -> List[Interval]:
    """Fold blank intervals into neighbors: leading blank -> next word starts
    earlier; trailing blank -> previous word ends later; middle blank -> half
    to each side."""
    iv = [Interval(i.mark, i.min_time, i.max_time) for i in intervals]
    for i in range(len(iv)):
        if iv[i].mark.strip() != "":
            continue
        if i == 0 and len(iv) > 1:
            iv[i + 1].min_time = iv[i].min_time
        elif i == len(iv) - 1 and i > 0:
            iv[i - 1].max_time = iv[i].max_time
        elif 0 < i < len(iv) - 1:
            half = (iv[i].max_time - iv[i].min_time) / 2
            iv[i - 1].max_time = round(iv[i - 1].max_time + half, 2)
            iv[i + 1].min_time = iv[i - 1].max_time
    return [i for i in iv if i.mark != ""]


def scale_to_frames(intervals: List[Interval], n_units: int, total_time: float) -> List[Interval]:
    """Rescale times to integer unit-frame indices; raises ValueError where
    two neighbours stop being contiguous (usdm_tpu asserts)."""
    ratio = n_units / total_time
    out = []
    for i, iv in enumerate(intervals):
        lo = round(iv.min_time * ratio)
        hi = round(iv.max_time * ratio)
        out.append(Interval(iv.mark, lo, hi))
        if i >= 1:
            if out[i].min_time != out[i - 1].max_time:
                raise ValueError("non-contiguous alignment")
    return out


def merge_zero_width(intervals: List[Interval]) -> List[Interval]:
    """Merge zero-width intervals into neighbors, concatenating marks
    (stage2.py:64-103)."""
    iv = [Interval(i.mark, i.min_time, i.max_time) for i in intervals]
    i = 0
    while i < len(iv):
        cur = iv[i]
        if i == 0 and i < len(iv) - 1:
            nxt = iv[i + 1]
            if cur.max_time == cur.min_time:
                cur.max_time = nxt.max_time
                cur.mark += " " + nxt.mark
                iv.pop(i + 1)
                continue
        elif i == len(iv) - 1 and i > 0:
            prv = iv[i - 1]
            if cur.max_time == cur.min_time:
                prv.max_time = cur.max_time
                prv.mark += " " + cur.mark
                iv.pop(i)
                continue
        elif 0 < i < len(iv) - 1:
            prv, nxt = iv[i - 1], iv[i + 1]
            if cur.max_time == cur.min_time:
                if nxt.max_time != nxt.min_time:
                    prv.max_time = nxt.max_time
                    prv.mark += " " + cur.mark + " " + nxt.mark
                    iv.pop(i)
                    iv.pop(i)
                    continue
                prv.max_time = cur.max_time
                prv.mark += " " + cur.mark
                iv.pop(i)
                continue
        i += 1
    return iv


# ---------------------------------------------------------------------------
# Stochastic interleaving
# ---------------------------------------------------------------------------


def sample_segment_indices(
    intervals: List[Interval], rng: random.Random, segment_seconds: int = SEGMENT_SECONDS
) -> List[int]:
    """Segment boundaries ~truncated-normal around equal splits of ~10 s
    (stage2.py:118-148); returns sorted unique interval indices."""
    from scipy import stats

    n_frames = intervals[-1].max_time
    num_segments = int(n_frames) // (TOKEN_SR * segment_seconds) + 1
    start_idx_list = [iv.min_time for iv in intervals] + [intervals[-1].max_time]

    seg_idx = [0]
    for k in range(1, num_segments):
        mean = n_frames / num_segments * k
        std = n_frames / (num_segments * 2)
        lo = mean - n_frames / num_segments
        hi = mean + n_frames / num_segments
        a, b = (lo - mean) / std, (hi - mean) / std
        draw = stats.truncnorm(a, b, loc=mean, scale=std).rvs(random_state=rng.randint(0, 2**31 - 1))
        seg_idx.append(min(range(len(start_idx_list)), key=lambda i: abs(start_idx_list[i] - draw)))
    seg_idx.append(len(intervals))
    return sorted(set(seg_idx))


def interleave_tokens(
    intervals: List[Interval],
    unit_token_ids: Sequence[int],
    encode_text,  # str -> List[int] (no BOS)
    continue_ids: Sequence[int],
    correspond_ids: Sequence[int],
    bos_id: int,
    eos_id: int,
    rng: random.Random,
) -> List[int]:
    """One interleaved epoch sample (stage2.py:150-182).

    `unit_token_ids[f]` is the vocab id of the unit at frame f.  `encode_text`
    tokenizes a text span without BOS (the reference drops the leading BOS of
    each piece with `[1:]`).
    """
    seg_idx = sample_segment_indices(intervals, rng)
    groups = [intervals[a:b] for a, b in zip(seg_idx[:-1], seg_idx[1:])]

    data: List[int] = [bos_id]
    last_type = "bos"
    for group in groups:
        if not group:
            continue
        text = " ".join(iv.mark for iv in group)
        lo, hi = int(group[0].min_time), int(group[-1].max_time)
        if rng.random() >= 0.5:
            if last_type == "unit":
                data += list(continue_ids)
            data += encode_text(text)
            last_type = "text"
        else:
            if last_type == "text":
                data += list(continue_ids)
            data += list(unit_token_ids[lo:hi])
            last_type = "unit"

        if rng.random() >= 0.5:
            data += list(correspond_ids)
            if last_type == "unit":
                data += encode_text(text)
                last_type = "text"
            else:
                data += list(unit_token_ids[lo:hi])
                last_type = "unit"
    data.append(eos_id)
    return data


def prepare_alignment(
    textgrid_path: str, n_units: int
) -> Optional[Tuple[List[Interval], str]]:
    """TextGrid -> (frame-scaled merged intervals, transcript); None when the
    utterance has fewer than 3 aligned words (stage2.py:115-116).  Raises
    ValueError on an alignment it cannot scale or merge (usdm_tpu asserts;
    an `assert` would vanish under python -O)."""
    raw = parse_textgrid_words(textgrid_path)
    total_time = raw[-1].max_time
    words = redistribute_blanks(raw)
    transcript = " ".join(i.mark for i in words)
    scaled = scale_to_frames(words, n_units, total_time)
    merged = merge_zero_width(scaled)
    post = " ".join(i.mark for i in merged)
    if transcript != post:
        raise ValueError("transcript changed by merging")
    if len(merged) < 3:
        return None
    return merged, transcript


def normalize_transcript(text: str) -> str:
    """Stage-1 text normalization (stage1.py:29-45 behavior): lowercase,
    strip punctuation except apostrophes, collapse whitespace."""
    text = text.lower()
    text = re.sub(r"[^a-z0-9' ]+", " ", text)
    return " ".join(text.split())
