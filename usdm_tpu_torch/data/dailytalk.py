"""DailyTalk single-turn SFT data preparation.

Port of usdm_tpu/data/dailytalk.py (pure Python, kept as a copy): pair
consecutive turns (even/odd phase), render the single-turn template, and
compute loss masks so that ONLY the user transcript (ASR target), the agent
response text, and the agent units (TTS target) are trained; the
instruction, user units, and separators are ignored.  Per turn with newline
indices nl[0..5] and correspond indices c[0..1]:
  trained:  (c[0], nl[3]]           user transcript incl. trailing newline
  trained:  (nl[4], nl[5])          agent text + <|correspond|> + agent units
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

IGNORE_INDEX = -100
MAX_LENGTH = 8192

INSTRUCTION = (
    "Below is a conversation between the user and the agent. Each turn includes "
    "the user's speech and its corresponding transcript, along with the agent's "
    "response text and the corresponding speech.\n"
)


def speech_template(user_unit: str, user_text: str, agent_text: str, agent_unit: str) -> str:
    """Single-turn template (dailytalk_single_turn.py:45-55)."""
    return (
        f"\n### User"
        f"\n{user_unit}<|correspond|>{user_text.lower()}"
        f"\n### Agent"
        f"\n{agent_text.lower()}<|correspond|>{agent_unit}"
        f"\n"
    )


def group_dialogs(metadata: Sequence[str]) -> Dict[str, List[List[str]]]:
    """'{turn}_{spk}_d{dialog}|...|text|...' lines -> dialog_num -> ordered
    [dialog_id, text]; drops dialogs with consecutive same-speaker turns
    (dailytalk_single_turn.py:18-41)."""
    dialog_dict: Dict[str, List[List[str]]] = {}
    for line in metadata:
        dialog_id = line.split("|")[0]
        dialog_num = dialog_id.split("_")[-1]
        text = line.split("|")[-2]
        dialog_dict.setdefault(dialog_num, []).append([dialog_id, text])

    drop = []
    for key, turns in dialog_dict.items():
        turns.sort(key=lambda x: int(x[0].split("_")[0]))
        if len(turns) - 1 != int(turns[-1][0].split("_")[0]):
            raise ValueError(f"dialog {key}: turns missing from the metadata")
        spk = [t[0].split("_")[1] for t in turns]
        if any(a == b for a, b in zip(spk, spk[1:])):
            drop.append(key)
    for key in drop:
        dialog_dict.pop(key)
    return dialog_dict


def mask_labels(input_ids: List[int], newline_id: int, correspond_id: int) -> List[int]:
    """input ids -> labels with IGNORE_INDEX outside the trained spans."""
    nl = [i for i, t in enumerate(input_ids) if t == newline_id]
    corr = [i for i, t in enumerate(input_ids) if t == correspond_id]
    labels = [IGNORE_INDEX] * len(input_ids)

    # agent line spans: (nl[4], nl[5]) per turn, stride 5 newlines
    k = 4
    while k + 1 < len(nl):
        for i in range(nl[k] + 1, nl[k + 1]):
            labels[i] = input_ids[i]
        k += 5

    # user transcript spans: (corr[j], nl[round(2.5 j) + 3]] stride 2
    j = 0
    while True:
        nidx = round(2.5 * j) + 3
        if j >= len(corr) or nidx >= len(nl):
            break
        for i in range(corr[j] + 1, nl[nidx] + 1):
            labels[i] = input_ids[i]
        j += 2
    return labels


def build_single_turn_samples(
    turns: Sequence[Tuple[str, str, str]],  # (dialog_id, units_str, transcript)
    encode,  # str -> List[int] incl. BOS
    newline_id: int,
    correspond_id: int,
    eos_token: str = "</s>",
    max_length: int = MAX_LENGTH,
) -> List[Tuple[List[int], List[int]]]:
    """Pair consecutive turns (user, agent) -> [(input_ids, labels)]."""
    out = []
    for user, agent in zip(turns[0::2], turns[1::2]):
        _, uu, ut = user
        _, au, at = agent
        text = INSTRUCTION + speech_template(uu, ut, at, au) + eos_token
        ids = encode(text)
        if len(ids) > max_length:
            continue
        out.append((ids, mask_labels(ids, newline_id, correspond_id)))
    return out


def build_dataset(
    metadata: Sequence[str],
    units_by_id: Dict[str, str],
    encode,
    newline_id: int,
    correspond_id: int,
    seed: int = 0,
) -> List[Tuple[List[int], List[int]]]:
    """Full set: both even and odd turn pairings per dialog
    (dailytalk_single_turn.py:174-184), shuffled."""
    dialogs = group_dialogs(metadata)
    data = []
    for turns in dialogs.values():
        enriched = [(tid, units_by_id[tid], text) for tid, text in turns]
        data += build_single_turn_samples(enriched, encode, newline_id, correspond_id)
        data += build_single_turn_samples(enriched[1:], encode, newline_id, correspond_id)
    random.Random(seed).shuffle(data)
    return data
