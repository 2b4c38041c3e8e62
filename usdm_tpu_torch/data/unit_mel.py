"""Unit-mel dataset + CFG/infilling collate for Voicebox training.

Port of usdm_tpu/data/unit_mel.py.  Filelist lines `wav_path|units|durations`;
units expand by duration x round(sr / 50), floor to a hop multiple and
mode-pool per hop to the mel rate; the mel is extracted at 22.05 kHz on the
host (usdm_tpu_torch.audio.mel) and normalized with the dataset constants.
The collate crops a random `out_size` window and applies classifier-free
dropout (p_uncond) or partial-mask infilling (p_drop, r in [r_min, r_max]),
drawing from the numpy Generator in exactly usdm_tpu's order, so one seed
gives the same batch in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from usdm_tpu_torch.audio.mel import mel_for_config, normalize_mel
from usdm_tpu_torch.audio.units import expand_durations_and_pool
from usdm_tpu_torch.audio.wav import load_wav
from usdm_tpu_torch.core.config import CfmTrainConfig, MelConfig


def parse_filelist(path: str) -> List[Tuple[str, List[int], List[int]]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            wav_path, units_s, durs_s = line.split("|")
            out.append((wav_path, [int(u) for u in units_s.split()],
                        [int(d) for d in durs_s.split()]))
    return out


class UnitMelDataset:
    def __init__(self, filelist_path: str, mel_cfg: MelConfig = MelConfig(),
                 n_tokens: int = 10000):
        self.items = parse_filelist(filelist_path)
        self.mel_cfg = mel_cfg
        self.n_tokens = n_tokens

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (units [T] int64, normalized mel [n_mels, T] f32)."""
        mc = self.mel_cfg
        wav_path, units, durs = self.items[int(idx)]
        pooled, new_length = expand_durations_and_pool(units, durs, mc.sampling_rate,
                                                       mc.token_sr, mc.hop_size)
        wav, _ = load_wav(wav_path, sr=mc.sampling_rate)
        if len(wav) < new_length:
            wav = np.pad(wav, (0, new_length - len(wav)))
        wav = np.clip(wav[:new_length], -1.0, 1.0).astype(np.float32)
        with torch.no_grad():
            mel = normalize_mel(mel_for_config(torch.from_numpy(wav[None]), mc), mc)
        mel = mel[0].numpy()
        if len(pooled) != mel.shape[-1]:
            raise ValueError(f"{wav_path}: {len(pooled)} pooled units for {mel.shape[-1]} "
                             f"mel frames")
        return pooled.astype(np.int64), mel.astype(np.float32)


class UnitMelCollate:
    def __init__(self, tc: CfmTrainConfig, mel_cfg: MelConfig = MelConfig(),
                 n_tokens: int = 10000):
        self.out_size = tc.out_size_seconds * mel_cfg.sampling_rate // mel_cfg.hop_size
        self.p_uncond = tc.p_uncond
        self.p_drop = tc.p_drop
        self.r_min = tc.r_min
        self.r_max = tc.r_max
        self.n_tokens = n_tokens
        self.n_feats = mel_cfg.num_mels

    def __call__(self, items: Sequence[Tuple[np.ndarray, np.ndarray]], rng: np.random.Generator,
                 evaluation: bool = False) -> Dict[str, np.ndarray]:
        b = len(items)
        t = self.out_size
        y = np.zeros((b, self.n_feats, t), np.float32)
        x = np.full((b, t), self.n_tokens, np.int64)  # pad with the null token
        mask = np.zeros((b, 1, t), np.int64)
        y_lengths = np.zeros(b, np.int64)

        for i, (units, mel) in enumerate(items):
            n = mel.shape[-1]
            if n > t:
                off = int(rng.integers(0, n - t))
                mel = mel[:, off: off + t]
                units = units[off: off + t]
                n = t
            y_lengths[i] = n
            y[i, :, :n] = mel
            x[i, :n] = units

            if evaluation:
                continue
            if rng.random() <= self.p_uncond:
                x[i, :n] = self.n_tokens  # classifier-free: null out the unit condition
            elif rng.random() >= self.p_drop:
                # infilling: reveal a (1 - r) fraction as context
                r = rng.uniform(self.r_min, self.r_max)
                nonmask = max(int(n * (1 - r)), 0)
                max_off = max(n - nonmask, 1)
                off = int(rng.integers(0, max_off))
                mask[i, 0, off: off + nonmask] = 1

        return {"x": x, "mask": mask, "y": y, "y_lengths": y_lengths}


def build_filelist(wav_dir: str, unit_extractor, out_path: str,
                   exts=(".wav", ".flac", ".mp3")) -> int:
    """Decoder preprocessing: the `exts` files under `wav_dir` (sorted) ->
    units with all durations 1 -> `path|units|durations` lines in
    `out_path`; `unit_extractor(wav16k: np.ndarray) -> List[int]`.  A file
    audio/wav.py cannot decode raises naming its format.  -> line count."""
    import glob

    lines = []
    files = sorted(f for ext in exts
                   for f in glob.glob(os.path.join(wav_dir, "**", f"*{ext}"), recursive=True))
    for fp in files:
        wav, _ = load_wav(fp, sr=16000)
        units = unit_extractor(wav)
        durs = " ".join("1" for _ in units)
        lines.append(f"{fp}|{' '.join(str(u) for u in units)}|{durs}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    return len(lines)
