"""Waveform / mel dataset for BigVGAN vocoder training.

Port of usdm_tpu/data/mel_dataset.py: filelists of `name|...` lines joined
onto a wav dir, peak normalization x 0.95 (training from scratch only), a
random segment_size crop (zero-padded when short), and a fine-tuning mode
that pairs the audio with a precomputed mel (.npy) and crops both at one
random hop-aligned offset.  The host only crops and stacks waveforms (with
the caller's numpy Generator, so one seed gives usdm_tpu's crops); the
conditioning mel (fmax 8000) is computed for the whole batch on the
training device (`collate_mel_batch`), and the loss mel (fmax sr/2,
`loss_mel_config`) inside the generator step.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from usdm_tpu_torch.audio.mel import mel_for_config
from usdm_tpu_torch.audio.wav import load_wav
from usdm_tpu_torch.core.config import MelConfig


def read_vocoder_filelist(list_path: str, wavs_dir: str) -> List[str]:
    """Each line's first `|` field, with a .wav suffix added where it has
    none, resolved against `wavs_dir` unless absolute."""
    files: List[str] = []
    with open(list_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name = line.split("|")[0]
            if not name.endswith(".wav"):
                name += ".wav"
            files.append(name if os.path.isabs(name) else os.path.join(wavs_dir, name))
    return files


def peak_normalize(wav: np.ndarray, headroom: float = 0.95) -> np.ndarray:
    """wav / max|wav| * headroom (librosa.util.normalize(wav) * 0.95); a
    silent wav (peak < 1e-10) as it is."""
    peak = float(np.max(np.abs(wav))) if wav.size else 0.0
    if peak < 1e-10:
        return wav
    return (wav / peak * headroom).astype(np.float32)


class MelAudioDataset:
    """Random-crop waveform dataset: an item is an f32 [segment_size] wav
    and, with `fine_tuning`, the aligned crop of `base_mels_path/<stem>.npy`
    (else None)."""

    def __init__(self, files: Sequence[str], segment_size: int = 8192,
                 mel_cfg: MelConfig = MelConfig(), split: bool = True,
                 fine_tuning: bool = False, base_mels_path: Optional[str] = None):
        self.files = list(files)
        self.segment_size = int(segment_size)
        self.mel_cfg = mel_cfg
        self.split = split
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        if fine_tuning and not base_mels_path:
            raise ValueError("fine_tuning=True requires base_mels_path")
        if segment_size % mel_cfg.hop_size:
            raise ValueError(f"segment_size {segment_size} must be a multiple of hop "
                             f"{mel_cfg.hop_size}")
        self.frames_per_seg = self.segment_size // mel_cfg.hop_size

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, path: str) -> np.ndarray:
        wav, _ = load_wav(path, sr=self.mel_cfg.sampling_rate)
        if not self.fine_tuning:
            wav = peak_normalize(wav)
        return np.clip(wav.astype(np.float32), -1.0, 1.0)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rng = rng or np.random.default_rng()
        path = self.files[int(idx)]
        wav = self._load(path)
        seg, hop = self.segment_size, self.mel_cfg.hop_size
        if not self.fine_tuning:
            if self.split:
                if len(wav) >= seg:
                    off = int(rng.integers(0, len(wav) - seg + 1))
                    wav = wav[off:off + seg]
                else:
                    wav = np.pad(wav, (0, seg - len(wav)))
            return wav, None

        stem = os.path.splitext(os.path.basename(path))[0]
        mel = np.load(os.path.join(self.base_mels_path, stem + ".npy")).astype(np.float32)
        if mel.ndim == 3:
            mel = mel[0]
        if self.split:
            n = self.frames_per_seg
            if len(wav) >= seg and mel.shape[-1] > n:
                m_off = int(rng.integers(0, mel.shape[-1] - n))
                mel = mel[:, m_off:m_off + n]
                wav = wav[m_off * hop:(m_off + n) * hop]
                if len(wav) < seg:  # the mel can outrun a short tail
                    wav = np.pad(wav, (0, seg - len(wav)))
            else:
                mel = np.pad(mel, ((0, 0), (0, max(0, n - mel.shape[-1]))))[:, :n]
                wav = np.pad(wav, (0, max(0, seg - len(wav))))[:seg]
        return wav, mel


def collate_mel_batch(items: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
                      mel_cfg: MelConfig = MelConfig(), device="cpu") -> Dict[str, torch.Tensor]:
    """Stack the crops on `device` -> {"mel" [B, n_mels, F], "wav" [B, 1, T]}:
    the conditioning mel at mel_cfg.fmax computed there for the whole batch,
    or the fine-tuning crops' mels."""
    wavs = torch.from_numpy(np.stack([w for w, _ in items]).astype(np.float32)).to(device)
    if items[0][1] is not None:
        mel = torch.from_numpy(np.stack([m for _, m in items])).to(device)
    else:
        mel = mel_for_config(wavs, mel_cfg)
    return {"mel": mel, "wav": wavs[:, None, :]}


def loss_mel_config(mel_cfg: MelConfig = MelConfig()) -> MelConfig:
    """The loss mel's config: full band, fmax = sr / 2 (the reference's
    fmax_loss=None)."""
    return mel_cfg.replace(fmax=float(mel_cfg.sampling_rate) / 2.0)


def dump_base_mels(filelist: Sequence[str], out_dir: str, mel_cfg: MelConfig = MelConfig(),
                   device="cpu") -> int:
    """Write `<stem>.npy` ground-truth mels ([n_mels, frames], of the wav cut
    to whole hops) for fine-tuning -> how many were written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for path in filelist:
        wav, _ = load_wav(path, sr=mel_cfg.sampling_rate)
        wav = np.clip(wav, -1.0, 1.0)
        usable = (len(wav) // mel_cfg.hop_size) * mel_cfg.hop_size
        if usable == 0:
            continue
        mel = mel_for_config(torch.from_numpy(np.ascontiguousarray(wav[None, :usable])).to(device),
                             mel_cfg)
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(out_dir, stem + ".npy"), mel[0].cpu().numpy())
        n += 1
    return n
