"""Host-side wav IO, polyphase resampling and length buckets (numpy and
scipy; no librosa or soundfile)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 mono waveform in [-1, 1], sample rate); int16, int32,
    uint8 and float files."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return wav, int(sr)


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(path: str, sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read, then resample to `sr` when given."""
    wav, orig = read_wav(path)
    if sr is not None and orig != sr:
        wav = resample(wav, orig, sr)
        orig = sr
    return wav, orig


def ceil_to(n: int, b: int) -> int:
    """Smallest positive multiple of `b` that is >= n (at least b)."""
    return -(-max(n, 1) // b) * b


def pad_to_bucket(wav: np.ndarray, sample_rate: int,
                  bucket_s: float = 0.5) -> Tuple[np.ndarray, int]:
    """Zero-pad a 1-D wav up to a `bucket_s`-second multiple -> (padded,
    true length), so the shapes downstream come from few buckets."""
    wav = np.asarray(wav, np.float32)
    bucket = max(int(sample_rate * bucket_s), 1)
    n = len(wav)
    padded = np.zeros(ceil_to(n, bucket), np.float32)
    padded[:n] = wav
    return padded, n
