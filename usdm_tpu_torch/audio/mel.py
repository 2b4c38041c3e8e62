"""Mel-spectrogram pipeline in PyTorch.

Port of usdm_tpu/audio/mel.py, with its math rather than torch.stft's padding
conventions, so frame counts match exactly: reflect-pad by (n_fft - hop) / 2,
frames at k * hop times a periodic Hann window, `torch.fft.rfft`, magnitude
sqrt(re^2 + im^2 + 1e-9), the librosa slaney mel basis (numpy, float64 then
float32), log(clamp(x, 1e-5)).  Runs on whatever device the waveform is on.
`mel_for_config_bucketed` computes a host wav's mel at a 0.5 s bucket of
its length, as usdm_tpu does for speaker reference clips.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.audio.wav import ceil_to
from usdm_tpu_torch.core.config import MelConfig

_MIN_LOG_HZ = 1000.0
_F_SP = 200.0 / 3
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """[n_mels, n_fft//2+1] slaney-normalized triangular filterbank."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])  # slaney normalization
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_periodic(win: int) -> np.ndarray:
    n = np.arange(win)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)


def frame_signal(y: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, frame_len]; frames start at k * hop."""
    return y.unfold(-1, frame_len, hop)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """sqrt(|STFT|^2 + 1e-9) of an already padded [..., T] signal ->
    [..., n_freq, n_frames]."""
    window = torch.from_numpy(_hann_periodic(win)).to(y.device)
    frames = frame_signal(y, win, hop) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)  # zero-pads win up to n_fft
    mag = torch.sqrt(spec.real**2 + spec.imag**2 + 1e-9)
    return mag.transpose(-1, -2)


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 22050, hop_size: int = 256, win_size: int = 1024,
                    fmin: float = 0.0, fmax: float = 8000.0,
                    center_pad: bool = True) -> torch.Tensor:
    """[B, T] f32 waveform in [-1, 1] -> [B, num_mels, T // hop] log-mel.
    `center_pad=False` skips the reflect pad, for callers that applied it
    on the host (mel_for_config_bucketed).  The filterbank product runs in
    f64 and rounds to f32: usdm_tpu runs it at Precision.HIGHEST, and an f32
    product on the card would follow the global TF32 flag."""
    basis = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax))
    y = y.float()
    if center_pad:
        pad = int((n_fft - hop_size) // 2)
        y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    mag = stft_magnitude(y, n_fft, hop_size, win_size)  # [B, n_freq, F]
    mel = torch.einsum("mf,bft->bmt", basis.to(y.device, torch.float64), mag.double()).float()
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_for_config(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    return mel_spectrogram(y, cfg.n_fft, cfg.num_mels, cfg.sampling_rate, cfg.hop_size,
                           cfg.win_size, cfg.fmin, cfg.fmax)


def mel_for_config_bucketed(wav: np.ndarray, cfg: MelConfig, bucket_s: float = 0.5,
                            device="cpu") -> torch.Tensor:
    """mel_for_config of a 1-D host wav, computed on `device` at its length
    zero-extended to a `bucket_s` multiple -> [1, num_mels, n_frames] f32.
    Equal to the exact-length mel on every frame: the reflect pad is made
    here at the true length, and no kept frame's window reaches the zeros."""
    pad = int((cfg.n_fft - cfg.hop_size) // 2)
    n = len(wav)
    y = np.pad(np.asarray(wav, np.float32), (pad, pad), mode="reflect")
    full = np.zeros(ceil_to(n, max(int(cfg.sampling_rate * bucket_s), 1)) + 2 * pad,
                    np.float32)
    full[: len(y)] = y
    n_frames = 1 + (n + 2 * pad - cfg.win_size) // cfg.hop_size
    mel = mel_spectrogram(torch.from_numpy(full[None]).to(device), cfg.n_fft, cfg.num_mels,
                          cfg.sampling_rate, cfg.hop_size, cfg.win_size, cfg.fmin, cfg.fmax,
                          center_pad=False)
    return mel[:, :, :n_frames]


def normalize_mel(mel, cfg: MelConfig):
    return (mel - cfg.mel_mean) / cfg.mel_std


def denormalize_mel(mel, cfg: MelConfig):
    return mel * cfg.mel_std + cfg.mel_mean
