"""Speech synthesis back end: units (+ an optional speaker reference) -> waveform.

Port of usdm_tpu/engine/synthesis.py (`SpeechDecoder.synthesize`,
`prepare_reference`): pool 50 Hz units to the mel frame rate, sample the
mel with Voicebox (Heun, CFG 1.0) on a frame bucket, de-normalize, vocode
with the mel edge-padded to the bucket, and cut the waveform to the exact
sample count.  With a reference, its pooled units and normalized mel are
prepended as a speech prompt that the ODE re-noises at every stage, and
the prompt frames are sliced off before the vocoder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.audio.mel import mel_for_config_bucketed, normalize_mel
from usdm_tpu_torch.audio.units import expand_and_pool
from usdm_tpu_torch.audio.wav import ceil_to, load_wav
from usdm_tpu_torch.core.config import BigVGANConfig, MelConfig, VoiceboxConfig, XlsrConfig
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.models import xlsr as XL

# (pooled reference units [n_ref] int, normalized reference mel [1, n_mels, n_ref] f32)
Reference = Tuple[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class SpeechDecoder:
    voicebox_params: VB.Params
    voicebox_cfg: VoiceboxConfig
    vocoder_params: BV.Params
    vocoder_cfg: BigVGANConfig
    mel_cfg: MelConfig = MelConfig()
    # frames are padded up to a multiple of this (0 = exact shapes), as in
    # usdm_tpu, so the port computes on the reference's shapes
    frame_bucket: int = 64

    @property
    def device(self) -> torch.device:
        return self.voicebox_params["proj_in_w"].device

    def _bucket(self, n: int) -> int:
        return ceil_to(n, self.frame_bucket) if self.frame_bucket else n

    def synthesize(self, units: Sequence[int], seed: int = 0,
                   reference: Optional[Reference] = None, n_timesteps: int = 50,
                   solver: str = "heun", gradient_scale: float = 1.0,
                   z: Optional[torch.Tensor] = None,
                   prompt_noises: Optional[torch.Tensor] = None) -> np.ndarray:
        """units (50 Hz ids) -> float waveform at mel_cfg.sampling_rate.

        With `reference` (prepare_reference's output), the reference's n_ref
        pooled units and the agent's share one row of bucket(n_ref +
        n_agent) frames, the reference mel fills cond's first n_ref frames
        as the speech prompt, and the mel is sliced to the agent's frames.
        The ODE's initial noise `z` ([1, n_mels, frames]) and the prompt's
        renoise draws `prompt_noises` (VB.generate) are given, or drawn from
        a torch.Generator seeded with `seed`."""
        mc = self.mel_cfg
        agent_units, _ = expand_and_pool(np.asarray(units), mc.sampling_rate, mc.token_sr,
                                         mc.hop_size)
        n_agent = len(agent_units)
        if n_agent == 0:
            return np.zeros(0, np.float32)
        dev = self.device
        row, n_ref = agent_units, 0
        if reference is not None:
            ref_units, ref_mel = reference
            n_ref = len(ref_units)
            row = np.concatenate([np.asarray(ref_units), agent_units])
        t = n_ref + n_agent
        x = torch.zeros((1, self._bucket(t)), dtype=torch.int64, device=dev)
        x[0, :t] = torch.from_numpy(row.astype(np.int64)).to(dev)
        cond = torch.zeros((1, mc.num_mels, self._bucket(t)), device=dev)
        if n_ref:
            cond[:, :, :n_ref] = ref_mel.to(dev)
        needs_draw = z is None or (reference is not None and prompt_noises is None)
        gen = torch.Generator(device=dev).manual_seed(seed) if needs_draw else None
        mel = VB.generate(self.voicebox_params, self.voicebox_cfg, x, cond,
                          torch.tensor([t], device=dev), n_timesteps=n_timesteps,
                          solver=solver, gradient_scale=gradient_scale, z=z, generator=gen,
                          speech_prompt=reference is not None, prompt_len=n_ref,
                          prompt_noises=prompt_noises)
        mel = mel[:, :, n_ref:t] * mc.mel_std + mc.mel_mean
        # the vocoder's bucket is the agent's alone: edge-replicate its last
        # frame over the pad, as usdm_tpu does
        pad = self._bucket(n_agent) - n_agent
        if pad:
            mel = F.pad(mel, (0, pad), mode="replicate")
        wav = BV.generator(self.vocoder_params, self.vocoder_cfg, mel)
        n_samples = n_agent * self.vocoder_cfg.total_upsample
        return np.clip(wav[0, 0, :n_samples].float().cpu().numpy(), -1.0, 1.0)


def prepare_reference(reference_path: str, xlsr_params: XL.Params, xlsr_cfg: XlsrConfig,
                      mel_cfg: MelConfig = MelConfig(), device="cuda") -> Reference:
    """Reference wav -> (pooled reference units, normalized reference mel on
    `device`): units from the wav at xlsr_cfg.sample_rate, the mel from the
    wav at mel_cfg.sampling_rate, cut or zero-padded to the pooled units'
    sample length and clipped to [-1, 1]; both cut to the shorter."""
    device = torch.device(device)
    wav16, _ = load_wav(reference_path, sr=xlsr_cfg.sample_rate)
    units = np.asarray(XL.extract_units_bucketed(xlsr_params, xlsr_cfg, wav16, device=device))
    pooled, new_length = expand_and_pool(units, mel_cfg.sampling_rate, mel_cfg.token_sr,
                                         mel_cfg.hop_size)
    wav22, _ = load_wav(reference_path, sr=mel_cfg.sampling_rate)
    if len(wav22) < new_length:
        wav22 = np.pad(wav22, (0, new_length - len(wav22)))
    wav22 = wav22[:new_length]
    mel = normalize_mel(mel_for_config_bucketed(np.clip(wav22, -1.0, 1.0), mel_cfg,
                                                device=device), mel_cfg)
    n = min(len(pooled), mel.shape[-1])
    return pooled[:n], mel[:, :, :n]
