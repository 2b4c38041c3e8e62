"""Metrics logging: a JSONL stream, TensorBoard through torch's
SummaryWriter when it is installed and asked for, and audio smoke tests
(usdm_tpu's MetricsLogger)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, out_dir: str, use_tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "train") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[f"{prefix}/{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def log_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """An audible smoke test: to TensorBoard when it is on, else a wav
        file `audio_<tag>_<step>.wav` in the output directory."""
        import numpy as np

        if self._tb is not None:
            import torch

            self._tb.add_audio(tag, torch.from_numpy(np.asarray(wav))[None], step, sample_rate)
        else:
            from usdm_tpu_torch.audio.wav import write_wav

            path = os.path.join(self.out_dir, f"audio_{tag.replace('/', '_')}_{step}.wav")
            write_wav(path, np.asarray(wav), sample_rate)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
