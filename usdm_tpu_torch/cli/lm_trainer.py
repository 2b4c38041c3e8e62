"""What the LM trainer CLIs (train_pt, train_sft) share: the state and step
of the full-parameter (resident or offloaded) and LoRA paths, batches on the
device, checkpoints with latest-step resume, the metrics of a step, and the
HF export.  Every path trains f32 masters with cfg.dtype as the compute
dtype (train/lm.py)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from usdm_tpu_torch.core import checkpoint as ckpt
from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train import lm as T
from usdm_tpu_torch.train import lora as LO


@dataclasses.dataclass
class Trainer:
    state: T.TrainState  # the masters, or the adapters with --lora
    step: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]
    base: Optional[dict]  # the frozen base of the LoRA path
    cfg: MistralConfig

    def params_for_export(self) -> dict:
        """The trained params, LoRA merged into the base."""
        if self.base is None:
            return self.state.params
        return LO.merge_lora(self.base, self.state.params)


def make_trainer(cfg: MistralConfig, tc: TrainConfig, device, gen: torch.Generator,
                 base: Optional[dict] = None, lora: bool = False, lora_r: int = 8,
                 lora_alpha: int = 64, offload: bool = False) -> Trainer:
    """`base`: f32 params to start from (drawn from `gen` when None).
    `lora`: adapters over the frozen base; else every parameter trains,
    its moments on the host with `offload`."""
    if lora:
        if base is None:
            base = M.init_params(cfg, gen, device, dtype="float32")
        adapters = LO.init_lora(cfg, gen, r=lora_r, alpha=lora_alpha, device=device)
        step, opt = LO.make_lora_train_step(cfg, tc)
        state = T.TrainState(adapters, opt.init(adapters), 0)
        return Trainer(state, lambda batch: step(base, state, batch), base, cfg)
    init = T.init_offload_state if offload else T.init_state
    state = init(cfg, tc, device, gen, base)
    step = T.make_train_step(cfg, tc)
    return Trainer(state, lambda batch: step(state, batch), None, cfg)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def resume(trainer: Trainer, ckpt_dir: str) -> int:
    """Restore the newest checkpoint under `ckpt_dir` into the trainer's
    state -> its step (0 when there is none)."""
    if ckpt.latest_step(ckpt_dir) is None:
        print(f"[warning] no checkpoints under {ckpt_dir}")
        return 0
    ckpt.restore_train_state(ckpt_dir, trainer.state)
    print(f"resuming from step {trainer.state.step}")
    return trainer.state.step


class StepMetrics:
    """A logged step's metrics as floats (which waits for it), with step_s,
    the wall seconds a step took since the last logged one, and on the card
    max_memory_gib, the peak of allocated device memory so far."""

    def __init__(self, start_step: int, device):
        self.restart(start_step)
        self.cuda = torch.device(device).type == "cuda"

    def restart(self, step: int) -> None:
        """Count the next step_s from now, as if `step` had just ended."""
        self.last = (step, time.perf_counter())

    def __call__(self, step: int, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        vals = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        vals["step_s"] = (now - self.last[1]) / max(step - self.last[0], 1)
        self.last = (step, now)
        if self.cuda:
            vals["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return vals


def export_hf(path: str, trainer: Trainer, tokenizer=None) -> None:
    """The trained params (LoRA merged) as an HF Mistral dir in bf16,
    readable by checkpoint.load_mistral and usdm_tpu's loader."""
    ckpt.save_mistral_hf(path, trainer.params_for_export(), trainer.cfg, tokenizer=tokenizer)
