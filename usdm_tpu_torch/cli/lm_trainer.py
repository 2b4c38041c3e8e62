"""What the LM trainer CLIs (train_pt, train_sft) share: the state and step
of the full-parameter (resident or offloaded) and LoRA paths, batches on the
device, checkpoints with latest-step resume, the metrics of a step, and the
HF export.  Every path trains f32 masters with cfg.dtype as the compute
dtype (train/lm.py).  Given a core/mesh.py Mesh (core/distributed.py
make_cli_mesh), every rank builds the same global batch and trains on its
rows; the full-parameter state shards (FSDP + TP), LoRA runs data
parallel over the whole base; rank 0 alone logs and writes."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from usdm_tpu_torch.core import checkpoint as ckpt
from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train import lm as T
from usdm_tpu_torch.train import lora as LO


@dataclasses.dataclass
class Trainer:
    state: T.TrainState  # the masters, or the adapters with --lora
    step: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]
    base: Optional[dict]  # the frozen base of the LoRA path
    cfg: MistralConfig
    mesh: Optional[MS.Mesh] = None

    def params_for_export(self) -> Optional[dict]:
        """The trained params, LoRA merged into the base; a sharded state's
        gathered leaf by leaf to the host of rank 0 (None on the others)."""
        if self.base is not None:
            return LO.merge_lora(self.base, self.state.params)
        if self.state.layout is None:
            return self.state.params
        it = iter(self.state.layout)
        full = tree_map(lambda t: next(it).gather_to_host(t), self.state.params)
        return full if self.mesh.rank == 0 else None


def make_trainer(cfg: MistralConfig, tc: TrainConfig, device, gen: torch.Generator,
                 base: Optional[dict] = None, lora: bool = False, lora_r: int = 8,
                 lora_alpha: int = 64, offload: bool = False,
                 mesh: Optional[MS.Mesh] = None) -> Trainer:
    """`base`: f32 params to start from (drawn from `gen` when None).
    `lora`: adapters over the frozen base; else every parameter trains,
    its moments on the host with `offload`.  `mesh`: the step takes this
    rank's rows (to_device); the masters shard, a base is whole."""
    if lora:
        if base is None:
            base = M.init_params(cfg, gen, device, dtype="float32")
        adapters = LO.init_lora(cfg, gen, r=lora_r, alpha=lora_alpha, device=device)
        step, opt = LO.make_lora_train_step(cfg, tc, mesh)
        state = T.TrainState(adapters, opt.init(adapters), 0)
        return Trainer(state, lambda batch: step(base, state, batch), base, cfg, mesh)
    init = T.init_offload_state if offload else T.init_state
    state = init(cfg, tc, device, gen, base, mesh=mesh)
    step = T.make_train_step(cfg, tc, mesh)
    return Trainer(state, lambda batch: step(state, batch), None, cfg, mesh)


def to_device(batch: Dict[str, np.ndarray], device,
              mesh: Optional[MS.Mesh] = None) -> Dict[str, torch.Tensor]:
    """A global batch's arrays on `device`: this rank's rows under a mesh."""
    if mesh is not None:
        batch = MS.shard_batch(mesh, batch)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


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
    readable by checkpoint.load_mistral and usdm_tpu's loader; written by
    rank 0 (every rank joins the gathers)."""
    params = trainer.params_for_export()
    if trainer.mesh is None or trainer.mesh.rank == 0:
        ckpt.save_mistral_hf(path, params, trainer.cfg, tokenizer=tokenizer)
