"""Train-state checkpoints: `torch.save` under `path/step_N`.

Port of the train-state part of usdm_tpu/core/checkpoint.py
(`save_train_state`, `latest_step`, `restore_train_state`, keep=2).  Each
checkpoint is a directory `step_N` holding `state.pt` (the params tree on the
CPU, the Adam state dict and the step); it is written under a temporary name
and renamed into place, so a reader never sees half a checkpoint.  These are
not orbax checkpoints: usdm_tpu's train states cannot be read here, nor the
port's there.  The reference-format loaders and exporters are not ported yet.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from usdm_tpu_torch.core.tree import tree_leaves, tree_map
from usdm_tpu_torch.train.cfm import CfmTrainState

_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(path))
                  if m and os.path.exists(os.path.join(path, m.group(0), _FILE)))


def save_train_state(path: str, state: CfmTrainState, step: int, keep: int = 2) -> None:
    """Write `state` as `path/step_<step>`, then drop all but the newest
    `keep` checkpoints."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step}")
    tmp = os.path.join(path, f".step_{step}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": tree_map(lambda a: a.detach().cpu(), state.params),
                "opt_state": state.opt_state.state_dict(), "step": int(state.step)},
               os.path.join(tmp, _FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{old}"))


def latest_step(path: str) -> Optional[int]:
    steps = _steps(os.path.abspath(path))
    return steps[-1] if steps else None


def restore_train_state(path: str, state: CfmTrainState,
                        step: Optional[int] = None) -> CfmTrainState:
    """Load `path/step_<step>` (the latest when None) into `state` in place:
    parameters copied into its tensors, on their device."""
    path = os.path.abspath(path)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no train-state checkpoint under {path}")
    saved = torch.load(os.path.join(path, f"step_{step}", _FILE), map_location="cpu",
                       weights_only=True)
    dst, src = tree_leaves(state.params), tree_leaves(saved["params"])
    if len(dst) != len(src) or any(a.shape != b.shape for a, b in zip(dst, src)):
        raise ValueError(f"checkpoint step_{step} does not match the model's parameters")
    with torch.no_grad():
        for a, b in zip(dst, src):
            a.copy_(b)
    state.opt_state.load_state_dict(saved["opt_state"])
    state.step = saved["step"]
    return state
