"""Helpers shared by the checkpoint converters of models/*.py.

A converter takes a state dict of host tensors (core/checkpoint.py
`read_state_dict`: possibly backed by mapped files) and pops each tensor
as it converts it, so its pages are released as soon as its copy on the
device exists.  Weight-norm folds run on the host in numpy, with the JAX
package's expression and dtype rules, so they give its bits.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 (which numpy lacks) widened to f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fold_weight_norm(state: State, prefix: str, axes: Sequence[int],
                     cast_f32: bool = False) -> torch.Tensor:
    """`prefix`.weight, or torch weight_norm's pair folded: g * v / ||v||
    over `axes`, from `weight_g`/`weight_v` or
    `parametrizations.weight.original0/1`.  The fold computes in the stored
    dtype, or in f32 with `cast_f32`, as each of usdm_tpu's converters does;
    the tensors are popped from `state`."""
    if f"{prefix}.weight" in state:
        return state.pop(f"{prefix}.weight")
    if f"{prefix}.weight_g" in state:
        g, v = state.pop(f"{prefix}.weight_g"), state.pop(f"{prefix}.weight_v")
    else:
        g = state.pop(f"{prefix}.parametrizations.weight.original0")
        v = state.pop(f"{prefix}.parametrizations.weight.original1")
    g, v = host_numpy(g), host_numpy(v)
    if cast_f32:
        g, v = g.astype(np.float32), v.astype(np.float32)
    norm = np.sqrt((v * v).sum(axis=tuple(axes), keepdims=True))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def take(state: State, name: str, device, dtype=torch.float32) -> torch.Tensor:
    """Pop `name` and return it on `device` in `dtype`."""
    return state.pop(name).to(device=device, dtype=dtype)


def take_linear(state: State, name: str, device, dtype=torch.float32) -> torch.Tensor:
    """Pop an nn.Linear weight [out, in] and return it as [in, out]."""
    return take(state, name, device, dtype).t().contiguous()
