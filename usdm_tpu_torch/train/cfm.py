"""token-Voicebox CFM trainer, on one GPU or data parallel.

Port of usdm_tpu/train/cfm.py: bf16 compute over f32 masters, the gradient
clipped to a global norm of 0.2 and Adam(1e-4), as the reference's config.
The JAX step is one jitted program over a data-parallel mesh; here it is an
eager step that updates the parameters and the Adam state in place (the
counterpart of `donate_argnums`), on one device or, given a core/mesh.py
Mesh, on every rank with the state replicated (usdm_tpu's layout: plain
data parallelism).  A rank's batch is its rows of the global batch; t and z
are drawn for the global batch from the generator every rank seeds alike,
and each rank takes its rows, so the step computes the single-device
step's numbers; the loss's denominator (loss frames x n_feats) is the
global one, and the gradients are all-reduced as sums before the update.

Parameters are a usdm_tpu_torch Voicebox params tree (dicts and lists of
tensors) whose leaves are f32 tensors with requires_grad.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import CfmTrainConfig, VoiceboxConfig
from usdm_tpu_torch.core.tree import tree_leaves, tree_map
from usdm_tpu_torch.models import voicebox as VB


@dataclasses.dataclass
class CfmTrainState:
    params: Any  # f32 master weights, requires_grad
    opt_state: torch.optim.Adam  # over tree_leaves(params), in that order
    step: int


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8).  The clip is written as optax
    computes it, g * max_norm / max(norm, max_norm); torch's
    clip_grad_norm_ adds 1e-6 to the norm."""

    max_norm: float
    lr: float

    def init(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(tree_leaves(params), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def update(self, adam: torch.optim.Adam) -> torch.Tensor:
        """Clip the gradients held in `.grad`, take one Adam step in place and
        clear the gradients -> the global norm before clipping."""
        grads = [p.grad for group in adam.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = self.max_norm / torch.clamp(norm, min=self.max_norm)
        for g in grads:
            g.mul_(scale)
        adam.step()
        adam.zero_grad(set_to_none=True)
        return norm


def make_optimizer(tc: CfmTrainConfig) -> ClipAdam:
    return ClipAdam(tc.grad_clip, tc.learning_rate)


def init_state(cfg: VoiceboxConfig, tc: CfmTrainConfig, device, generator: torch.Generator):
    """Random f32 parameters from `generator` (on `device`) -> (state, opt)."""
    opt = make_optimizer(tc)
    params = tree_map(lambda a: a.requires_grad_(True), VB.init_params(cfg, generator, device))
    return CfmTrainState(params, opt.init(params), 0), opt


def make_train_step(cfg: VoiceboxConfig, tc: CfmTrainConfig, opt: Optional[ClipAdam] = None,
                    compute_dtype: str = "bfloat16", mesh: Optional["MS.Mesh"] = None):
    """-> step(state, batch, generator=None, t=None, z=None) -> {"loss",
    "grad_norm"} (device tensors, no synchronization).  batch: "x" [B, T]
    units, "mask" [B, 1, T] context mask, "y" [B, n_feats, T] target mel,
    "y_lengths" [B], on the params' device.  t and z are drawn from
    `generator` unless given.  `mesh`: the batch is this rank's rows
    (core/mesh.py shard_batch), t and z (given or drawn) the global
    batch's; the metrics are global."""
    opt = opt or make_optimizer(tc)
    cdt = getattr(torch, compute_dtype)

    def to_compute(a: torch.Tensor) -> torch.Tensor:
        return a.to(cdt) if a.dtype == torch.float32 and a.ndim >= 2 else a

    def step(state: CfmTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        frames = None
        if mesh is not None:
            t, z = _global_noise(batch["y"], mesh, generator, t, z)
            frames = lambda n: MS.all_reduce(n.clone(), mesh, mesh.batch_axes)  # noqa: E731
        loss, _ = VB.cfm_loss(tree_map(to_compute, state.params), cfg, batch["x"],
                              batch["mask"].float(), batch["y"], batch["y_lengths"], t=t, z=z,
                              generator=generator, frames=frames)
        loss.backward()
        shown = loss.detach()
        if mesh is not None:
            MS.all_reduce_grads(state.params, mesh)
            shown = MS.all_reduce(shown.clone(), mesh, mesh.batch_axes)
        norm = opt.update(state.opt_state)
        state.step += 1
        return {"loss": shown, "grad_norm": norm}

    return step


def _global_noise(y: torch.Tensor, mesh: "MS.Mesh", generator, t, z):
    """This rank's rows of the global batch's t [B] and z [B, n_feats, T]:
    drawn as cfm_loss draws them for the whole batch (t, then z), unless
    given whole."""
    shape = (y.shape[0] * mesh.batch_shards,) + tuple(y.shape[1:])
    if t is None:
        t = torch.rand(shape[0], generator=generator, device=y.device, dtype=y.dtype)
    if z is None:
        z = torch.randn(shape, generator=generator, device=y.device, dtype=y.dtype)
    return MS.shard_batch(mesh, t), MS.shard_batch(mesh, z)


def make_eval_step(cfg: VoiceboxConfig):
    """-> step(params, batch, generator=None) -> {"loss"}: f32, no gradient."""

    @torch.no_grad()
    def step(params, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        loss, _ = VB.cfm_loss(params, cfg, batch["x"], batch["mask"].float(), batch["y"],
                              batch["y_lengths"], generator=generator, remat=False)
        return {"loss": loss}

    return step
