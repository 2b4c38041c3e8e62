"""BigVGAN GAN training, on one GPU or data parallel: a discriminator
step, then a generator step.

Port of usdm_tpu/train/vocoder.py: LSGAN adversarial losses over MPD + MRD,
feature matching (x2, inside feature_loss) and the full-band mel L1 (x45),
AdamW(b1 0.8, b2 0.99, weight decay 0.01) with exponential decay for each
side, f32 throughout.  usdm_tpu jits two data-parallel steps that donate
the state; here each step is eager and updates the parameters and moments
in place, on one device or, given a core/mesh.py Mesh, on every rank with
the state replicated and the batch split over data.  The discriminator step runs the
generator without autograd; the generator step scores its output with the
freshly updated discriminators, detached (so their gradients are never
computed).  Every BigVGAN activation is K3 (ops/fused_act.py), whose
backward recomputes the plain composition, as usdm_tpu's custom_vjp.

Data parallel: every loss term is a mean over equal-sized per-example
blocks (the LSGAN terms, feature matching, the mel L1), and every rank
holds the same number of rows (shard_batch), so the global mean is the mean
of the ranks' means: each rank's loss is scaled by 1 / ranks, the
gradients are all-reduced as sums, and the shown losses are all-reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from usdm_tpu_torch.audio.mel import mel_for_config
from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import BigVGANConfig, MelConfig, TrainConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.train.lm import AdamWState, ClipAdamW

MEL_LOSS_WEIGHT = 45.0


@dataclasses.dataclass
class GanTrainState:
    gen_params: dict  # f32 with requires_grad
    mpd: list
    mrd: list
    gen_opt: AdamWState  # over tree_leaves(gen_params)
    disc_opt: AdamWState  # over tree_leaves(discs)
    step: int = 0

    @property
    def discs(self) -> dict:
        return {"mpd": self.mpd, "mrd": self.mrd}

    @property
    def params(self) -> dict:
        """Every parameter, for checkpoint.save_train_state."""
        return {"gen": self.gen_params, **self.discs}

    @property
    def opt_state(self) -> "_BothOpts":
        return _BothOpts(self)


@dataclasses.dataclass
class _BothOpts:
    """Both optimizers' state as one, for the train-state checkpoints."""

    state: GanTrainState

    def state_dict(self) -> dict:
        return {"gen": self.state.gen_opt.state_dict(), "disc": self.state.disc_opt.state_dict()}

    def load_state_dict(self, saved: dict) -> None:
        self.state.gen_opt.load_state_dict(saved["gen"])
        self.state.disc_opt.load_state_dict(saved["disc"])


# optax.adamw's settings in usdm_tpu's make_optimizer (eps 1e-8); no clipping
GAN_TC = TrainConfig(adam_b1=0.8, adam_b2=0.99, weight_decay=0.01)


def make_optimizer(lr: float = 2e-4, decay: float = 0.999) -> ClipAdamW:
    """optax.adamw(exponential_decay(lr, 1000, decay**1000), b1=0.8, b2=0.99,
    weight_decay=0.01): lr(count) = lr * (decay**1000) ** (count / 1000), at
    the count before the increment, as optax takes it."""
    return ClipAdamW(GAN_TC, lambda count: lr * (decay**1000) ** (count / 1000), clip=False)


def init_state(cfg: BigVGANConfig, generator: torch.Generator, lr: float = 2e-4,
               decay: float = 0.999, periods: Sequence[int] = BV.DEFAULT_PERIODS,
               device="cpu"):
    """Generator, MPD (one per period) and MRD (three resolutions) drawn from
    `generator` on `device`, zero moments -> (state, gen optimizer, disc
    optimizer)."""
    gen = BV.init_generator(cfg, generator, device)
    mpd = BV.init_mpd(generator, periods, device=device)
    mrd = BV.init_mrd(generator, device=device)
    gen, mpd, mrd = (tree_map(lambda t: t.requires_grad_(True), x) for x in (gen, mpd, mrd))
    gopt, dopt = make_optimizer(lr, decay), make_optimizer(lr, decay)
    state = GanTrainState(gen, mpd, mrd, gopt.init(gen), dopt.init({"mpd": mpd, "mrd": mrd}))
    return state, gopt, dopt


def _mel(wav_b1t: torch.Tensor, mc: MelConfig) -> torch.Tensor:
    return mel_for_config(wav_b1t[:, 0], mc)


def make_train_steps(cfg: BigVGANConfig, gopt: ClipAdamW, dopt: ClipAdamW,
                     mel_cfg: MelConfig = MelConfig(), resolutions=BV.DEFAULT_RESOLUTIONS,
                     periods=BV.DEFAULT_PERIODS, mesh: Optional["MS.Mesh"] = None):
    """-> (disc_step, gen_step), each (state, batch) -> metrics (device
    tensors, no synchronization), the state updated in place; call disc
    first, then gen (HiFi-GAN's order).  batch: "mel" [B, n_mels, F] and
    "wav" [B, 1, T] on the params' device; `mel_cfg` is the loss mel's
    (fmax sr/2: data/mel_dataset.py::loss_mel_config).  `mesh`: the batch
    is this rank's rows; the metrics are the global batch's."""
    ranks = 1 if mesh is None else mesh.batch_shards

    def finish(loss, params, shown):
        """Backward of this rank's share of the global mean, the gradients
        summed over the ranks, the shown values (stacked) averaged."""
        (loss / ranks).backward()
        shown = torch.stack([v.detach() for v in shown])
        if mesh is None:
            return shown
        MS.all_reduce_grads(params, mesh)
        return MS.all_reduce(shown, mesh, mesh.batch_axes) / ranks

    def cropped(fake, batch):
        t = min(fake.shape[-1], batch["wav"].shape[-1])
        return batch["wav"][..., :t], fake[..., :t]

    def disc_step(state: GanTrainState, batch: Dict[str, torch.Tensor]) -> dict:
        with torch.no_grad():
            fake = BV.forward(state.gen_params, cfg, batch["mel"])
        real, fake = cropped(fake, batch)
        y_r, y_g, _, _ = BV.discriminate(state.mpd, state.mrd, resolutions, real, fake, periods)
        loss, _, _ = BV.discriminator_loss(y_r, y_g)
        shown = finish(loss, state.discs, [loss])
        dopt.update(state.discs, state.disc_opt)
        return {"disc_loss": shown[0]}

    def gen_step(state: GanTrainState, batch: Dict[str, torch.Tensor]) -> dict:
        fake = BV.forward(state.gen_params, cfg, batch["mel"])
        real, fake = cropped(fake, batch)
        discs = tree_map(lambda t: t.detach(), state.discs)
        y_r, y_g, f_r, f_g = BV.discriminate(discs["mpd"], discs["mrd"], resolutions, real, fake,
                                             periods)
        adv, _ = BV.generator_loss(y_g)
        fm = BV.feature_loss(f_r, f_g)
        mel_l1 = torch.mean(torch.abs(_mel(real, mel_cfg) - _mel(fake, mel_cfg)))
        loss = adv + fm + MEL_LOSS_WEIGHT * mel_l1
        shown = finish(loss, state.gen_params, [adv, fm, mel_l1, loss])
        gopt.update(state.gen_params, state.gen_opt)
        state.step += 1
        return dict(zip(("gen_adv", "gen_fm", "gen_mel_l1", "gen_loss"), shown))

    return disc_step, gen_step
