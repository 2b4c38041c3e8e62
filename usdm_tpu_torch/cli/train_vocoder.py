"""CLI: BigVGAN vocoder GAN training / fine-tuning, on one GPU or data
parallel over several.

Port of usdm_tpu/cli/train_vocoder.py, with its flags plus `--device`:

  python -m usdm_tpu_torch.cli.train_vocoder --output_dir out \\
      --input_wavs_dir wavs/ --input_training_file train.txt \\
      [--input_validation_file val.txt] [--max_steps N] [--export DIR]

Filelist-driven random waveform crops (data/mel_dataset.py), alternating
MPD + MRD discriminator and generator steps (train/vocoder.py: LSGAN, 2x
feature matching, 45x full-band mel L1), AdamW(0.8, 0.99) with exponential
decay (`--lr_decay`, which usdm_tpu parses and does not pass on), f32
throughout, K3 forward in every activation.  Each epoch ends with the
validation mel L1 (every --eval_every epochs) and a checkpoint (every
--save_every epochs); `--init_from` warm-starts the generator from a
BigVGAN dir; `--fine_tuning` conditions on the precomputed mels of
`--base_mels_path`.  Checkpoints `<output_dir>/checkpoints/step_N` are
named by the global step and hold the whole GAN state, the epoch, the
position in it and the data rng's state, so `--resume` continues from the
newest one exactly as the uninterrupted run goes on (usdm_tpu names its
per-epoch checkpoints by epoch, its last by the run's own step count, and
restarts the step count on resume).  Metrics of every step go to
`<output_dir>/metrics.jsonl` (disc_loss, gen_loss, gen_adv, gen_fm,
gen_mel_l1, the wall step_s, data loading included, and, on the card,
max_memory_gib).  `--export DIR` writes the trained generator as
config.json + bigvgan_generator.pt (checkpoint.load_bigvgan reads it).
`--device cuda` (the default) raises without a card.

Data parallel (usdm_tpu's create_mesh(dp=-1, tp=1): every rank over
`data`, the GAN state replicated): one process per GPU, started by torchrun
or with `--coordinator host:port --num_processes N --process_id r` each.
Every rank draws the same global batch of --batch_size crops from the
seeded loader and trains on its block of rows; rank 0 alone logs,
validates and writes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--input_wavs_dir", required=True)
    p.add_argument("--input_training_file", required=True,
                   help="lines of 'name|...'; first field resolved against input_wavs_dir")
    p.add_argument("--input_validation_file", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--segment_size", type=int, default=8192)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--lr_decay", type=float, default=0.999)
    p.add_argument("--n_epochs", type=int, default=3100)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--save_every", type=int, default=1, help="epochs between checkpoints")
    p.add_argument("--eval_every", type=int, default=1, help="epochs between validation passes")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_from", default=None,
                   help="warm-start the generator from a BigVGAN dir (fine-tuning)")
    p.add_argument("--fine_tuning", action="store_true",
                   help="condition on precomputed mels from --base_mels_path")
    p.add_argument("--base_mels_path", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--export", default=None,
                   help="after training, export the generator as config.json + "
                        "bigvgan_generator.pt (reference layout)")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    from usdm_tpu_torch.core import distributed as D

    D.add_cli_args(p)
    args = p.parse_args(argv)

    import torch

    from usdm_tpu_torch.audio.mel import mel_for_config
    from usdm_tpu_torch.cli.lm_trainer import StepMetrics
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core import mesh as MS
    from usdm_tpu_torch.core.config import BigVGANConfig, MelConfig
    from usdm_tpu_torch.core.logging import MetricsLogger
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.data.mel_dataset import (MelAudioDataset, collate_mel_batch,
                                                 loss_mel_config, read_vocoder_filelist)
    from usdm_tpu_torch.models import bigvgan as BV
    from usdm_tpu_torch.train import vocoder as V

    device = ckpt.check_device(args.device)
    mesh = D.make_cli_mesh(args, device)
    primary = D.is_primary()
    cfg = BigVGANConfig.tiny() if args.tiny else BigVGANConfig()
    mel_cfg = MelConfig()
    resolutions, periods = BV.DEFAULT_RESOLUTIONS, BV.DEFAULT_PERIODS
    if args.tiny:
        # the hop must equal the generator's upsampling so wav and mel lengths align
        mel_cfg = mel_cfg.replace(num_mels=cfg.num_mels, n_fft=64, win_size=64,
                                  hop_size=cfg.total_upsample)
        resolutions, periods = ((256, 64, 128),), (2, 3)
    if args.segment_size % mel_cfg.hop_size:
        p.error(f"--segment_size must be a multiple of the hop {mel_cfg.hop_size}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, gopt, dopt = V.init_state(cfg, gen, args.learning_rate, args.lr_decay, periods,
                                     device)
    if args.init_from:
        warm, _ = ckpt.load_bigvgan(args.init_from, cfg, device=device)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(state.gen_params), tree_leaves(warm)):
                dst.copy_(src)
        del warm

    rng = np.random.default_rng(args.seed)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    pos = {"epoch": 0, "order": None, "next": 0}  # where the data stands
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        ckpt.restore_train_state(ckpt_dir, state)
        saved = ckpt.read_train_extra(ckpt_dir, state.step)
        rng.bit_generator.state = saved["rng"]
        pos = {k: saved[k] for k in pos}
        if primary:
            print(f"resuming from step {state.step} (epoch {pos['epoch']})")

    disc_step, gen_step = V.make_train_steps(cfg, gopt, dopt, loss_mel_config(mel_cfg),
                                             resolutions, periods, mesh)
    files = read_vocoder_filelist(args.input_training_file, args.input_wavs_dir)
    dataset = MelAudioDataset(files, args.segment_size, mel_cfg, fine_tuning=args.fine_tuning,
                              base_mels_path=args.base_mels_path)
    if len(dataset) < args.batch_size:
        p.error(f"{len(dataset)} training clips make no batch of --batch_size "
                f"{args.batch_size}")
    val = None
    if args.input_validation_file:
        val = MelAudioDataset(read_vocoder_filelist(args.input_validation_file,
                                                    args.input_wavs_dir),
                              args.segment_size, mel_cfg, fine_tuning=args.fine_tuning,
                              base_mels_path=args.base_mels_path)

    logger = MetricsLogger(args.output_dir, use_tensorboard=False, enabled=primary)
    metrics_of = StepMetrics(state.step, device)

    saved_at = [state.step if args.resume else None]

    def save():
        ckpt.save_train_state(ckpt_dir, state, state.step,
                              extra={**pos, "rng": rng.bit_generator.state})
        saved_at[0] = state.step

    def done() -> bool:
        return bool(args.max_steps) and state.step >= args.max_steps

    bs = args.batch_size
    while pos["epoch"] < args.n_epochs and not done():
        epoch = pos["epoch"]
        if pos["order"] is None:
            pos["order"] = rng.permutation(len(dataset)).tolist()
        order = pos["order"]
        starts = range(0, len(order) - bs + 1, bs)
        while pos["next"] < len(starts) and not done():
            i = starts[pos["next"]]
            items = [dataset.__getitem__(j, rng) for j in order[i:i + bs]]
            batch = collate_mel_batch(items, mel_cfg, device)
            if mesh is not None:  # this rank's rows of the global batch
                batch = MS.shard_batch(mesh, batch)
            metrics = {**disc_step(state, batch), **gen_step(state, batch)}
            vals = metrics_of(state.step, metrics)  # waits for the step
            pos["next"] += 1
            logger.log(state.step, vals)
            if (state.step % 20 == 0 or state.step == 1) and primary:
                print(f"epoch {epoch} step {state.step}: gen={vals['gen_loss']:.4f} "
                      f"disc={vals['disc_loss']:.4f} mel_l1={vals['gen_mel_l1']:.4f}")
        if done():
            break
        if (val is not None and (epoch + 1) % max(args.eval_every, 1) == 0 and len(val)
                and primary):
            # cycled when the validation set is smaller than a batch
            items = [val.__getitem__(j % len(val), np.random.default_rng(0)) for j in range(bs)]
            batch = collate_mel_batch(items, mel_cfg, device)
            fake = BV.generator(state.gen_params, cfg, batch["mel"])
            t = min(fake.shape[-1], batch["wav"].shape[-1])
            lc = loss_mel_config(mel_cfg)
            err = float(torch.mean(torch.abs(mel_for_config(batch["wav"][:, 0, :t], lc)
                                             - mel_for_config(fake[:, 0, :t], lc))))
            logger.log(state.step, {"val_mel_l1": err}, prefix="eval")
            print(f"epoch {epoch}: val_mel_l1={err:.4f}")
        pos = {"epoch": epoch + 1, "order": None, "next": 0}
        if (epoch + 1) % args.save_every == 0:
            save()
    if saved_at[0] != state.step:
        save()
    if args.export and primary:
        ckpt.save_bigvgan_generator(args.export, state.gen_params, cfg)
        print(f"exported generator: {args.export}")
    logger.close()
    D.finish()
    if primary:
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
