"""CLI: token-Voicebox CFM training, on one GPU or data parallel over several.

Port of usdm_tpu/cli/train_voicebox.py: unit-mel filelist dataset,
CFG/infilling collate, the train loop with bf16 compute over f32 masters and
per-layer remat, per-epoch eval loss and a 10-step Euler synthesis smoke
test, and train-state checkpoints with latest-step resume.

    python -m usdm_tpu_torch.cli.train_voicebox --train_filelist list.txt \\
        --output_dir out [--max_steps N] [--device cuda]

Runs on `--device` (default cuda) and raises when that device is absent; it
never falls back to the CPU (`--device cpu` asks for the CPU).  Metrics go to
`<output_dir>/metrics.jsonl` (usdm_tpu_torch.core.logging.MetricsLogger,
JSONL only): every step's loss, grad_norm and step_s, the wall time between two
steps' results.  A step's metrics are read after the next step is queued, so
the host prepares one batch while the device runs the previous step.
Every checkpoint is named by the global step (`checkpoints/step_N`), and
`--resume` continues the step count and the epoch from the newest one;
`--max_steps` counts global steps.  (usdm_tpu names its per-epoch checkpoints
by epoch and its last one by the run's own step count.)  `--bigvgan_dir`
vocodes each synthesis smoke test's mel into a wav
(`MetricsLogger.log_audio`); `--export_hub DIR` writes the trained params
as a HubMixin directory after training (`load_voicebox` and usdm_tpu's read
it).

Data parallel (usdm_tpu's create_mesh(dp=-1, tp=1): every rank over
`data`, the state replicated): one process per GPU, started by torchrun or
with `--coordinator host:port --num_processes N --process_id r` each.
Every rank builds the same global batch of --batch_size rows from the
seeded loader and trains on its block of rows (train/cfm.py draws t and z
for the global batch), so the run computes the single-process run's
numbers; rank 0 alone logs, runs the smoke tests and writes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--train_filelist", required=True,
                   help="lines of 'wav_path|units|durations' (reference filelist format)")
    p.add_argument("--valid_filelist", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--n_epochs", type=int, default=10000)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--out_size_second", type=int, default=16)
    p.add_argument("--p_uncond", type=float, default=0.2)
    p.add_argument("--p_drop", type=float, default=0.3)
    p.add_argument("--r_min", type=float, default=0.7)
    p.add_argument("--r_max", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=37)
    p.add_argument("--save_every", type=int, default=1, help="epochs between checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--synthesize_every", type=int, default=1,
                   help="epochs between mel synthesis smoke tests (0 = off)")
    p.add_argument("--export_hub", default=None,
                   help="after training, export the params as a HubMixin dir (read by "
                        "load_voicebox)")
    p.add_argument("--bigvgan_dir", default=None,
                   help="BigVGAN checkpoint dir: vocode each smoke test's mel into a wav")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    from usdm_tpu_torch.core import distributed as D

    D.add_cli_args(p)
    args = p.parse_args(argv)

    import torch

    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core import mesh as MS
    from usdm_tpu_torch.core.config import CfmTrainConfig, MelConfig, VoiceboxConfig
    from usdm_tpu_torch.core.logging import MetricsLogger
    from usdm_tpu_torch.data.unit_mel import UnitMelCollate, UnitMelDataset
    from usdm_tpu_torch.models import bigvgan as BV
    from usdm_tpu_torch.models import voicebox as VB
    from usdm_tpu_torch.train import cfm as C

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available (pass --device cpu to train "
                           "on the CPU)")
    mesh = D.make_cli_mesh(args, device)
    primary = D.is_primary()

    cfg = VoiceboxConfig.tiny().replace(n_feats=80) if args.tiny else VoiceboxConfig()
    mel_cfg = MelConfig()
    tc = CfmTrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        out_size_seconds=args.out_size_second, p_uncond=args.p_uncond,
        p_drop=args.p_drop, r_min=args.r_min, r_max=args.r_max,
        seed=args.seed, n_epochs=args.n_epochs, save_every=args.save_every,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, opt = C.init_state(cfg, tc, device, gen)

    dataset = UnitMelDataset(args.train_filelist, mel_cfg, n_tokens=cfg.n_tokens)
    collate = UnitMelCollate(tc, mel_cfg, n_tokens=cfg.n_tokens)
    val = (UnitMelDataset(args.valid_filelist, mel_cfg, n_tokens=cfg.n_tokens)
           if args.valid_filelist else None)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        state = ckpt.restore_train_state(ckpt_dir, state)
        if primary:
            print(f"resuming from step {state.step}")
    gstep = state.step
    saved = gstep if args.resume else None
    start_epoch = gstep // steps_per_epoch

    step_fn = C.make_train_step(cfg, tc, opt, mesh=mesh)
    eval_fn = C.make_eval_step(cfg)
    logger = MetricsLogger(args.output_dir, use_tensorboard=False, enabled=primary)
    vocoder = ckpt.load_bigvgan(args.bigvgan_dir, device=device) if args.bigvgan_dir else None

    def to_device(batch, shard=True):
        if mesh is not None and shard:  # this rank's rows
            batch = MS.shard_batch(mesh, batch)
        out = {}
        for k, v in batch.items():
            v = np.ascontiguousarray(v)
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                      else t)
        return out

    last = [time.perf_counter()]
    pending = []  # (gstep, epoch, metrics) of the step whose result is not read yet

    def flush():
        for gstep_, epoch_, metrics in pending:
            vals = {k: float(v) for k, v in metrics.items()}  # waits for that step
            now = time.perf_counter()
            vals["step_s"] = now - last[0]
            last[0] = now
            logger.log(gstep_, vals)
            if gstep_ % 20 == 0 and primary:
                print(f"epoch {epoch_} step {gstep_}: loss={vals['loss']:.4f}")
        pending.clear()

    rng = np.random.default_rng(args.seed)
    for epoch in range(start_epoch, args.n_epochs):
        order = rng.permutation(len(dataset))
        for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
            if args.max_steps and gstep >= args.max_steps:
                break
            items = [dataset[j] for j in order[i: i + args.batch_size]]
            batch = to_device(collate(items, rng))
            metrics = step_fn(state, batch, gen)
            gstep += 1
            flush()  # the previous step's, while this one runs
            pending.append((gstep, epoch, metrics))
        if args.max_steps and gstep >= args.max_steps:
            break
        if val is not None:
            flush()
            items = [val[j] for j in range(min(len(val), args.batch_size))]
            batch = collate(items, rng, evaluation=True)  # every rank: rng stays in step
            if primary:
                ev = eval_fn(state.params, to_device(batch, shard=False),
                             torch.Generator(device=device).manual_seed(0))
                logger.log(gstep, ev, prefix="eval")
        if (args.synthesize_every and (epoch + 1) % args.synthesize_every == 0 and len(dataset)
                and primary):
            flush()
            unit, _ = dataset[0]  # smoke test: synthesize the first sample's mel
            n = min(len(unit), 200)
            with torch.no_grad():
                out = VB.generate(state.params, cfg,
                                  torch.from_numpy(unit[None, :n]).to(device),
                                  torch.zeros((1, cfg.n_feats, n), device=device),
                                  torch.tensor([n], device=device), n_timesteps=10,
                                  solver="euler", gradient_scale=1.0,
                                  generator=torch.Generator(device=device).manual_seed(epoch))
            logger.log(gstep, {"synth_mel_mean": float(out.mean())}, prefix="smoke")
            if vocoder is not None:
                bv_params, bv_cfg = vocoder
                with torch.no_grad():
                    wav = BV.generator(bv_params, bv_cfg, out * mel_cfg.mel_std + mel_cfg.mel_mean)
                logger.log_audio(gstep, "smoke/audio", wav[0, 0].float().cpu().numpy(),
                                 mel_cfg.sampling_rate)
        if (epoch + 1) % args.save_every == 0:
            flush()
            ckpt.save_train_state(ckpt_dir, state, state.step)
            saved = state.step
    flush()
    if saved != state.step:
        ckpt.save_train_state(ckpt_dir, state, state.step)
    if args.export_hub and primary:
        # the reference's training saves a HubMixin dir (decoder/scripts/train.py:305-318)
        ckpt.save_voicebox_hub(args.export_hub, state.params, cfg)
        print(f"exported HubMixin dir: {args.export_hub}")
    logger.close()
    D.finish()
    if primary:
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
