"""CLI: DailyTalk SFT (USDM phase), on one GPU or sharded over several.

Port of usdm_tpu/cli/train_sft.py, with its flags plus `--device` and
`--resume`:

  python -m usdm_tpu_torch.cli.train_sft --train_path sft.txt --output_dir out \\
      --model_dir ustm/ [--lora] [--resume] [--export_hf DIR]

Loads the USTM checkpoint (HF dir) as f32 masters computing in bf16 (or
draws a tiny model with --tiny), reads `ids|labels` lines (the DailyTalk
preprocessing output), right-pads each batch and trains in a random order
per epoch, every parameter or (--lora) adapters over the frozen base
(`--eval_path` is accepted and read by neither, as in usdm_tpu).
Checkpoints `<output_dir>/checkpoints/step_N` every --save_steps and at the
end hold the whole train state, the LoRA adapters' too (usdm_tpu saves the
adapters alone and cannot resume); `--resume` continues from the newest,
in the batch order of an uninterrupted run.  `--export_hf` writes the
final params (LoRA merged) as an HF dir.  Metrics as cli/train_pt.py's.
`--device cuda` (the default) raises without a card.  The multi-process
flags (--dp, --tp, --num_slices, --coordinator, --num_processes,
--process_id, or torchrun) run as cli/train_pt.py's: every parameter
sharded (FSDP + TP), or with --lora data parallel over the whole base
(usdm_tpu's layout; the model axis then repeats the work).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def read_sft_file(path: str):
    """'ids|labels' lines -> [(ids, labels)]."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ids_s, labels_s = line.split("|")
            out.append(([int(t) for t in ids_s.split()], [int(t) for t in labels_s.split()]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_dir", default=None, help="USTM checkpoint (HF dir)")
    p.add_argument("--train_path", required=True)
    p.add_argument("--eval_path", default=None, help="accepted and unused, as in usdm_tpu")
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--max_steps", type=int, default=0, help="override epoch-based stopping")
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--lora", action="store_true")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--export_hf", default=None,
                   help="after training, export final params (LoRA merged if --lora) as an "
                        "HF-Mistral dir")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    from usdm_tpu_torch.core import distributed as D

    D.add_cli_args(p)
    args = p.parse_args(argv)

    import torch

    from usdm_tpu_torch.cli import lm_trainer as LT
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.core.logging import MetricsLogger
    from usdm_tpu_torch.data.collators import sft_collate
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import lm as T

    device = ckpt.check_device(args.device)
    if not args.tiny and not args.model_dir:
        p.error("--model_dir is required (or pass --tiny)")
    mesh = D.make_cli_mesh(args, device)
    primary = D.is_primary()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = read_sft_file(args.train_path)
    if args.tiny:
        cfg = MistralConfig.tiny(vocab_size=512).replace(dtype=T.COMPUTE_DTYPE)
        base = M.init_params(cfg, gen, device, dtype="float32")
    else:
        base, cfg = T.load_masters(args.model_dir, device)

    steps_per_epoch = max(len(data) // args.train_batch_size, 1)
    max_steps = args.max_steps or steps_per_epoch * args.num_train_epochs
    tc = TrainConfig(learning_rate=args.learning_rate, batch_size=args.train_batch_size,
                     max_steps=max_steps, seed=args.seed,
                     dp=1 if mesh is None else mesh.size("data"),
                     tp=1 if mesh is None else mesh.size("model"))
    trainer = LT.make_trainer(cfg, tc, device, gen, base, lora=args.lora, lora_r=args.lora_r,
                              lora_alpha=args.lora_alpha, mesh=mesh)
    del base
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    start_step = LT.resume(trainer, ckpt_dir) if args.resume else 0
    logger = MetricsLogger(args.output_dir, use_tensorboard=False, enabled=primary)
    pad_id = cfg.vocab_size - 1
    rng = np.random.default_rng(args.seed)

    def batches():
        while True:
            order = rng.permutation(len(data))  # a random order each epoch
            for i in range(0, len(order) - args.train_batch_size + 1, args.train_batch_size):
                chunk = [data[j] for j in order[i:i + args.train_batch_size]]
                yield sft_collate(chunk, pad_id=pad_id)

    it = batches()
    for _ in range(start_step):  # the batches the resumed steps consumed
        next(it)
    metrics_of = LT.StepMetrics(start_step, device)
    for step in range(start_step, max_steps):
        metrics = trainer.step(LT.to_device(next(it), device, mesh))
        if (step + 1) % args.logging_steps == 0 or step == start_step:
            vals = metrics_of(step + 1, metrics)
            logger.log(step + 1, vals)
            if primary:
                print(f"step {step + 1}: loss={vals['loss']:.4f}")
        if (step + 1) % args.save_steps == 0 or step + 1 == max_steps:
            ckpt.save_train_state(ckpt_dir, trainer.state, step + 1, keep=tc.keep_checkpoints)
    if args.export_hf:
        LT.export_hf(args.export_hf, trainer)
        if primary:
            print(f"exported HF dir{' (LoRA merged)' if args.lora else ''}: {args.export_hf}")
    logger.close()
    D.finish()
    if primary:
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
