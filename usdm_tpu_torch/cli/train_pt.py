"""CLI: interleaved speech-text pre-training (USTM phase), on one GPU or
sharded over several.

Port of usdm_tpu/cli/train_pt.py, with the same flags plus `--device`:

  python -m usdm_tpu_torch.cli.train_pt --data_path rows/ --output_dir out \\
      [--model_dir mistral-7b] [--offload] [--resume] [--export_hf DIR]
  torchrun --nproc_per_node 8 -m usdm_tpu_torch.cli.train_pt ... --dp 4 --tp 2

Loads base Mistral weights (or draws them: MistralConfig(), or --tiny),
extends the vocabulary by the speech tokens (normal(0, initializer_range)
rows), and trains on packed rows (`*.txt` of space-separated ids, one row a
line, read again for each epoch; an HF datasets cache needs the `datasets`
package) with segment-isolated attention: bf16 compute over f32 masters
(from a checkpoint too), per-layer remat, AdamW with usdm_tpu's schedule.
`--offload` keeps Adam's moments in pinned host memory (the full-width 7B
on one 80 GB card needs it: the budget printed at start says why).
`--lora` is refused: usdm_tpu's train_pt parses it and trains every
parameter all the same; adapters train with cli/train_sft.py --lora.
Checkpoints
`<output_dir>/checkpoints/step_N` (`--save_steps 0`: none, the final one
included); `--resume` continues from the newest and skips the rows its
steps consumed (usdm_tpu rereads from the first row).  `--profile_steps N`
traces the first N steps with torch.profiler into `<output_dir>/trace`
and trains on untraced (usdm_tpu stops after them).  Metrics go to
`<output_dir>/metrics.jsonl`: loss, grad_norm, ntokens, step_s and, on the
card, max_memory_gib.  `--device cuda` (the default) raises without a card.

Sharded (usdm_tpu's FSDP over `data`, TP over `model`; train/lm.py): one
process per GPU, started by torchrun or with `--coordinator host:port
--num_processes N --process_id r` each; `--dp` x `--tp` (x `--num_slices`)
must equal N (`--dp -1`: every rank left), and a host without LOCAL_RANK
must hold N GPUs.  Every rank reads the same rows and trains on its block of
each global batch of --train_batch_size rows, so the data order is the
single-process run's; rank 0 alone logs and writes (checkpoints gathered
leaf by leaf in the single-device format, restorable at any dp and tp;
the export).  A coordinator with one process and --dp 1 --tp 1 runs the
sharded path in a one-rank group.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys

import numpy as np


def iter_packed_rows(data_path: str):
    """Rows of token ids from the *.txt files of a directory (sorted), or
    from an HF datasets cache (`input_ids` column; needs `datasets`)."""
    files = sorted(glob.glob(os.path.join(data_path, "*.txt"))) if os.path.isdir(data_path) else []
    if files:
        for fp in files:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield [int(t) for t in line.split()]
        return
    try:
        import datasets
    except ImportError as e:
        raise ModuleNotFoundError(f"{data_path} holds no *.txt rows, and reading an HF datasets "
                                  f"cache needs the `datasets` package, which is not "
                                  f"installed") from e
    ds = datasets.load_from_disk(data_path)
    if hasattr(ds, "keys") and "train" in ds:
        ds = ds["train"]
    for ex in ds:
        ids = ex["input_ids"]
        yield [int(t) for t in ids.split()] if isinstance(ids, str) else ids


def rows_forever(data_path: str):
    """iter_packed_rows over and over (one pass an epoch)."""
    while True:
        n = 0
        for row in iter_packed_rows(data_path):
            n += 1
            yield row
        if not n:
            raise ValueError(f"no rows in {data_path}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_dir", default=None, help="base Mistral HF dir; random init if omitted")
    p.add_argument("--data_path", required=True)
    p.add_argument("--eval_data_path", default=None,
                   help="held-out packed rows; evaluated every --eval_steps")
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--eval_batches", type=int, default=8)
    p.add_argument("--tokenizer_dir", default=None,
                   help="tokenizer saved alongside every checkpoint")
    p.add_argument("--num_unit_tokens", type=int, default=10000)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--max_input_length", type=int, default=8192)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=1000, help="0: no checkpoints")
    p.add_argument("--save_total_limit", type=int, default=2)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--lora", action="store_true", help="refused: see cli/train_sft.py --lora")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--tiny", action="store_true", help="tiny random model (plumbing test)")
    p.add_argument("--offload", action="store_true",
                   help="Adam moments in pinned host memory, streamed leaf by leaf")
    p.add_argument("--export_hf", default=None,
                   help="after training, export the final params as an HF-Mistral dir")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace the first N steps with torch.profiler")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    from usdm_tpu_torch.core import distributed as D

    D.add_cli_args(p)
    args = p.parse_args(argv)
    if args.lora:
        p.error("--lora: usdm_tpu's train_pt accepts it and trains every parameter; "
                "train adapters with usdm_tpu_torch.cli.train_sft --lora")

    import torch

    from usdm_tpu_torch.cli import lm_trainer as LT
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core.config import MistralConfig, TokenSpace, TrainConfig
    from usdm_tpu_torch.core.logging import MetricsLogger, profile_trace
    from usdm_tpu_torch.data.collators import pack_collate
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import lm as T

    device = ckpt.check_device(args.device)
    mesh = D.make_cli_mesh(args, device)
    primary = D.is_primary()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    base = None
    if args.tiny:
        cfg = MistralConfig.tiny(vocab_size=512).replace(dtype=T.COMPUTE_DTYPE)
    elif args.model_dir:
        base, cfg = T.load_masters(args.model_dir, device)
        ts = TokenSpace(base_vocab_size=cfg.vocab_size, num_units=args.num_unit_tokens)
        base = M.extend_embeddings(base, cfg, ts.vocab_size, gen)
        cfg = cfg.replace(vocab_size=ts.vocab_size)
    else:
        cfg = MistralConfig().replace(dtype=T.COMPUTE_DTYPE)

    dp = 1 if mesh is None else mesh.size("data")
    tp = 1 if mesh is None else mesh.size("model")
    tc = TrainConfig(
        learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
        batch_size=args.train_batch_size, max_steps=args.max_steps, seed=args.seed,
        dp=dp, tp=tp, save_every=args.save_steps, keep_checkpoints=args.save_total_limit,
    )
    hbm_gb = (torch.cuda.get_device_properties(device).total_memory / 2**30
              if device.type == "cuda" else None)
    shards = 1 if mesh is None else mesh.batch_shards
    budget = T.memory_budget(cfg, dp=dp, tp=tp, seq_len=args.max_input_length,
                             batch_per_chip=max(tc.batch_size // shards, 1),
                             offload=args.offload, hbm_gb=hbm_gb or 0.0)
    where = (f"of the card's {hbm_gb:.2f} GiB (fits: {budget['fits']})" if hbm_gb
             else "(a CPU run: no device memory to hold it against)")
    if primary:
        print(f"memory budget (dp {dp}, tp {tp}): device {budget['device_gb']:.2f} GiB {where}, "
              f"host {budget['host_gb']:.2f} GiB")
        if hbm_gb and not budget["fits"] and not args.offload:
            print("[warning] the budget exceeds the card's memory: consider --offload")

    trainer = LT.make_trainer(cfg, tc, device, gen, base, offload=args.offload, mesh=mesh)
    del base
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    start_step = LT.resume(trainer, ckpt_dir) if args.resume else 0
    eval_fn = T.make_eval_step(cfg, tc, mesh) if args.eval_data_path else None
    logger = MetricsLogger(args.output_dir, use_tensorboard=False, enabled=primary)
    pad_id = cfg.vocab_size - 1

    tokenizer = None
    if args.tokenizer_dir:
        from usdm_tpu_torch.core.tokenizer import UsdmTokenizer

        tokenizer = UsdmTokenizer.load(args.tokenizer_dir, num_units=args.num_unit_tokens)

    saved = [start_step if args.resume else None]

    def save_ckpt(step):
        ckpt.save_train_state(ckpt_dir, trainer.state, step, keep=tc.keep_checkpoints)
        saved[0] = step
        if tokenizer is not None and primary:
            tokenizer.save(os.path.join(ckpt_dir, f"tokenizer-{step}"))

    last_eval = [-1]

    def run_eval(step):
        if eval_fn is None or last_eval[0] == step:
            return
        last_eval[0] = step
        rows_it = iter_packed_rows(args.eval_data_path)
        losses, toks = [], 0
        for _ in range(args.eval_batches):
            batch_rows = [r[:args.max_input_length] for _, r in zip(range(tc.batch_size),
                                                                    rows_it)]
            if len(batch_rows) < tc.batch_size:
                break
            m = eval_fn(trainer.state.params,
                        LT.to_device(pack_collate(batch_rows, pad_id=pad_id), device, mesh))
            losses.append(float(m["loss"]))
            toks += int(m["ntokens"])
        if losses:
            logger.log(step, {"loss": float(np.mean(losses)), "ntokens": toks}, prefix="eval")
            if primary:
                print(f"eval @ {step}: loss={np.mean(losses):.4f}")

    rows = rows_forever(args.data_path)
    for _ in range(start_step * tc.batch_size):  # the rows the resumed steps consumed
        next(rows)

    def next_batch():
        batch_rows = [next(rows)[:args.max_input_length] for _ in range(tc.batch_size)]
        return LT.to_device(pack_collate(batch_rows, pad_id=pad_id), device, mesh)

    metrics_of = LT.StepMetrics(start_step, device)
    with contextlib.ExitStack() as profiling:
        if args.profile_steps and primary:
            profiling.enter_context(profile_trace(os.path.join(args.output_dir, "trace")))
        for step in range(start_step, args.max_steps):
            metrics = trainer.step(next_batch())
            if (step + 1) % args.logging_steps == 0 or step == start_step:
                vals = metrics_of(step + 1, metrics)
                logger.log(step + 1, vals)
                if primary:
                    print(f"step {step + 1}: loss={vals['loss']:.4f} "
                          f"gnorm={vals['grad_norm']:.3f}")
            if (step + 1) % args.eval_steps == 0:
                run_eval(step + 1)
            if args.save_steps and (step + 1) % args.save_steps == 0:
                save_ckpt(step + 1)
            if step + 1 == start_step + args.profile_steps:
                profiling.close()  # writes the trace of the first profile_steps steps
                metrics_of.restart(step + 1)  # the next step_s leaves the writing out
    run_eval(args.max_steps)
    if args.save_steps and saved[0] != args.max_steps:
        save_ckpt(args.max_steps)
    if args.export_hf:
        LT.export_hf(args.export_hf, trainer, tokenizer)
        if primary:
            print(f"exported HF dir: {args.export_hf}")
    logger.close()
    D.finish()
    if primary:
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
