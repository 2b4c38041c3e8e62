"""CLI: distill a speculative-decoding draft model from a USDM target, on
one GPU or sharded over several.

Port of usdm_tpu/cli/train_draft.py, with its flags plus `--device`:

  python -m usdm_tpu_torch.cli.train_draft --output_dir out --model_dir TARGET \\
      --data_path rows/ [--draft_layers 8] [--quantize_target] [--resume] \\
      [--export_hf out/draft_hf]

The target (an HF Mistral dir in bf16, a random MistralConfig() 7B without
--model_dir, or --tiny's small f32 model) runs without autograd, W8A8 with
--quantize_target; the draft (its first --draft_layers layers, or random
with --init random) trains as f32 masters computing in the target's dtype
(train/distill.py), with train/lm.py's clipped AdamW, schedule and remat.
Rows are train_pt's packed rows (`*.txt` of space-separated ids, read again
each epoch), cut to --max_input_length and packed by pack_collate.  Every
logged step reports `agree`, the argmax agreement that predicts speculative
acceptance, beside loss, grad_norm, ntokens, step_s and, on the card,
max_memory_gib (`<output_dir>/metrics.jsonl`).  Checkpoints
`<output_dir>/checkpoints/step_N` hold the draft's train state; `--resume`
continues from the newest and skips the rows its steps consumed (usdm_tpu
rereads from the first row), so it equals the uninterrupted run.
`--export_hf` writes the draft as an HF Mistral dir that --draft_dir of
cli.infer and cli.serve loads.  `--device cuda` (the default) raises
without a card.  The multi-process flags run as cli/train_pt.py's: the
draft's state sharded (FSDP + TP), the target whole on every rank, each
rank on its rows of the global batch; rank 0 logs and writes.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_dir", default=None,
                   help="target checkpoint (HF-Mistral dir); random 7B if omitted")
    p.add_argument("--data_path", required=True)
    p.add_argument("--draft_layers", type=int, default=8,
                   help="draft depth; init copies the target's first N layers")
    p.add_argument("--init", choices=["early-exit", "random"], default="early-exit")
    p.add_argument("--mode", choices=["kl", "top1"], default="kl",
                   help="kl: Hinton distillation at --temperature; top1: CE against the "
                        "target argmax (the greedy-acceptance objective)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--quantize_target", action="store_true",
                   help="run the target forward in W8A8 serving mode")
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--max_input_length", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=512,
                   help="sequence chunk for the dual-logits loss (neither model's full "
                        "[T, vocab] logits materialize)")
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--save_total_limit", type=int, default=2)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny random target (plumbing test)")
    p.add_argument("--export_hf", default=None,
                   help="after training, export the draft as an HF-Mistral dir, ready for "
                        "--draft_dir on serve/infer")
    p.add_argument("--device", default="cuda", help="torch device to train on")
    from usdm_tpu_torch.core import distributed as D

    D.add_cli_args(p)
    args = p.parse_args(argv)

    import torch

    from usdm_tpu_torch.cli import lm_trainer as LT
    from usdm_tpu_torch.cli.train_pt import rows_forever
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.core.logging import MetricsLogger
    from usdm_tpu_torch.data.collators import pack_collate
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.models.quant import quantize_llm_params
    from usdm_tpu_torch.train import distill as DI
    from usdm_tpu_torch.train import lm as T

    device = ckpt.check_device(args.device)
    mesh = D.make_cli_mesh(args, device)
    primary = D.is_primary()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.tiny:
        cfg_t = MistralConfig.tiny(vocab_size=512)
        target = M.init_params(cfg_t, gen, device, dtype="float32")
    elif args.model_dir:
        target, cfg_t = ckpt.load_mistral(args.model_dir, dtype="bfloat16", device=device)
    else:
        cfg_t = MistralConfig()
        target = M.init_params(cfg_t, gen, device)
    if args.quantize_target:
        quantize_llm_params(target)

    n_layers = min(args.draft_layers, cfg_t.num_layers)
    if args.init == "early-exit":
        draft, cfg_d = DI.init_draft_from_target(target, cfg_t, n_layers)
    else:
        cfg_d = cfg_t.replace(num_layers=n_layers)
        draft = M.init_params(cfg_d, gen, device, dtype="float32")

    tc = TrainConfig(learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
                     batch_size=args.train_batch_size, max_steps=args.max_steps, seed=args.seed,
                     dp=1 if mesh is None else mesh.size("data"),
                     tp=1 if mesh is None else mesh.size("model"), save_every=args.save_steps,
                     keep_checkpoints=args.save_total_limit)
    state = T.init_state(cfg_d, tc, device, params=draft, mesh=mesh)
    del draft
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    start_step = 0
    saved = None
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        ckpt.restore_train_state(ckpt_dir, state)
        start_step = saved = state.step
        if primary:
            print(f"resuming from step {start_step}")

    step_fn = DI.make_distill_step(cfg_d, cfg_t, tc, temperature=args.temperature,
                                   mode=args.mode, chunk=args.chunk, mesh=mesh)
    logger = MetricsLogger(args.output_dir, use_tensorboard=False, enabled=primary)
    pad_id = cfg_t.vocab_size - 1
    rows = rows_forever(args.data_path)
    for _ in range(start_step * tc.batch_size):  # the rows the resumed steps consumed
        next(rows)

    def next_batch():
        batch_rows = [next(rows)[:args.max_input_length] for _ in range(tc.batch_size)]
        return LT.to_device(pack_collate(batch_rows, pad_id=pad_id), device, mesh)

    metrics_of = LT.StepMetrics(start_step, device)
    for step in range(start_step, args.max_steps):
        metrics = step_fn(state, target, next_batch())
        if (step + 1) % args.logging_steps == 0 or step == start_step:
            vals = metrics_of(step + 1, metrics)
            logger.log(step + 1, vals)
            if primary:
                print(f"step {step + 1}: loss={vals['loss']:.4f} agree={vals['agree']:.3f}")
        if (step + 1) % tc.save_every == 0:
            ckpt.save_train_state(ckpt_dir, state, step + 1, keep=tc.keep_checkpoints)
            saved = step + 1
    if saved != args.max_steps:
        ckpt.save_train_state(ckpt_dir, state, args.max_steps, keep=tc.keep_checkpoints)
    if args.export_hf:
        trainer = LT.Trainer(state, None, None, cfg_d, mesh)
        LT.export_hf(args.export_hf, trainer)
        if primary:
            print(f"exported draft HF dir: {args.export_hf}")
    logger.close()
    D.finish()
    if primary:
        print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
