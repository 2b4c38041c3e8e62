"""CLI: end-to-end speech-to-speech inference on one GPU, or several (--tp).

Port of usdm_tpu/cli/infer.py, with the same flags plus `--device`:

  python -m usdm_tpu_torch.cli.infer \\
      --input_path user.wav --output_path out.wav \\
      --model_dir /ckpts/usdm --xlsr_dir /ckpts/xlsr --kmeans /ckpts/kmeans_10k.npy \\
      --voicebox_dir /ckpts/voicebox --bigvgan_dir /ckpts/bigvgan \\
      [--reference_path ref.wav] [--int8] [--no_vb_int8] [--device cuda]

The checkpoints are the reference's local directories (no `safetensors`,
`tokenizers` or `transformers` needed).  With --demo it runs the random
tiny pipeline (no checkpoints) as a plumbing check.  `--device cuda` (the
default) raises without a card; `--device cpu` runs the plain versions.

`--tp N` serves the LM tensor-parallel on N GPUs (engine/tp.py), as
usdm_tpu's `make_server(tp=N)` with a PagedDialogPolicy: this process is
rank 0 (the whole pipeline, the LM's rank-0 slices) and starts N - 1
worker processes (each the LM's slices alone), unless torchrun started the
ranks; it raises by name when the host has fewer than N cards.  With
`--device cpu` the ranks run over gloo.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_path", required=True, help="user speech wav")
    p.add_argument("--output_path", required=True, help="where to write the spoken response")
    p.add_argument("--reference_path", default=None,
                   help="reference audio for speaker adaptation (optional)")
    p.add_argument("--model_dir", default=None, help="USDM LLM checkpoint dir (HF layout)")
    p.add_argument("--xlsr_dir", default=None,
                   help="XLS-R checkpoint: an HF wav2vec2 dir or fairseq2's .pt")
    p.add_argument("--kmeans", default=None, help="kmeans_10k.npy path")
    p.add_argument("--voicebox_dir", default=None, help="token-Voicebox checkpoint dir")
    p.add_argument("--bigvgan_dir", default=None, help="BigVGAN checkpoint dir")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--n_timesteps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top_k", type=int, default=1, help="1 = greedy (reference default)")
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--int8", action="store_true",
                   help="quantize the LLM to W8A8 int8 (K6 decode products)")
    p.add_argument("--no_vb_int8", action="store_true",
                   help="keep the Voicebox estimator's matmuls in float (the default "
                        "quantizes them to W8A8, as usdm_tpu does)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: the LM over N GPUs (N divides the 8 kv "
                        "heads)")
    p.add_argument("--demo", action="store_true", help="random tiny pipeline (plumbing check)")
    p.add_argument("--draft_dir", default=None,
                   help="small draft-LM dir (HF layout): greedy speculative decoding, "
                        "output identical to plain greedy")
    p.add_argument("--draft", default=None,
                   help="training-free self-draft ('early-exit:8') or 'ngram'")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises without a card)")
    args = p.parse_args(argv)
    if not args.demo:
        missing = [n for n in ("model_dir", "xlsr_dir", "kmeans", "voicebox_dir", "bigvgan_dir")
                   if getattr(args, n) is None]
        if missing:
            p.error(f"missing checkpoint args: {missing} (or pass --demo)")
    if args.tp > 1:
        from usdm_tpu_torch.engine import tp as TP

        return TP.launch(args.tp, args.device, _tp_rank, args)
    return _respond(args, args.device)


def rank_draft(args, device, shard=None):
    """The draft the command line asks for: `--draft_dir`'s LM (`shard`'s
    slices under TP), the `--draft` spec, or None."""
    from usdm_tpu_torch.core import checkpoint as ckpt

    if args.draft_dir:
        return ckpt.load_mistral(args.draft_dir, dtype="bfloat16", device=device, shard=shard)
    return args.draft


def rank_pipeline(args, device, shard=None):
    """The pipeline of the command line (`shard`: the LM's slices of one
    tensor-parallel rank)."""
    from usdm_tpu_torch.pipeline import UsdmPipeline

    if args.demo:
        return UsdmPipeline.tiny_random(device=device)
    return UsdmPipeline.from_pretrained(
        args.model_dir, args.xlsr_dir, args.kmeans, args.voicebox_dir, args.bigvgan_dir,
        args.tokenizer_dir, lm_int8=args.int8, vb_int8=not args.no_vb_int8, device=device,
        lm_shard=shard)


def _respond(args, device, tp: int = 1) -> int:
    """One turn: with `tp` > 1 as rank 0, through the tensor-parallel
    server and a PagedDialogPolicy (usdm_tpu's make_server(tp=) with its
    default EngineConfig), else through pipe.respond()."""
    pipe = rank_pipeline(args, device, (tp, 0) if tp > 1 else None)
    server = None
    try:
        kw = dict(n_timesteps=args.n_timesteps, seed=args.seed)
        if tp > 1:
            from usdm_tpu_torch.engine.server import PagedDialogPolicy

            server = pipe.make_server(tp=tp, draft=rank_draft(args, pipe.device, (tp, 0)))
            policy = PagedDialogPolicy(server, pipe.tokenizer, max_new_tokens=pipe.max_new_tokens,
                                       top_k=args.top_k, top_p=args.top_p,
                                       temperature=args.temperature, seed=args.seed)
            result = pipe.respond_with_policy(policy, args.input_path, args.output_path,
                                              args.reference_path, **kw)
        else:
            draft = rank_draft(args, pipe.device)
            if draft is not None:
                pipe.enable_speculation(draft)
            result = pipe.respond(args.input_path, args.output_path, args.reference_path,
                                  top_k=args.top_k, top_p=args.top_p,
                                  temperature=args.temperature, **kw)
    finally:
        if server is not None:
            server.close()
        pipe.close()
    print(f"user_text: {result.user_text!r}")
    print(f"agent_text: {result.agent_text!r}")
    print(f"agent_units: {len(result.agent_units)} units "
          f"(~{len(result.agent_units) / 50.0:.2f} s)")
    print(f"wrote: {args.output_path}")
    return 0


def _tp_rank(rank: int, args) -> int:
    """One rank of `--tp`: rank 0 runs the turn; the others serve their LM
    slices (and the draft's) until rank 0's server closes."""
    from usdm_tpu_torch.engine import tp as TP
    from usdm_tpu_torch.pipeline import serve_lm, worker_lm

    dev = TP.rank_device(args.device)
    if rank == 0:
        return _respond(args, dev, args.tp)
    shard = (args.tp, rank)
    lm, cfg = worker_lm(dev, None if args.demo else args.model_dir, args.int8, shard)
    serve_lm(lm, cfg, None, args.tp, rank_draft(args, dev, shard), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
