#!/usr/bin/env python3
"""Drive the usdm_tpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase, one card

Phases:
  1. device: card name, power limit (nvidia-smi) and the TF32 flags, PyTorch's
     defaults (the port's f32 convolutions turn cuDNN's TF32 off themselves,
     usdm_tpu_torch/ops/conv.py);
  2. build: nvcc builds every kernel from usdm_tpu_torch/csrc/;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the main paths give it, with the stated bound,
     plus CUDA-event times of both.  Flash attention (K2, K5) has one route
     per dtype: bf16 on the tensor cores, held against the plain versions
     with round_operands=True (P and dS rounded to bf16 where the kernels
     round them; K2 also at a mixed link's chunk rows, each with its own
     start, two fully padded), f32 on the tensor cores (3xTF32), held to
     1e-4 (K5 f32 at the small f32 train step's attention, the kernels
     line's shape, at the full-width f32 CFM step's and at d 8, each timed
     eagerly and from a CUDA graph beside its 3xTF32 bound, its plain
     version and SDPA's backward); K4's forward and its
     backward kernel at the training shape (eager, from a CUDA graph, and
     the plain autograd backward beside them); K6 at the four 7B projection
     shapes and M 1 / 8 / 16, both routes, eager and from a CUDA graph,
     beside torch._int_mm over rows padded to 17; K3 at the six BigVGAN
     stage shapes (f32 and bf16; its error against the f64 plain version
     logged; f32 without log-scale held to 1e-4 of each channel's scale
     against it), then a turn's 109 launches from one graph; the new paths'
     shapes: K2 bf16 at the dense prefill_extend (256 queries at offset 320
     against an 8,192-slot cache valid to 576), K2 f32 at the prompted
     estimator (B 2, T+1 705 and 1857, ALiBi), K4's forward at [2, 1857,
     1024] f32; the tiny models' head dims: K1 at 16 (bf16, f32 and int8
     pools, B 1 and 2, window None and 64), K2 at 8 (f32 with ALiBi as the
     tiny estimator calls it, f32 at tiny XLS-R's 2,400 frames, bf16 causal
     over packed segments) and K5 bf16 at 8;
  4. slice: a full-width random UsdmPipeline (Mistral-7B bf16, XLS-R 1B,
     Voicebox, BigVGAN) runs two greedy respond() turns with stage budgets
     pinned at 48/32/256 tokens; every kernel of that path must have
     launched, every decode link must have been one CUDA-graph replay
     launching K1 once per layer, and chain run-ahead must have engaged;
     then one more turn on an engine with eager decode links
     (eager_links=True) must give the graphed turn's tokens.  Before them,
     on the small pipelines: (e) prepare_reference and a reference
     synthesis (shared z and prompt noises, 1e-4 of the peak) and a dense
     turn (use_paged=False: the CPU's and the paged turn's tokens) on the
     card against the CPU.  After them: (f) a turn with a 3 s speaker
     reference (the plain turn's dialog tokens, the estimator at the
     extended frames, audio for the agent's units alone); (g) a synthesis
     with a 16 s reference (K4's forward launches; the mel within 1e-3 of
     its peak of the call with fused_ln off); (h) two dense turns
     (respond(use_paged=False), budgets 48/32/256): every decode step one
     graph replay, K2's bf16 route in prefill, K1 never, tokens equal to the
     paged turn's or each divergence a tie-flip; then the same dialog with
     eager steps must give the same tokens; (i) serve: cli.serve's handler
     over this pipeline and its one-slot dialog server on a local port
     takes three concurrent POSTs of the turn's wav (seed 1, 50 ODE steps,
     budgets 48/32/256): plain JSON, ?stream=1 and multipart with a 3 s
     speaker reference, then /health and /stats; every request's stage
     tokens and
     the plain POST's texts, unit count and wav bytes equal the graphed
     turn's, the SSE result equals the plain JSON, every decode link is one
     graph replay, K1-K3 launch; (j) TF32: one f32 conv through
     ops/conv.py within 1e-5 of the f64 conv's peak (bypassed under the
     default flag: beyond it), the turn under allow_tf32=False (the old
     process-wide setting) equal to the graphed turn (units, tokens, the
     wav within 1e-4 of its peak), and, logged, the user units and the
     vocoded wav's nRMS with the helper bypassed (what TF32 would change);
  5. int8 serving: a small W8A8 turn on the card against the CPU plain path
     (identical tokens); then (A) a full-width W8A8 turn,
     UsdmPipeline.full_random(lm_int8=True, vb_int8=True).respond(), budgets
     pinned at 48/32/256; then (B) eight client threads call
     EngineServer.generate over a PagedEngine of the same W8A8 7B with int8
     KV pages (bench_serving's load: prompt 384, 128 new tokens, 2 requests
     per client, page 256, greedy, EOS masked out; the EngineConfig
     defaults, so mixed prefill + decode links engage while three slots
     decode), then the same prompts once more with multi_impl="fused" (the
     same tokens); then (C) 16 clients arriving 0.15 s apart (bench.py's
     stagger_s load, batch 16) once with mixed prefill and once without:
     identical tokens, mixed links carrying more than one chunk row, the
     pool whole afterwards; on the mixed server three clients stream
     (generate_stream: the same tokens) and one generator closed after its
     first yield must cancel its request; every kernel of each path must
     have launched, every decode link of (A), (B) and (C) must have been
     one graph replay launching K1 once per layer and K6 224 times, and
     every (eager) mixed link K1 once per layer; (A) has its eager-link
     turn as in phase 4, and one dense turn (use_paged=False) whose every
     decode step is one graph replay launching K6 224 times, its tokens
     the W8A8 paged turn's or each divergence a tie-flip;
  6. train: one f32 CFM train step of a small Voicebox on the card against
     the CPU (its K5 launches, all on the f32 route, are the kernels line's
     K5 f32 counts), then the trainer CLI (usdm_tpu_torch.cli.train_voicebox) runs ~10
     full-width steps (VoiceboxConfig(), batch 8 of 16 s crops, bf16 over f32
     masters, per-layer remat) on synthetic noise clips; every kernel of that
     path must have launched (K4's backward kernel too), and 5 steps on one
     fixed batch must lower the loss;
  7. probes: X1 (io-layout bf16 and int8 matvecs), X2 (packed-int4 matvec)
     and X3 (weight-streaming probe, every mode) against their plain versions
     at the probe shapes (D 4096, F 14336, 16 layers), each timed over the
     16 layers, then the port's three probe entry points
     (usdm_tpu_torch.scripts.exp_stream_variants, exp_matvec, exp_int4) run
     once at full size and print their JSON lines; every probe kernel must
     have launched there;
  8. vocoder gate: the port of scripts/bench_fused_act.py
     (usdm_tpu_torch.scripts.bench_fused_act) at full width, BigVGAN bf16 on
     a 10 s mel with fused_act off then on: parity rel < 6e-2, 109 K3
     launches per call, both RTFs;
  9. speculation: (a) tiny engines with a draft model (the target, or a
     random one) or "ngram", f32 or bf16, bf16/f32 or int8 pools: rounds
     replayed from CUDA graphs equal eager rounds bit for bit, and the
     tokens equal the plain engine's and (f32) the CPU port's; (b) the
     ports of scripts/bench_ngram.py (W8A8 7B, 1219-token prompt, 256 new
     tokens, zero and random weights) and scripts/bench_spec_degraded.py
     (plain, early-exit:4, a random 4-layer draft) print their JSON lines,
     every W8A8 speculative run identical to plain greedy; (c) phases 4
     and 5 each end with a full-width turn under
     enable_speculation("ngram"): W8A8 identical to the plain turn, bf16
     identical or each divergence a tie-flip by bench_ngram's rule
     (counted); (d) every round one graph replay launching K1 once a
     target layer plus K+1 times a draft layer, K6 7 times each; then the
     stress port (usdm_tpu_torch.scripts.stress_engine) runs 2 rounds with
     mixed links on, in bf16 and with draft="ngram";
 10. load (run at the end of phase 4, on its pipeline): (a) the full-width
     random pipeline is exported to the reference's checkpoint formats in a
     temporary directory on local disk (~20 GB; the phase fails, naming the
     free bytes, if there is no room): the LM with its tokenizer
     (save_mistral_hf, one bf16 model.safetensors), the Voicebox
     (save_voicebox_hub), BigVGAN (save_bigvgan_generator), XLS-R as a
     fairseq2 .pt (save_xlsr below) and kmeans.npy; (b)
     UsdmPipeline.from_pretrained(vb_int8=False) on the card runs phase 4's
     turn (seed 1, budgets 48/32/256): the user units and every stage's
     tokens equal phase 4's graphed turn, the mel and the wav within 1e-4 of
     their peaks (the folded weight norms round each weight by about an
     ulp), K1-K3 launched; (c) with (b)'s pipeline freed, from_pretrained's
     defaults (vb_int8=True): the same tokens, the mel within nRMS 1e-2 of
     (b)'s (usdm_tpu's gate) from the ODE noise of seed 1 and of seed 2;
     then the port of scripts/bench_vb_int8.py
     prints its JSON line, and (d) one JSON line of cold-start numbers
     (bytes, seconds and GB/s of the export and each load, the host memory
     each adds (the peak of VmRSS sampled every 2 ms less VmRSS before it;
     the machine refuses /proc/self/clear_refs), which must stay within the
     largest pickled file (the XLS-R .pt) plus 1 GB, device memory after each
     load, the loaded turns' wall and RTF) beside the card's name and power
     limit.

 11. LM training (runs last, on an emptied card): (a) K2 and K5 bf16 at the
     7B training shape (B 1, T 8192, GQA 32/8, d 128, causal, window 4096,
     segments 5000 + 2000 + 1192, so the window masks keys inside the first)
     against their plain versions, with eager and CUDA-graph times, bounds,
     and scaled_dot_product_attention's forward and backward with the same
     boolean mask; (b) python -m usdm_tpu_torch.cli.train_pt --offload at
     full width (MistralConfig(), 32 layers, random init, batch 1 of
     8,192-token rows of those segments, 3 steps, all profiled, exported as
     an HF dir): per step the wall, loss, grad norm and peak device memory,
     device busy over the steps, peak device memory within memory_budget's
     device_gb and the host memory added within its host_gb + 3 GiB, K2 64
     and K5 32 + 32 launches a step (forward, remat recompute, backward),
     layer 0's weights moved; (c) the offload step equals the resident step
     bit for bit at full width and depth 2 over 3 steps; (d) cli.train_sft
     --lora at full width and depth from (b)'s export, 3 steps of batch 2 of
     ~1,536-token rows with the user half masked: the CLI's base after
     training is (b)'s export bit for bit, the adapters moved, and
     merge_lora's logits on one row (f32 compute) equal base + adapters
     within 2^-10 of the adapters' effect (the merged export is not written:
     the run keeps its disk writes within 45 GiB, and phases 6, 10 and (b)
     write ~39 GB);
     (e) cli.train_sft every parameter, resident, --tiny (for the same
     reason): a run resumed from step 2 of 4 equals the uninterrupted run's
     step 4 bit for bit.
 12. GAN and distillation training (after phase 11, on an emptied card):
     (a) K3's autograd Function at the six stage shapes of a full-width
     generator (B 32, an 8,192-sample crop, f32, snake-beta, log-scale): the
     forward within 1e-4 of the plain version, dx, dalpha and dbeta within
     1e-5 of each gradient's peak of autograd through the plain version,
     the bare launch's output without grad_fn (negative control), forward
     and backward times; (b) python -m usdm_tpu_torch.cli.train_vocoder at
     full width (BigVGANConfig(), MPD periods 2-11, MRD at three
     resolutions, batch 32 of 8,192-sample crops of 96 synthetic chirp
     clips, 3 steps, --export): per step wall, losses, mel L1, peak memory,
     K3 218 launches a step, the export loaded by load_bigvgan within 2^-21
     of each weight's peak (biases and snake parameters bit for bit), then
     one profiled iteration (busy share, top device ops, the K3 backward
     recompute's span); (c) the distill step at full width in process: K2
     and K5 at one of its layers (B 2 x 4,096, GQA 32/8, d 128, segments
     2500 + 1000 + 596) against their plain versions (bf16 bound; negative
     control: the kernels without the segments fail it on the rows the
     segments separate), the
     random bf16 7B target as its own draft (agree >= 0.95, loss < 0.05),
     then an 8-layer early-exit draft (f32 masters, resident AdamW) for 3
     steps of 2 packed 4,096-token rows against the bf16 target and 3
     against the W8A8 one: per step wall, tokens/s, loss, agree, peak
     memory; K2 48 and K5 8 + 8 launches a step; (d) K1 at head_dim 32
     (B 1, 2 and the verify step's 8 rows, contexts 1-256, window 64)
     against its plain version (bf16 bound; negative control: without the
     window, or with half of it, it fails), then cli.train_draft --tiny
     from a target dir on the card: resumed from step 2 of 4 equal to the
     uninterrupted run bit for bit, and its --export_hf dir, loaded as
     --draft_dir loads it, drafts for a PagedEngine with plain greedy's
     tokens (K1 launches).  The whole run writes ~41.5 GB to local disk
     (phase 10 20.4, phase 11 14.6, phase 6 4.1, phase 12 2.4), within 45
     GiB.
 13. tiny entry points (run first, after phase 3): the tiny models' own
     head dims (LM 16, XLS-R and Voicebox 8), unwidened:
     UsdmPipeline.tiny_random(device="cpu") against its copy on the card
     (the same dialog tokens, K1-K3 launched, the wav within 1e-3 of its
     peak from shared noise, also 100 units past the estimator's flash
     gate); python -m usdm_tpu_torch.cli.infer --demo and cli.serve --demo
     (one POST) in subprocesses on the card; cli.demo_streamlit's --demo
     pipeline (tiny_random drawn on the card) answers one respond().
 14. preprocessing (inside phase 10, on its export): the preprocessing CLI
     on eight noise clips of 2-12 s and one of 45 s with transcripts, word
     TextGrids and DailyTalk metadata the phase writes: stage1 at full width
     (the exported XLS-R and its 10,000 centroids; K2 must launch on the
     45 s clip, whose units must equal the plain-attention route's or each
     differing frame be a near tie within 1e-5; audio seconds per second
     logged), stage2, stage3 (8,192-token bins, efficiency logged),
     dailytalk, decoder-filelist; then the same CLI over a tiny XLS-R (32
     centroids, head_dim 8) whose outputs the --tiny trainers can index:
     cli.train_pt, cli.train_sft and cli.train_voicebox, two steps each on
     the card (K2 and K5 bf16 must launch).
 15. profilers: usdm_tpu_torch.scripts.profile_decode_step on phase 4's
     bf16 and phase 5's W8A8 pipelines (the b = 1 link at ctx 1,219 against
     its parts, from CUDA-graph replays) and scripts.profile_respond on
     phase 5's (the pinned-budget turn by phase); each prints its JSON line.
 16. measuring scripts, the ports of scripts/' exp_decode2, exp_decode,
     bench_batch_decode, bench_runahead, trace_estimator, exp_stream_qmv and
     validate_memory_budget (usdm_tpu_torch.scripts.*), each printing its
     JSON lines: (a) after phase 15 on phase 4's pipeline, the eight decode
     step ablations over its bf16 7B and the estimator's trace over its f32
     Voicebox; (b) after phase 15 on phase 5's, the ablations, exp_decode
     and the batched decode (b 8/16/32, bf16 and int8 pools; K6's and
     torch._int_mm's launches a step by b) over a zero W8A8 7B, the
     ablations over the pipeline's W8A8 7B (the fused variants' tokens
     equal the unfused ones' on both), the run-ahead sweep (horizons 8-64,
     every configuration the same tokens, no graph captured inside a timed
     rep) and its EOS check over it, the estimator's trace over zero bf16
     weights and the W8A8 Voicebox (Chrome traces to --out-dir); (c) last,
     on an emptied card, K1 at b 32 (page 256, 6 pages a slot, bf16 and
     int8 pools), K6 at M 1 at Dout 6144, 28672 and 42003 (f32 bit for
     bit), K2/K5 bf16 at GQA 8/2 d 128 T 8,192 and K2 bf16 with ALiBi at
     the estimator's shape, each against its plain version with times,
     then exp_stream_qmv and
     validate_memory_budget's three train steps (measured peak against
     memory_budget).
 17. tp (tensor-parallel serving, engine/tp.py): (a) inside phases 4 and 5,
     after phase 16 (a) / (b), on their pipelines: PagedEngine(mesh=
     make_tp_mesh(1)) over the bf16 7B with bf16 pools and over the W8A8
     7B with int8 pools, in a one-rank NCCL group (real NCCL calls), 2
     requests of 128-token prompts and 64 greedy tokens, then the same with
     ngram speculation: the single-device graphed engine's tokens, and the
     all-reduces (2 a layer), vocab gathers (1), eager links and K1/K2/K6
     launches of every link, round and prefill chunk as the code implies;
     (b) after phase 16 (c), on an emptied card: K6 (M 1, 8, 16; f32 bit for
     bit), K1 (bf16 and int8 pools, ctx 1,219) and K2 bf16 (a prefill
     chunk) at the per-rank shapes of tp 2, 4 and 8, each against its plain
     version, timed eagerly and from a CUDA graph beside its bound and its
     library call (<out-dir>/tp_kernels.json); (c) with one card, cli.infer
     --tp 2 must refuse by name; (d) with two or more, cli.infer --demo
     --tp 2 must equal --tp 1 (with one card it prints tp2_run "not run").
 18. sharded training (core/mesh.py, train/lm.py's FSDP + TP, data
     parallelism in train/cfm.py, train/vocoder.py, train/lora.py), after
     phase 17: (a) cli.train_pt with phase 11 (b)'s flags plus --coordinator
     localhost --num_processes 1 --process_id 0 --dp 1 --tp 1, in a one-rank
     NCCL group, 2 steps: loss and grad_norm equal to 11 (b)'s bit for bit,
     every collective counted as train/lm.py step_collectives implies, peak
     memory within memory_budget's; (b) the full-width CFM step and GAN
     steps, 2 each, on a one-rank mesh against one device, bit for bit
     (cuDNN's deterministic algorithms on for both runs);
     (c) phase 12 (c)'s first distill step with the draft on the mesh, bit
     for bit; (d) on an emptied card, K2/K5 at the 7B's per-rank heads of tp
     2, 4, 8 and K2/K4/K5 at the CFM step's per-rank rows and K3's Function
     at the GAN step's of dp 2, 4, 8, each against its plain version, timed
     eagerly and from a CUDA graph beside its bound and library call
     (<out-dir>/train_rank_kernels.json); (e) with one card, cli.train_pt
     --tp 2 and cli.train_voicebox --num_processes 2 refuse by name (with
     two or more, a tiny --dp 2 run against --dp 1; with one it prints
     dp2_run "not run").

Each kernel's bound_ms is the least time the card could take for the work
of its timed case: the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations over the H100's peak for
their type (989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s f32 off the
tensor cores).  library_ms times one PyTorch call computing the same
function where one exists (it is used nowhere in the port).

Prints one JSON line of kernel results, then, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero without that line when CUDA
is absent or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNELS = {
    "paged_decode_attention": {
        "source": "usdm_tpu_torch/csrc/paged_attention.cu",
        "replaces": "usdm_tpu/ops/paged_attention.py:41",
    },
    "flash_attention": {
        "source": "usdm_tpu_torch/csrc/flash_attention_mma.cu (bf16)",
        "replaces": "usdm_tpu/ops/flash_attention.py:57",
    },
    "flash_attention_f32": {
        "source": "usdm_tpu_torch/csrc/flash_attention.cu (f32, 3xTF32)",
        "replaces": "usdm_tpu/ops/flash_attention.py:57",
    },
    "fused_activation1d": {
        "source": "usdm_tpu_torch/csrc/fused_act.cu",
        "replaces": "usdm_tpu/ops/fused_act.py:68",
    },
    "add_mask_ln": {
        "source": "usdm_tpu_torch/csrc/fused_ln.cu",
        "replaces": "usdm_tpu/ops/fused_ln.py:44",
    },
    "add_mask_ln_bwd": {
        "source": "usdm_tpu_torch/csrc/fused_ln.cu (add_mask_ln_bwd_kernel, dw_db_reduce_kernel)",
        "replaces": "usdm_tpu/ops/fused_ln.py:106 (the custom_vjp's backward of the kernel at "
                    ":44)",
    },
    "flash_attention_bwd_dq": {
        "source": "usdm_tpu_torch/csrc/flash_attention_bwd_dq_mma.cu (bf16)",
        "replaces": "usdm_tpu/ops/flash_attention.py:287",
    },
    "flash_attention_bwd_dkv": {
        "source": "usdm_tpu_torch/csrc/flash_attention_bwd_dkv_mma.cu (bf16)",
        "replaces": "usdm_tpu/ops/flash_attention.py:367",
    },
    "flash_attention_bwd_dq_f32": {
        "source": "usdm_tpu_torch/csrc/flash_attention_bwd_dq_tf32.cu (f32, 3xTF32)",
        "replaces": "usdm_tpu/ops/flash_attention.py:287",
    },
    "flash_attention_bwd_dkv_f32": {
        "source": "usdm_tpu_torch/csrc/flash_attention_bwd_dkv_tf32.cu (f32, 3xTF32)",
        "replaces": "usdm_tpu/ops/flash_attention.py:367",
    },
    "stream_qmv": {
        "source": "usdm_tpu_torch/csrc/stream_matvec.cu",
        "replaces": "usdm_tpu/ops/stream_matvec.py:30",
    },
    "paged_decode_attention_int8": {
        "source": "usdm_tpu_torch/csrc/paged_attention.cu",
        "replaces": "usdm_tpu/ops/paged_attention.py:41",
    },
    "mv_io_bf16": {
        "source": "usdm_tpu_torch/csrc/matvec_io.cu",
        "replaces": "scripts/exp_matvec.py:142",
    },
    "mv_io_i8": {
        "source": "usdm_tpu_torch/csrc/matvec_io.cu",
        "replaces": "scripts/exp_matvec.py:150",
    },
    "qmv4": {
        "source": "usdm_tpu_torch/csrc/int4_matvec.cu",
        "replaces": "scripts/exp_int4_pallas.py:45",
    },
    "stream_probe": {
        "source": "usdm_tpu_torch/csrc/stream_probe.cu",
        "replaces": "scripts/exp_stream_variants.py:46",
    },
}

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}


def least_time(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time of a kernel's work on one H100: bytes over the memory
    rate or operations over the peak for their type, whichever is larger.
    Kind "3xtf32": f32 products done as three TF32 products each, against
    the TF32 peak."""
    if kind == "3xtf32":
        ops, kind = 3 * ops, "tf32"
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_mask(qseg, kseg, qpos, kpos, causal: bool, window):
    """The (query, key) pairs flash attention computes, [B, Tq, Tk] bool."""
    m = (qseg[:, :, None] == kseg[:, None, :]) & (qseg[:, :, None] >= 0)
    d = qpos[:, :, None] - kpos[:, None, :]
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d <= window)
    return m


def _counted() -> dict:
    """Every kernel wrapper that counts its launches in `.launches`."""
    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.ops import fused_act as FA
    from usdm_tpu_torch.ops import fused_ln as LN
    from usdm_tpu_torch.ops import int4_matvec as I4
    from usdm_tpu_torch.ops import matvec_io as MV
    from usdm_tpu_torch.ops import paged_attention as PA
    from usdm_tpu_torch.ops import stream_matvec as SM
    from usdm_tpu_torch.ops import stream_probe as SP

    return {"paged_decode_attention": PA.paged_decode_attention,
            "flash_attention": FL.flash_attention,
            "fused_activation1d": FA.fused_activation1d,
            "add_mask_ln": LN.add_mask_ln, "add_mask_ln_bwd": LN.add_mask_ln_bwd,
            "flash_attention_bwd_dq": FL.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": FL.flash_attention_bwd_dkv,
            "stream_qmv": SM.stream_qmv,
            "mv_io_bf16": MV.mv_io_bf16, "mv_io_i8": MV.mv_io_i8, "qmv4": I4.qmv4,
            "stream_probe": SP.stream_probe}


def launch_counts() -> dict:
    """Every wrapper's launch count, by the names of KERNELS ("flash_attention"
    and "flash_attention_bwd_*" count both routes, the "*_f32" keys the f32
    one alone)."""
    from usdm_tpu_torch.ops import paged_attention as PA

    return {**{k: fn.launches for k, fn in _counted().items()},
            **{f"{k}_f32": fn.tf32_launches for k, fn in _flash_wrappers().items()},
            "paged_decode_attention_int8": PA.paged_decode_attention.int8_launches}


def _flash_wrappers() -> dict:
    """The three flash-attention wrappers, which also count the launches of
    their bf16 route in `.mma_launches` and of their f32 route (3xTF32) in
    `.tf32_launches`."""
    return {k: fn for k, fn in _counted().items() if k.startswith("flash_attention")}


def mma_counts() -> dict:
    return {k: fn.mma_launches for k, fn in _flash_wrappers().items()}


def reset_counts() -> None:
    from usdm_tpu_torch.ops import paged_attention as PA

    for fn in _counted().values():
        fn.launches = 0
    for fn in _flash_wrappers().values():
        fn.mma_launches = fn.tf32_launches = 0
    PA.paged_decode_attention.int8_launches = 0


def log(msg: str) -> None:
    print(msg, flush=True)


class _Tee:
    """A stdout that writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def cuda_ms(fn) -> float:
    """Median CUDA-event time of `fn()` in milliseconds, on card 0 (the
    probes' timer, usdm_tpu_torch.scripts.common.timeit)."""
    import torch

    from usdm_tpu_torch.scripts.common import timeit

    return timeit(fn, torch.device("cuda", 0))


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def bf16_bound(want) -> float:
    """Bound of a bf16 kernel against its plain version when both accumulate
    in f32 and round at the same places (K1: only the outputs; the bf16 flash
    route and its plain versions with round_operands: also P and dS): one
    bf16 ulp of the case's largest output, 2^-7 * max|want|, plus 1e-4 for
    f32 summation order.  It scales with the outputs, which shrink as the
    context grows."""
    return 2.0**-7 * want.float().abs().max().item() + 1e-4


def check(name: str, case: str, got, want, bound: float) -> float:
    import torch

    err = max_err(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and err <= bound
    log(f"  {name} [{case}] max_abs_err={err:.3e} bound={bound:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} [{case}] disagrees with its plain version: "
                             f"max_abs_err {err} > {bound}")
    return err


# --------------------------------------------------------------- phase 3
def f32_case(dev, args, bias, valid, ops: int) -> dict:
    """Times of K2's f32 route at one case, beside its plain version and one
    scaled_dot_product_attention call on the same f32 operands in [B, H, T,
    d] (with `bias` as a float mask, or none); the kernel's and the library
    call's error against the f64 plain version on the rows `valid` marks
    (the library call gives padded query rows values, the kernel 0)."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    q, k, v = args[:3]
    out = {"ms": cuda_ms(lambda: FL.flash_attention(*args)),
           "graph_ms": graph_ms(lambda: [FL.flash_attention(*args) for _ in range(10)], dev) / 10,
           "plain_ms": cuda_ms(lambda: FL.flash_attention_reference(*args)),
           **least_time(2 * nbytes(q) + nbytes(k, v, *args[3:7]), ops, "3xtf32"),
           "cuda_core_ms": least_time(2 * nbytes(q) + nbytes(k, v, *args[3:7]), ops,
                                      "f32")["bound_ms"]}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

    with _profiler() as prof:
        lib = sdpa()
        torch.cuda.synchronize()
    out["library_kernels"] = sorted({e.key for e in prof.key_averages()
                                     if e.device_type == torch.autograd.DeviceType.CUDA})
    out["library_ms"] = cuda_ms(sdpa)
    out["library_graph_ms"] = graph_ms(lambda: [sdpa() for _ in range(10)], dev) / 10
    exact, _ = FL.flash_attention_reference(*[x.double() for x in args[:3]], *args[3:])
    got = FL.flash_attention(*args)
    lib = lib.transpose(1, 2)
    if valid is not None:
        lib, got = torch.where(valid, lib, exact), torch.where(valid, got, exact)
    out["library_err"] = max_err(lib.double(), exact)
    out["err_f64"] = max_err(got.double(), exact)
    out["tflops"] = ops / out["graph_ms"] / 1e9
    return out


K3_PER_TURN = 109  # BigVGAN's activations: 6 stages x 3 AMP blocks x 3 dilations x 2, + 1
# BigVGAN's six (channels, samples) activation shapes for a 448-frame mel
STAGES = ((768, 1792), (384, 7168), (192, 14336), (96, 28672), (48, 57344), (24, 114688))


def kernel_checks(dev) -> dict:
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # K1: Mistral decode geometry, bf16 pools of 32 layer regions, shuffled
    # page tables.  Timed as a decode step calls it: once per layer region,
    # so the 32 regions' KV (~93 MB at 700 tokens) does not stay in L2.  The
    # window-512 case cuts most of a 4200-token context; there the bound must
    # also reject the kernel run with its window dropped or off by one.
    log("K1 paged_decode_attention vs paged_decode_attention_reference "
        "(bf16, bound 2^-7 * max|want| + 1e-4)")
    hkv, g, d, p, maxp, n_layers = 8, 4, 128, 64, 128, 32
    errs, timing = [], None
    for b in (1, 3):
        n_pages = b * maxp + 1
        kp = randn(hkv, n_layers * n_pages, p, d, dtype=torch.bfloat16)
        vp = randn(hkv, n_layers * n_pages, p, d, dtype=torch.bfloat16)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev).to(torch.int32)
        table = perm[: b * maxp].reshape(b, maxp).contiguous()
        tables = [(table + li * n_pages).contiguous() for li in range(n_layers)]
        for seq, window in ((1, 4096), (63, 4096), (64, 4096), (700, 4096), (4200, 4096),
                            (4200, 512)):
            lens = torch.full((b,), seq, dtype=torch.int32, device=dev)
            if b == 3:
                lens[1] = max(1, seq // 2)
            q = randn(b, hkv, g, d, dtype=torch.bfloat16)
            got = PA.paged_decode_attention(q, kp, vp, tables[1], lens, window)
            want = PA.paged_decode_attention_reference(q, kp, vp, tables[1], lens, window)
            bound = bf16_bound(want)
            errs.append(check("K1", f"B={b} seq={seq} window={window}", got, want, bound))
            if window == 512:
                for wrong in (None, 511, 513):
                    err = max_err(PA.paged_decode_attention(q, kp, vp, tables[1], lens, wrong),
                                  want)
                    log(f"  K1 [B={b} seq={seq}] kernel with window {wrong} against the "
                        f"plain version with 512: max_abs_err={err:.3e}, must exceed "
                        f"{bound:.3e}")
                    if err <= bound:
                        raise AssertionError(f"the K1 bound cannot tell window {wrong} "
                                             f"from 512")
            if b == 1 and seq == 700:
                def step(fn, **kw):
                    return lambda: [fn(q, kp, vp, t, lens, 4096, **kw) for t in tables]
                timing = (cuda_ms(step(PA.paged_decode_attention)) / n_layers,
                          cuda_ms(step(PA.paged_decode_attention_reference)) / n_layers,
                          graph_ms(step(PA.paged_decode_attention), dev) / n_layers,
                          cuda_ms(step(PA.paged_decode_attention, n_splits=1)) / n_layers,
                          graph_ms(step(PA.paged_decode_attention, n_splits=1), dev) / n_layers)
                # per layer: q, out, the table and the 700 K and V rows of 8 heads
                k1_bound = least_time(2 * nbytes(q) + nbytes(tables[1], lens)
                                      + 2 * seq * hkv * d * kp.element_size(),
                                      4 * g * hkv * seq * d, "bf16")
        del kp, vp
    log(f"  K1 time at B=1 seq=700 (per layer, 32 layer regions in turn): kernel "
        f"{timing[0]:.4f} ms eager, {timing[2]:.4f} ms from a CUDA graph (n_splits "
        f"{PA.split_count(1, hkv, maxp, p, PA._sm_count(0))}, the host's choice); at n_splits=1 "
        f"{timing[3]:.4f} ms eager, {timing[4]:.4f} ms from a graph; plain {timing[1]:.4f} ms; "
        f"bound {k1_bound['bound_ms']:.5f} ms ({k1_bound['bound_by']})")
    k1_split_checks(dev)
    results["paged_decode_attention"] = {"max_abs_err": max(errs), "ms": timing[0],
                                         "plain_ms": timing[1], **k1_bound, "library_ms": None,
                                         "case": "B=1 seq=700 bf16"}

    # the tensor-core parts (csrc/mma.cuh) on one 64 x 64 tile, before any
    # kernel built from them: S = Q.K^T against torch.matmul of the same bf16
    # values in f32, O = bf16(S).V against the matmul of the kernel's own
    # rounded S; exact products, so only the order of the f32 sums differs
    log("mma tile harness: S = Q.K^T and O = bf16(S).V of one tile vs torch.matmul in f32 "
        "(bound 1e-5 of the largest value: summation order)")
    for d in (64, 80, 128):
        tq, tk, tv = (randn(64, d, dtype=torch.bfloat16) for _ in range(3))
        s_out, o_out = FL.mma_tile_products(tq, tk, tv)
        for what, got, want in (("S", s_out, tq.float() @ tk.float().t()),
                                ("O", o_out, s_out.bfloat16().float() @ tv.float())):
            check("mma tile", f"d={d} {what}", got, want, 1e-5 * want.abs().max().item())

    # K2: (a) Mistral prefill chunk at start=768, (b) Voicebox, (c) XLS-R long
    log("K2 flash_attention vs flash_attention_reference (bf16, the tensor-core route, against "
        "the plain version with round_operands=True: bound 2^-7 * max|want| + 1e-4; f32, the "
        "3xTF32 route: bound 1e-4, error against the f64 plain version logged; the "
        "log-sum-exp, f32 on both sides, within 1e-4)")
    errs, errs32, timings = [], [], {}

    def check_flash(case, args, bound=None):
        """f32 when `bound` is given, else bf16: held against the rounded
        plain version; the error against the unrounded one (bf16) or the f64
        one (f32) is logged only."""
        got, got_lse = FL.flash_attention(*args, return_lse=True)
        want, want_lse = FL.flash_attention_reference(*args, round_operands=bound is None)
        err = check("K2", case, got, want, bf16_bound(want) if bound is None else bound)
        check("K2 lse", case, got_lse, want_lse, 1e-4)
        if bound is None:
            exact, _ = FL.flash_attention_reference(*args)
            log(f"  K2 [{case}] against the unrounded plain version (not gated): "
                f"max_abs_err={max_err(got, exact):.3e}")
        else:
            exact, _ = FL.flash_attention_reference(*[x.double() for x in args[:3]], *args[3:])
            log(f"  K2 [{case}] against the f64 plain version (not gated): "
                f"max_abs_err={max_err(got.double(), exact):.3e}")
        return err

    # (a) chunk of 512 queries at positions 768.., 300 valid; context 2048
    c, s_ctx, start, n_valid = 512, 2048, 768, 300
    q = randn(1, c, 32, 128, dtype=torch.bfloat16)
    kv = randn(2, 8, s_ctx, 128, dtype=torch.bfloat16)  # head-major context, as gathered
    k, v = kv[0].permute(1, 0, 2)[None], kv[1].permute(1, 0, 2)[None]
    # rows as the engine's prefill makes them: int32, once per chunk
    qpos = (start + torch.arange(c, device=dev, dtype=torch.int32))[None]
    kpos = torch.arange(s_ctx, device=dev, dtype=torch.int32)[None]
    qseg = torch.where(torch.arange(c, device=dev)[None] < n_valid, 0, -1).to(torch.int32)
    kseg = torch.where(kpos < start + n_valid, 0, -1).to(torch.int32)
    args_a = (q, k, v, qseg, kseg, qpos, kpos, True, 4096, None, False)
    errs.append(check_flash("prefill bf16 Tq=512 Tk=2048 start=768", args_a))
    timings["a"] = (cuda_ms(lambda: FL.flash_attention(*args_a)),
                    cuda_ms(lambda: FL.flash_attention_reference(*args_a)))
    mask_a = attn_mask(qseg, kseg, qpos, kpos, True, 4096)
    k2_ops = 4 * 128 * 32 * int(mask_a.sum())
    k2_bound = least_time(2 * nbytes(q) + nbytes(k, v, qseg, kseg, qpos, kpos), k2_ops, "bf16")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    def sdpa_a():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask_a[:, None], enable_gqa=True)

    k2_lib = cuda_ms(sdpa_a)
    # the same calls replayed from a CUDA graph, 10 to a replay: the device's
    # time alone (a single eager call also waits on the host's dispatch: the
    # wrapper's checks and int32 rows, or PyTorch's own)
    k2_graph = (graph_ms(lambda: [FL.flash_attention(*args_a) for _ in range(10)], dev) / 10,
                graph_ms(lambda: [sdpa_a() for _ in range(10)], dev) / 10)
    del qt, kt, vt
    # bf16 at head dims the tile widths do not divide (d 80 runs at width 96),
    # T 300 ragged against the 64-row tiles, non-causal, second row shorter
    t3 = 300
    pos = torch.arange(t3, device=dev)[None].expand(2, t3)
    seg = torch.where(pos < torch.tensor([[t3], [177]], device=dev), 0, -1)
    for d in (80, 96):
        q, k, v = (randn(2, t3, 4, d, dtype=torch.bfloat16) for _ in range(3))
        errs.append(check_flash(f"bf16 d={d} T=300 ragged non-causal",
                                (q, k, v, seg, seg, pos, pos, False, None, None, False)))
    # a bf16 view whose rows do not start on 16-byte boundaries (storage
    # offset of 4 elements): the wrapper copies it and the tensor-core route
    # runs; same bits as the aligned call, and counted as mma launches
    aligned = FL.flash_attention(q, k, v, seg, seg, pos, pos, False)
    shifted = []
    for x in (q, k, v):
        buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=dev)
        buf[4:].copy_(x.reshape(-1))
        shifted.append(buf[4:].view(x.shape))
    before = FL.flash_attention.mma_launches
    moved = FL.flash_attention(*shifted, seg, seg, pos, pos, False)
    ok = (shifted[0].data_ptr() % 16 != 0 and torch.equal(moved, aligned)
          and FL.flash_attention.mma_launches == before + 1)
    log(f"  K2 [bf16 d=96 operands at a storage offset of 8 bytes] copied by the wrapper, "
        f"tensor-core route, bit-equal to the aligned call: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K2: a misaligned bf16 view did not take the copy route")
    # (b) Voicebox: B=2, T=449, 16 heads d=64, ALiBi, second row shorter, f32;
    # rows as the estimator makes them: int32, contiguous, once per forward
    t1 = 449
    q, k, v = (randn(2, t1, 16, 64) for _ in range(3))
    pos = torch.arange(t1, device=dev, dtype=torch.int32)[None].expand(2, t1).contiguous()
    lens = torch.tensor([t1, 301], device=dev)
    seg = torch.where(pos < lens[:, None], 0, -1).to(torch.int32)
    args_b = (q, k, v, seg, seg, pos, pos, False, None, 64**-0.5, True)
    errs32.append(check_flash("voicebox f32 B=2 T=449 ALiBi", args_b, 1e-4))
    valid_b = attn_mask(seg, seg, pos, pos, False, None)
    # the library yardstick as models/voicebox.py's plain path builds its
    # bias: ALiBi with key column 0 exempt, the pad columns at finfo.min
    slopes = FL.alibi_slopes_pow2(16).to(dev)[None, :, None, None]
    dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
    bias_b = -slopes * dist * (pos[:, None, None, :] != 0)
    bias_b = torch.where((seg >= 0)[:, None, None, :], bias_b, torch.finfo(torch.float32).min)
    f32 = {"b": f32_case(dev, args_b, bias_b, (seg >= 0)[:, :, None, None],
                         4 * 64 * 16 * int(valid_b.sum()))}
    del dist, bias_b
    # (c) XLS-R long clip: T=2100, 16 heads d=80, f32, non-causal
    t = 2100
    q, k, v = (randn(1, t, 16, 80) for _ in range(3))
    pos = torch.arange(t, device=dev)[None]
    seg = torch.zeros_like(pos)
    args_c = (q, k, v, seg, seg, pos, pos, False)
    errs32.append(check_flash("xlsr f32 T=2100 d=80", args_c, 1e-4))
    f32["c"] = f32_case(dev, args_c, None, None, 4 * 80 * 16 * t * t)
    # (d) the prompted estimator: a speaker reference's frames before a
    # 256-unit answer's, B 2 (CFG), T+1 705 (a 3 s reference) and 1857 (16 s),
    # 16 heads d 64, ALiBi, non-causal, both rows of one length
    for t1, n_valid in ((705, 700), (1857, 1820)):
        q, k, v = (randn(2, t1, 16, 64) for _ in range(3))
        pos = torch.arange(t1, device=dev, dtype=torch.int32)[None].expand(2, t1).contiguous()
        seg = torch.where(pos < n_valid, 0, -1).to(torch.int32)
        args_d = (q, k, v, seg, seg, pos, pos, False, None, 64**-0.5, True)
        errs32.append(check_flash(f"prompted voicebox f32 B=2 T+1={t1} ALiBi", args_d, 1e-4))
        valid_d = attn_mask(seg, seg, pos, pos, False, None)
        dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
        bias_d = -slopes * dist * (pos[:, None, None, :] != 0)
        bias_d = torch.where((seg >= 0)[:, None, None, :], bias_d,
                             torch.finfo(torch.float32).min)
        f32[f"d T+1={t1}"] = f32_case(dev, args_d, bias_d, (seg >= 0)[:, :, None, None],
                                      4 * 64 * 16 * int(valid_d.sum()))
        del dist, bias_d, q, k, v
    for key, r in f32.items():
        log(f"  K2 ({key}) f32, 3xTF32 route: kernel {r['ms']:.4f} ms eager, "
            f"{r['graph_ms']:.4f} ms from a CUDA graph ({r['tflops']:.1f} TFLOP/s of f32 "
            f"products); plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, 3xTF32 at 495 TFLOP/s; the 67 TFLOP/s f32 CUDA-core floor "
            f"{r['cuda_core_ms']:.4f} ms); scaled_dot_product_attention f32 "
            f"{r['library_ms']:.4f} ms eager, {r['library_graph_ms']:.4f} ms from a graph, "
            f"kernels {r['library_kernels']}, max_abs_err against the f64 plain version "
            f"{r['library_err']:.3e} (the kernel's {r['err_f64']:.3e})")
    log(f"  K2 (a) bf16, tensor-core route: bound {k2_bound['bound_ms']:.4f} ms "
        f"({k2_bound['bound_by']}), {k2_ops / timings['a'][0] / 1e9:.1f} TFLOP/s achieved; one "
        f"scaled_dot_product_attention call with the boolean mask {k2_lib:.4f} ms; replayed "
        f"from a CUDA graph (device time alone) kernel {k2_graph[0]:.4f} ms, the library call "
        f"{k2_graph[1]:.4f} ms")
    km, pm = timings["a"]
    log(f"  K2 time (a): kernel {km:.4f} ms, plain {pm:.4f} ms")
    errs += [k2_mixed_case(dev, randn, *case) for case in MIXED_CASES]
    errs.append(k2_dense_extend_case(dev, randn))
    results["flash_attention"] = {"max_abs_err": max(errs), "ms": km, "plain_ms": pm,
                                  **k2_bound, "library_ms": k2_lib, "case": "prefill (a) bf16"}
    rb = f32["b"]
    results["flash_attention_f32"] = {"max_abs_err": max(errs32),
                                      **{k: rb[k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by", "library_ms")},
                                      "case": "voicebox (b) f32 B=2 T=449 d=64 ALiBi"}

    results["fused_activation1d"] = k3_checks(dev, randn)
    return results


# the chunk rows of one mixed prefill + decode link (engine/paged_ops.py::
# paged_mixed_step at the serving cell's page 256, chunk 256, 3 pages a
# sequence) as (starts, n_valid, S_ctx): each row its own start, 128 or 256
# valid queries or none (fully padded, every query segment -1); NPF 8 over 3
# pages, and the NPF 2 and 4 rows over 1 and 2 pages that part (C)'s
# 384-token prompts mostly give (chunk 0 at start 0, chunk 1 at 256)
MIXED_CASES = (((0, 256, 0, 256, 0, 0, 256, 0), (256, 128, 256, 256, 0, 128, 256, 0), 768),
               ((0, 0), (256, 128), 256), ((0, 256, 0, 0), (256, 128, 256, 0), 512))


def k2_mixed_case(dev, randn, starts, valid, s_ctx) -> float:
    """K2 (bf16) at a mixed link's shape: NPF rows (B), T 256, GQA 32/8, d
    128, S_ctx keys, window 4096, per-row starts and kv segments, against
    the plain version with round_operands at the bf16 bound; padded rows
    (n_valid 0) must be 0 on both sides.  Logs eager, CUDA-graph and SDPA
    (boolean mask) ms and the bound -> the error."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    npf, c = len(starts), 256
    q = randn(npf, c, 32, 128, dtype=torch.bfloat16)
    kv = randn(2, npf, 8, s_ctx, 128, dtype=torch.bfloat16)  # head-major, as gathered
    k, v = kv[0].permute(0, 2, 1, 3), kv[1].permute(0, 2, 1, 3)
    start = torch.tensor(starts, device=dev, dtype=torch.int32)[:, None]
    n_valid = torch.tensor(valid, device=dev, dtype=torch.int32)[:, None]
    ar = torch.arange(c, device=dev, dtype=torch.int32)[None]
    qpos = start + ar
    qseg = torch.where(ar < n_valid, 0, -1).to(torch.int32)
    kpos = torch.arange(s_ctx, device=dev, dtype=torch.int32)[None].expand(npf, s_ctx)
    kseg = torch.where(kpos < start + n_valid, 0, -1).to(torch.int32)
    kpos = kpos.contiguous()
    args = (q, k, v, qseg, kseg, qpos, kpos, True, 4096, None, False)
    got = FL.flash_attention(*args)
    want, _ = FL.flash_attention_reference(*args, round_operands=True)
    case = (f"mixed link B={npf} T=256 S_ctx={s_ctx} per-row starts, "
            f"{valid.count(0)} rows padded")
    err = check("K2", case, got, want, bf16_bound(want))
    padded = n_valid[:, 0] == 0
    if not (torch.all(got[padded] == 0) and torch.all(want[padded] == 0)):
        raise AssertionError("K2: a fully padded row is not 0")
    mask = attn_mask(qseg, kseg, qpos, kpos, True, 4096)
    bound = least_time(2 * nbytes(q) + nbytes(k, v, qseg, kseg, qpos, kpos),
                       4 * 128 * 32 * int(mask.sum()), "bf16")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)

    ms = cuda_ms(lambda: FL.flash_attention(*args))
    g_ms = graph_ms(lambda: [FL.flash_attention(*args) for _ in range(10)], dev) / 10
    lib = cuda_ms(sdpa)
    lib_g = graph_ms(lambda: [sdpa() for _ in range(10)], dev) / 10
    plain = cuda_ms(lambda: FL.flash_attention_reference(*args))
    log(f"  K2 [{case}]: kernel {ms:.4f} ms eager, {g_ms:.4f} ms from a CUDA graph; plain "
        f"{plain:.4f} ms; scaled_dot_product_attention with the boolean mask {lib:.4f} ms, "
        f"{lib_g:.4f} ms from a graph; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); "
        f"{int(mask.sum())} of {npf * c * s_ctx} (query, key) pairs pass the masks (the "
        f"wrapper does not report its skipped tiles)")
    return err


def k2_dense_extend_case(dev, randn) -> float:
    """K2 (bf16) where the dense prefill_extend calls it: B 1, 256 queries at
    offset 320 against an 8,192-slot cache whose keys from 576 on are
    padding (segment -1), window 4096, GQA 32/8, d 128; the tiles must be
    skipped by position (usdm_tpu's Pallas kernel skips by flat index, which
    is wrong at this shape).  Against the plain version with round_operands
    at the bf16 bound; logs eager, CUDA-graph, plain and SDPA (boolean mask)
    ms and the bound, counted on the keys the masks pass -> the error."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    t, s, off = 256, 8192, 320
    q = randn(1, t, 32, 128, dtype=torch.bfloat16)
    k, v = (randn(1, s, 8, 128, dtype=torch.bfloat16) for _ in range(2))
    qpos = (off + torch.arange(t, device=dev, dtype=torch.int32))[None]
    qseg = torch.zeros(1, t, dtype=torch.int32, device=dev)
    kpos = torch.arange(s, device=dev, dtype=torch.int32)[None]
    kseg = torch.where(kpos < off + t, 0, -1).to(torch.int32)
    args = (q, k, v, qseg, kseg, qpos, kpos, True, 4096, None, False)
    got = FL.flash_attention(*args)
    want, _ = FL.flash_attention_reference(*args, round_operands=True)
    case = "dense prefill_extend B=1 T=256 at offset 320, S=8192, keys valid to 576"
    err = check("K2", case, got, want, bf16_bound(want))
    mask = attn_mask(qseg, kseg, qpos, kpos, True, 4096)
    # the bytes the function needs: q and out, the 576 valid K and V rows
    bound = least_time(2 * nbytes(q) + 2 * (off + t) * 8 * 128 * k.element_size()
                       + nbytes(qseg, kseg, qpos, kpos), 4 * 128 * 32 * int(mask.sum()), "bf16")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)

    ms = cuda_ms(lambda: FL.flash_attention(*args))
    g_ms = graph_ms(lambda: [FL.flash_attention(*args) for _ in range(10)], dev) / 10
    plain = cuda_ms(lambda: FL.flash_attention_reference(*args))
    lib = cuda_ms(sdpa)
    lib_g = graph_ms(lambda: [sdpa() for _ in range(10)], dev) / 10
    log(f"  K2 [{case}]: kernel {ms:.4f} ms eager, {g_ms:.4f} ms from a CUDA graph; plain "
        f"{plain:.4f} ms; scaled_dot_product_attention with the boolean mask {lib:.4f} ms, "
        f"{lib_g:.4f} ms from a graph; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return err


def k4_prompt_case(dev) -> float:
    """K4's forward where a 16 s speaker reference puts the estimator over
    its gate: [2, 1857, 1024] f32, rows valid to 1820 (int32 lengths, as
    the estimator passes them), post_mask off and on, against the plain
    version at the f32 bound 1e-5; eager, CUDA-graph and plain ms and the
    bound -> the error."""
    import torch

    from usdm_tpu_torch.ops import fused_ln as LN

    gen = torch.Generator(device=dev).manual_seed(12)
    x, r = (torch.randn(2, 1857, 1024, generator=gen, device=dev) for _ in range(2))
    w = torch.randn(1024, generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn(1024, generator=gen, device=dev) * 0.1
    lens = torch.tensor([1820, 1820], dtype=torch.int32, device=dev)
    errs = [check("K4", f"[2, 1857, 1024] f32 post_mask={post}",
                  LN.add_mask_ln(x, r, lens, w, b, post),
                  LN.add_mask_ln_reference(x, r, lens, w, b, post), 1e-5)
            for post in (False, True)]
    ms = cuda_ms(lambda: LN.add_mask_ln(x, r, lens, w, b, True))
    g_ms = graph_ms(lambda: [LN.add_mask_ln(x, r, lens, w, b, True) for _ in range(10)], dev) / 10
    plain = cuda_ms(lambda: LN.add_mask_ln_reference(x, r, lens, w, b, True))
    bound = least_time(3 * nbytes(x) + nbytes(w, b, lens), 8 * x.numel(), "f32")
    log(f"  K4 time [2, 1857, 1024] f32 post_mask (the 16 s prompted estimator): kernel "
        f"{ms:.4f} ms eager, {g_ms:.4f} ms from a CUDA graph; plain {plain:.4f} ms; bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return max(errs)


def k3_checks(dev, randn) -> dict:
    """K3 at the six BigVGAN stage shapes of a 448-frame mel, snake-beta,
    log-scale, against the plain version (f32 and bf16) and, not gated, the
    f64 plain version (the reduced sine's error); in f32 without log-scale
    against the f64 plain version (k3_linear_scale); per stage in f32: eager,
    from a CUDA graph, plain, bound; then a turn's 109 launches at their
    shapes from one CUDA graph."""
    import torch

    from usdm_tpu_torch.ops import fused_act as FA

    log("K3 fused_activation1d vs activation1d_reference in f32 on the same inputs "
        "(snake-beta, log-scale; bound 1e-4 f32, 3e-2 bf16: the bf16 output's rounding, half "
        "an ulp, 0.0156 below |y| = 8; the f64 plain version's error logged)")
    errs, stages, xs, max_arg, err64 = [], [], [], 0.0, 0.0
    for ch, tlen in STAGES:
        alpha, beta = randn(ch) * 0.3, randn(ch) * 0.3
        for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            x = randn(1, ch, tlen, dtype=dtype)
            got = FA.fused_activation1d(x, alpha, beta, True)
            want = FA.activation1d_reference(x.float(), alpha, beta, True)
            errs.append(check("K3", f"C={ch} T={tlen} {str(dtype)[6:]}", got, want, bound))
            if dtype != torch.float32:
                continue
            exact = FA.activation1d_reference(x.double(), alpha.double(), beta.double(), True)
            e64 = max_err(got.double(), exact)
            arg = (FA.upsample2(x) * alpha.exp()[None, :, None]).abs().max().item()
            max_arg, err64 = max(max_arg, arg), max(err64, e64)

            def act():
                return FA.fused_activation1d(x, alpha, beta, True)

            st = {"C": ch, "T": tlen, "err_f64": e64, "max_arg": arg, "ms": cuda_ms(act),
                  "graph_ms": graph_ms(lambda: [act() for _ in range(10)], dev) / 10,
                  "plain_ms": cuda_ms(lambda: FA.activation1d_reference(x, alpha, beta, True)),
                  **least_time(8 * ch * tlen + 8 * ch, 60 * ch * tlen, "f32")}
            stages.append(st)
            xs.append((x, alpha, beta))
            log(f"  K3 time C={ch} T={tlen} f32: kernel {st['ms']:.4f} ms eager, "
                f"{st['graph_ms']:.4f} ms from a CUDA graph, "
                f"plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms ({st['bound_by']}); "
                f"against the f64 plain version {e64:.3e}; max |a u| {arg:.2f}")
    rel_linear = k3_linear_scale(randn)
    # a turn: 18 activations per stage (3 AMP blocks x 3 dilations x 2) and
    # the last one at the last stage's shape, replayed from one CUDA graph
    turn = [xs[i] for i in range(len(STAGES)) for _ in range(18)] + [xs[-1]]
    turn_ms = graph_ms(lambda: [FA.fused_activation1d(x, a, b, True) for x, a, b in turn], dev)
    turn_bound = 18 * sum(st["bound_ms"] for st in stages) + stages[-1]["bound_ms"]
    # per element: 2x upsampling and 2x downsampling with 12-tap filters (12
    # multiply-adds each way) and the snake on the two upsampled values
    # (~6 operations each): ~60 f32 operations; f32 in and out, alpha, beta
    elems = sum(ch * tlen for ch, tlen in STAGES)
    res = {"max_abs_err": max(errs), "err_f64": err64, "max_arg": max_arg,
           "ms": sum(s["ms"] for s in stages), "plain_ms": sum(s["plain_ms"] for s in stages),
           "graph_ms": sum(s["graph_ms"] for s in stages),
           **least_time(8 * elems + sum(8 * ch for ch, _ in STAGES), 60 * elems, "f32"),
           "library_ms": None, "turn_graph_ms": turn_ms, "turn_launches": len(turn),
           "turn_bound_ms": turn_bound, "stages": stages, "linear_rel_err_f64": rel_linear,
           "case": "sum of one activation per stage, f32"}
    log(f"  K3 one activation per stage, f32, summed: kernel {res['ms']:.4f} ms eager, "
        f"{res['graph_ms']:.4f} ms from a CUDA graph, "
        f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"a turn's {len(turn)} launches from one graph {turn_ms:.4f} ms (bound "
        f"{turn_bound:.4f} ms); against the f64 plain version {err64:.3e} at |a u| <= "
        f"{max_arg:.2f}")
    return res


def k3_linear_scale(randn) -> float:
    """K3 in f32 without log-scale, alpha and beta drawn from N(0, 0.3^2) as
    they are, at the six stage shapes: a b near 0 lifts a channel's outputs,
    and every f32 rounding in them, by 1/b, so each channel is held to 1e-4
    times its largest |y| (at least 1) against the f64 plain version.
    Returns the largest error so scaled."""
    import torch

    from usdm_tpu_torch.ops import fused_act as FA

    worst = 0.0
    for ch, tlen in STAGES:
        alpha, beta = randn(ch) * 0.3, randn(ch) * 0.3
        x = randn(1, ch, tlen)
        got = FA.fused_activation1d(x, alpha, beta, False).double()
        want = FA.activation1d_reference(x.double(), alpha.double(), beta.double(), False)
        scale = want.abs().amax(dim=(0, 2)).clamp(min=1.0)
        rel = ((got - want).abs().amax(dim=(0, 2)) / scale).max().item()
        ok = bool(torch.isfinite(got).all()) and rel <= 1e-4
        log(f"  K3 [C={ch} T={tlen} f32, linear scale] max_abs_err / channel scale against the "
            f"f64 plain version {rel:.3e} bound 1.000e-04 (min |b| {beta.abs().min().item():.3e}, "
            f"largest channel scale {scale.max().item():.1f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3 [C={ch} T={tlen} linear scale] disagrees with its f64 "
                                 f"plain version: {rel} of the channel scale > 1e-4")
        worst = max(worst, rel)
    return worst


def tiny_kernel_checks(dev) -> dict:
    """Phase 3, the tiny models' head dims (ROADMAP F5): K1 at head_dim 16
    (the tiny LM: GQA 4/2, page 16, two layer regions; bf16, f32 and int8
    pools; B 1 and 2; window None and 64), K2 at head_dim 8 (f32 with ALiBi
    as the tiny Voicebox's estimator calls it, B 2 x T+1 174, 4 heads; f32
    as tiny XLS-R calls it, T 2400; bf16 causal over three packed segments,
    B 2 x 300, GQA 4/2) and K5 bf16 at that last case, each against its
    plain version (bf16: bf16_bound; f32: 1e-4; int8 pools: bf16_bound of
    the plain version on f32 queries plus the measured effect of rounding
    the dequantized K/V, as phase 3's int8 case); logged with eager, graph
    and plain ms, the bound and one SDPA call's ms (K2: the forward with the
    boolean mask or the additive ALiBi bias; K5: the backward).
    -> the largest error per kernel name."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import quant_kv_token
    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"paged_decode_attention": 0.0, "paged_decode_attention_int8": 0.0,
            "flash_attention": 0.0, "flash_attention_f32": 0.0, "flash_attention_bwd_dq": 0.0,
            "flash_attention_bwd_dkv": 0.0}

    def keep(name, err):
        errs[name] = max(errs[name], err)

    def timed(label, fn, plain, n_bytes, ops, kind, library=None):
        t = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn, dev), "plain_ms": cuda_ms(plain),
             **least_time(n_bytes, ops, kind),
             "library_ms": cuda_ms(library) if library is not None else None}
        log(f"  {label} times: " + json.dumps(t))

    hkv, grp, d, page, maxp = 2, 2, 16, 16, 8
    for kind in ("bf16", "f32", "int8"):
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        for b in (1, 2):
            nt = 2 * (b * maxp + 1)  # two layer regions
            table = torch.randperm(nt - 1, generator=gen, device=dev)[: b * maxp]
            table = table.reshape(b, maxp).to(torch.int32).contiguous()
            lens = torch.tensor([100, 7][:b], dtype=torch.int32, device=dev)
            q = randn(b, hkv, grp, d, dtype=dt)
            scales = {}
            if kind == "int8":
                pools = []
                for key in ("k_scales", "v_scales"):
                    qv, sv = quant_kv_token(randn(hkv, nt, page, d))
                    pools.append(qv)
                    scales[key] = sv.transpose(0, 1).contiguous()  # [NT, Hkv, P]
            else:
                pools = [randn(hkv, nt, page, d, dtype=dt) for _ in range(2)]
            for window in (None, 64):
                args = (q, *pools, table, lens, window)
                got = PA.paged_decode_attention(*args, **scales)
                want = PA.paged_decode_attention_reference(*args, **scales)
                case = f"d=16 {kind} B={b} window={window}"
                if kind == "f32":
                    err = check("K1", case, got, want, 1e-4)
                elif kind == "bf16":
                    err = check("K1", case, got, want, bf16_bound(want))
                else:
                    fold = PA.paged_decode_attention_reference(q.float(), *pools, table, lens,
                                                               window, **scales)
                    err = check("K1", case, got, want,
                                bf16_bound(fold) + max_err(want, fold))
                keep("paged_decode_attention_int8" if scales else "paged_decode_attention", err)
                if b == 2 and window == 64:
                    rows = torch.clamp(lens, max=window + 1)  # the in-window rows read
                    kv_row = hkv * d * pools[0].element_size() + (8 * hkv if scales else 0)
                    timed(f"K1 [{case}]", lambda: PA.paged_decode_attention(*args, **scales),
                          lambda: PA.paged_decode_attention_reference(*args, **scales),
                          2 * nbytes(q) + 2 * kv_row * int(rows.sum()),
                          4 * hkv * grp * d * int(rows.sum()), "f32")

    def rows(b, t, n_seg):
        pos = torch.arange(t, device=dev)[None].expand(b, t)
        if n_seg > 1:  # packed segments, positions restart in each
            bounds = torch.tensor([0, t // 3, 2 * t // 3, t], device=dev)
            seg = torch.bucketize(pos, bounds[1:-1], right=True).contiguous()
            pos = (pos - bounds[seg]).contiguous()
        else:  # the second row shorter
            seg = torch.where(pos < torch.tensor([[t], [2 * t // 3]], device=dev)[:b], 0, -1)
        return seg, seg, pos, pos

    cases = (("Voicebox estimator f32 ALiBi", 2, 174, 4, 4, torch.float32, 1,
              dict(causal=False, sliding_window=None, alibi=True)),
             ("XLS-R f32", 1, 2400, 4, 4, torch.float32, 1,
              dict(causal=False, sliding_window=None, alibi=False)),
             ("bf16 causal segments", 2, 300, 4, 2, torch.bfloat16, 3,
              dict(causal=True, sliding_window=None, alibi=False)))
    for label, b, t, h, h_kv, dt, n_seg, flags in cases:
        q, do = randn(b, t, h, 8, dtype=dt), randn(b, t, h, 8, dtype=dt)
        k, v = randn(b, t, h_kv, 8, dtype=dt), randn(b, t, h_kv, 8, dtype=dt)
        rr = rows(b, t, n_seg)
        bf = dt == torch.bfloat16
        o, lse = FL.flash_attention(q, k, v, *rr, return_lse=True, **flags)
        want_o, want_lse = FL.flash_attention_reference(q, k, v, *rr, **flags,
                                                        round_operands=bf)
        case = f"d=8 {label} B={b} T={t}"
        keep("flash_attention" if bf else "flash_attention_f32",
             check("K2", case, o, want_o, bf16_bound(want_o) if bf else 1e-4))
        check("K2 lse", case, lse, want_lse, 1e-4)
        mask = attn_mask(rr[0], rr[1], rr[2], rr[3], flags["causal"], flags["sliding_window"])
        pairs = int(mask.sum()) * h
        # one SDPA call, K/V repeated over the group, with the boolean mask
        # or, for ALiBi, the additive bias (key column 0 exempt, padding at
        # the dtype's least value)
        sdpa_mask = mask[:, None]
        if flags["alibi"]:
            slopes = FL.alibi_slopes_pow2(h).to(dev)[None, :, None, None]
            dist = (rr[2][:, None, :, None] - rr[3][:, None, None, :]).abs().float()
            sdpa_mask = torch.where(sdpa_mask, -slopes * dist * (rr[3][:, None, None, :] != 0),
                                    torch.finfo(dt).min).to(dt)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k.repeat_interleave(h // h_kv, 2),
                                v.repeat_interleave(h // h_kv, 2)))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=sdpa_mask)
        with torch.no_grad():
            timed(f"K2 [{case}]", lambda: FL.flash_attention(q, k, v, *rr, **flags),
                  lambda: FL.flash_attention_reference(q, k, v, *rr, **flags,
                                                       round_operands=bf),
                  2 * nbytes(q) + nbytes(k, v, lse), 4 * pairs * 8, "bf16" if bf else "3xtf32",
                  library)
        if not bf:
            continue
        got = FL.flash_attention_bwd(q, k, v, o, lse, do, *rr, flags["causal"],
                                     flags["sliding_window"], None, flags["alibi"])
        want = FL.flash_attention_bwd_reference(q, k, v, o, lse, do, *rr, flags["causal"],
                                                flags["sliding_window"], None, flags["alibi"],
                                                round_operands=True)
        for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
            keep("flash_attention_bwd_dq" if name == "dq" else "flash_attention_bwd_dkv",
                 check(f"K5 {name}", case, gg, ww, bf16_bound(ww)))
        ot = library()  # SDPA's backward with the same boolean mask, dq, dk and dv
        dot = do.transpose(1, 2)
        timed(f"K5 [{case}]", lambda: FL.flash_attention_bwd(
            q, k, v, o, lse, do, *rr, flags["causal"], flags["sliding_window"], None,
            flags["alibi"]), lambda: FL.flash_attention_bwd_reference(
            q, k, v, o, lse, do, *rr, flags["causal"], flags["sliding_window"], None,
            flags["alibi"], round_operands=True),
            2 * nbytes(q, k, v) + nbytes(do, o, lse), 10 * pairs * 8, "bf16",
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    return errs


def k1_split_checks(dev) -> None:
    """K1 at forced split counts (1, 2) and the host's choice, B 1 and 8, page
    64 and 256, and B 16 at page 256 with 3 pages a slot (part (C)'s server),
    bf16 and int8 pools, with and without a window of 512, the B 8 slots of
    lengths 1 to 4200, the B 16 of 1 to 768; then a speculative verify's
    launch: B*(K+1) rows (B 1 and 4, K 4; row j*B + b reads slot b's table
    row up to kv_len lens_b + j + 1) at the split count the host picks for B
    rows, at bench_ngram's page 64 with 128 and 24 pages a slot and
    bench_spec_degraded's page 256 with 3, windows None, 512 and the 7B's
    4096; bounds as in the K1 and K1-int8 cases (int8 scale slots the kernel
    must not read hold NaN).  Then one call, captured in a CUDA graph and
    replayed, must equal the eager call bit for bit, and the eager call must
    run under sync debug mode "error": no value is read back to the host."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import quant_kv_token
    from usdm_tpu_torch.ops import paged_attention as PA

    log("K1 split over the KV length: forced n_splits 1, 2 and the host's choice, and a "
        "verify's B*(K+1) rows at B's (bounds of the K1 cases; int8 against the f32-query "
        "plain version, then against the plain version with the K/V rounding's measured "
        "effect added)")
    gen = torch.Generator(device=dev).manual_seed(4)
    hkv, g, d = 8, 4, 128

    def setup(kv, b, maxp, page, rows):
        nt = b * maxp + 1
        table = torch.randperm(nt, generator=gen, device=dev)[: b * maxp]
        table = table.reshape(b, maxp).to(torch.int32).contiguous()
        q = torch.randn(rows, hkv, g, d, generator=gen, device=dev).bfloat16()
        if kv == "bf16":
            kp, vp = (torch.randn(hkv, nt, page, d, generator=gen, device=dev).bfloat16()
                      for _ in range(2))
            return table, q, kp, vp, {}
        (kp, ks), (vp, vs) = (quant_kv_token(torch.randn(
            hkv, nt, page, d, generator=gen, device=dev)) for _ in range(2))
        return table, q, kp, vp, {"k_scales": ks.transpose(0, 1).contiguous(),
                                  "v_scales": vs.transpose(0, 1).contiguous()}

    def case(label, q, kp, vp, scales, table, lens, windows, splits):
        """Each window and (tag, n_splits) against the plain version -> the
        scales the last window's calls took (NaN where they must not read)."""
        nt, page = kp.shape[1], kp.shape[2]
        for window in windows:
            seen = dict(scales)
            if scales:  # NaN where the kernel must not read
                read = torch.zeros(nt, page, dtype=torch.bool, device=dev)
                pos = torch.arange(table.shape[1] * page, device=dev)
                for bi, n in enumerate(lens.tolist()):
                    ok = (pos < n) & ((n - 1 - pos <= window) if window else True)
                    read[table[bi].long()[pos[ok] // page], pos[ok] % page] = True
                seen = {k: a.masked_fill(~read[:, None, :], float("nan"))
                        for k, a in scales.items()}
            want = PA.paged_decode_attention_reference(q, kp, vp, table, lens, window,
                                                       **scales)
            fold = PA.paged_decode_attention_reference(q.float(), kp, vp, table, lens,
                                                       window, **scales)
            bound = bf16_bound(fold)
            rounding = max_err(want, fold) if scales else 0.0
            errs = []
            for tag, n_splits in splits:
                got = PA.paged_decode_attention(q, kp, vp, table, lens, window,
                                                n_splits=n_splits, **seen)
                e1, e2 = max_err(got, fold), max_err(got, want)
                ok = bool(torch.isfinite(got.float()).all()) and (
                    e1 <= bound and e2 <= bound + rounding)
                errs.append(f"{tag}: {e1:.3e}/{e2:.3e}")
                if not ok:
                    raise AssertionError(f"K1 {label} window {window} n_splits {tag}: "
                                         f"{e1}, {e2} against {bound} + {rounding}")
            log(f"  K1 [{label} window={window}] max_abs_err by n_splits (f32-query plain "
                f"/ plain): {', '.join(errs)}; bound {bound:.3e} (+ {rounding:.3e}) ok")
        return seen

    slot_lens = {1: [700], 8: [1, 700, 4200, 63, 64, 257, 2, 1500],
                 16: [1, 384, 385, 512, 767, 768, 256, 257, 2, 100, 450, 500, 700, 64, 65, 640]}
    # a verify's slots (the position of its current token); the last sits
    # past the 7B's window where the table holds it
    verify_lens = {1: [700], 4: [1, 700, 62, 763]}
    k1 = 5
    graph_cases = []
    for kv in ("bf16", "int8"):
        # B 16 with 3 pages of 256 a slot: part (C)'s server
        for page, b in ((64, 1), (64, 8), (256, 1), (256, 8), (256, 16)):
            maxp = 3 if b == 16 else -(-4200 // page)
            table, q, kp, vp, scales = setup(kv, b, maxp, page, b)
            lens = torch.tensor(slot_lens[b], dtype=torch.int32, device=dev)
            auto = PA.split_count(b, hkv, maxp, page, PA._sm_count(0))
            seen = case(f"split {kv} page={page} B={b}", q, kp, vp, scales, table, lens,
                        (None, 512), ((1, 1), (2, 2), (f"host {auto}", None)))
            if b == 8 and page == 64:
                graph_cases.append((kv, (q, kp, vp, table, lens, 512), seen))
        # a verify's launch (paged_ops.paged_verify_step): B*(K+1) rows, row
        # j*B + b on slot b's table row at kv_len lens_b + j + 1, cut at the
        # split count the host picks for a decode link's B rows
        for page, maxp in ((64, 128), (64, 24), (256, 3)):
            for b in (1, 4):
                table, q, kp, vp, scales = setup(kv, b, maxp, page, b * k1)
                base = verify_lens[b][:-1] + [6000 if maxp == 128 else verify_lens[b][-1]]
                lens = (torch.tensor(base, dtype=torch.int32, device=dev)[None, :]
                        + torch.arange(1, k1 + 1, dtype=torch.int32, device=dev)[:, None])
                n_splits = PA.host_split_count(b, hkv, maxp, page, q.device)
                case(f"verify {kv} page={page} pages={maxp} B={b} K+1={k1}", q, kp, vp,
                     scales, table.repeat(k1, 1), lens.reshape(-1), (None, 512, 4096),
                     ((f"B {b}'s {n_splits}", n_splits),))
    for kv, args, seen in graph_cases:
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = PA.paged_decode_attention(*args, **seen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = PA.paged_decode_attention(*args, **seen)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = torch.equal(out, eager)
        log(f"  K1 split [{kv} page=64 B=8 window=512] eager call under sync debug mode "
            f"\"error\": no sync; captured in a CUDA graph and replayed: "
            f"{'bit-equal to the eager call' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError(f"K1 ({kv}) from a CUDA graph differs from the eager call")


def train_kernel_checks(dev) -> dict:
    """K5 and K4 against their plain versions at the training path's shapes."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.ops import fused_ln as LN

    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # K5 (a): the Voicebox training shape, B 8 of T+1 = 1379, 16 heads d 64,
    # ALiBi, non-causal, rows ragged.  Both backward versions take the same
    # saved forward (K2's output and log-sum-exp), which is first held
    # against K2's plain version at this shape.
    log("K5 flash_attention_bwd_dq / flash_attention_bwd_dkv vs flash_attention_bwd_reference "
        "(dq, dk, dv; bf16, the tensor-core route, against the plain version with "
        "round_operands=True: bound 2^-7 * max|want| + 1e-4 per output, both multiply bf16 "
        "operands, accumulate in f32 and round P and dS at the same places; f32, 3xTF32 on "
        "the tensor cores: bound 1e-4), on the forward of K2, held against "
        "flash_attention_reference first (output: same bounds; log-sum-exp 1e-4)")
    b, t1, h, d = 8, 1379, 16, 64
    # rows as the estimator makes them: int32, contiguous, once per forward
    pos = torch.arange(t1, device=dev, dtype=torch.int32)[None].expand(b, t1).contiguous()
    lens = torch.tensor([1379, 900, 1379, 1200, 640, 1379, 1000, 1301], device=dev)
    seg = torch.where(pos < lens[:, None], 0, -1).to(torch.int32)
    errs = {"dq": [], "dkv": [], "fwd": [], "fwd32": [], "dq32": [], "dkv32": []}
    timing, k5_bounds, k5_ops, library, library_fwd = {}, {}, {}, None, None

    def bwd_case(case, q, k, v, do, segs, poss, causal, window, alibi, dtype):
        o, lse = FL.flash_attention(q, k, v, segs, segs, poss, poss, causal, window,
                                    alibi=alibi, return_lse=True)
        rounded = dtype == torch.bfloat16
        want_o, want_lse = FL.flash_attention_reference(q, k, v, segs, segs, poss, poss, causal,
                                                        window, None, alibi, rounded)
        errs["fwd" if rounded else "fwd32"].append(check("K2", f"{case} o", o, want_o,
                                                         bf16_bound(want_o) if rounded else 1e-4))
        check("K2 lse", case, lse, want_lse, 1e-4)
        del want_o, want_lse
        ref_args = (q, k, v, o, lse, do, segs, segs, poss, poss, causal, window, None, alibi)
        want = FL.flash_attention_bwd_reference(*ref_args, rounded)
        got = FL.flash_attention_bwd(*ref_args)
        out = []
        for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
            bound = bf16_bound(ww) if rounded else 1e-4
            out.append(check("K5", f"{case} {name}", gg, ww, bound))
        if rounded:
            exact = FL.flash_attention_bwd_reference(*ref_args)
            log(f"  K5 [{case}] against the unrounded plain version (not gated): max_abs_err "
                + ", ".join(f"{n} {max_err(gg, ee):.3e}"
                            for n, gg, ee in zip(("dq", "dk", "dv"), got, exact)))
            del exact
        errs["dq" if rounded else "dq32"].append(out[0])
        errs["dkv" if rounded else "dkv32"].append(max(out[1:]))
        return o, lse, want

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (randn(b, t1, h, d, dtype=dtype) for _ in range(4))
        o, lse, want = bwd_case(f"(a) voicebox {str(dtype)[6:]} B=8 T=1379 ALiBi", q, k, v, do,
                                seg, pos, False, None, True, dtype)
        if dtype != torch.bfloat16:
            continue
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, seg, seg, pos, pos, False, None, None, True)
        timing["a"] = (cuda_ms(lambda: FL.flash_attention_bwd_dq(*args)),
                       cuda_ms(lambda: FL.flash_attention_bwd_dkv(*args)),
                       cuda_ms(lambda: FL.flash_attention_bwd_reference(
                           q, k, v, o, lse, do, seg, seg, pos, pos, False, None, None, True)),
                       cuda_ms(lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos, False,
                                                          None, alibi=True)),
                       cuda_ms(lambda: FL.flash_attention_reference(q, k, v, seg, seg, pos, pos,
                                                                    False, None, None, True)))
        timing["graph"] = tuple(
            graph_ms(lambda fn=fn: [fn() for _ in range(10)], dev) / 10
            for fn in (lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos, False, None,
                                                  alibi=True),
                       lambda: FL.flash_attention_bwd_dq(*args),
                       lambda: FL.flash_attention_bwd_dkv(*args)))
        # dq needs 3 products over the valid (query, key) pairs (S = QK^T,
        # dP = dO V^T, dQ = dS K), dk/dv 4 (S, dP, dV = P^T dO, dK = dS^T Q)
        pairs = h * int(attn_mask(seg, seg, pos, pos, False, None).sum())
        ins = nbytes(q, k, v, do, lse, delta, seg, pos)
        k5_bounds["dq"] = least_time(ins + nbytes(q), 3 * 2 * d * pairs, "bf16")
        k5_bounds["dkv"] = least_time(ins + nbytes(k, v), 4 * 2 * d * pairs, "bf16")
        # K2's forward at this shape: S = QK^T and O = PV over the same pairs
        k5_bounds["fwd"] = least_time(2 * nbytes(q) + nbytes(k, v, seg, pos), 2 * 2 * d * pairs,
                                      "bf16")
        k5_ops = {"fwd": 4 * d * pairs, "dq": 6 * d * pairs, "dkv": 8 * d * pairs}
        # the library yardstick: scaled_dot_product_attention's backward with
        # the ALiBi + padding bias added to the scores (key column 0 exempt)
        slopes = FL.alibi_slopes_pow2(h).to(dev)[None, :, None, None]
        dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
        alibi = -slopes * dist * (pos[:, None, None, :] != 0)
        valid = attn_mask(seg, seg, pos, pos, False, None)[:, None]
        bias = torch.where(valid, alibi, torch.finfo(dtype).min).to(dtype)
        del dist, alibi, valid
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
        dot = do.transpose(1, 2)
        library = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
        with torch.no_grad():  # K2's yardstick at this shape: the forward alone
            library_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias))
        del qt, kt, vt, ot, bias
        # (c) the kernels run with ALiBi off (forward and backward) must miss
        # the bound that the ALiBi gradient meets
        o2, lse2 = FL.flash_attention(q, k, v, seg, seg, pos, pos, False, None, alibi=False,
                                      return_lse=True)
        wrong = FL.flash_attention_bwd(q, k, v, o2, lse2, do, seg, seg, pos, pos, False, None,
                                       None, False)
        for name, gg, ww in zip(("dq", "dk", "dv"), wrong, want):
            err, bound = max_err(gg, ww), bf16_bound(ww)
            log(f"  K5 [(c) ALiBi off against ALiBi on, {name}] max_abs_err={err:.3e}, must "
                f"exceed {bound:.3e} by a wide factor: {err / bound:.1f}x")
            if err <= 4 * bound:
                raise AssertionError(f"the K5 bound cannot tell ALiBi off from on ({name})")
        del q, k, v, do, o, o2, lse, lse2, want, wrong
    # (b) an LM training shape: GQA 32/8, d 128, T 2048, causal, window 4096,
    # three packed segments, bf16
    t_lm = 2048
    bounds = torch.tensor([700, 1500], device=dev)
    ar = torch.arange(t_lm, device=dev)
    seg_lm = torch.bucketize(ar, bounds, right=True)
    pos_lm = (ar - torch.cat([torch.zeros(1, device=dev, dtype=torch.long), bounds])[seg_lm])
    seg_lm, pos_lm = seg_lm[None].expand(2, t_lm), pos_lm[None].expand(2, t_lm)
    q, do = randn(2, t_lm, 32, 128, dtype=torch.bfloat16), randn(2, t_lm, 32, 128,
                                                                 dtype=torch.bfloat16)
    k, v = randn(2, t_lm, 8, 128, dtype=torch.bfloat16), randn(2, t_lm, 8, 128,
                                                               dtype=torch.bfloat16)
    bwd_case("(b) LM bf16 GQA 32/8 d=128 T=2048 causal window 4096 3 segments", q, k, v, do,
             seg_lm, pos_lm, True, 4096, False, torch.bfloat16)
    km_dq, km_dkv, pm, fk, fp = timing["a"]
    log(f"  K5 time (a) bf16: dq kernel {km_dq:.4f} ms, dkv kernel {km_dkv:.4f} ms, plain "
        f"backward (dq, dk, dv together) {pm:.4f} ms; K2 forward at the same shape: kernel "
        f"{fk:.4f} ms, plain {fp:.4f} ms")
    log(f"  K5 (a) bounds: dq {k5_bounds['dq']['bound_ms']:.4f} ms, dkv "
        f"{k5_bounds['dkv']['bound_ms']:.4f} ms (K2 forward at this shape "
        f"{k5_bounds['fwd']['bound_ms']:.4f} ms); scaled_dot_product_attention's backward with "
        f"the ALiBi + padding bias (dq, dk, dv together) {library:.4f} ms, its forward "
        f"{library_fwd:.4f} ms")
    log("  K5 (a) achieved on the tensor-core route: "
        + ", ".join(f"{n} {k5_ops[n] / ms / 1e9:.1f} TFLOP/s"
                    for n, ms in (("fwd", fk), ("dq", km_dq), ("dkv", km_dkv)))
        + f"; dq + dkv {km_dq + km_dkv:.4f} ms against the library backward's {library:.4f} ms")
    log("  K5 (a) replayed from a CUDA graph (device time alone, 10 calls to a replay): "
        + ", ".join(f"{n} {ms:.4f} ms ({k5_ops[n] / ms / 1e9:.1f} TFLOP/s)"
                    for n, ms in zip(("fwd", "dq", "dkv"), timing["graph"])))
    results["flash_attention_bwd_dq"] = {"max_abs_err": max(errs["dq"]), "ms": km_dq,
                                         "plain_ms": pm, **k5_bounds["dq"], "library_ms": library}
    results["flash_attention_bwd_dkv"] = {"max_abs_err": max(errs["dkv"]), "ms": km_dkv,
                                          "plain_ms": pm, **k5_bounds["dkv"], "library_ms": library}
    # K5's f32 route at its cases (the small train step's shape on the
    # kernels line): its errors join (a)'s f32 ones
    k5_errs, k5_times = _k5_f32_case(dev, randn)
    for key, err in (("flash_attention_bwd_dq_f32", max(errs["dq32"])),
                     ("flash_attention_bwd_dkv_f32", max(errs["dkv32"]))):
        results[key] = {**k5_times["small train step"][key],
                        "max_abs_err": max(err, k5_errs[key])}
    # K2 at the training shapes, by route
    results["flash_attention_train_err"] = (max(errs["fwd"]), max(errs["fwd32"]))
    del q, k, v, do

    # K4: the estimator's residual + mask + LN at [8, 1379, 1024], ragged rows
    # (int32 lengths, as the estimator passes them), forward and backward
    log("K4 add_mask_ln vs add_mask_ln_reference (bf16 bound 2^-6 * max|want|: two roundings "
        "before the output, a flip of the first can carry; f32 bound 1e-5); its backward "
        "add_mask_ln_bwd vs add_mask_ln_backward_reference (dx = dr: bf16 2^-6 * max|want|, "
        "f32 1e-5; dw, db: bf16 2^-6 * max|want|, f32 1e-6 * the largest column sum of the "
        "terms' magnitudes, f32 sums in another order)")
    errs, bwd_errs, timing = [], [], None
    ln_lens = lens.to(torch.int32)  # valid rows incl. the time token
    for dtype in (torch.bfloat16, torch.float32):
        x, r, go = (randn(8, t1, 1024, dtype=dtype) for _ in range(3))
        w = (randn(1024) * 0.1 + 1.0).to(dtype)
        bb = (randn(1024) * 0.1).to(dtype)
        for post in (False, True):
            got = LN.add_mask_ln(x, r, ln_lens, w, bb, post)
            want = LN.add_mask_ln_reference(x, r, ln_lens, w, bb, post)
            bound = 2.0**-6 * want.float().abs().max().item() if dtype == torch.bfloat16 else 1e-5
            errs.append(check("K4", f"[8, 1379, 1024] {str(dtype)[6:]} post_mask={post}", got,
                              want, bound))
            got = LN.add_mask_ln_bwd(x, r, ln_lens, w, go, post)
            want = LN.add_mask_ln_backward_reference(x, r, ln_lens, w, go, post)
            for name, gg, ww, bound in zip(("dx", "dr", "dw", "db"), got, want,
                                           _ln_bwd_bounds(x, r, ln_lens, go, post, want)):
                bwd_errs.append(check("K4 backward", f"[8, 1379, 1024] {str(dtype)[6:]} "
                                      f"post_mask={post} {name}", gg, ww, bound))
        leaves = [a.detach().requires_grad_() for a in (x, r, w, bb)]
        out = LN.add_mask_ln_reference(leaves[0], leaves[1], ln_lens, leaves[2], leaves[3], True)
        tag = str(dtype)[6:]
        timing_d = {
            "fwd": cuda_ms(lambda: LN.add_mask_ln(x, r, ln_lens, w, bb, True)),
            "fwd_graph": graph_ms(lambda: [LN.add_mask_ln(x, r, ln_lens, w, bb, True)
                                           for _ in range(10)], dev) / 10,
            "fwd_plain": cuda_ms(lambda: LN.add_mask_ln_reference(x, r, ln_lens, w, bb, True)),
            "bwd": cuda_ms(lambda: LN.add_mask_ln_bwd(x, r, ln_lens, w, go, True)),
            "bwd_graph": graph_ms(lambda: [LN.add_mask_ln_bwd(x, r, ln_lens, w, go, True)
                                           for _ in range(10)], dev) / 10,
            "bwd_plain": cuda_ms(lambda: LN.add_mask_ln_backward_reference(x, r, ln_lens, w, go,
                                                                           True)),
            # the backward before this kernel: autograd through the plain forward
            "bwd_autograd": cuda_ms(lambda: torch.autograd.grad(out, leaves, go,
                                                                retain_graph=True))}
        log(f"  K4 time [8, 1379, 1024] {tag} post_mask: forward kernel {timing_d['fwd']:.4f} ms "
            f"eager, {timing_d['fwd_graph']:.4f} ms from a CUDA graph, plain "
            f"{timing_d['fwd_plain']:.4f} ms; backward kernel {timing_d['bwd']:.4f} ms eager, "
            f"{timing_d['bwd_graph']:.4f} ms from a CUDA graph, plain "
            f"{timing_d['bwd_plain']:.4f} ms, autograd through the plain forward "
            f"{timing_d['bwd_autograd']:.4f} ms")
        if dtype == torch.bfloat16:
            timing = timing_d
            # forward: x, r in, out; ~8 operations per element (add, mask,
            # mean, variance, normalize, scale, shift, mask)
            k4_bound = least_time(3 * nbytes(x) + nbytes(w, bb, ln_lens), 8 * x.numel(), "bf16")
            # backward: x, r, g in, dx out (dr is dx), dw and db out; ~20
            # operations per element (the forward's again, dn, the sums, dx)
            k4b_bound = least_time(4 * nbytes(x) + 3 * nbytes(w) + nbytes(ln_lens),
                                   20 * x.numel(), "bf16")
        del leaves, out
    log(f"  K4 bounds bf16: forward {k4_bound['bound_ms']:.4f} ms, backward "
        f"{k4b_bound['bound_ms']:.4f} ms ({k4b_bound['bound_by']})")
    results["add_mask_ln"] = {"max_abs_err": max(errs), "ms": timing["fwd"],
                              "plain_ms": timing["fwd_plain"], **k4_bound, "library_ms": None,
                              "graph_ms": timing["fwd_graph"]}
    results["add_mask_ln_bwd"] = {"max_abs_err": max(bwd_errs), "ms": timing["bwd"],
                                  "plain_ms": timing["bwd_plain"], **k4b_bound,
                                  "library_ms": None, "graph_ms": timing["bwd_graph"],
                                  "autograd_ms": timing["bwd_autograd"]}
    return results


def _ln_bwd_bounds(x, r, lengths, go, post_mask, want) -> list:
    """K4 backward's bounds against its plain version: dx, dr 2^-6 * max|want|
    in bf16 (both round dn and ds; a flip of dn can carry), 1e-5 in f32; dw,
    db f32: 1e-6 of the largest column sum of the terms' magnitudes (f32
    sums over rows in another order; the error grows with the terms, not
    with the sum, which cancels); bf16: two bf16 ulps of the largest (the
    one final rounding, single terms moved by a flip)."""
    import torch

    bf16 = x.dtype == torch.bfloat16
    m = (torch.arange(x.shape[1], device=x.device)[None] < lengths[:, None]).to(x.dtype)[..., None]
    xf = ((x + r) * m).float()
    d = xf - xf.mean(-1, keepdim=True)
    n = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + 1e-5)
    gy = (go * m if post_mask else go).float()
    mags = ((gy * n).abs().sum((0, 1)).max().item(), gy.abs().sum((0, 1)).max().item())
    dx_bound = 2.0**-6 * want[0].float().abs().max().item() if bf16 else 1e-5
    return [dx_bound, dx_bound] + [2.0**-6 * ww.float().abs().max().item() if bf16
                                   else 1e-6 * mag for ww, mag in zip(want[2:], mags)]


def int8_kernel_checks(dev) -> dict:
    """K6 and K1's int8 branch against their plain versions at the int8
    paths' shapes, with CUDA-event times."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import quant_kv_token
    from usdm_tpu_torch.models import quant as Q
    from usdm_tpu_torch.ops import paged_attention as PA
    from usdm_tpu_torch.ops import stream_matvec as SM

    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}

    # K6 at the 7B decode projections (Dout, Din), M 1 / 5 / 8 / 16 (M 5:
    # a speculative verify at B 1, K 4)
    log("K6 stream_qmv vs stream_qmv_reference (f32 out: bit for bit, i.e. exact int32 "
        "accumulators and the same epilogue; bf16 in and out: one bf16 ulp of each value)")
    errs = []
    for dout, din in ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)):
        w = Q.quantize_weight(torch.randn(din, dout, generator=gen, device=dev) * 0.02)
        for m in (1, 5, 8, 16):
            y = torch.randn(m, din, generator=gen, device=dev) * 2.0
            got, want = SM.stream_qmv(y, w, torch.float32), SM.stream_qmv_reference(
                y, w, torch.float32)
            errs.append(check("K6", f"M={m} [{dout}, {din}] f32", got, want, 0.0))
            yb = y.bfloat16()
            got, want = (fn(yb, w, torch.bfloat16).float()
                         for fn in (SM.stream_qmv, SM.stream_qmv_reference))
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
            worst = ((got - want).abs() / ulp).max().item()
            log(f"  K6 [M={m} [{dout}, {din}] bf16] max error {worst:.2f} bf16 ulps "
                f"{'ok' if worst <= 1 else 'FAIL'}")
            if worst > 1:
                raise AssertionError(f"K6 bf16 M={m} [{dout}, {din}] off by {worst} ulps")
            errs.append(max_err(got, want))
    # timed as a decode step streams them: 8 different weights of a shape in
    # turn (118-470 MB), so none is found in the 50 MB L2; bf16 rows as the
    # paths give them (M 1: the W8A8 turn; M 5: its speculative verify; M 8:
    # the server's batch; M 16: the most K6 takes).  Eager (the host's dispatch included) and replayed
    # from a CUDA graph (the device alone); at M 1 the A/B of the routes from
    # a graph, the tensor cores forced through the test hook beside the
    # planned __dp4a route; the library: torch._int_mm over the rows padded
    # to 17 with qmm's quantize and epilogue around it.
    from usdm_tpu_torch.scripts.common import int_mm

    def library(yy, w):
        qy, ys = SM.quantize_rows(yy)
        return SM.epilogue(int_mm(qy, w["q"].t()), ys, w["s"], yy.dtype)

    k6 = {}
    for dout, din in ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096)):
        ws = [Q.quantize_weight(torch.randn(din, dout, generator=gen, device=dev) * 0.02)
              for _ in range(8)]
        for m in (1, 5, 8, 16):
            y = torch.randn(m, din, generator=gen, device=dev).bfloat16()
            t = {name: fn() / len(ws) for name, fn in {
                "ms": lambda: cuda_ms(lambda: [SM.stream_qmv(y, w) for w in ws]),
                "graph_ms": lambda: graph_ms(lambda: [SM.stream_qmv(y, w) for w in ws], dev),
                **({"tc_graph_ms": lambda: graph_ms(
                    lambda: [SM._stream_qmv_route(y, w, torch.bfloat16, 1) for w in ws], dev)}
                   if m <= 2 else {}),
                "library_ms": lambda: cuda_ms(lambda: [library(y, w) for w in ws]),
                "library_graph_ms": lambda: graph_ms(lambda: [library(y, w) for w in ws], dev),
            }.items()}
            t.update(least_time(nbytes(y, ws[0]["q"], ws[0]["s"]) + m * dout * 2,
                                2 * m * dout * din, "int8"))
            k6[(dout, din, m)] = t
            log(f"  K6 time M={m} [{dout}, {din}] bf16, 8 weights in turn: eager {t['ms']:.4f} "
                f"ms, graph {t['graph_ms']:.4f} ms ({t['bound_ms'] / t['graph_ms']:.0%} of the "
                f"bound {t['bound_ms']:.4f} ms)"
                + (f"; the tensor-core route forced: graph {t['tc_graph_ms']:.4f} ms"
                   if m <= 2 else "")
                + f"; torch._int_mm route eager {t['library_ms']:.4f} ms, graph "
                f"{t['library_graph_ms']:.4f} ms")
        if (dout, din) == (14336, 4096):
            y = torch.randn(8, din, generator=gen, device=dev).bfloat16()
            pm = cuda_ms(lambda: [SM.stream_qmv_reference(y, w) for w in ws]) / len(ws)
            deq = [Q.dequantize_weight(w) for w in ws]  # what int8 replaces: bf16 [Din, Dout]
            bf16_ms = cuda_ms(lambda: [y @ w for w in deq]) / len(deq)
            del deq
        del ws
    k6_case = k6[(14336, 4096, 8)]
    log(f"  K6 M=8 [14336, 4096]: plain {pm:.4f} ms, the bf16 matmul of the dequantized weight "
        f"it replaces {bf16_ms:.4f} ms")
    results["stream_qmv"] = {"max_abs_err": max(errs), "plain_ms": pm, **k6_case,
                             "bf16_matmul_ms": bf16_ms, "case": "M=8 [14336, 4096] bf16",
                             "cases": {f"M={m} [{o}, {i}]": v for (o, i, m), v in k6.items()}}

    # K1 int8: GQA 32/8, d 128, bf16 queries over int8 pools of 32 layer
    # regions with page-major f32 scales; page 64 (respond's engine) and 256
    # (the server's); scale slots the kernel must not read hold NaN.
    log("K1 int8 paged_decode_attention vs paged_decode_attention_reference (bound: one bf16 "
        "ulp of the largest output + 1e-4 against the plain version on f32 queries, the "
        "kernel's function; against usdm_tpu's semantics, which round the dequantized K/V to "
        "bf16, that plus the rounding's measured effect)")
    hkv, g, d, n_layers = 8, 4, 128, 32
    errs, timing = [], {}
    # (page, B, pages a slot): respond's engine, the 8-client server, and
    # part (C)'s server (batch 16, 3 pages of 256 a sequence)
    for page, b, maxp in ((64, 1, 66), (256, 8, 17), (256, 16, 3)):
        n_pages = b * maxp + 1
        nt = n_layers * n_pages
        pools = []
        for _ in range(2):
            qv, sv = quant_kv_token(torch.randn(hkv, nt, page, d, generator=gen, device=dev))
            pools += [qv, sv.transpose(0, 1).contiguous()]
            del sv
        kq, ks, vq, vs = pools
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev).to(torch.int32)
        table = perm[: b * maxp].reshape(b, maxp).contiguous()
        tables = [(table + li * n_pages).contiguous() for li in range(n_layers)]
        cases = ((1, 4096), (63, 4096), (64, 4096), (700, 4096), (4200, 4096), (4200, 512))
        if maxp == 3:
            cases = ((1, 4096), (63, 4096), (257, 4096), (384, 4096), (512, 4096), (768, 4096),
                     (768, 512))
        auto = PA.split_count(b, hkv, maxp, page, PA._sm_count(0))
        for seq, window in cases:
            lens = torch.full((b,), seq, dtype=torch.int32, device=dev)
            if b == 16:  # part (C)'s slots hold different lengths
                lens = torch.randint(1, seq + 1, (b,), generator=gen, device=dev,
                                     dtype=torch.int32)
                lens[0] = seq
            elif b > 1:
                lens[b // 2] = max(1, seq // 2)
            q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()
            read = torch.zeros(nt, page, dtype=torch.bool, device=dev)
            pos = torch.arange(maxp * page, device=dev)
            for bi in range(b):
                n = int(lens[bi])
                ok = (pos < n) & (n - 1 - pos <= window)
                read[tables[1][bi].long()[pos[ok] // page], pos[ok] % page] = True
            ks_nan, vs_nan = (a.masked_fill(~read[:, None, :], float("nan")) for a in (ks, vs))
            got = PA.paged_decode_attention(q, kq, vq, tables[1], lens, window,
                                            k_scales=ks_nan, v_scales=vs_nan)
            del ks_nan, vs_nan, read
            want = PA.paged_decode_attention_reference(q, kq, vq, tables[1], lens, window,
                                                       k_scales=ks, v_scales=vs)
            fold = PA.paged_decode_attention_reference(q.float(), kq, vq, tables[1], lens,
                                                       window, k_scales=ks, v_scales=vs)
            case = f"page={page} B={b} seq={seq} window={window} n_splits={auto} (the host's)"
            check("K1 int8", f"{case} vs f32-query plain", got, fold, bf16_bound(fold))
            errs.append(check("K1 int8", case, got, want, bf16_bound(fold) + max_err(want, fold)))
            if (page, b, seq) in ((64, 1, 700), (256, 8, 700)):
                def step(fn):
                    return lambda: [fn(q, kq, vq, t, lens, 4096, k_scales=ks, v_scales=vs)
                                    for t in tables]
                kv_rows = int(lens.sum())  # K and V rows of 8 heads: int8 + f32 scale
                timing[page] = (cuda_ms(step(PA.paged_decode_attention)) / n_layers,
                                cuda_ms(step(PA.paged_decode_attention_reference)) / n_layers,
                                least_time(2 * nbytes(q) + nbytes(tables[1], lens)
                                      + 2 * kv_rows * hkv * (d + 4),
                                      4 * g * hkv * kv_rows * d, "bf16"),
                                graph_ms(step(PA.paged_decode_attention), dev) / n_layers,
                                PA.split_count(b, hkv, maxp, page, PA._sm_count(0)))
        del pools, kq, ks, vq, vs
    for page, (km, pm, bd, gm, n_splits) in timing.items():
        log(f"  K1 int8 time page {page} B={1 if page == 64 else 8} seq=700 (per layer, 32 "
            f"layer regions in turn): kernel {km:.4f} ms eager, {gm:.4f} ms from a CUDA graph "
            f"(n_splits {n_splits}), plain {pm:.4f} ms, bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})")
    km, pm, bd, _, _ = timing[256]
    results["paged_decode_attention_int8"] = {"max_abs_err": max(errs), "ms": km,
                                              "plain_ms": pm, **bd, "library_ms": None,
                                              "case": "page 256 B=8 seq=700 (350 in one slot)"}
    return results


# --------------------------------------------------------------- phase 4
def _to(tree, dev):
    import torch

    from usdm_tpu_torch.core.tree import tree_map

    return tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a, tree)


def card_copy(cpu, dev):
    """The CPU pipeline `cpu` with its weights moved to `dev` (the same
    weights: torch draws other numbers on the card for the same seed)."""
    import dataclasses

    return dataclasses.replace(
        cpu, lm_params=_to(cpu.lm_params, dev), xlsr_params=_to(cpu.xlsr_params, dev),
        decoder=dataclasses.replace(cpu.decoder,
                                    voicebox_params=_to(cpu.decoder.voicebox_params, dev),
                                    vocoder_params=_to(cpu.decoder.vocoder_params, dev)),
        device=dev, _server=None, _dense_loops={})


def turn_on_card_check(dev, wav_in: str, cpu, label: str, long_units: int = 0) -> tuple:
    """One turn of the f32 pipeline `cpu` on the CPU (plain PyTorch paths)
    and of its copy on the card (the kernels): identical dialog tokens, K1,
    K2 and K3 launched on the card; then both synthesize the agent's units
    (and, with `long_units`, that many units more: past the estimator's
    flash gate of 128 frames) from one shared initial noise, within 1e-3 of
    the waveform's peak (f32 both sides, TF32 off).  -> (card pipeline, the
    turn's result as a dict, the card's launches in the turn)."""
    import dataclasses

    import torch

    from usdm_tpu_torch.ops.flash_attention import flash_attention
    from usdm_tpu_torch.ops.fused_act import fused_activation1d
    from usdm_tpu_torch.ops.paged_attention import paged_decode_attention

    card = card_copy(cpu, dev)
    counters = (paged_decode_attention, flash_attention, fused_activation1d)
    results = []
    for pipe in (cpu, card):
        reset_counts()
        try:
            res = pipe.respond_with_policy(_paged_policy(pipe, seed=2), wav_in,
                                           n_timesteps=6, seed=2)
        finally:
            pipe.close()
        results.append((dataclasses.asdict(res), {fn.__name__: fn.launches for fn in counters}))
    (want, _), (got, counts) = results
    log(f"{label} turn, card vs CPU: tokens {'equal' if got == want else 'DIFFER'}, "
        f"{len(got['agent_units'])} agent units, launches {counts}")
    if got != want:
        raise AssertionError(f"{label} turn differs on the card: {got} vs {want}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel did not run in the {label} turn: {counts}")
    # the synthesis of those units from one initial noise (torch draws other
    # numbers on the card than on the CPU for the same seed, so z is shared)
    units = got["agent_units"]
    unit_sets = [units]
    if long_units:
        unit_sets.append(units + np.random.default_rng(6).integers(
            0, cpu.decoder.voicebox_cfg.n_tokens, long_units).tolist())
    for us in unit_sets:
        n = len(us) * 441 // 256
        z = torch.randn(1, 80, -(-n // 64) * 64, generator=torch.Generator().manual_seed(3))
        k2 = flash_attention.launches
        want_audio = cpu.decoder.synthesize(us, z=z, n_timesteps=6)
        got_audio = card.decoder.synthesize(us, z=z.to(dev), n_timesteps=6)
        peak = float(np.abs(want_audio).max())
        err = float(np.abs(got_audio - want_audio).max())
        log(f"{label} synthesis of {len(us)} units, card vs CPU: audio max_abs_err={err:.3e}, "
            f"peak {peak:.3e} (bound 1e-3 of the peak), K2 launches "
            f"{flash_attention.launches - k2}")
        if got_audio.shape != want_audio.shape or not peak > 0 or err > 1e-3 * peak:
            raise AssertionError(f"{label} synthesis differs on the card: {err} (peak {peak})")
    if long_units and flash_attention.launches == k2:
        raise AssertionError(f"{label}: the estimator past its flash gate did not launch K2")
    return card, got, counts


def small_turn_check(dev, wav_in: str) -> None:
    """turn_on_card_check on tiny_random's configs widened to the head dims
    the kernels took before they took the tiny ones (32 in the LM, 16 in
    XLS-R, whose 20x tiny extractor puts a 3 s clip past the 2048-frame
    flash gate, and in Voicebox), then the reference and dense checks on
    the same pair of pipelines."""
    from usdm_tpu_torch.core.config import BigVGANConfig, MistralConfig, VoiceboxConfig, XlsrConfig
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
    from usdm_tpu_torch.pipeline import UsdmPipeline

    tok = UsdmTokenizer.build_test(num_units=32)
    cpu = UsdmPipeline.random_init(
        tok, MistralConfig.tiny(vocab_size=tok.vocab_size).replace(head_dim=32),
        XlsrConfig.tiny().replace(num_clusters=32, hidden_size=64, intermediate_size=128),
        VoiceboxConfig.tiny().replace(n_tokens=32, n_feats=80, hidden_size=64,
                                      intermediate_size=128),
        BigVGANConfig.tiny().replace(num_mels=80), "cpu", seed=0, max_new_tokens=16)
    card, want, _ = turn_on_card_check(dev, wav_in, cpu, "small")
    small_reference_and_dense_checks(dev, cpu, card, wav_in, want, want["agent_units"])


def run_module(module: str, *args: str, timeout: float = 300) -> str:
    """python -m `module` `args` in a subprocess from the repo root; raises
    with the tail of its output unless it exits 0 -> its stdout."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=root, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode:
        raise AssertionError(f"python -m {module} exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def serve_demo_post(wav_in: str, timeout: float = 300) -> dict:
    """python -m usdm_tpu_torch.cli.serve --demo on a free local port in a
    subprocess: /health answers, one POST of `wav_in` returns the turn's
    JSON; the server is stopped in any case -> the reply's JSON."""
    import urllib.request

    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "usdm_tpu_torch.cli.serve", "--demo",
                             "--port", str(port), "--n_timesteps", "4"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"cli.serve --demo exited {proc.returncode}:\n"
                                     f"{proc.stdout.read()[-3000:]}")
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                if time.perf_counter() - t0 > timeout:
                    raise
                time.sleep(0.5)
        req = urllib.request.Request(url + "/respond?seed=1", data=open(wav_in, "rb").read(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def tiny_entry_points_run(dev, tmp: str, wav_in: str) -> dict:
    """Phase 13: the tiny models' head dims on the card, unwidened
    (ROADMAP F5: the LM's 16 reaches K1 and K2's f32 route, XLS-R's and
    Voicebox's 8 K2's f32 route): (a) UsdmPipeline.tiny_random(device="cpu")
    against its copy on the card (turn_on_card_check, with 100 more units
    synthesized so the estimator passes its flash gate); (b) cli.infer
    --demo and (c) cli.serve --demo with one POST, each in a subprocess on
    the card; (d) cli.demo_streamlit's --demo pipeline (tiny_random drawn on
    the card, no config replaced) answers one respond().  -> the launches
    of (a)'s card turn."""
    import argparse

    from usdm_tpu_torch.cli import demo_streamlit
    from usdm_tpu_torch.ops.flash_attention import flash_attention
    from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
    from usdm_tpu_torch.pipeline import UsdmPipeline

    cpu = UsdmPipeline.tiny_random(device="cpu")
    t0 = time.perf_counter()
    _, _, counts = turn_on_card_check(dev, wav_in, cpu, "tiny (head_dim 16 / 8)",
                                      long_units=100)
    counts = {**counts, "flash_attention_f32": flash_attention.tf32_launches}
    out = os.path.join(tmp, "tiny_infer.wav")
    stdout = run_module("usdm_tpu_torch.cli.infer", "--demo", "--input_path", wav_in,
                        "--output_path", out, "--n_timesteps", "4")
    if not os.path.getsize(out):
        raise AssertionError("cli.infer --demo wrote no wav")
    served = serve_demo_post(wav_in)
    if not served.get("audio_b64") or "agent_text" not in served:
        raise AssertionError(f"cli.serve --demo answered {sorted(served)}")
    pipe = demo_streamlit._build_pipeline(argparse.Namespace(demo=True, device="cuda"))
    reset_counts()
    try:
        res = pipe.respond(wav_in, os.path.join(tmp, "tiny_streamlit.wav"), n_timesteps=4)
    finally:
        pipe.close()
    if not paged_decode_attention.launches or not res.agent_units:
        raise AssertionError("the demo pipeline on the card ran no decode link")
    info = {"turn_launches": counts, "infer_stdout": stdout.strip().splitlines()[-2:],
            "serve_units": served["n_units"], "streamlit_units": len(res.agent_units),
            "s": time.perf_counter() - t0}
    log("phase 13 tiny entry points: " + json.dumps(info))
    return info


def small_reference_and_dense_checks(dev, cpu, card, wav_in: str, paged: dict,
                                     units: list) -> None:
    """Phase 4 (e), on the small f32 pipelines: prepare_reference on the card
    against the CPU (the same units, the mel within 1e-4), the synthesis of
    `units` with that reference from one shared z and prompt_noises within
    1e-4 of the waveform's peak; then a dense turn (respond's use_paged=False
    policy) on the CPU and on the card: the same tokens as each other and as
    the paged turn `paged`, every dense decode step on the card one graph
    replay, and K1 never launched."""
    import dataclasses

    import torch

    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.engine.synthesis import prepare_reference
    from usdm_tpu_torch.ops.paged_attention import paged_decode_attention

    ref_path = os.path.join(os.path.dirname(wav_in), "small_ref.wav")
    write_wav(ref_path, (np.random.default_rng(4).standard_normal(3 * 22050) * 0.2)
              .astype(np.float32), 22050)
    mc = cpu.decoder.mel_cfg
    want_u, want_m = prepare_reference(ref_path, cpu.xlsr_params, cpu.xlsr_cfg, mc, "cpu")
    got_u, got_m = prepare_reference(ref_path, card.xlsr_params, card.xlsr_cfg, mc, dev)
    mel_err = max_err(got_m.cpu(), want_m)
    log(f"small prepare_reference, card vs CPU: {len(want_u)} units "
        f"{'equal' if np.array_equal(got_u, want_u) else 'DIFFER'}, mel max_abs_err "
        f"{mel_err:.3e} (bound 1e-4)")
    if not np.array_equal(got_u, want_u) or mel_err > 1e-4:
        raise AssertionError("prepare_reference differs on the card")
    frames = -(-(len(want_u) + len(units) * 441 // 256) // 64) * 64
    g = torch.Generator().manual_seed(5)
    z = torch.randn(1, 80, frames, generator=g)
    pn = torch.randn(3, 2, 1, 80, frames, generator=g)  # 6 timesteps: 3 Heun steps
    want_audio = cpu.decoder.synthesize(units, reference=(want_u, want_m), z=z,
                                        prompt_noises=pn, n_timesteps=6)
    got_audio = card.decoder.synthesize(units, reference=(want_u, want_m.to(dev)),
                                        z=z.to(dev), prompt_noises=pn.to(dev), n_timesteps=6)
    peak = float(np.abs(want_audio).max())
    err = float(np.abs(got_audio - want_audio).max())
    log(f"small reference synthesis, card vs CPU: {len(want_u)} reference frames, audio "
        f"max_abs_err={err:.3e}, peak {peak:.3e} (bound 1e-4 of the peak)")
    if got_audio.shape != want_audio.shape or not peak > 0 or err > 1e-4 * peak:
        raise AssertionError(f"small reference synthesis differs on the card: {err}")
    results = []
    for pipe in (cpu, card):
        paged_decode_attention.launches = 0
        try:
            res = pipe.respond_with_policy(pipe.dense_policy(seed=2), wav_in, n_timesteps=6,
                                           seed=2)
            loops = list(pipe._dense_loops.values())
            steps = sum(lp.steps for lp in loops)
            replays = sum(lp.replays for lp in loops)
        finally:
            pipe.close()
        results.append(dataclasses.asdict(res))
    log(f"small dense turn: card vs CPU tokens {'equal' if results[1] == results[0] else 'DIFFER'},"
        f" vs the paged turn {'equal' if results[1] == paged else 'DIFFER'}; card: {steps} "
        f"dense decode steps, {replays} graph replays, K1 {paged_decode_attention.launches}")
    if results[1] != results[0] or results[1] != paged:
        raise AssertionError(f"the small dense turn differs: {results} vs paged {paged}")
    if steps <= 0 or replays != steps or paged_decode_attention.launches:
        raise AssertionError("the small dense turn's steps were not all graph replays, or K1 ran")


BUDGETS = {"unit2text": 48, "text2text": 32, "text2unit": 256}


def _paged_policy(pipe, seed: int, stages: dict = None):
    """respond()'s paged dialog policy; on the full-width pipeline with the
    stage budgets pinned at 48/32/256 tokens.  With `stages`, it records
    there, per stage, the prompt's ids, the stage mask and the engine's
    speculative rounds and emitted tokens (the dialog server has one
    caller)."""
    from usdm_tpu_torch.engine.server import PagedDialogPolicy
    from usdm_tpu_torch.ops.sampling import stage_allow_mask

    class BudgetedPolicy(PagedDialogPolicy):
        def _run_stage(self, stage, prompt):
            if pipe.max_new_tokens is None:
                self.max_new_tokens = BUDGETS[stage]
            if stages is None:
                return super()._run_stage(stage, prompt)
            eng = self.server.engine
            rounds, emitted = eng.spec_rounds, eng.spec_emitted
            out = super()._run_stage(stage, prompt)
            stages[stage] = {"prompt": self.tok.encode(prompt),
                             "allow": stage_allow_mask(stage, self.ts),
                             "rounds": eng.spec_rounds - rounds,
                             "emitted": eng.spec_emitted - emitted}
            return out

    return BudgetedPolicy(pipe._dialog_server(), pipe.tokenizer,
                          max_new_tokens=pipe.max_new_tokens, seed=seed)


def _link_checks(engine, before: dict, counts: dict, label: str, w8a8: bool,
                 turn: bool = True) -> dict:
    """What the engine did in one run of a path, from its stats before and
    after.  `steps` counts decode links and mixed prefill + decode links:
    every decode link (chained, fused or per-token) must have been one CUDA
    graph replay; each decode link and each (eager) mixed link launches K1
    once per layer; W8A8 decode links launch K6 once per projection (7 a
    layer), mixed links none (their NPF*256 + B rows go to torch._int_mm);
    in a turn, run-ahead must have engaged.  -> the run's decode links,
    mixed links and their chunk rows, replays, run-ahead chains and perf_s
    seconds."""
    st = engine.stats()
    steps = st["steps"] - before["steps"]
    mixed = st["mixed_links"] - before["mixed_links"]
    decode = steps - mixed
    replays = st["graph_replays"] - before["graph_replays"]
    ahead = st["runahead_chains"] - before["runahead_chains"]
    perf = {k: round(v - before["perf_s"].get(k, 0.0), 4) for k, v in st["perf_s"].items()}
    layers = engine.cfg.num_layers
    k1 = counts["paged_decode_attention_int8" if engine.kv.quantized
                else "paged_decode_attention"]
    if decode <= 0 or replays != decode:
        raise AssertionError(f"{label}: {replays} graph replays for {decode} decode links")
    if turn and ahead <= 0:
        raise AssertionError(f"{label}: chain run-ahead never engaged")
    if k1 != layers * steps:
        raise AssertionError(f"{label}: K1 launched {k1} times over {decode} decode links and "
                             f"{mixed} mixed links of {layers} layers")
    if counts["stream_qmv"] != (7 * layers * decode if w8a8 else 0):
        raise AssertionError(f"{label}: K6 launched {counts['stream_qmv']} times over {decode} "
                             f"decode links")
    return {"decode_links": decode, "mixed_links": mixed,
            "mixed_rows": st["mixed_rows"] - before["mixed_rows"], "graph_replays": replays,
            "runahead_chains": ahead, "perf_s": perf}


def _eager_link_turn(pipe, wav_in: str, want: dict, label: str) -> dict:
    """One more turn of `pipe` on a fresh dialog engine of the same config
    with eager decode links (`eager_links=True`): its tokens must equal the
    graphed turn's (`want`: the DialogResult and the user units)."""
    import dataclasses

    import torch

    from usdm_tpu_torch.engine.paged import PagedEngine
    from usdm_tpu_torch.engine.server import EngineServer

    ecfg = pipe._dialog_server().engine.ecfg
    pipe.close()
    pipe._server = EngineServer(PagedEngine(pipe.lm_params, pipe.lm_cfg, ecfg,
                                            device=pipe.device, eager_links=True))
    try:
        trace = {}
        t0 = time.perf_counter()
        res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, n_timesteps=50,
                                       seed=1, trace=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = pipe._server.engine.stats()
    finally:
        pipe.close()
    got = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
    info = {"wall_s": wall, "dialog_s": trace["dialog_s"], "decode_links": st["steps"],
            "graph_replays": st["graph_replays"], "perf_s": st["perf_s"],
            "tokens": "equal" if got == want else "DIFFER"}
    log(f"{label}, eager links: " + json.dumps(info))
    if st["graph_replays"] or got != want:
        raise AssertionError(f"{label}: the eager-link turn differs from the graphed turn: "
                             f"{got} vs {want}")
    return info


# of the peak |wav|: the turn under the old process-wide flag against the graphed turn
TF32_WAV_BOUND = 1e-4


@contextlib.contextmanager
def tf32_convs():
    """ops/conv.py's conv replaced, for the enclosed calls, by the plain
    F.conv1d / conv2d / conv_transpose1d call, which follows cuDNN's TF32
    flag (every call site looks CV.conv up when it runs)."""
    import torch.nn.functional as F

    from usdm_tpu_torch.ops import conv as CV

    def plain(x, w, b=None, stride=1, padding=0, dilation=1, groups=1, transposed=False):
        fn = {(3, False): F.conv1d, (4, False): F.conv2d, (3, True): F.conv_transpose1d,
              (4, True): F.conv_transpose2d}[x.dim(), transposed]
        return fn(x, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups)

    helper, CV.conv = CV.conv, plain
    try:
        yield
    finally:
        CV.conv = helper


def tf32_check(pipe, wav_in: str, want: dict, want_audio) -> dict:
    """Phase 4 (j): the port's f32 convolutions ignore cuDNN's TF32 flag
    (ops/conv.py).  (1) One f32 conv at BigVGAN's stage-0 resblock shape
    against the f64 conv: within 1e-5 of the output's peak through the
    helper, and beyond it with the helper bypassed under PyTorch's default
    flag (the negative control: the flag bites).  (2) The graphed turn ran
    under PyTorch's default flags; the same turn under
    torch.backends.cudnn.allow_tf32 = False (what chip_smoke set for the
    whole process before) gives its user units and stage tokens exactly and
    its wav within 1e-4 of the peak.  (3) What TF32 would have changed,
    with the helper bypassed (tf32_convs) under the default flag: the user
    units of the input wav that differ, and the nRMS of the wav vocoded
    from the graphed turn's agent units (seed 1), against the graphed
    turn's; logged, not gated."""
    import dataclasses

    import torch

    from usdm_tpu_torch.audio.wav import load_wav
    from usdm_tpu_torch.ops import conv as CV

    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("phase 4 (j) needs PyTorch's default cuDNN TF32 flag (True)")
    gen = torch.Generator(device=pipe.device).manual_seed(12)
    x = torch.randn(4, 768, 1792, generator=gen, device=pipe.device)
    w = torch.randn(768, 768, 3, generator=gen, device=pipe.device) * 0.02
    exact = torch.nn.functional.conv1d(x.double(), w.double(), padding=1)
    peak = float(exact.abs().max())
    full = max_err(CV.conv(x, w, padding=1).double(), exact) / peak
    with tf32_convs():
        tf32 = max_err(CV.conv(x, w, padding=1).double(), exact) / peak
    conv_info = {"shape": "x [4, 768, 1792] w [768, 768, 3] f32", "rel_err_helper": full,
                 "rel_err_tf32": tf32}
    log("phase 4 (j) one f32 conv against the f64 conv, error / peak: " + json.dumps(conv_info))
    if not (full <= 1e-5 < tf32):
        raise AssertionError(f"phase 4 (j): the helper's conv is off by {full} of the peak, "
                             f"the TF32 conv by {tf32}")
    del x, w, exact

    torch.backends.cudnn.allow_tf32 = False
    try:
        trace = {}
        res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, n_timesteps=50,
                                       seed=1, trace=trace)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    got = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
    audio = trace["audio"]
    wav_peak = float(np.abs(want_audio).max())
    wav_err = (float(np.abs(audio - want_audio).max()) if audio.shape == want_audio.shape
               else float("inf"))
    same = got == want and wav_err <= TF32_WAV_BOUND * wav_peak

    wav16, _ = load_wav(wav_in, sr=16000)
    with tf32_convs():
        units = pipe.extract_units(wav16)
        audio_tf32 = pipe.decoder.synthesize(want["agent_units"], seed=1)
    base = want["user_units"]
    n = min(len(units), len(base))
    info = {"old_flag_turn": {"tokens_and_units": "equal" if got == want else "DIFFER",
                              "wav_max_abs_err": wav_err, "wav_peak": wav_peak,
                              "bound": TF32_WAV_BOUND * wav_peak},
            "tf32_route": {"user_units": len(units), "graphed_user_units": len(base),
                           "units_differing": int(sum(a != b for a, b in zip(units[:n], base[:n])))
                           + abs(len(units) - len(base)),
                           "wav_nrms": _nrms(audio_tf32, want_audio)
                           if audio_tf32.shape == want_audio.shape else None,
                           "wav_max_abs_err": float(np.abs(audio_tf32 - want_audio).max())
                           if audio_tf32.shape == want_audio.shape else None},
            "conv": conv_info}
    log("phase 4 (j) TF32: " + json.dumps(info))
    if not same:
        raise AssertionError(f"phase 4 (j): the turn under allow_tf32=False differs from the "
                             f"turn under the default flags: {info['old_flag_turn']}")
    return info


def serve_run(pipe, tmp: str, wav_in: str, want: dict, want_wav: str) -> dict:
    """Phase 4 (i): cli.serve's handler over phase 4's full-width pipeline
    and its dialog server (one slot: the engine the turn ran on; a wider
    batch changes the GEMMs' shapes and so the greedy tokens' ties), on a
    local port: three concurrent POSTs of phase 4's wav with seed 1 and 50
    ODE steps (plain JSON, ?stream=1, and multipart with a 3 s speaker
    reference), which queue for the slot, the stage budgets pinned at
    48/32/256 as in phase 4's turns; then /health and /stats.  Every
    request's stage tokens, the plain POST's texts, unit count and wav bytes
    equal phase 4's graphed turn (`want`, written to `want_wav`), the SSE
    result equals the plain JSON, every decode link is one graph replay
    launching K1 once a layer, and K2 (both routes) and K3 (109 a synthesis)
    launched.  -> wall time, the requests' verdicts, the path's launches."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.cli import serve
    from usdm_tpu_torch.engine import server as S

    ref = os.path.join(tmp, "serve_ref.wav")  # 3 s of 16 kHz noise, another draw
    write_wav(ref, (np.random.default_rng(5).standard_normal(48000) * 0.1).astype(np.float32),
              16000)
    wav_bytes = open(wav_in, "rb").read()
    engine = pipe._dialog_server()  # phase 4's engine: one slot, as the turn ran
    recorded, lock = {}, threading.Lock()
    real_stage = S.PagedDialogPolicy._run_stage

    def budgeted(self, stage, prompt):
        self.max_new_tokens = BUDGETS[stage]
        out = real_stage(self, stage, prompt)
        with lock:
            recorded.setdefault(id(self), {})[stage] = list(out)
        return out

    S.PagedDialogPolicy._run_stage = budgeted
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(pipe, engine, 50))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    boundary = "usdmservephase"
    multipart = b"".join(
        (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{n}\"; filename=\"{n}.wav\""
         f"\r\nContent-Type: audio/wav\r\n\r\n").encode() + data + b"\r\n"
        for n, data in (("wav", wav_bytes), ("reference", open(ref, "rb").read()))
    ) + f"--{boundary}--\r\n".encode()
    posts = {"plain": ("?seed=1", wav_bytes, {}),
             "stream": ("?seed=1&stream=1", wav_bytes, {}),
             "reference": ("?seed=1", multipart,
                           {"Content-Type": f"multipart/form-data; boundary={boundary}"})}
    replies, errors = {}, {}

    def post(name):
        qs, data, headers = posts[name]
        req = urllib.request.Request(url + "/respond" + qs, data=data, method="POST",
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                replies[name] = r.read()
        except Exception as e:  # noqa: BLE001 - reported below
            errors[name] = repr(e)

    try:
        before = engine.engine.stats()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(n,)) for n in posts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        mma = mma_counts()["flash_attention"]
        links = _link_checks(engine.engine, before, counts, "serve", False, turn=False)
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            health = r.read()
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        S.PagedDialogPolicy._run_stage = real_stage
        httpd.shutdown()
        httpd.server_close()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"phase 4 (i): requests failed or hung: {errors}")
    plain = json.loads(replies["plain"])
    events = []
    for block in replies["stream"].decode().split("\n\n"):
        lines = dict(x.split(": ", 1) for x in block.splitlines() if ": " in x)
        if "event" in lines:
            events.append((lines["event"], json.loads(lines["data"])))
    with_ref = json.loads(replies["reference"])
    tokens_equal = [toks == want["stage_tokens"] for toks in recorded.values()]
    audio = base64.b64decode(plain["audio_b64"])
    verdicts = {
        "requests_recorded": len(recorded), "stage_tokens_equal": tokens_equal,
        "plain_text_units_equal": (plain["user_text"], plain["agent_text"], plain["n_units"])
        == (want["user_text"], want["agent_text"], len(want["agent_units"])),
        "plain_wav_equal": audio == open(want_wav, "rb").read(),
        "sse_result_equals_plain": bool(events) and events[-1] == ("result", plain),
        "sse_stage_events": sum(k == "stage" for k, _ in events),
        "reference_agent_text_equal": with_ref["agent_text"] == want["agent_text"],
        "reference_wav_bytes": len(base64.b64decode(with_ref["audio_b64"])),
    }
    info = {"wall_s": wall, "verdicts": verdicts, "engine": links, "health": health.decode(),
            "stats_total_finished": stats["total_finished"], "launches": counts,
            "flash_attention_mma_launches": mma}
    log("phase 4 (i) serve: " + json.dumps(info))
    if not (len(recorded) == 3 and all(tokens_equal) and verdicts["plain_text_units_equal"]
            and verdicts["plain_wav_equal"] and verdicts["sse_result_equals_plain"]
            and verdicts["reference_agent_text_equal"] and health == b"ok"):
        raise AssertionError(f"phase 4 (i): the served turns differ from phase 4's: {verdicts}")
    if not (counts["paged_decode_attention"] and mma and counts["flash_attention_f32"]
            and counts["fused_activation1d"] == 3 * K3_PER_TURN):
        raise AssertionError(f"phase 4 (i): a kernel of the serve path did not launch: {counts}")
    return info


def _dense_policy(pipe, seed: int, stages: dict, eager: bool = False):
    """respond(use_paged=False)'s policy over the pipeline's dense loops,
    the stage budgets pinned at 48/32/256 tokens; it records per stage the
    prompt's ids and the stage mask in `stages`."""
    from usdm_tpu_torch.engine.dialog import DialogPolicy
    from usdm_tpu_torch.ops.sampling import stage_allow_mask

    class BudgetedDense(DialogPolicy):
        def _run_stage(self, stage, prompt, max_new=None):
            stages[stage] = {"prompt": self.tok.encode(prompt),
                             "allow": stage_allow_mask(stage, self.ts)}
            return super()._run_stage(stage, prompt, max_new or BUDGETS[stage])

    return BudgetedDense(pipe.lm_params, pipe.lm_cfg, pipe.tokenizer, seed=seed,
                         loops=pipe._dense_loops, eager=eager)


def dense_turns(pipe, wav_in: str, want: dict, plain: dict, label: str, w8a8: bool,
                graphed_turns: int = 2, eager_twin: bool = True) -> dict:
    """Phase 4 (h) / phase 5: full-width respond(use_paged=False) turns of
    `pipe` (budgets 48/32/256), `graphed_turns` of them (the first captures
    the three stages' graphs), then with `eager_twin` the same dialog with
    eager steps.  Every dense decode step must be one graph replay, K1 must
    not launch, K2's bf16 route must (prefill), W8A8 steps launch K6 7 times
    a layer; tokens: the graphed turns equal each other and the eager run,
    and against the paged turn `want` are equal or each divergence a
    tie-flip (counted).  -> dialog_s (beside the paged turn's, `plain`),
    wall ms a decode step (DenseLoop.run's wall over its steps), a step's
    device ms replayed from a graph at the turn's cache, peak memory."""
    import dataclasses

    import torch

    from usdm_tpu_torch.engine import generate as G
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.ops import attention as A

    real_run = G.DenseLoop.run
    run_s = []

    def timed_run(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run(self, *args, **kw)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
        return out

    def loop_totals(eager):
        loops = [lp for (_, _, e), lp in pipe._dense_loops.items() if e == eager]
        return sum(lp.steps for lp in loops), sum(lp.replays for lp in loops)

    turns, first = [], None
    G.DenseLoop.run = timed_run
    try:
        for turn in range(graphed_turns + (1 if eager_twin else 0)):
            eager = turn == graphed_turns
            stages: dict = {}
            steps0, replays0 = loop_totals(eager)
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            run_s.clear()
            trace = {}
            policy = _dense_policy(pipe, 1, stages, eager)
            t0 = time.perf_counter()
            if eager:  # the dialog alone, on the graphed turns' user units
                res = policy.respond_to_units(first["user_units"])
                trace = {"user_units": first["user_units"]}
            else:
                res = pipe.respond_with_policy(policy, wav_in, n_timesteps=50, seed=1,
                                               trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            mma = mma_counts()["flash_attention"]
            steps1, replays1 = loop_totals(eager)
            steps, replays = steps1 - steps0, replays1 - replays0
            got = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
            info = {"run": "eager" if eager else f"graphed {turn}", "wall_s": wall,
                    "dialog_s": wall if eager else trace["dialog_s"],
                    "paged_dialog_s": plain["dialog_s"], "decode_steps": steps,
                    "graph_replays": replays,
                    "decode_ms_per_step": 1e3 * sum(run_s) / max(steps, 1),
                    "stage_tokens": {k: len(v) for k, v in res.stage_tokens.items()},
                    "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": counts, "flash_attention_mma_launches": mma}
            if eager:
                info["tokens_vs_graphed"] = "equal" if got == first else "DIFFER"
                if got != first or replays:
                    raise AssertionError(f"{label}, dense: the eager steps differ from the "
                                         f"graphed turn's")
            else:
                if got["user_units"] != want["user_units"]:
                    raise AssertionError(f"{label}, dense: the user units differ")
                verdicts = _stage_verdicts(pipe, want, got, stages)
                info["divergences"] = sum(v.get("divergences", 0) for v in verdicts.values())
                info["verdicts"] = verdicts
                info["synth_s"] = trace["synth_s"]
                if any(v.get("divergences") and not v["tie_flip"] for v in verdicts.values()):
                    raise AssertionError(f"{label}, dense: a divergence from the paged turn is "
                                         f"not a tie-flip: {verdicts}")
                if first is not None and got != first:
                    raise AssertionError(f"{label}, dense: two graphed turns differ")
                first = first or got
                if steps <= 0 or replays != steps:
                    raise AssertionError(f"{label}, dense: {replays} graph replays for {steps} "
                                         f"decode steps")
                if mma <= 0:
                    raise AssertionError(f"{label}, dense: K2's bf16 route never launched")
            if counts["paged_decode_attention"] or counts["paged_decode_attention_int8"]:
                raise AssertionError(f"{label}, dense: K1 launched")
            if counts["stream_qmv"] != (7 * pipe.lm_cfg.num_layers * steps if w8a8 else 0):
                raise AssertionError(f"{label}, dense: K6 launched {counts['stream_qmv']} times "
                                     f"over {steps} decode steps")
            log(f"{label}, dense (use_paged=False): " + json.dumps(info))
            turns.append(info)
    finally:
        G.DenseLoop.run = real_run
    # a step's device time: decode_step at the turn's 8,192-slot cache,
    # replayed from a graph (it rewrites one slot past the valid prefix)
    loop = next(lp for (_, _, e), lp in pipe._dense_loops.items() if not e)
    cfg, cache = pipe.lm_cfg, loop.cache
    step_ms = graph_ms(lambda: M.decode_step(pipe.lm_params, cfg, loop.last, cache),
                       pipe.device)
    # its attention alone: decode_attention over the 32 layers' whole
    # caches, against reading every slot's K and V once, and the valid ones
    s = cache.k.shape[2]
    pos = cache.length
    slot_pos = pos[:, None] - (pos[:, None] - torch.arange(s, device=pipe.device)) % s
    q = torch.randn(1, 1, cfg.num_heads, cfg.head_dim, device=pipe.device,
                    dtype=cache.k.dtype)
    attn_ms = graph_ms(lambda: [A.decode_attention(q, cache.k[li], cache.v[li], pos + 1,
                                                   cfg.sliding_window, kv_positions=slot_pos)
                                for li in range(cfg.num_layers)], pipe.device)
    valid = int(pos.max()) + 1
    full = least_time(2 * nbytes(cache.k), 0, "bf16")["bound_ms"]
    prefix = least_time(2 * nbytes(cache.k) * valid / s, 0, "bf16")["bound_ms"]
    log(f"{label}, dense: decode_step device time from a graph at S={s}: {step_ms:.4f} ms; its "
        f"attention (decode_attention, {cfg.num_layers} layers) {attn_ms:.4f} ms, against "
        f"{full:.4f} ms to read every slot's K and V once and {prefix:.4f} ms for the {valid} "
        f"valid ones")
    return {"turns": turns, "step_device_ms": step_ms, "attention_device_ms": attn_ms,
            "attention_all_slots_bound_ms": full, "attention_valid_bound_ms": prefix,
            "cache_len": s}


def _recording_generate():
    """Wrap VB.generate (not a kernel wrapper) so a run records each call's
    frame count and mel -> (the list of records, the wrapper, a restore
    function); setting the wrapper's `fused_ln` overrides the estimator's."""
    from usdm_tpu_torch.models import voicebox as VB

    real = VB.generate
    calls = []

    def recording(*args, **kw):
        if getattr(recording, "fused_ln", None):
            kw["fused_ln"] = recording.fused_ln
        mel = real(*args, **kw)
        calls.append({"frames": args[2].shape[1], "mel": mel})
        return mel

    VB.generate = recording

    def restore():
        VB.generate = real

    return calls, recording, restore


def reference_runs(pipe, tmp: str, wav_in: str, want: dict, plain: dict) -> dict:
    """Phase 4 (f) and (g).  (f) a full-width bf16 turn with a 3 s noise
    reference written at 22.05 kHz (budgets 48/32/256): the plain turn's
    dialog tokens (`want`), the estimator at the reference's and answer's
    bucketed frames, K2's f32 route and K3's 109 launches, K4 not (its gate
    B·(T+1) >= 3072 is not met), audio for the agent's units alone; ref_s
    and synth_s beside the plain turn's (`plain`).  (g) one synthesize of
    those agent units with a 16 s reference: K4's forward launches (counted)
    and the mel stays within 1e-3 of its peak of the same call with
    fused_ln off."""
    import dataclasses

    import torch

    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.engine.synthesis import prepare_reference
    from usdm_tpu_torch.ops.fused_ln import add_mask_ln

    mc = pipe.decoder.mel_cfg
    out = {}
    calls, recording, restore = _recording_generate()
    try:
        ref3 = os.path.join(tmp, "ref3.wav")
        write_wav(ref3, (np.random.default_rng(8).standard_normal(3 * 22050) * 0.2)
                  .astype(np.float32), 22050)
        wav_out = os.path.join(tmp, "agent_ref.wav")
        reset_counts()
        trace = {}
        t0 = time.perf_counter()
        res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, wav_out, ref3,
                                       n_timesteps=50, seed=1, trace=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        audio = trace["audio"]
        n_agent = len(res.agent_units) * 441 // 256
        frames = calls[-1]["frames"]
        info = {"wall_s": wall, "dialog_s": trace["dialog_s"], "ref_s": trace["ref_s"],
                "synth_s": trace["synth_s"], "plain_synth_s": plain["synth_s"],
                "plain_dialog_s": plain["dialog_s"], "estimator_t_plus_1": frames + 1,
                "agent_frames": n_agent, "audio_s": len(audio) / mc.sampling_rate,
                "launches": counts}
        log("(f) bf16 turn with a 3 s reference: " + json.dumps(info))
        got = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
        if got != want:
            raise AssertionError("(f) the reference changed the dialog tokens")
        if not frames > n_agent + 64 or counts["flash_attention_f32"] <= 0:
            raise AssertionError(f"(f) the estimator ran at {frames} frames for {n_agent} agent "
                                 f"frames, K2 f32 {counts['flash_attention_f32']} launches")
        if counts["fused_activation1d"] != K3_PER_TURN or counts["add_mask_ln"]:
            raise AssertionError(f"(f) K3 {counts['fused_activation1d']}, K4 "
                                 f"{counts['add_mask_ln']} launches")
        if len(audio) != n_agent * 256 or not np.isfinite(audio).all():
            raise AssertionError(f"(f) audio of {len(audio)} samples for {n_agent} agent frames")
        out["f"] = info

        ref16 = os.path.join(tmp, "ref16.wav")
        write_wav(ref16, (np.random.default_rng(9).standard_normal(16 * 22050) * 0.2)
                  .astype(np.float32), 22050)
        t0 = time.perf_counter()
        reference = prepare_reference(ref16, pipe.xlsr_params, pipe.xlsr_cfg, mc, pipe.device)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        n_ref = len(reference[0])
        frames = -(-(n_ref + n_agent) // 64) * 64
        g = torch.Generator(device=pipe.device).manual_seed(7)
        z = torch.randn(1, mc.num_mels, frames, generator=g, device=pipe.device)
        pn = torch.randn(25, 2, 1, mc.num_mels, frames, generator=g, device=pipe.device)
        runs = []
        for fused in (None, "plain"):
            recording.fused_ln = fused
            reset_counts()
            t0 = time.perf_counter()
            wav = pipe.decoder.synthesize(res.agent_units, reference=reference, z=z,
                                          prompt_noises=pn, n_timesteps=50)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, add_mask_ln.launches, calls[-1]["mel"], wav))
        (s_fused, k4, mel, wav), (s_plain, k4_off, mel_off, wav_off) = runs
        peak = mel_off.abs().max().item()
        err = max_err(mel, mel_off)
        info = {"reference_units": n_ref, "estimator_t_plus_1": frames + 1,
                "b_t1": 2 * (frames + 1), "ref_s": ref_s, "synth_s": s_fused,
                "synth_s_fused_ln_off": s_plain, "k4_launches": k4,
                "k4_launches_fused_ln_off": k4_off, "mel_max_abs_err": err, "mel_peak": peak,
                "audio_max_abs_err": float(np.abs(wav - wav_off).max())}
        log("(g) synthesize with a 16 s reference, fused_ln auto vs off: " + json.dumps(info))
        if k4 <= 0 or k4 % 49 or k4_off:  # 49 estimator calls: 25 Heun steps
            raise AssertionError(f"(g) K4 launched {k4} times (fused_ln off: {k4_off})")
        if err > 1e-3 * peak or not np.isfinite(wav).all():
            raise AssertionError(f"(g) the mel with K4 is {err} from the plain one (peak {peak})")
        out["g"] = info
    finally:
        restore()
    return out


def _device_busy(prof, wall: float) -> dict:
    """Device seconds of a profiled run (the self time of its device events,
    summed as the profiler table's "Self CUDA time total"), their share of
    its wall time, and the host's launches: CUDA-graph replays and single
    kernel launches."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    calls = {e.key: e.count for e in events}
    kernel_launches = sum(n for k, n in calls.items()
                          if k.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return {"device_s": dev_us / 1e6, "device_busy": dev_us / 1e6 / wall,
            "graph_launches": calls.get("cudaGraphLaunch", 0),
            "kernel_launches": kernel_launches}


def profilers_run(pipe, wav_in: str, label: str, respond: bool) -> dict:
    """Phase 15, on phase 4's or 5's full-width pipeline: the port of
    scripts/profile_decode_step.py (its b = 1 link at ctx 1,219 against its
    parts, every part from CUDA-graph replays, 30 a part) and, with
    `respond`, of scripts/profile_respond.py (the pinned-budget turn by
    phase).  Each prints its JSON line."""
    from usdm_tpu_torch.scripts import profile_decode_step, profile_respond

    t0 = time.perf_counter()
    out = {"decode_step": profile_decode_step.run(pipe.lm_params, pipe.lm_cfg, pipe.device)}
    print(json.dumps({"profile_decode_step": out["decode_step"], "pipeline": label}), flush=True)
    if respond:
        out["respond"] = profile_respond.run(pipe, wav_in)
        print(json.dumps({"profile_respond": out["respond"], "pipeline": label}), flush=True)
    log(f"phase time: profilers ({label}) {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------- phase 16
def _measured(label: str, fn, launches: dict):
    """fn() with every launch count set to 0 just before it and read just
    after; its launches are added to `launches` under the kernels line's
    names (flash_attention: K2's bf16 route; flash_attention_f32 its f32
    route) -> fn's result."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    counts = launch_counts()
    counts["flash_attention"] = mma_counts()["flash_attention"]
    log(f"phase 16 {label}: {time.perf_counter() - t0:.1f} s, launches "
        + json.dumps({k: n for k, n in counts.items() if n}))
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n
    return out


def _emit(module: str, line, label: str) -> None:
    print(json.dumps({module: line, "pipeline": label}), flush=True)


def _ablation_checks(line: dict, layers: int) -> None:
    """exp_decode2's line: K6 launches a step by variant (W8A8: 7 products a
    layer, 4 fused; the W8A8 lm_head one more), and (W8A8) the fused
    variants' tokens equal the unfused ones'."""
    from usdm_tpu_torch.scripts.exp_decode2 import VARIANTS

    w8a8 = line["weights"] == "w8a8"
    want = {name: ((4 if kw.get("fuse") else 7) * layers if w8a8 else 0)
            + int(kw.get("head") == "int8") for name, kw in VARIANTS.items()}
    if line["k6_launches"] != want:
        raise AssertionError(f"phase 16 exp_decode2 ({line['weights']}): K6 launches "
                             f"{line['k6_launches']}, want {want}")
    if w8a8 and not line["fused_tokens_equal"]:
        raise AssertionError(f"phase 16 exp_decode2: the fused W8A8 variants' tokens differ "
                             f"from the unfused ones': {line['tokens']}")


def _estimator_check(line: dict, counts_before: dict, launches: dict, route: str) -> None:
    """trace_estimator's line: every group took device time, K2 launched on
    `route` (flash_attention: bf16, flash_attention_f32) once a layer a
    call (24 x 6 calls)."""
    n = launches.get(route, 0) - counts_before.get(route, 0)
    if n != 24 * 6 or not all(line["groups_ms"][g] > 0 for g in
                              ("products", "layer_norm", "attention", "convpos")):
        raise AssertionError(f"phase 16 trace_estimator {line['weights']}: {n} {route} "
                             f"launches (want 144), groups {line['groups_ms']}")


def measure_bf16_run(pipe, out_dir: str) -> dict:
    """Phase 16 (a), on phase 4's bf16 pipeline: exp_decode2's eight
    ablations over its bf16 7B (tokens of the fused variants logged: cuBLAS
    may sum a fused product in another order) and trace_estimator over its
    f32 Voicebox."""
    from usdm_tpu_torch.scripts import exp_decode2, trace_estimator

    t0 = time.perf_counter()
    launches = {}
    ed2 = _measured("exp_decode2 (bf16 7B)", lambda: exp_decode2.run(
        pipe.lm_params, pipe.lm_cfg, pipe.device), launches)
    _emit("exp_decode2", ed2, "phase 4 bf16")
    _ablation_checks(ed2, pipe.lm_cfg.num_layers)
    before = dict(launches)
    te = _measured("trace_estimator (float Voicebox)", lambda: trace_estimator.run(
        pipe.decoder.voicebox_params, pipe.decoder.voicebox_cfg, pipe.device, "float", out_dir),
        launches)
    _emit("trace_estimator", te, "phase 4 bf16")
    _estimator_check(te, before, launches, "flash_attention_f32")
    return {"launches": launches, "exp_decode2": ed2, "trace_estimator": te,
            "seconds": time.perf_counter() - t0}


def measure_w8a8_run(pipe, out_dir: str) -> dict:
    """Phase 16 (b), on phase 5's W8A8 pipeline and on zero weights where
    the TPU scripts use them: exp_decode2, exp_decode and bench_batch_decode
    over a zero W8A8 7B (scales 1e-8), exp_decode2 over the pipeline's W8A8
    7B, bench_runahead's sweep and EOS check over it (its own engines,
    bf16 pools), trace_estimator over zero bf16 weights and over the
    pipeline's W8A8 Voicebox."""
    import gc

    import torch

    from usdm_tpu_torch.core.config import VoiceboxConfig
    from usdm_tpu_torch.scripts import (bench_batch_decode, bench_runahead, exp_decode,
                                        exp_decode2, trace_estimator)
    from usdm_tpu_torch.scripts.profile_decode_step import zero_params

    t0 = time.perf_counter()
    dev, cfg = pipe.device, pipe.lm_cfg
    launches, out = {}, {}
    zero = zero_params(cfg, dev, True)
    out["exp_decode2_zero"] = _measured("exp_decode2 (zero W8A8 7B)", lambda: exp_decode2.run(
        zero, cfg, dev), launches)
    _emit("exp_decode2", out["exp_decode2_zero"], "zero W8A8")
    _ablation_checks(out["exp_decode2_zero"], cfg.num_layers)
    out["exp_decode"] = _measured("exp_decode (zero W8A8 7B)", lambda: exp_decode.run(
        zero, cfg, dev), launches)
    _emit("exp_decode", out["exp_decode"], "zero W8A8")
    out["bench_batch_decode"] = _measured("bench_batch_decode (zero W8A8 7B)",
                                          lambda: bench_batch_decode.run(zero, cfg, dev),
                                          launches)
    del zero
    gc.collect()
    torch.cuda.empty_cache()
    for line in out["bench_batch_decode"]:
        if "failed" in line:
            raise AssertionError(f"phase 16 bench_batch_decode: {line}")
        want = ({"stream_qmv": 7 * cfg.num_layers, "torch_int_mm": 0} if line["b"] <= 16 else
                {"stream_qmv": 0, "torch_int_mm": 7 * cfg.num_layers})
        got = line["launches_per_step"]
        k1 = got["paged_decode_attention"] == (0 if line["kv"] == "int8" else cfg.num_layers)
        if any(got[k] != n for k, n in want.items()) or not k1:
            raise AssertionError(f"phase 16 bench_batch_decode b {line['b']} {line['kv']}: "
                                 f"routes {got}, want {want} and K1 once a layer")
    out["exp_decode2"] = _measured("exp_decode2 (the pipeline's W8A8 7B)", lambda: exp_decode2.run(
        pipe.lm_params, cfg, dev), launches)
    _emit("exp_decode2", out["exp_decode2"], "phase 5 W8A8")
    _ablation_checks(out["exp_decode2"], cfg.num_layers)
    out["bench_runahead"] = _measured("bench_runahead sweep", lambda: bench_runahead.sweep(
        pipe.lm_params, cfg, dev), launches)
    out["bench_runahead_eos"] = _measured("bench_runahead EOS", lambda: bench_runahead.eos_overshoot(
        pipe.lm_params, cfg, dev), launches)
    gc.collect()
    torch.cuda.empty_cache()
    vcfg = VoiceboxConfig()
    before = dict(launches)
    zero_vb = trace_estimator.weights(vcfg, dev, "zero_bf16")
    out["trace_estimator_zero"] = _measured("trace_estimator (zero bf16 Voicebox)",
                                            lambda: trace_estimator.run(
                                                zero_vb, vcfg, dev, "zero_bf16", out_dir),
                                            launches)
    del zero_vb
    _emit("trace_estimator", out["trace_estimator_zero"], "zero bf16")
    _estimator_check(out["trace_estimator_zero"], before, launches, "flash_attention")
    before = dict(launches)
    out["trace_estimator"] = _measured("trace_estimator (W8A8 Voicebox)", lambda: trace_estimator.run(
        pipe.decoder.voicebox_params, pipe.decoder.voicebox_cfg, dev, "w8a8", out_dir), launches)
    _emit("trace_estimator", out["trace_estimator"], "phase 5 W8A8")
    _estimator_check(out["trace_estimator"], before, launches, "flash_attention_f32")
    out["launches"], out["seconds"] = launches, time.perf_counter() - t0
    return out


def _k1_b32_checks(dev, randn) -> tuple:
    """K1 at bench_batch_decode's b 32: page 256, 6 pages a slot, 1,220
    tokens a slot (one slot 700), bf16 and int8 pools, window 4096, against
    its plain version (phase 3's bounds), with times and bounds -> (the
    bf16 and the int8 errors, the times)."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import quant_kv_token
    from usdm_tpu_torch.ops import paged_attention as PA

    b, hkv, g, d, page, maxp = 32, 8, 4, 128, 256, 6
    nt = b * maxp + 1
    gen = torch.Generator(device=dev).manual_seed(17)
    table = torch.randperm(nt - 1, generator=gen, device=dev)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32).contiguous()
    lens = torch.full((b,), 1220, dtype=torch.int32, device=dev)
    lens[5] = 700
    q = randn(b, hkv, g, d).bfloat16()
    rows = int(lens.sum())
    errs, times = {}, {}
    for kind in ("bf16", "int8"):
        scales = {}
        if kind == "int8":
            pools = []
            for key in ("k_scales", "v_scales"):
                qv, sv = quant_kv_token(randn(hkv, nt, page, d))
                pools.append(qv)
                scales[key] = sv.transpose(0, 1).contiguous()
        else:
            pools = [randn(hkv, nt, page, d).bfloat16() for _ in range(2)]
        args = (q, *pools, table, lens, 4096)
        got = PA.paged_decode_attention(*args, **scales)
        want = PA.paged_decode_attention_reference(*args, **scales)
        case = f"B=32 page 256, 6 pages a slot, 1,220 tokens, {kind} pools"
        if kind == "bf16":
            errs[kind] = check("K1", case, got, want, bf16_bound(want))
        else:
            fold = PA.paged_decode_attention_reference(q.float(), *pools, table, lens, 4096,
                                                       **scales)
            errs[kind] = check("K1 int8", case, got, want, bf16_bound(fold) + max_err(want, fold))
        row = hkv * d * pools[0].element_size() + (4 * hkv if scales else 0)
        times[kind] = {"ms": cuda_ms(lambda: PA.paged_decode_attention(*args, **scales)),
                       "graph_ms": graph_ms(lambda: PA.paged_decode_attention(*args, **scales),
                                            dev),
                       "plain_ms": cuda_ms(lambda: PA.paged_decode_attention_reference(
                           *args, **scales)),
                       **least_time(2 * nbytes(q) + nbytes(table, lens) + 2 * row * rows,
                                    4 * g * hkv * d * rows, "bf16"),
                       "n_splits": PA.split_count(b, hkv, maxp, page, PA._sm_count(0))}
        log(f"  K1 [{case}] times: " + json.dumps(times[kind]))
        del pools
    return errs, times


def _k6_width_checks(dev) -> tuple:
    """K6 at M 1 at the fused and int8-head widths (Dout 6144, 28672, 42003;
    Din 4096) against its plain version: f32 bit for bit, bf16 within one
    ulp of each value; times over 8 weights in turn (none stays in the L2)
    from a CUDA graph, beside the torch._int_mm route's (Dout % 8 == 0) and
    the bf16 matvec's of the dequantized weights -> (the largest error,
    the times)."""
    import torch

    from usdm_tpu_torch.models import quant as Q
    from usdm_tpu_torch.ops import stream_matvec as SM
    from usdm_tpu_torch.scripts.common import int_mm

    gen = torch.Generator(device=dev).manual_seed(18)
    errs, times = [], {}

    def library(yy, w):
        qy, ys = SM.quantize_rows(yy)
        return SM.epilogue(int_mm(qy, w["q"].t()), ys, w["s"], yy.dtype)

    for dout in (6144, 28672, 42003):
        ws = [Q.quantize_weight(torch.randn(4096, dout, generator=gen, device=dev) * 0.02)
              for _ in range(8)]
        y = torch.randn(1, 4096, generator=gen, device=dev) * 2.0
        got, want = SM.stream_qmv(y, ws[0], torch.float32), SM.stream_qmv_reference(
            y, ws[0], torch.float32)
        errs.append(check("K6", f"M=1 [{dout}, 4096] f32", got, want, 0.0))
        yb = y.bfloat16()
        got, want = (fn(yb, ws[0], torch.bfloat16).float()
                     for fn in (SM.stream_qmv, SM.stream_qmv_reference))
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        worst = ((got - want).abs() / ulp).max().item()
        log(f"  K6 [M=1 [{dout}, 4096] bf16] max error {worst:.2f} bf16 ulps "
            f"{'ok' if worst <= 1 else 'FAIL'}")
        if worst > 1:
            raise AssertionError(f"K6 bf16 M=1 [{dout}, 4096] off by {worst} ulps")
        errs.append(max_err(got, want))
        t = {"ms": cuda_ms(lambda: [SM.stream_qmv(yb, w) for w in ws]) / 8,
             "graph_ms": graph_ms(lambda: [SM.stream_qmv(yb, w) for w in ws], dev) / 8,
             "plain_ms": cuda_ms(lambda: [SM.stream_qmv_reference(yb, w) for w in ws]) / 8,
             # torch._int_mm takes Dout in multiples of 8 only (not the head's 42,003)
             "library_graph_ms": (graph_ms(lambda: [library(yb, w) for w in ws], dev) / 8
                                  if dout % 8 == 0 else None),
             **least_time(nbytes(yb, ws[0]["q"], ws[0]["s"]) + dout * 2, 2 * dout * 4096,
                          "int8")}
        deq = [Q.dequantize_weight(w).t().contiguous() for w in ws]  # bf16 [Dout, Din]
        # what the W8A8 product replaces: the bf16 matvec of the dequantized weight
        t["bf16_graph_ms"] = graph_ms(lambda: [torch.nn.functional.linear(yb, w) for w in deq],
                                      dev) / 8
        del deq
        times[dout] = t
        log(f"  K6 time M=1 [{dout}, 4096] bf16, 8 weights in turn: " + json.dumps(t))
        del ws
    return max(errs), times


def _flash_gqa82_checks(dev, randn) -> tuple:
    """K2 and K5 bf16 at validate_memory_budget's attention (B 1, T 8,192,
    GQA 8/2, d 128, causal, window 4096, one segment) against their plain
    versions with round_operands=True (bf16_bound; lse 1e-4), with times
    and bounds -> ({fwd, dq, dkv} errors, the times)."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    t, h, hkv, d, window = 8192, 8, 2, 128, 4096
    seg = torch.zeros(1, t, dtype=torch.int32, device=dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None]
    q, do = randn(1, t, h, d).bfloat16(), randn(1, t, h, d).bfloat16()
    k, v = randn(1, t, hkv, d).bfloat16(), randn(1, t, hkv, d).bfloat16()
    case = "B=1 T=8192 GQA 8/2 d=128 causal window 4096"
    o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, True, window, return_lse=True)
    want_o, want_lse = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, True, window,
                                                    None, False, True)
    errs = {"fwd": check("K2", f"{case} o", o, want_o, bf16_bound(want_o))}
    check("K2 lse", case, lse, want_lse, 1e-4)
    del want_o, want_lse
    ref = (q, k, v, o, lse, do, seg, seg, pos, pos, True, window, None, False)
    got, want = FL.flash_attention_bwd(*ref), FL.flash_attention_bwd_reference(*ref, True)
    out = [check("K5", f"{case} {n}", gg, ww, bf16_bound(ww))
           for n, gg, ww in zip(("dq", "dk", "dv"), got, want)]
    errs["dq"], errs["dkv"] = out[0], max(out[1:])
    del got, want
    pairs = h * int(attn_mask(seg, seg, pos, pos, True, window).sum())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, seg, seg, pos, pos, True, window, None, False)
    ins = nbytes(q, k, v, do, lse, delta, seg, pos)
    times = {
        "fwd": {"ms": cuda_ms(lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos, True,
                                                         window)),
                **least_time(2 * nbytes(q) + nbytes(k, v, seg, pos), 4 * d * pairs, "bf16")},
        "dq": {"ms": cuda_ms(lambda: FL.flash_attention_bwd_dq(*args)),
               **least_time(ins + nbytes(q), 6 * d * pairs, "bf16")},
        "dkv": {"ms": cuda_ms(lambda: FL.flash_attention_bwd_dkv(*args)),
                **least_time(ins + nbytes(k, v), 8 * d * pairs, "bf16")}}
    log(f"  K2 / K5 [{case}] times: " + json.dumps(times))
    return errs, times


def _flash_estimator_bf16_check(dev, randn) -> tuple:
    """K2 bf16 with ALiBi at the zero-weight estimator's attention (B 2,
    T+1 450, 16 heads of d 64, non-causal, every row valid) against its
    plain version (bf16_bound), with times, the bound and SDPA with the
    additive ALiBi bias -> (the error, the times)."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    b, t1, h, d = 2, 450, 16, 64
    seg = torch.zeros(b, t1, dtype=torch.int32, device=dev)
    pos = torch.arange(t1, dtype=torch.int32, device=dev)[None].expand(b, t1).contiguous()
    q, k, v = (randn(b, t1, h, d).bfloat16() for _ in range(3))
    case = "B=2 T+1=450 H=16 d=64 ALiBi (the bf16 estimator)"
    flags = dict(causal=False, sliding_window=None, alibi=True)
    got = FL.flash_attention(q, k, v, seg, seg, pos, pos, **flags)
    want, _ = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, **flags,
                                           round_operands=True)
    err = check("K2", case, got, want, bf16_bound(want))
    slopes = FL.alibi_slopes_pow2(h).to(dev)[None, :, None, None]
    dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
    bias = (-slopes * dist * (pos[:, None, None, :] != 0)).to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = b * h * t1 * t1
    times = {"ms": cuda_ms(lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos, **flags)),
             "graph_ms": graph_ms(lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos,
                                                             **flags), dev),
             "plain_ms": cuda_ms(lambda: FL.flash_attention_reference(
                 q, k, v, seg, seg, pos, pos, **flags, round_operands=True)),
             **least_time(2 * nbytes(q) + nbytes(k, v, seg, pos), 4 * d * pairs, "bf16"),
             "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=bias))}
    log(f"  K2 [{case}] times: " + json.dumps(times))
    return err, times


K5_F32_CASES = {  # name: (B, T+1, heads, d, valid rows of each batch row); ALiBi, non-causal
    "small train step": (8, 400, 4, 32, (400, 301, 400, 251, 400, 400, 121, 400)),
    "full-width CFM": (8, 1380, 16, 64, (1380, 900, 1380, 1200, 640, 1380, 1000, 1301)),
    "d 8": (2, 174, 4, 8, (174, 116)),
}


def k5_f32_inputs(dev, randn, name: str) -> tuple:
    """K5_F32_CASES[name]: (q, k, v, do, seg, pos), rows int32 and
    contiguous, as the estimator makes them."""
    import torch

    b, t1, h, d, lens = K5_F32_CASES[name]
    pos = torch.arange(t1, device=dev, dtype=torch.int32)[None].expand(b, t1).contiguous()
    seg = torch.where(pos < torch.tensor(lens, device=dev)[:, None], 0, -1).to(torch.int32)
    q, k, v, do = (randn(b, t1, h, d) for _ in range(4))
    return q, k, v, do, seg, pos


def _k5_f32_case(dev, randn) -> tuple:
    """K5's f32 route (3xTF32 on the tensor cores,
    csrc/flash_attention_bwd_dq_tf32.cu and _dkv_tf32.cu) at K5_F32_CASES: the small f32 train step's attention (the shape on the
    kernels line), the full-width f32 CFM step's and the tiny models' d 8,
    each on K2's f32 forward against its plain version (1e-4), with eager and
    CUDA-graph times of dq, dk/dv and the whole backward, the plain
    backward's, the bound (3xTF32 operations) and SDPA's backward with the
    ALiBi + padding bias -> ({kernel: error}, {case: times})."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    errs = {"flash_attention_bwd_dq_f32": 0.0, "flash_attention_bwd_dkv_f32": 0.0}
    times = {}
    for name in K5_F32_CASES:
        q, k, v, do, seg, pos = k5_f32_inputs(dev, randn, name)
        b, t1, h, d = q.shape
        o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, False, None, alibi=True,
                                    return_lse=True)
        ref = (q, k, v, o, lse, do, seg, seg, pos, pos, False, None, None, True)
        got, want = FL.flash_attention_bwd(*ref), FL.flash_attention_bwd_reference(*ref)
        case = f"f32 B={b} T+1={t1} H={h} d={d} ALiBi ({name})"
        out = [check("K5", f"{case} {n}", gg, ww, 1e-4)
               for n, gg, ww in zip(("dq", "dk", "dv"), got, want)]
        errs["flash_attention_bwd_dq_f32"] = max(errs["flash_attention_bwd_dq_f32"], out[0])
        errs["flash_attention_bwd_dkv_f32"] = max(errs["flash_attention_bwd_dkv_f32"],
                                                  *out[1:])
        peaks = [ww.abs().max().item() for ww in want]
        log(f"  K5 [{case}] the plain gradients' peaks (dq, dk, dv): {peaks}")
        if not min(peaks) > 0:
            raise AssertionError(f"K5 [{case}]: a zero gradient compares nothing: {peaks}")
        del got, want
        valid = attn_mask(seg, seg, pos, pos, False, None)
        pairs = h * int(valid.sum())
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, seg, seg, pos, pos, False, None, None, True)
        slopes = FL.alibi_slopes_pow2(h).to(dev)[None, :, None, None]
        dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
        bias = torch.where(valid[:, None], -slopes * dist * (pos[:, None, None, :] != 0),
                           torch.finfo(torch.float32).min)
        del dist
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
        dot = do.transpose(1, 2)
        library = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
        del qt, kt, vt, ot, bias
        plain = cuda_ms(lambda: FL.flash_attention_bwd_reference(*ref))
        ins = nbytes(q, k, v, do, lse, delta, seg, pos)
        # dq: S = QK^T, dP = dO V^T, dQ = dS K; dk/dv: S, dP, dV = P^T dO,
        # dK = dS^T Q -- 2 d operations a pair each, three TF32 products each
        kernels = {"flash_attention_bwd_dq_f32": (FL.flash_attention_bwd_dq, nbytes(q), 6),
                   "flash_attention_bwd_dkv_f32": (FL.flash_attention_bwd_dkv, nbytes(k, v), 8)}
        times[name] = {
            key: {"ms": cuda_ms(lambda fn=fn: fn(*args)),
                  "graph_ms": graph_ms(lambda fn=fn: [fn(*args) for _ in range(10)], dev) / 10,
                  "plain_ms": plain, **least_time(ins + outs, ops * d * pairs, "3xtf32"),
                  "library_ms": library}
            for key, (fn, outs, ops) in kernels.items()}
        times[name]["backward"] = {
            "ms": cuda_ms(lambda: FL.flash_attention_bwd(*ref)),
            "graph_ms": graph_ms(lambda: [FL.flash_attention_bwd(*ref) for _ in range(10)],
                                 dev) / 10,
            **least_time(ins + nbytes(q, k, v), 14 * d * pairs, "3xtf32")}
        log(f"  K5 [{case}] times (dq, dk/dv, the whole backward with delta; SDPA's backward "
            f"with the ALiBi + padding bias as library_ms): " + json.dumps(times[name]))
        del q, k, v, do, o, lse, delta
    return errs, times


def measure_tail_run(dev) -> dict:
    """Phase 16 (c), on an emptied card after phase 12: each kernel at the
    shapes the measuring scripts give it against its plain version (K1 at
    b 32, K6 at the fused and int8-head widths, K2/K5 at GQA 8/2 T 8,192,
    K2 bf16 with ALiBi at the estimator's shape), then exp_stream_qmv and
    validate_memory_budget as a user runs them."""
    import torch

    from usdm_tpu_torch.scripts import exp_stream_qmv, validate_memory_budget

    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    log("phase 16 (c): kernels at the measuring scripts' shapes against their plain versions")
    k1_errs, k1_times = _k1_b32_checks(dev, randn)
    k6_err, k6_times = _k6_width_checks(dev)
    flash_errs, flash_times = _flash_gqa82_checks(dev, randn)
    est_err, est_times = _flash_estimator_bf16_check(dev, randn)
    _free_device()
    errs = {"paged_decode_attention": k1_errs["bf16"],
            "paged_decode_attention_int8": k1_errs["int8"], "stream_qmv": k6_err,
            "flash_attention": max(flash_errs["fwd"], est_err),
            "flash_attention_bwd_dq": flash_errs["dq"],
            "flash_attention_bwd_dkv": flash_errs["dkv"]}
    launches = {}
    esq = _measured("exp_stream_qmv", lambda: exp_stream_qmv.main([]), launches)
    _free_device()
    vmb = _measured("validate_memory_budget", lambda: validate_memory_budget.main([]), launches)
    if not (launches.get("flash_attention", 0) and launches.get("flash_attention_bwd_dq", 0)
            and launches.get("stream_qmv", 0)):
        raise AssertionError(f"phase 16 (c): K2/K5 or K6 did not launch: {launches}")
    for line in vmb:
        log(f"phase 16 validate_memory_budget: layers {line['layers']} seq {line['seq']}: "
            f"measured {line['measured_peak_gb']:.3f} GiB, model {line['device_gb']:.3f} GiB, "
            f"model/measured {line['model_over_measured']:.3f}")
    return {"max_abs_err": errs, "launches": launches, "exp_stream_qmv": esq,
            "validate_memory_budget": vmb,
            "times": {"k1_b32": k1_times, "k6_widths": k6_times, "k2_k5_gqa82": flash_times,
                      "k2_estimator_bf16": est_times}}


def user_wav(tmp: str) -> str:
    """The turns' user speech: 3 s of 16 kHz noise -> its path in `tmp`."""
    from usdm_tpu_torch.audio.wav import write_wav

    wav_in = os.path.join(tmp, "user.wav")
    if not os.path.exists(wav_in):
        write_wav(wav_in, (np.random.default_rng(0).standard_normal(48000) * 0.1)
                  .astype(np.float32), 16000)
    return wav_in


def slice_run(dev, profile: bool, tmp: str, out_dir: str, smi: str) -> dict:
    import dataclasses

    import torch

    from usdm_tpu_torch.ops.flash_attention import flash_attention
    from usdm_tpu_torch.ops.fused_act import fused_activation1d
    from usdm_tpu_torch.ops.fused_ln import add_mask_ln
    from usdm_tpu_torch.ops.paged_attention import paged_decode_attention
    from usdm_tpu_torch.pipeline import UsdmPipeline

    wav_in = user_wav(tmp)
    small_turn_check(dev, wav_in)

    t0 = time.perf_counter()
    pipe = UsdmPipeline.full_random(device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"built full-width random pipeline in {time.perf_counter() - t0:.1f} s; "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    counters = (paged_decode_attention, flash_attention, fused_activation1d)
    turns = []
    try:
        for turn in range(3 if profile else 2):
            prof = None
            if turn == 2:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            engine = pipe._dialog_server().engine
            before = engine.stats()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            wav_out = os.path.join(tmp, f"agent{turn}.wav")
            trace = {}
            t0 = time.perf_counter()
            res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, wav_out,
                                           n_timesteps=50, seed=1, trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            mma = mma_counts()["flash_attention"]
            links = _link_checks(engine, before, counts, f"bf16 turn {turn}", False)
            if prof is not None:
                prof.__exit__(None, None, None)
                _write_profile(prof, out_dir)
                links.update(_device_busy(prof, wall))
            audio = trace["audio"]
            audio_s = len(audio) / pipe.decoder.mel_cfg.sampling_rate
            info = {
                "turn": turn, "wall_s": wall, "xlsr_s": trace["xlsr_s"],
                "dialog_s": trace["dialog_s"], "synth_s": trace["synth_s"],
                "user_units": len(trace["user_units"]),
                "stage_tokens": {k: len(v) for k, v in res.stage_tokens.items()},
                "agent_units": len(res.agent_units), "audio_s": audio_s,
                "rtf": wall / audio_s if audio_s else None,
                "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                "engine": links, "launches": counts, "flash_attention_mma_launches": mma,
            }
            log(f"turn {turn}: " + json.dumps(info))
            if not all(counts[fn.__name__] for fn in counters):
                raise AssertionError(f"a kernel of the main path never launched: {counts}")
            # the LM's bf16 prefill takes K2's bf16 route, the f32 Voicebox
            # and XLS-R its f32 route (3xTF32)
            tf32 = counts["flash_attention_f32"]
            if not (0 < mma and 0 < tf32 and mma + tf32 == counts["flash_attention"]):
                raise AssertionError(f"K2's routes in the bf16 turn: {mma} bf16 and {tf32} f32 "
                                     f"launches of {counts['flash_attention']}")
            if counts["fused_activation1d"] != K3_PER_TURN:
                raise AssertionError(f"K3 launched {counts['fused_activation1d']} times in the "
                                     f"turn, want {K3_PER_TURN} (one per activation)")
            if add_mask_ln.launches:  # B * (T + 1) = 2 * 449 is under its gate
                raise AssertionError("the fused LayerNorm kernel ran in respond()")
            if counts["stream_qmv"] or counts["paged_decode_attention_int8"]:
                raise AssertionError(f"an int8 kernel ran in the bf16 turn: {counts}")
            if len(audio) == 0 or not np.isfinite(audio).all():
                raise AssertionError("respond() produced empty or non-finite audio")
            if len(audio) != len(res.agent_units) * 441 // 256 * 256:
                raise AssertionError(f"audio length {len(audio)} does not match "
                                     f"{len(res.agent_units)} agent units")
            if not os.path.exists(wav_out):
                raise AssertionError("respond() wrote no output wav")
            turns.append(info)
            graphed = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
            graphed_audio = audio
        eager = _eager_link_turn(pipe, wav_in, graphed, "bf16 turn")
        t0 = time.perf_counter()
        tf32 = tf32_check(pipe, wav_in, graphed, graphed_audio)
        log(f"phase time: TF32 (j) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served = serve_run(pipe, tmp, wav_in, graphed, wav_out)
        log(f"phase time: serve (i) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        spec = spec_turn(pipe, wav_in, graphed, "bf16 turn", False)
        log(f"phase time: speculation, bf16 turn {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ref = reference_runs(pipe, tmp, wav_in, graphed, turns[-1])
        log(f"phase time: speaker reference (f, g) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dense = dense_turns(pipe, wav_in, graphed, turns[-1], "bf16 turn", False)
        log(f"phase time: dense turns (h) {time.perf_counter() - t0:.1f} s")
        profiles = profilers_run(pipe, wav_in, "phase 4 bf16", respond=False)
        measure = measure_bf16_run(pipe, out_dir)
        log(f"phase time: 16 (a) measuring scripts on phase 4's pipeline "
            f"{measure['seconds']:.1f} s")
        t0 = time.perf_counter()
        tp = tp_engine_run(pipe, "bf16 7B", w8a8=False)
        tp["seconds"] = time.perf_counter() - t0
        log(f"phase time: 17 (a) tp engine on phase 4's pipeline {tp['seconds']:.1f} s")
        t0 = time.perf_counter()
        load = load_run(dev, pipe, wav_in, graphed, graphed_audio, tmp, smi)
        log(f"phase time: load (phase 10) {time.perf_counter() - t0:.1f} s")
    finally:
        pipe.close()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return {"turns": turns, "eager": eager, "tf32": tf32, "serve": served, "spec": spec,
            "ref": ref, "dense": dense, "load": load, "profiles": profiles, "measure": measure,
            "tp": tp}



# --------------------------------------------------------------- phase 5
def _nrms(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b**2)))


def int8_small_turn_check(dev, wav_in: str) -> None:
    """The small turn's pipeline with lm_int8 and vb_int8 (lm_head scaled by
    8, so no greedy argmax rests on a margin within rounding noise) runs one
    turn on the CPU (plain paths) and on the card (K6 for the decode rows,
    torch._int_mm above 16 rows): identical dialog tokens.  The two
    syntheses of those units from one shared noise may differ where an
    activation rounds to neighbouring int8 values on the two sides; they
    must stay within the W8A8 drift of the CPU's synthesis from the same
    pipeline's float Voicebox (normalized RMS and largest error)."""
    import dataclasses

    import torch

    from usdm_tpu_torch.core.config import BigVGANConfig, MistralConfig, VoiceboxConfig, XlsrConfig
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
    from usdm_tpu_torch.pipeline import UsdmPipeline

    tok = UsdmTokenizer.build_test(num_units=32)
    cfgs = (MistralConfig.tiny(vocab_size=tok.vocab_size).replace(head_dim=32),
            XlsrConfig.tiny().replace(num_clusters=32, hidden_size=64, intermediate_size=128),
            VoiceboxConfig.tiny().replace(n_tokens=32, n_feats=80, hidden_size=64,
                                          intermediate_size=128),
            BigVGANConfig.tiny().replace(num_mels=80))
    cpu = UsdmPipeline.random_init(tok, *cfgs, "cpu", seed=0, lm_int8=True, vb_int8=True,
                                   max_new_tokens=16)
    cpu.lm_params["lm_head"].mul_(8.0)
    f32_decoder = UsdmPipeline.random_init(tok, *cfgs, "cpu", seed=0).decoder
    card = dataclasses.replace(
        cpu, lm_params=_to(cpu.lm_params, dev), xlsr_params=_to(cpu.xlsr_params, dev),
        decoder=dataclasses.replace(cpu.decoder,
                                    voicebox_params=_to(cpu.decoder.voicebox_params, dev),
                                    vocoder_params=_to(cpu.decoder.vocoder_params, dev)),
        device=dev, _server=None)
    results = []
    for pipe in (cpu, card):
        reset_counts()
        try:
            res = pipe.respond_with_policy(_paged_policy(pipe, seed=2), wav_in,
                                           n_timesteps=6, seed=2)
        finally:
            pipe.close()
        results.append((dataclasses.asdict(res), launch_counts()))
    (want, _), (got, counts) = results
    log(f"small W8A8 turn, card vs CPU: tokens {'equal' if got == want else 'DIFFER'}, "
        f"{len(got['agent_units'])} agent units, launches {counts}")
    if got != want:
        raise AssertionError(f"small W8A8 turn differs on the card: {got} vs {want}")
    if not counts["stream_qmv"]:
        raise AssertionError(f"K6 did not run in the small W8A8 turn: {counts}")
    units = got["agent_units"]
    n = len(units) * 441 // 256
    z = torch.randn(1, 80, -(-n // 64) * 64, generator=torch.Generator().manual_seed(3))
    want_audio = cpu.decoder.synthesize(units, z=z, n_timesteps=6)
    f32_audio = f32_decoder.synthesize(units, z=z, n_timesteps=6)
    got_audio = card.decoder.synthesize(units, z=z.to(dev), n_timesteps=6)
    err, drift = _nrms(got_audio, want_audio), _nrms(want_audio, f32_audio)
    err_max, drift_max = (float(np.abs(a - want_audio).max()) for a in (got_audio, f32_audio))
    log(f"small W8A8 synthesis, card vs CPU: nRMS {err:.3e} (bound: the W8A8 drift from the "
        f"float Voicebox, {drift:.3e}), max_abs_err {err_max:.3e} (bound {drift_max:.3e})")
    if got_audio.shape != want_audio.shape or not drift > 0 or err > drift or err_max > drift_max:
        raise AssertionError("small W8A8 synthesis differs on the card beyond the W8A8 drift")


def _serve_load(server, prompts, allow, max_new: int, stagger_s: float = 0.0,
                stream=()) -> tuple:
    """Each client thread (client ci from ci * stagger_s seconds on, as
    bench.py's `stagger_s` load) submits its prompts one after another
    through EngineServer.generate, or, for the clients in `stream`, through
    generate_stream (its yields concatenated) -> (tokens per client, wall
    seconds)."""
    import threading

    done, errors = {}, []

    def one(ci, p):
        if ci in stream:
            return [t for part in server.generate_stream(p, allow, eos_id=2,
                                                         max_new_tokens=max_new, timeout=600)
                    for t in part]
        return server.generate(p, allow, eos_id=2, max_new_tokens=max_new, timeout=600)

    def client(ci):
        try:
            time.sleep(ci * stagger_s)
            done[ci] = [one(ci, p) for p in prompts[ci]]
        except Exception as e:  # re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return done, wall


def _load_info(engine, before, counts, label, done, wall, prompt_len, max_new) -> dict:
    """One timed load's numbers (tokens, tok/s, TTFTs, the engine's links)
    after `_link_checks`."""
    import torch

    links = _link_checks(engine, before, counts, label, True, turn=False)
    ttfts = sorted(engine._ttfts)
    n_tok = sum(len(t) for outs in done.values() for t in outs)
    return {"clients": len(done), "requests": sum(len(o) for o in done.values()),
            "prompt_len": prompt_len, "max_new_tokens": max_new, "wall_s": wall,
            "generated_tokens": n_tok, "tok_s": n_tok / wall,
            "ttft_p50_s": ttfts[len(ttfts) // 2],
            "ttft_p95_s": ttfts[min(int(0.95 * len(ttfts)), len(ttfts) - 1)],
            "ttfts_s": [round(t, 4) for t in engine._ttfts],  # in order
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "engine": links, "stats": engine.stats(), "launches": counts}


def _fused_load(server, prompts, allow, max_new: int, want: dict) -> dict:
    """The multi-step part: load (B)'s prompts once more with
    `multi_impl="fused"` (step_multi: one horizon of graphed links and one
    sync a tick); its tokens must equal the chained load's (`want`)."""
    import torch

    engine = server.engine
    engine.multi_impl = "fused"
    try:
        engine._ttfts.clear()
        before = engine.stats()
        reset_counts()
        done, wall = _serve_load(server, prompts, allow, max_new)
        torch.cuda.synchronize()
        info = _load_info(engine, before, launch_counts(), "(B) fused multi-step load", done,
                          wall, len(prompts[0][0]), max_new)
    finally:
        engine.multi_impl = "chain"
    same = all(done[ci] == want[ci] for ci in want)
    info["tokens"] = "equal" if same else "DIFFER"
    log("(B) multi_impl=fused: " + json.dumps(info))
    if not same:
        raise AssertionError("(B): multi_impl='fused' gave other tokens than 'chain'")
    if "multi_dispatch" not in info["engine"]["perf_s"]:
        raise AssertionError("(B): the fused multi-step decode never ran")
    return info


LOAD16 = {"clients": 16, "per_client": 2, "prompt_len": 384, "max_new": 128, "stagger_s": 0.15}


def load16_run(pipe) -> dict:
    """Part (C): 16 clients over the W8A8 7B with int8 KV pages, client i
    first submitting at i * 0.15 s (bench.py's `stagger_s` load), 2
    requests each of 384-token prompts, 128 new tokens, greedy, EOS masked
    out, one warm-up request each; once with mixed prefill (the defaults:
    rows 8, min_decode 3) and once alternating, on the same prompts.  Their
    tokens must be identical per request, mixed links must have engaged with
    more than one chunk row in some link, every decode link must have been a
    graph replay and the pool must be whole afterwards.  Then the streaming
    part on the mixed server."""
    import torch

    from usdm_tpu_torch.core.config import EngineConfig

    n, per, plen, max_new = (LOAD16[k] for k in ("clients", "per_client", "prompt_len",
                                                  "max_new"))
    rng = np.random.default_rng(16)
    allow = np.ones(pipe.lm_cfg.vocab_size, bool)
    allow[:3] = False  # EOS (id 2) unreachable: every request runs its budget
    prompts = [[rng.integers(3, 32000, plen).tolist() for _ in range(per)] for _ in range(n)]
    warm = [[rng.integers(3, 32000, plen).tolist()] for _ in range(n)]
    out, toks = {}, {}
    for mixed in (True, False):
        label = f"(C) 16 staggered clients, mixed_prefill={mixed}"
        server = pipe.make_server(EngineConfig(page_size=256, max_pages_per_seq=3,
                                               max_batch_size=n, prefill_chunk=256,
                                               kv_dtype="int8", mixed_prefill=mixed))
        try:
            engine = server.engine
            _serve_load(server, warm, allow, 8)
            engine._ttfts.clear()
            before = engine.stats()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            done, wall = _serve_load(server, prompts, allow, max_new, LOAD16["stagger_s"])
            torch.cuda.synchronize()
            info = _load_info(engine, before, launch_counts(), label, done, wall, plen, max_new)
            log(label + ": " + json.dumps(info))
            if info["generated_tokens"] != n * per * max_new or len(engine._ttfts) != n * per:
                raise AssertionError(f"{label}: {info['generated_tokens']} tokens, "
                                     f"{len(engine._ttfts)} first tokens")
            if len(engine.free_pages) != engine.n_pages - 1:
                raise AssertionError(f"{label}: {len(engine.free_pages)} of "
                                     f"{engine.n_pages - 1} pages free after the load")
            m = info["engine"]
            if mixed and not (m["mixed_links"] > 0 and m["mixed_rows"] > m["mixed_links"]):
                raise AssertionError(f"{label}: {m['mixed_links']} mixed links carrying "
                                     f"{m['mixed_rows']} chunk rows")
            if not mixed and m["mixed_links"]:
                raise AssertionError(f"{label}: mixed links ran")
            if mixed:
                out["stream"] = _stream_part(server, prompts, allow, max_new, done)
        finally:
            server.close()
        out["mixed" if mixed else "alternating"] = info
        toks[mixed] = done
    same = all(toks[True][ci] == toks[False][ci] for ci in range(n))
    log(f"(C) tokens, mixed against alternating: {'equal' if same else 'DIFFER'}")
    if not same:
        bad = [ci for ci in range(n) if toks[True][ci] != toks[False][ci]]
        raise AssertionError(f"(C): mixed and alternating tokens differ for clients {bad}")
    return out


def mixed_link_times(pipe, out_dir: str) -> dict:
    """One mixed link (paged_mixed_step, eager) of the W8A8 7B over int8
    pages at NPF 1 and 8 chunk rows of 256 queries beside 16 decode rows:
    the host's wall time of the synchronized call and, under the profiler,
    its device time (the kernels' summed self time; the tables in
    `out_dir`) -> per NPF."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import PagedKV, paged_mixed_step

    dev, cfg, b, c = pipe.device, pipe.lm_cfg, 16, 256
    n_pages = b * 3 + 1
    kv = PagedKV.create(cfg, n_pages, 256, dev, "int8")
    rng = np.random.default_rng(8)
    table = torch.arange(b * 3, device=dev, dtype=torch.int32).reshape(b, 3)
    lens = torch.full((b,), 600, device=dev, dtype=torch.int32)  # past the chunk rows' pages
    tok = torch.as_tensor(rng.integers(3, 32000, b), device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    allow = torch.ones(b, cfg.vocab_size, dtype=torch.bool, device=dev)
    out = {}
    for npf in (1, 8):
        packed = np.full((npf, c + 2 + 3), n_pages - 1, np.int32)
        for r in range(npf):  # rows at start 0 and 256 over the slots' pages
            packed[r, :c] = rng.integers(3, 32000, c)
            packed[r, c], packed[r, c + 1] = (r % 2) * 256, c
            packed[r, c + 2:] = table[r % b].cpu().numpy()
        rows = torch.as_tensor(packed, device=dev)

        def link():
            return paged_mixed_step(pipe.lm_params, kv, cfg, rows, tok, lens, table, active,
                                    ~active, torch.full_like(tok, 2), allow, 256, 2, c, True)

        link()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            link()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with _profiler() as prof:
            link()
            torch.cuda.synchronize()
        busy = _device_busy(prof, 1.0)
        _write_profile(prof, out_dir, f"mixed_link_npf{npf}_profile.txt")
        out[f"npf{npf}"] = {"wall_s": statistics.median(walls), "device_s": busy["device_s"],
                            "kernel_launches": busy["kernel_launches"]}
    log("(C) one mixed link, W8A8 7B, int8 KV, B 16: " + json.dumps(out))
    del kv
    return out


def _stream_part(server, prompts, allow, max_new: int, want: dict) -> dict:
    """Three clients of (C) call generate_stream while the others call
    generate: every client's tokens must equal (C)'s.  Then one generator
    closed after its first yield must cancel its request: the engine idle,
    every slot free, every page back."""
    import torch

    engine = server.engine
    done, wall = _serve_load(server, prompts, allow, max_new, LOAD16["stagger_s"],
                             stream=(0, 1, 2))
    torch.cuda.synchronize()
    same = all(done[ci] == want[ci] for ci in want)
    cancelled = engine.total_cancelled
    gen = server.generate_stream(prompts[0][0], allow, eos_id=2, max_new_tokens=max_new,
                                 timeout=60)
    first = next(gen)
    gen.close()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (engine.busy or engine.total_cancelled == cancelled):
        time.sleep(0.01)
    st = engine.stats()
    freed = (st["total_cancelled"] == cancelled + 1 and not engine.busy
             and st["active_slots"] == st["held_sessions"] == 0
             and st["free_pages"] == engine.n_pages - 1)
    info = {"wall_s": wall, "tokens": "equal" if same else "DIFFER",
            "closed_after_tokens": len(first), "cancel_freed": freed}
    log("(C) streaming part: " + json.dumps(info))
    if not same:
        raise AssertionError("(C): generate_stream's tokens differ from generate's")
    if not freed:
        raise AssertionError("(C): closing a generator did not cancel its request")
    return info


def _profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def int8_run(dev, tmp: str, wav_in: str, profile: bool, out_dir: str) -> dict:
    """Paths (A) and (B) of the int8 slice; with `profile` a third (A) turn
    and a second (B) load run under torch.profiler."""
    import dataclasses
    import gc

    import torch

    from usdm_tpu_torch.core.config import EngineConfig
    from usdm_tpu_torch.pipeline import UsdmPipeline

    int8_small_turn_check(dev, wav_in)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = UsdmPipeline.full_random(device=dev, seed=0, lm_int8=True, vb_int8=True)
    torch.cuda.synchronize()
    log(f"built full-width W8A8 pipeline in {time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak while quantizing "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    out = {}
    try:
        # (A) the W8A8 turn, twice (the first warms cuBLAS's int8 heuristics)
        for turn in range(3 if profile else 2):
            prof = _profiler() if turn == 2 else None
            if prof is not None:
                prof.__enter__()
            engine = pipe._dialog_server().engine
            before = engine.stats()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            trace = {}
            wav_out = os.path.join(tmp, f"agent_int8_{turn}.wav")
            t0 = time.perf_counter()
            res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, wav_out,
                                           n_timesteps=50, seed=1, trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            links = _link_checks(engine, before, counts, f"W8A8 turn {turn}", True)
            if prof is not None:
                prof.__exit__(None, None, None)
                _write_profile(prof, out_dir, "int8_turn_profile.txt")
                links.update(_device_busy(prof, wall))
            audio = trace["audio"]
            audio_s = len(audio) / pipe.decoder.mel_cfg.sampling_rate
            info = {"turn": turn, "wall_s": wall, "xlsr_s": trace["xlsr_s"],
                    "dialog_s": trace["dialog_s"], "synth_s": trace["synth_s"],
                    "stage_tokens": {k: len(v) for k, v in res.stage_tokens.items()},
                    "agent_units": len(res.agent_units), "audio_s": audio_s,
                    "rtf": wall / audio_s if audio_s else None,
                    "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "engine": links, "launches": counts}
            log(f"(A) W8A8 turn {turn}: " + json.dumps(info))
            need = ("stream_qmv", "paged_decode_attention", "flash_attention",
                    "fused_activation1d")
            if not all(counts[k] for k in need):
                raise AssertionError(f"a kernel of path (A) never launched: {counts}")
            if counts["fused_activation1d"] != K3_PER_TURN:
                raise AssertionError(f"K3 launched {counts['fused_activation1d']} times in the "
                                     f"W8A8 turn, want {K3_PER_TURN}")
            if len(audio) == 0 or not np.isfinite(audio).all() or not os.path.exists(wav_out):
                raise AssertionError("the W8A8 turn produced no finite audio")
            if len(audio) != len(res.agent_units) * 441 // 256 * 256:
                raise AssertionError("audio length does not match the agent units")
            out["A"] = info
            graphed = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
        out["A_eager"] = _eager_link_turn(pipe, wav_in, graphed, "(A) W8A8 turn")
        t0 = time.perf_counter()
        out["A_spec"] = spec_turn(pipe, wav_in, graphed, "(A) W8A8 turn", True)
        log(f"phase time: speculation, W8A8 turn {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["A_dense"] = dense_turns(pipe, wav_in, graphed, out["A"], "(A) W8A8 turn", True,
                                     graphed_turns=1, eager_twin=False)
        log(f"phase time: dense W8A8 turn {time.perf_counter() - t0:.1f} s")
        out["profiles"] = profilers_run(pipe, wav_in, "phase 5 W8A8", respond=True)
        out["measure"] = measure_w8a8_run(pipe, out_dir)
        log(f"phase time: 16 (b) measuring scripts on phase 5's pipeline "
            f"{out['measure']['seconds']:.1f} s")
        t0 = time.perf_counter()
        out["tp"] = tp_engine_run(pipe, "W8A8 7B, int8 KV", w8a8=True)
        out["tp"]["seconds"] = time.perf_counter() - t0
        log(f"phase time: 17 (a) tp engine on phase 5's pipeline {out['tp']['seconds']:.1f} s")

        # (B) eight clients over the same W8A8 7B with int8 KV pages
        n_clients, per_client, prompt_len, max_new = 8, 2, 384, 128
        ecfg = EngineConfig(page_size=256, max_pages_per_seq=3, max_batch_size=n_clients,
                            prefill_chunk=256, kv_dtype="int8")
        server = pipe.make_server(ecfg)
        try:
            engine = server.engine
            rng = np.random.default_rng(0)
            allow = np.ones(pipe.lm_cfg.vocab_size, bool)
            allow[:3] = False  # EOS (id 2) unreachable: every request runs its budget
            prompts = [[rng.integers(3, 32000, prompt_len).tolist() for _ in range(per_client)]
                       for _ in range(n_clients)]
            _serve_load(server, [[rng.integers(3, 32000, prompt_len).tolist()]
                                 for _ in range(n_clients)], allow, 8)  # warm-up
            engine._ttfts.clear()
            before = engine.stats()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            done, wall = _serve_load(server, prompts, allow, max_new)
            torch.cuda.synchronize()
            counts = launch_counts()
            info = _load_info(engine, before, counts, "(B) load", done, wall, prompt_len,
                              max_new)
            log("(B) W8A8 7B, int8 KV, 8 clients: " + json.dumps(info))
            out["B_fused"] = _fused_load(server, prompts, allow, max_new, done)
            if profile:  # the same load once more, under the profiler
                again = [[rng.integers(3, 32000, prompt_len).tolist() for _ in range(per_client)]
                         for _ in range(n_clients)]
                with _profiler() as prof:
                    _, wall_p = _serve_load(server, again, allow, max_new)
                    torch.cuda.synchronize()
                log(f"(B) profiled load: {wall_p:.3f} s, " + json.dumps(_device_busy(prof, wall_p)))
                _write_profile(prof, out_dir, "serve_profile.txt")
        finally:
            server.close()
        n_tok, n_first = info["generated_tokens"], len(info["ttfts_s"])
        if n_tok != n_clients * per_client * max_new or n_first != n_clients * per_client:
            raise AssertionError(f"(B) generated {n_tok} tokens, {n_first} first tokens")
        if not all(counts[k] for k in ("stream_qmv", "paged_decode_attention_int8",
                                       "flash_attention")):
            raise AssertionError(f"a kernel of path (B) never launched: {counts}")
        if counts["paged_decode_attention"]:
            raise AssertionError("the bf16 K1 branch ran over int8 KV pages")
        out["B"] = info
        out["C"] = load16_run(pipe)
        out["C"]["link"] = mixed_link_times(pipe, out_dir)
    finally:
        pipe.close()
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return out


# --------------------------------------------------------------- phase 6
def _train_counters():
    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.ops import fused_ln as LN

    return {"flash_attention": FL.flash_attention, "add_mask_ln": LN.add_mask_ln,
            "add_mask_ln_bwd": LN.add_mask_ln_bwd,
            "flash_attention_bwd_dq": FL.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": FL.flash_attention_bwd_dkv}


class _RecordGrads:
    """The train step's optimizer, keeping a copy of the gradients it is
    handed, before the clip and the Adam step."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, adam):
        self.grads = [p.grad.detach().clone() for group in adam.param_groups
                      for p in group["params"]]
        return self.opt.update(adam)


def small_train_check(dev) -> dict:
    """One f32 train step of a small Voicebox (H 128, 4 heads of d 32, T+1 =
    400, B 8: the flash and fused-LN gates open on the card, the plain paths
    run on the CPU) from the same init, batch, t and z on both sides: the
    loss, then each parameter's gradient before the optimizer, then the
    updated parameters.  -> the card step's launches of K5's f32 route (every
    K5 launch of the step must take it)."""
    import torch

    from usdm_tpu_torch.core.config import CfmTrainConfig, VoiceboxConfig
    from usdm_tpu_torch.core.tree import tree_leaves, tree_map
    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.train import cfm as C

    cfg = VoiceboxConfig.tiny().replace(n_tokens=32, n_feats=80, hidden_size=128,
                                        intermediate_size=256)
    tc = CfmTrainConfig()
    cpu, opt = C.init_state(cfg, tc, "cpu", torch.Generator().manual_seed(0))
    params = tree_map(lambda a: a.detach().clone().to(dev).requires_grad_(), cpu.params)
    card = C.CfmTrainState(params, opt.init(params), 0)
    rng = np.random.default_rng(0)
    b, t = 8, 399
    mask = np.zeros((b, 1, t), np.float32)
    mask[1, 0, 40:200] = 1.0
    batch = {"x": rng.integers(0, cfg.n_tokens + 1, (b, t)), "mask": mask,
             "y": rng.standard_normal((b, cfg.n_feats, t)).astype(np.float32),
             "y_lengths": np.asarray([399, 300, 399, 250, 399, 399, 120, 399])}
    tz = (rng.uniform(size=b).astype(np.float32),
          rng.standard_normal((b, cfg.n_feats, t)).astype(np.float32))
    counters = _train_counters()
    bwd = {"flash_attention_bwd_dq_f32": FL.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv_f32": FL.flash_attention_bwd_dkv}
    out = {}
    for name, state, where in (("card", card, dev), ("cpu", cpu, "cpu")):
        for fn in counters.values():
            fn.launches = 0
        for fn in bwd.values():
            fn.tf32_launches = 0
        rec = _RecordGrads(opt)
        step = C.make_train_step(cfg, tc, rec, compute_dtype="float32")
        tb = {k: torch.from_numpy(np.asarray(v)).to(where) for k, v in batch.items()}
        m = step(state, tb, t=torch.from_numpy(tz[0]).to(where), z=torch.from_numpy(tz[1]).to(where))
        out[name] = ({k: float(v) for k, v in m.items()}, [g.cpu() for g in rec.grads],
                     {k: fn.launches for k, fn in counters.items()},
                     {k: fn.tf32_launches for k, fn in bwd.items()})
    (mc, g_card, counts, tf32), (mp, g_cpu, _, _) = out["card"], out["cpu"]
    loss_rel = abs(mc["loss"] - mp["loss"]) / abs(mp["loss"])
    # each leaf's gradient: within 1e-4 of each value plus 1e-4 of the leaf's
    # largest, plus 1e-6 of the largest in the tree for leaves that are zero
    # in exact arithmetic and hold rounding noise (the key bias: softmax
    # ignores a per-row constant) -- the bound of the CPU parity tests
    floor = 1e-6 * max(w.abs().max().item() for w in g_cpu)
    ratios = [((g - w).abs() / (1e-4 * w.abs() + 1e-4 * w.abs().max() + floor)).max().item()
              for g, w in zip(g_card, g_cpu)]
    worst = int(np.argmax(ratios))
    # one Adam step moves each weight by at most ~lr whatever its gradient;
    # a noise gradient that flips sign moves it by 2 lr, so this bound checks
    # only that the card took one step of the CPU's size: the gradients'
    # magnitudes are checked above
    pbound = 2 * tc.learning_rate + 1e-6
    perr = max((a.detach().cpu() - bb.detach()).abs().max().item()
               for a, bb in zip(tree_leaves(card.params), tree_leaves(cpu.params)))
    log(f"small train step, card vs CPU (f32): loss {mc['loss']:.6f} vs {mp['loss']:.6f} "
        f"(rel {loss_rel:.2e}, bound 1e-4); gradients of {len(g_cpu)} leaves before the "
        f"optimizer, largest error/bound {ratios[worst]:.3f} (leaf {worst}, must be <= 1); "
        f"updated params max_abs_err={perr:.3e} (bound {pbound:.2e}), launches {counts}, "
        f"K5 on the f32 route {tf32}")
    if loss_rel > 1e-4 or ratios[worst] > 1 or perr > pbound:
        raise AssertionError("the small train step differs on the card")
    if not all(counts.values()):
        raise AssertionError(f"a kernel did not run in the small train step: {counts}")
    if [tf32[k + "_f32"] for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")] != [
            counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]]:
        raise AssertionError(f"K5 left the f32 route in the f32 train step: {tf32} of {counts}")
    return tf32


def _write_train_data(tmp: str, n_items: int = 16, seed: int = 0) -> str:
    """Noise clips of 8-20 s at 22.05 kHz (some shorter than the 16 s crop)
    and a filelist of random units and durations covering each."""
    from usdm_tpu_torch.audio.wav import write_wav

    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_items):
        n = int(22050 * rng.uniform(8.0, 20.0))
        path = os.path.join(tmp, f"clip{i}.wav")
        write_wav(path, (rng.standard_normal(n) * 0.1).astype(np.float32), 22050)
        n_units = -(-n // 441)
        durs = rng.integers(1, 4, n_units)
        durs = durs[: int(np.searchsorted(np.cumsum(durs), n_units)) + 1]
        units = rng.integers(0, 10000, len(durs))
        lines.append(f"{path}|{' '.join(map(str, units))}|{' '.join(map(str, durs))}")
    filelist = os.path.join(tmp, "train.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(lines))
    return filelist


def train_run(dev, profile: bool, tmp: str, out_dir: str) -> dict:
    import gc

    import torch

    from usdm_tpu_torch.cli import train_voicebox
    from usdm_tpu_torch.core import checkpoint as CK
    from usdm_tpu_torch.core.config import CfmTrainConfig, MelConfig, VoiceboxConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.data.unit_mel import UnitMelCollate, UnitMelDataset
    from usdm_tpu_torch.train import cfm as C

    small_f32 = small_train_check(dev)
    filelist = _write_train_data(tmp)
    out = os.path.join(tmp, "train_out")
    n_steps, seed = 10, 37
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    train_voicebox.main(["--train_filelist", filelist, "--output_dir", out, "--max_steps",
                         str(n_steps), "--synthesize_every", "0", "--save_every", "1000",
                         "--seed", str(seed), "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if k in _train_counters()}
    mma = mma_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "train/loss" in r]
    cfg, tc, mel_cfg = VoiceboxConfig(), CfmTrainConfig(), MelConfig()
    frames = tc.batch_size * (tc.out_size_seconds * mel_cfg.sampling_rate // mel_cfg.hop_size)
    step_s = [r["train/step_s"] for r in steps]
    # the first two steps warm up; the last step's result is read right after
    # the one before it, with no step dispatched between, so its step_s shows
    # only how far the device trailed the host, not a step's time
    med = statistics.median(step_s[2:-1])
    info = {"steps": len(steps), "wall_s": wall, "step_s": step_s, "median_step_s": med,
            "frames_per_s": frames / med, "loss": [r["train/loss"] for r in steps],
            "grad_norm": [r["train/grad_norm"] for r in steps],
            "max_memory_allocated_gib": peak, "launches": counts, "mma_launches": mma,
            "small_f32_launches": small_f32}
    log("full-width CFM training (VoiceboxConfig(), batch 8 x 16 s crops, bf16 over f32, "
        "remat): " + json.dumps(info))
    if len(steps) != n_steps or not np.isfinite(info["loss"]).all():
        raise AssertionError(f"the trainer ran {len(steps)} steps, losses {info['loss']}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the training path never launched: {counts}")
    if any(mma[k] != counts[k] for k in mma):  # training computes in bf16
        raise AssertionError(f"a flash kernel of the bf16 training path left the tensor-core "
                             f"route: {mma} of {counts}")

    # the checkpoint moved away from the init; 5 steps on one fixed batch with
    # fixed t and z lower the loss
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, opt = C.init_state(cfg, tc, dev, gen)
    init = [a.detach().clone() for a in tree_leaves(state.params)]
    restored = CK.restore_train_state(os.path.join(out, "checkpoints"), state).step
    moved = max((a.detach() - b).abs().max().item()
                for a, b in zip(tree_leaves(state.params), init))
    del init
    ds = UnitMelDataset(filelist, mel_cfg, n_tokens=cfg.n_tokens)
    batch = UnitMelCollate(tc, mel_cfg, cfg.n_tokens)([ds[i] for i in range(8)],
                                                      np.random.default_rng(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    g2 = torch.Generator(device=dev).manual_seed(1)
    t = torch.rand(8, generator=g2, device=dev)
    z = torch.randn(batch["y"].shape, generator=g2, device=dev)
    step = C.make_train_step(cfg, tc, opt)
    losses = []
    for i in range(5):
        prof = None
        if profile and i == 3:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch, t=t, z=z)["loss"]))
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            log(f"profiled train step: {time.perf_counter() - t0:.3f} s")
            _write_profile(prof, out_dir, "train_profile.txt")
    log(f"checkpoint step {restored}: params moved from the init by up to {moved:.3e}; "
        f"5 steps on one fixed batch with fixed t, z: losses {losses}")
    if not moved > 0 or not losses[-1] < losses[0]:
        raise AssertionError("the params did not move or the loss did not fall")
    del state, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return info


# --------------------------------------------------------------- phase 7
PROBE_D, PROBE_F, PROBE_L = 4096, 14336, 16  # the probes' chain: 16 distinct layers


def graph_ms(fn, dev) -> float:
    """Median CUDA-event time of fn() captured once in a CUDA graph and
    replayed: the device's time for a list of launches, without the host's
    dispatch between them (the probes time their chains so).  The replays
    add their launches to the wrappers' counts."""
    from usdm_tpu_torch.scripts.common import graphed

    return cuda_ms(graphed(fn, dev))


def probe_kernel_checks(dev) -> dict:
    """X1-X3 against their plain versions at the probe shapes, each timed
    over the 16 layers' calls (up and down projections for X1 and X2, one
    [F, D] matrix per layer for X3)."""
    import torch

    from usdm_tpu_torch.ops import int4_matvec as I4
    from usdm_tpu_torch.ops import matvec_io as MV
    from usdm_tpu_torch.ops import stream_probe as SP
    from usdm_tpu_torch.scripts.common import int_mm

    gen = torch.Generator(device=dev).manual_seed(3)
    d, f, n = PROBE_D, PROBE_F, PROBE_L
    results = {}

    def i8(*shape, lo=-127, hi=127):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(k, dtype):
        return (torch.rand(n, k, generator=gen, device=dev) * 0.02 + 1e-3).to(dtype)

    def per_layer(fn, ws_up, ws_dn, x_up, x_dn, s_up, s_dn):
        return lambda: [(fn(x_up, ws_up[i], s_up[i]), fn(x_dn, ws_dn[i], s_dn[i]))
                        for i in range(n)]

    # X1: io int8 weights [D, F] and [F, D]; one activation row
    log("X1 mv_io_bf16 / mv_io_i8 vs mv_io_bf16_reference / mv_io_i8_reference (X1a bf16: one "
        "bf16 ulp of the largest output + 1e-4; X1b: bit for bit)")
    up, dn = i8(n, d, f), i8(n, f, d)
    s_up, s_dn = scales(f, torch.bfloat16), scales(d, torch.bfloat16)
    y_up = torch.randn(1, d, generator=gen, device=dev).bfloat16()
    y_dn = torch.randn(1, f, generator=gen, device=dev).bfloat16()
    q_up, q_dn = i8(1, d), i8(1, f)
    errs = {"bf16": [], "i8": []}
    for bf in MV.TILES:
        for i in (0, n - 1):
            for x, q, sc, what in ((y_up, up[i], s_up[i], "up"), (y_dn, dn[i], s_dn[i], "down")):
                want = MV.mv_io_bf16_reference(x, q, sc)
                errs["bf16"].append(check("X1a", f"{what} [{q.shape[0]}, {q.shape[1]}] layer {i} "
                                          f"bf {bf}", MV.mv_io_bf16(x, q, sc, bf), want,
                                          bf16_bound(want)))
            for x, q, sc, what in ((q_up, up[i], s_up[i], "up"), (q_dn, dn[i], s_dn[i], "down")):
                errs["i8"].append(check("X1b", f"{what} [{q.shape[0]}, {q.shape[1]}] layer {i} "
                                        f"bf {bf}", MV.mv_io_i8(x, q, sc, bf),
                                        MV.mv_io_i8_reference(x, q, sc), 0.0))
    # each call reads its weight once, its row and scales, writes Dout bf16
    x1_bytes = {key: 2 * n * d * f + n * (nbytes(s_up[0], s_dn[0]) + (x_size + 2) * (d + f))
                for key, x_size in (("bf16", 2), ("i8", 1))}
    timing = {
        "bf16": (graph_ms(per_layer(MV.mv_io_bf16, up, dn, y_up, y_dn, s_up, s_dn), dev),
                 graph_ms(per_layer(MV.mv_io_bf16_reference, up, dn, y_up, y_dn, s_up, s_dn),
                          dev)),
        "i8": (graph_ms(per_layer(MV.mv_io_i8, up, dn, q_up, q_dn, s_up, s_dn), dev),
               graph_ms(per_layer(MV.mv_io_i8_reference, up, dn, q_up, q_dn, s_up, s_dn), dev))}
    lib_i8 = graph_ms(lambda: [(int_mm(q_up, up[i]), int_mm(q_dn, dn[i])) for i in range(n)], dev)
    del up, dn
    up_b = [torch.randint(-127, 127, (d, f), generator=gen, device=dev).bfloat16()
            for _ in range(n)]
    dn_b = [torch.randint(-127, 127, (f, d), generator=gen, device=dev).bfloat16()
            for _ in range(n)]
    lib_bf16 = graph_ms(lambda: [(y_up @ up_b[i], y_dn @ dn_b[i]) for i in range(n)], dev)
    del up_b, dn_b
    for key, kind, lib, what in (
            ("bf16", "bf16", lib_bf16, "bf16 matmul of the dequantized bf16 weights"),
            ("i8", "int8", lib_i8, "torch._int_mm, rows padded to 17, io int8 weights")):
        km, pm = timing[key]
        bound = least_time(x1_bytes[key], 2 * 2 * n * d * f, kind)
        log(f"  X1{'a' if key == 'bf16' else 'b'} time, 16 layers x (up + down), bf 512: kernel "
            f"{km:.4f} ms ({2 * n * d * f / km / 1e6:.1f} GB/s of weights), plain {pm:.4f} ms, "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); {what}: {lib:.4f} ms")
        results[f"mv_io_{key}"] = {"max_abs_err": max(errs[key]), "ms": km, "plain_ms": pm,
                                   **bound, "library_ms": lib,
                                   "case": "16 layers x (up [4096, 14336] + down), one row"}

    # X2: int4 weights packed by halves, "oi" [F, D/2] and [D, F/2]
    log("X2 qmv4 vs qmv4_reference (bit for bit in f32)")
    w_up, w_dn = i8(n, f, d, lo=-8, hi=8), i8(n, d, f, lo=-8, hi=8)
    p_up, p_dn = I4.pack_halves(w_up), I4.pack_halves(w_dn)
    s4_up, s4_dn = scales(f, torch.float32), scales(d, torch.float32)
    errs = []
    for m in (1, 8, 16):
        qa, qb = i8(m, d), i8(m, f)
        for i in (0, n - 1):
            errs.append(check("X2", f"M={m} up [{f}, {d}] layer {i}", I4.qmv4(qa, p_up[i],
                              s4_up[i]), I4.qmv4_reference(qa, p_up[i], s4_up[i]), 0.0))
            errs.append(check("X2", f"M={m} down [{d}, {f}] layer {i}", I4.qmv4(qb, p_dn[i],
                              s4_dn[i]), I4.qmv4_reference(qb, p_dn[i], s4_dn[i]), 0.0))
    km = graph_ms(per_layer(I4.qmv4, p_up, p_dn, q_up, q_dn, s4_up, s4_dn), dev)
    pm = graph_ms(per_layer(I4.qmv4_reference, p_up, p_dn, q_up, q_dn, s4_up, s4_dn), dev)
    lib = graph_ms(lambda: [(int_mm(q_up, w_up[i].t()), int_mm(q_dn, w_dn[i].t()))
                            for i in range(n)], dev)
    bound = least_time(n * d * f + n * (nbytes(s4_up[0], s4_dn[0]) + (d + f) + 4 * (d + f)),
                       2 * 2 * n * d * f, "int8")
    log(f"  X2 time, 16 layers x (up + down), M=1: kernel {km:.4f} ms ({n * d * f / km / 1e6:.1f} "
        f"GB/s of int4 bytes, {2 * n * d * f / km / 1e6:.1f} int8-equivalent), plain {pm:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}); torch._int_mm over the same "
        f"weights unpacked to int8 (rows padded to 17): {lib:.4f} ms")
    results["qmv4"] = {"max_abs_err": max(errs), "ms": km, "plain_ms": pm, **bound,
                       "library_ms": lib, "case": "16 layers x (up + down), M=1"}
    del w_up, w_dn, p_up, p_dn

    # X3: every mode over the 16-layer chain, and the loads-in-flight sweep
    log("X3 stream_probe vs stream_probe_reference over the 16-layer chain, tiles of 1024 and "
        "2048 rows (every mode bit for bit: vpu and dot_bf16 sum in the kernel's f32 order)")
    ws = i8(n, f, d)
    xs = {b: i8(b, d) for b in (1, 8, 32)}

    def chain(fn, mode, bpad, bf, **kw):
        c = torch.zeros(1, 128, device=dev)
        for w in ws:
            c = c + fn(xs[bpad], w, mode, bf, **kw)
        return c

    errs = []
    for bf in (1024, 2048):
        for mode, bpad in (("dma_only", 1), ("dot", 1), ("dot", 8), ("dot", 32), ("vpu", 1),
                           ("dot_bf16", 1)):
            want = chain(SP.stream_probe_reference, mode, bpad, bf)
            for loads in SP.LOADS:
                errs.append(check("X3", f"{mode} bpad {bpad} loads {loads} bf {bf}",
                                  chain(SP.stream_probe, mode, bpad, bf, loads=loads), want, 0.0))
    # the kernels line times dot at bpad 1, whose plain version reads every
    # weight byte as the kernel does (dma_only's reads one row per tile)
    km = graph_ms(lambda: [SP.stream_probe(xs[1], w, "dot", 1024, 8) for w in ws], dev)
    pm = graph_ms(lambda: [SP.stream_probe_reference(xs[1], w, "dot", 1024) for w in ws], dev)
    copy = {lo: graph_ms(lambda lo=lo: [SP.stream_probe(xs[1], w, "dma_only", 1024, lo)
                                        for w in ws], dev) for lo in SP.LOADS}
    dots = {b: graph_ms(lambda b=b: [SP.stream_probe(xs[b], w, "dot", 1024, 8) for w in ws], dev)
            for b in (8, 32)}
    bound = least_time(n * (nbytes(ws[0], xs[1]) + 4 * 128), 2 * n * f * d, "int8")
    # a yardstick of the read rate from PyTorch's own reduction kernel over
    # the same bytes, viewed as int64 (not the same function: no library_ms)
    sum_ms = graph_ms(lambda: [w.view(torch.int64).sum() for w in ws], dev)
    # X1a's yardstick at X3's weights (its dot modes compute X1a's
    # function): one bf16 row times each [F, D] weight dequantized to bf16
    x_b = xs[1].bfloat16()
    w_b = [w.bfloat16() for w in ws]
    lib = graph_ms(lambda: [torch.nn.functional.linear(x_b, w) for w in w_b], dev)
    del w_b
    log(f"  X3 time dot bpad 1, 16 x [{f}, {d}] int8, loads 8: kernel {km:.4f} ms "
        f"({n * f * d / km / 1e6:.1f} GB/s), plain {pm:.4f} ms, bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}); dma_only by loads in flight "
        + ", ".join(f"{lo}: {t:.4f}" for lo, t in copy.items()) + " ms; dot at bpad "
        + ", ".join(f"{b}: {t:.4f}" for b, t in dots.items()) + " ms (loads 8); PyTorch's "
        f"sum over the same 16 weights as int64 {sum_ms:.4f} ms ({n * f * d / sum_ms / 1e6:.1f} "
        f"GB/s); the bf16 matmul of the weights dequantized to bf16 {lib:.4f} ms")
    results["stream_probe"] = {"max_abs_err": max(errs), "ms": km, "plain_ms": pm, **bound,
                               "library_ms": lib,
                               "case": "dot bpad 1, loads 8, 16 layers of [14336, 4096] int8"}
    del ws
    return results


def probe_run(dev) -> dict:
    """The port's three probe entry points at full size, as a user runs
    them; every probe kernel must launch there."""
    import gc

    import torch

    from usdm_tpu_torch.scripts import exp_int4, exp_matvec, exp_stream_variants

    reset_counts()
    lines = {}
    for mod in (exp_stream_variants, exp_matvec, exp_int4):
        lines[mod.__name__.rsplit(".", 1)[-1]] = mod.main([])
        gc.collect()
        torch.cuda.empty_cache()
    counts = launch_counts()
    log(f"probe entry points: launches {counts}")
    need = ("mv_io_bf16", "mv_io_i8", "qmv4", "stream_probe")
    if not all(counts[k] for k in need):
        raise AssertionError(f"a probe kernel never launched in the probe entry points: {counts}")
    # every formulation timed on the card, but the two int4 matmuls PyTorch
    # lacks and the TPU-only operand order; X2's own checks were exact
    skip = {"w4a8_native", "w4a4_native", "wlhs", "check"}
    for name, line in lines.items():
        bad = [k for k, v in line["results"].items() if k not in skip and not v.get("gbps", 0) > 0]
        if line["device"]["platform"] != "gpu" or bad:
            raise AssertionError(f"{name}: not run on the card, or no rate for {bad}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return {"launches": counts}


# --------------------------------------------------------------- phase 8
def vocoder_gate(dev) -> dict:
    """The port of scripts/bench_fused_act.py at full width: BigVGAN bf16 on
    a 10 s mel (861 frames), fused_act off then on, parity rel < 6e-2 and one
    K3 launch per activation (109 per call); its own run of the kernel."""
    from usdm_tpu_torch.core.config import BigVGANConfig
    from usdm_tpu_torch.scripts import bench_fused_act

    reset_counts()
    out = bench_fused_act.run(BigVGANConfig(), dev)
    counts = launch_counts()
    fused = out["runs"]["fused"]
    # 1 warm-up + 5 timed fused calls; nothing else of the port launches
    if (counts["fused_activation1d"] != 6 * K3_PER_TURN
            or fused["k3_launches_per_call"] != K3_PER_TURN):
        raise AssertionError(f"bench_fused_act: K3 launched {counts['fused_activation1d']} "
                             f"times in 6 fused calls")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return out


# --------------------------------------------------------------- phase 9
def spec_turn(pipe, wav_in: str, want: dict, label: str, w8a8: bool) -> dict:
    """Phase 9 (c): one more full-width turn of `pipe` (budgets pinned at
    48/32/256) with enable_speculation("ngram"), against the graphed
    non-speculative turn `want` (its DialogResult and user units).  Every
    decode link and round must be one graph replay, launching K1 once a
    layer (and K6 7 times a layer with W8A8).  W8A8: identical tokens.
    bf16: identical, or the first divergence is classified by
    bench_ngram's tie-flip rule (a later stage then reads another prompt
    and is not compared).  -> wall, rounds, accepted tokens per round by
    stage, the verdicts and the count of divergences."""
    import dataclasses

    import torch

    pipe.enable_speculation("ngram")
    stages: dict = {}
    try:
        engine = pipe._dialog_server().engine
        before = engine.stats()
        reset_counts()
        trace = {}
        t0 = time.perf_counter()
        res = pipe.respond_with_policy(_paged_policy(pipe, 1, stages), wav_in, n_timesteps=50,
                                       seed=1, trace=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        links = _link_checks(engine, before, counts, label, w8a8, turn=False)
    finally:
        pipe.enable_speculation(None)
    got = dataclasses.asdict(res)
    if list(trace["user_units"]) != want["user_units"]:
        raise AssertionError(f"{label}: the user units differ from the plain turn's")
    verdicts = _stage_verdicts(pipe, want, got, stages)
    n_div = sum(v.get("divergences", 0) for v in verdicts.values())
    rounds = sum(r["rounds"] for r in stages.values())
    info = {"wall_s": wall, "dialog_s": trace["dialog_s"], "synth_s": trace["synth_s"],
            "spec_rounds": rounds,
            "accept_per_round": {s: (r["emitted"] / r["rounds"] if r["rounds"] else None)
                                 for s, r in stages.items()},
            "rounds_by_stage": {s: r["rounds"] for s, r in stages.items()},
            "stage_tokens": {k: len(v) for k, v in got["stage_tokens"].items()},
            "divergences": n_div, "verdicts": verdicts, "engine": links,
            "launches": {k: counts[k] for k in ("paged_decode_attention",
                                                "paged_decode_attention_int8", "stream_qmv")}}
    log(f"{label}, ngram speculation: " + json.dumps(info))
    if rounds <= 0:
        raise AssertionError(f"{label}: no speculative round ran")
    if w8a8 and n_div:
        raise AssertionError(f"{label}: W8A8 speculative tokens differ from plain greedy")
    if any(v.get("divergences") and not v["tie_flip"] for v in verdicts.values()):
        raise AssertionError(f"{label}: a divergence is not a tie-flip: {verdicts}")
    return info


def _stage_verdicts(pipe, want: dict, got: dict, stages: dict) -> dict:
    """Stage by stage, `got`'s tokens against `want`'s (two DialogResults as
    dicts) by bench_ngram's rule: equal, or the first divergence judged a
    tie-flip or not from the dense forward's logits over the prompt
    `stages[stage]["prompt"]` (a later stage then reads another prompt and
    is not compared)."""
    from usdm_tpu_torch.scripts.bench_ngram import classify_divergence

    verdicts, compared = {}, True
    for stage, toks in want["stage_tokens"].items():
        if not compared:
            verdicts[stage] = {"compared": False}
            continue
        rec = stages[stage]
        verdicts[stage] = classify_divergence(pipe.lm_params, pipe.lm_cfg, rec["prompt"], toks,
                                              got["stage_tokens"][stage], rec["allow"],
                                              pipe.device)
        compared = not verdicts[stage]["divergences"]
    return verdicts


# tiny engines of phase 9 (a): (dtype, draft, prompts, kv pool)
SPEC_SMALL = (("float32", "same", "random", None), ("float32", "random", "random", None),
              ("float32", "ngram", "cyclic", None), ("float32", "ngram", "random", None),
              ("float32", "ngram", "cyclic", "int8"), ("float32", "same", "random", "int8"),
              ("bfloat16", "same", "random", None), ("bfloat16", "ngram", "cyclic", None),
              ("bfloat16", "random", "cyclic", "int8"))


def _spec_small_run(params, draft, cfg, dev, kv, prompts, spec_k, eager=False):
    """One tiny engine (page 8, 12 pages, batch 2, chunk 32, horizon 8) over
    three requests -> (tokens, stats, real pages of its pools)."""
    from usdm_tpu_torch.core.config import EngineConfig
    from usdm_tpu_torch.engine.paged import PagedEngine, Request

    ecfg = EngineConfig(page_size=8, max_pages_per_seq=12, max_batch_size=2, prefill_chunk=32,
                        decode_horizon=8, spec_k=spec_k, kv_dtype=kv)
    eng = PagedEngine(params, cfg, ecfg, device=dev, draft=draft, eager_links=eager)
    r = np.random.default_rng(6)
    allow = np.ones(cfg.vocab_size, bool)
    allow[:3] = False
    if prompts == "cyclic":  # greedy under a 2-token mask cycles: lookup accepts
        allow[:] = False
        allow[40:42] = True
    reqs = eng.run([Request(i, r.integers(3, cfg.vocab_size, int(n)).tolist(), allow, 2, 30)
                    for i, n in enumerate((12, 37, 20))])
    pools = []
    for kvp in (eng.kv, eng.draft_kv):
        if kvp is not None:
            keep = np.arange(kvp.total_pages) % eng.n_pages != eng.n_pages - 1
            pools += [t[:, keep].cpu() for t in (kvp.k_pages, kvp.v_pages)]
    return [q.output_ids for q in reqs], eng.stats(), pools


def spec_small_checks(dev) -> dict:
    """Phase 9 (a): tiny engines (MistralConfig.tiny() with head_dim 32)
    with a draft equal to the target, a random draft, or ngram, on cyclic
    (2-token mask) or random prompts, f32 or bf16 weights, pools of the
    weights' dtype or int8: on the card, rounds replayed from graphs give
    the eager rounds' tokens and pool bits, and the tokens are the card's
    plain engine's (spec_k 0) and, in f32, the CPU port's speculative
    engine's (the CPU rounds bf16 products in other orders than the card).
    Every decode link and round is one replay."""
    import torch

    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.core.tree import tree_map
    from usdm_tpu_torch.models import mistral as LM

    base = MistralConfig.tiny().replace(head_dim=32)
    cpu = {s: LM.init_params(base, torch.Generator().manual_seed(s), "cpu") for s in (0, 9)}
    rounds = replays = 0
    for dtype, draft, prompts, kv in SPEC_SMALL:
        cfg = base.replace(dtype=dtype)
        card = {s: tree_map(lambda a: a.to(dev, LM.torch_dtype(dtype)), p) for s, p in cpu.items()}
        pick = lambda w: {"same": (w[0], cfg), "random": (w[9], cfg), "ngram": "ngram"}[draft]  # noqa: E731
        graphed, st, pools = _spec_small_run(card[0], pick(card), cfg, dev, kv, prompts, 3)
        eager, st_e, pools_e = _spec_small_run(card[0], pick(card), cfg, dev, kv, prompts, 3, True)
        plain, _, _ = _spec_small_run(card[0], None, cfg, dev, kv, prompts, 0)
        case = f"{dtype} {draft} {prompts} kv={kv or dtype}"
        if st["spec_rounds"] <= 0 or st["graph_replays"] != st["steps"] - st["mixed_links"]:
            raise AssertionError(f"spec small {case}: {st['spec_rounds']} rounds, "
                                 f"{st['graph_replays']} replays of {st['steps']} links")
        if graphed != eager or not all(torch.equal(a, b) for a, b in zip(pools, pools_e)):
            raise AssertionError(f"spec small {case}: graphed rounds differ from eager rounds")
        if graphed != plain:
            raise AssertionError(f"spec small {case}: tokens differ from the plain engine's: "
                                 f"{graphed} vs {plain}")
        line = (f"spec small {case}: {st['spec_rounds']} rounds, accept/round "
                f"{st['spec_accept_per_round']}, graphed == eager == plain")
        if dtype == "float32":
            got, _, _ = _spec_small_run(cpu[0], pick(cpu), cfg, "cpu", kv, prompts, 3)
            if got != graphed:
                raise AssertionError(f"spec small {case}: card {graphed} vs CPU {got}")
            line += " == CPU"
        log(line)
        rounds += st["spec_rounds"]
        replays += st["graph_replays"]
    return {"cases": len(SPEC_SMALL), "rounds": rounds, "graph_replays": replays}


def spec_rows_table() -> list:
    """Which float products a verify ran as one product over every column
    (their rows keep the decode link's bits at B*(K+1) rows on this card)
    and which one a column: paged_ops.row_invariance() after the phase."""
    from usdm_tpu_torch.engine import paged_ops

    return [{"device": str(k[0]), "dtype": str(k[1]).replace("torch.", ""), "shape": list(k[2]),
             "b": k[3], "k1": k[4], "one_product": v}
            for k, v in sorted(paged_ops.row_invariance().items(), key=lambda kv: str(kv[0]))]


def _round_launches(name: str, r: dict, layers: int, kk: int) -> None:
    """Phase 9 (d) on a bench run's timed requests (bf16 pools, W8A8
    weights): every link and round one replay; K1 once a target layer per
    link or round, plus K+1 times a draft layer per round and once per
    mirrored step; K6 7 times each of those layers (verify at B*(K+1) = 5
    rows, K6's range)."""
    t, dl = r["timed"], r.get("draft_layers", 0)
    steps, rounds = t["steps"], t["spec_rounds"]
    drafted = dl * ((steps - rounds) + kk * rounds)
    want = {"graph_replays": steps, "k1": layers * steps + drafted, "k1_int8": 0,
            "k6": 7 * (layers * steps + drafted)}
    got = {k: t[k] for k in want}
    if got != want or steps <= 0:
        raise AssertionError(f"{name}: launches {got}, want {want}")


def spec_run(dev) -> dict:
    """Phase 9: speculative decoding.  (a) tiny engines on the card against
    eager rounds, the plain engine and the CPU; (b) bench_ngram and
    bench_spec_degraded, the ports, at full width (W8A8 7B), their JSON
    lines printed, every speculative run identical to plain greedy; (d)
    their timed requests' replays and K1/K6 launches per link and round;
    then the stress port twice with mixed links from one decoding slot on
    (bf16; draft="ngram").  The full-width turns (c) ran in phases 4 and 5.
    -> the results and the phase's K1/K6 launches."""
    import gc

    import torch

    from usdm_tpu_torch.scripts import bench_ngram, bench_spec_degraded, stress_engine

    out = {"small": spec_small_checks(dev)}
    reset_counts()
    ngram = bench_ngram.run(dev)
    print(json.dumps({"bench_ngram": ngram}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    degraded = bench_spec_degraded.run(dev)
    print(json.dumps({"bench_spec_degraded": degraded}), flush=True)
    out["launches"] = launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    for regime, r in ngram["regimes"].items():
        if r["verdict"]["divergences"]:
            raise AssertionError(f"bench_ngram {regime}: W8A8 ngram tokens differ from plain")
        _round_launches(f"bench_ngram {regime} plain", {"timed": r["plain_timed"]}, 32, 5)
        _round_launches(f"bench_ngram {regime} ngram", {"timed": r["ngram_timed"]}, 32, 5)
    for name, r in degraded["runs"].items():
        _round_launches(f"bench_spec_degraded {name}", r, 32, 5)
    out["bench_ngram"] = {k: {f: v[f] for f in ("plain_tok_s", "ngram_tok_s", "speedup",
                                                 "accept_per_round")}
                          for k, v in ngram["regimes"].items()}
    out["bench_spec_degraded"] = {k: {f: v[f] for f in ("tok_s", "spec_rounds",
                                                         "accept_per_round")}
                                  for k, v in degraded["runs"].items()}
    out["stress"] = {}
    for label, kw in (("bf16", dict(draft_mode="none", dtype="bfloat16")),
                      ("ngram", dict(draft_mode="ngram", dtype="float32"))):
        st = stress_engine.run(dev, rounds=2, **kw)
        mixed = sum(r["mixed_links"] for r in st["rounds"])
        spec = sum(r["spec_rounds"] for r in st["rounds"])
        if mixed <= 0 or (label == "ngram") != (spec > 0):
            raise AssertionError(f"stress {label}: {mixed} mixed links, {spec} rounds")
        out["stress"][label] = {"seconds": st["seconds"], "mixed_links": mixed,
                                "spec_rounds": spec}
    out["verify_products"] = spec_rows_table()
    log("speculation: " + json.dumps(out))
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return out


# --------------------------------------------------------------- phase 10
LOAD_MEL_BOUND = 1e-4  # of the peak |mel|: phase 4's mel against the loaded pipeline's
LOAD_WAV_BOUND = 1e-4  # of the peak |wav|
VB_INT8_NRMS_GATE = 1e-2  # usdm_tpu's own gate (scripts/bench_vb_int8.py:72)
LOAD_DISK_BYTES = 21e9  # the full stack's files: LM 14.5 GB, XLS-R 3.8, Voicebox, BigVGAN
LOAD_HOST_SLACK = 1e9  # host bytes a step may add beyond the largest pickled file
DRIFT_SEEDS = (1, 2)  # the ODE noises the W8A8 drift is read at (1: phase 4's turn)


def save_xlsr(path: str, params, cfg, layout: str = "fairseq2") -> None:
    """XLS-R params as a checkpoint both packages' load_xlsr read: fairseq2's
    xlsr2_1b_v2 layout (a `.pt` of {"model": state_dict}, no config: the
    layout the reference ships) or an HF Wav2Vec2Model directory
    (config.json + model.safetensors).  The positional conv is written as
    weight_norm's weight_g/weight_v (dim 2), split on the host in f32.
    usdm_tpu has no XLS-R exporter; this is a check of the loaders, not a
    package feature.  Phase 10 writes the fairseq2 layout; the HF layout is
    for the tests, which import this helper (tests/test_torch_checkpoint.py,
    test_torch_from_pretrained.py and test_torch_cuda.py write tiny XLS-R
    directories with it, since a fairseq2 .pt carries no config): keep its
    signature and both layouts.  The tensors stay on their
    device until the writer copies them to the host one at a time (torch.save
    records a card's tensors as cuda storages; the loaders map them to the
    CPU)."""
    import torch

    from usdm_tpu_torch.core import safetensors as ST
    from usdm_tpu_torch.core.checkpoint import _weight_norm_split

    def host(t):
        return t.detach().to(torch.float32).contiguous()

    fs2 = layout == "fairseq2"
    conv = ("encoder_frontend.feature_extractor.layers.{}" if fs2
            else "feature_extractor.conv_layers.{}")
    feat_ln = "encoder_frontend.post_extract_layer_norm" if fs2 else "feature_projection.layer_norm"
    proj = "encoder_frontend.model_dim_proj" if fs2 else "feature_projection.projection"
    pc = "encoder_frontend.pos_encoder.conv" if fs2 else "encoder.pos_conv_embed.conv"
    names = (("self_attn_layer_norm", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
              "self_attn.output_proj", "ffn_layer_norm", "ffn.inner_proj", "ffn.output_proj")
             if fs2 else
             ("layer_norm", "attention.q_proj", "attention.k_proj", "attention.v_proj",
              "attention.out_proj", "final_layer_norm", "feed_forward.intermediate_dense",
              "feed_forward.output_dense"))
    sd = {}
    for i, c in enumerate(params["convs"]):
        p = conv.format(i)
        sd.update({p + ".conv.weight": host(c["w"]), p + ".conv.bias": host(c["b"]),
                   p + ".layer_norm.weight": host(c["ln_w"]),
                   p + ".layer_norm.bias": host(c["ln_b"])})
    g, v = _weight_norm_split(host(params["pos_conv_w"]).cpu(), dim=2)
    sd.update({feat_ln + ".weight": host(params["feat_ln_w"]),
               feat_ln + ".bias": host(params["feat_ln_b"]),
               proj + ".weight": host(params["proj_w"].t()), proj + ".bias": host(params["proj_b"]),
               pc + ".weight_g": g, pc + ".weight_v": v, pc + ".bias": host(params["pos_conv_b"])})
    for i, lp in enumerate(params["layers"]):
        ln1, q, k, v_, o, ln2, f1, f2 = (f"encoder.layers.{i}.{n}" for n in names)
        for ln, w, b in ((ln1, "ln1_w", "ln1_b"), (ln2, "ln2_w", "ln2_b")):
            sd[ln + ".weight"], sd[ln + ".bias"] = host(lp[w]), host(lp[b])
        for n, w, b in ((q, "wq", "bq"), (k, "wk", "bk"), (v_, "wv", "bv"), (o, "wo", "bo"),
                        (f1, "ffn_w1", "ffn_b1"), (f2, "ffn_w2", "ffn_b2")):
            sd[n + ".weight"], sd[n + ".bias"] = host(lp[w].t()), host(lp[b])
    if fs2:
        torch.save({"model": sd}, path)
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"conv_dim": [cfg.conv_channels] * len(cfg.conv_kernels),
                   "conv_kernel": list(cfg.conv_kernels), "conv_stride": list(cfg.conv_strides),
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_attention_heads": cfg.num_heads, "num_hidden_layers": cfg.num_layers,
                   "num_conv_pos_embeddings": cfg.conv_pos_width,
                   "num_conv_pos_embedding_groups": cfg.conv_pos_groups}, f)
    ST.save_file(sd, os.path.join(path, "model.safetensors"))


WORDS = ("hello", "there", "friend", "how", "are", "you", "today", "it's", "fine", "thanks")
PREP_CLIPS_S = (2.0, 3.5, 5.0, 6.5, 8.0, 9.5, 11.0, 12.0, 45.0)  # the last: past K2's gate


def word_textgrid(rng, seconds: float, zero_width: bool = False) -> str:
    """A long-format TextGrid whose 'words' tier covers `seconds` with words
    and blanks (a leading one, some in the middle, never two in a row, as
    MFA writes them; with `zero_width` a word of no width between two
    others), plus a 'phones' tier the parser must skip."""
    marks, t, bounds = [], 0.0, [0.0]
    while t < seconds - 0.3:
        t = min(round(t + float(rng.uniform(0.15, 0.6)), 2), seconds)
        bounds.append(t)
        blank = not marks or (marks[-1] != "" and rng.random() < 0.2)
        marks.append("" if blank else str(rng.choice(WORDS)))
    if bounds[-1] < seconds and marks[-1] != "":
        bounds.append(seconds)
        marks.append("")
    if zero_width and len(marks) > 4:
        bounds.insert(3, bounds[3])
        marks.insert(3, "uh")
    items = "".join(
        f"        intervals [{i + 1}]:\n            xmin = {a}\n            xmax = {b}\n"
        f"            text = \"{m}\"\n"
        for i, (m, a, b) in enumerate(zip(marks, bounds[:-1], bounds[1:])))
    return (f"File type = \"ooTextFile\"\nObject class = \"TextGrid\"\n\nxmin = 0\n"
            f"xmax = {seconds}\ntiers? <exists>\nsize = 2\nitem []:\n    item [1]:\n"
            f"        class = \"IntervalTier\"\n        name = \"words\"\n        xmin = 0\n"
            f"        xmax = {seconds}\n        intervals: size = {len(marks)}\n{items}"
            f"    item [2]:\n        class = \"IntervalTier\"\n        name = \"phones\"\n"
            f"        xmin = 0\n        xmax = {seconds}\n        intervals: size = 1\n"
            f"        intervals [1]:\n            xmin = 0\n            xmax = {seconds}\n"
            f"            text = \"x\"\n")


def dailytalk_metadata(rng, n_dialogs: int) -> list:
    """DailyTalk metadata lines `{turn}_{speaker}_d{dialog}|wav|text|speaker`,
    shuffled: speakers alternate, except in dialog 1, whose same-speaker
    run drops it."""
    lines = []
    for d in range(n_dialogs):
        for t in range(int(rng.integers(2, 6))):
            spk = t % 2 if d != 1 else 0
            text = " ".join(str(w) for w in rng.choice(WORDS, int(rng.integers(2, 6))))
            lines.append(f"{t}_{spk}_d{d}|{t}_{spk}_d{d}.wav|{text.capitalize()}.|{spk}")
    rng.shuffle(lines)
    return lines


def write_corpus(root: str, seed: int = 0, clips=PREP_CLIPS_S) -> dict:
    """Noise clips at 16 kHz with transcripts (`wavs/`), a word TextGrid over
    each (`tg/`), and DailyTalk metadata over 2-4 s turns laid out as
    `dailytalk/<dialog>/<id>.wav` (dialog 3 the test split) -> their paths."""
    from usdm_tpu_torch.audio.wav import write_wav

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k) for k in ("wavs", "tg", "dailytalk")}
    for d in paths.values():
        os.makedirs(d, exist_ok=True)
    for i, sec in enumerate(clips):
        write_wav(os.path.join(paths["wavs"], f"utt{i}.wav"),
                  (rng.standard_normal(int(16000 * sec)) * 0.1).astype(np.float32), 16000)
        with open(os.path.join(paths["wavs"], f"utt{i}.txt"), "w") as f:
            f.write("Hello, there! It's " + " ".join(rng.choice(WORDS, 3)) + ".")
        with open(os.path.join(paths["tg"], f"utt{i}.TextGrid"), "w") as f:
            f.write(word_textgrid(rng, sec))
    meta = dailytalk_metadata(rng, 4)
    for line in meta:
        did = line.split("|")[0]
        d = os.path.join(paths["dailytalk"], did.split("_")[-1][1:])
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, f"{did}.wav"), (rng.standard_normal(
            int(16000 * rng.uniform(2, 4))) * 0.1).astype(np.float32), 16000)
    test = [m for m in meta if m.split("|")[0].endswith("_d3")]  # whole dialogs a split
    for split, lines in (("train", [m for m in meta if m not in test]), ("test", test)):
        paths[split] = os.path.join(root, f"{split}.txt")
        with open(paths[split], "w") as f:
            f.write("\n".join(lines))
    return paths


def _near_tie_units(params, cfg, wav, got: list) -> dict:
    """`got` (the units of the card's default route) against the same
    extractor with plain attention on the card: equal, or every differing
    frame a near tie, its two centroids' squared distances from the plain
    route's feature within 1e-5 relative -> the counts and the worst gap."""
    import torch

    from usdm_tpu_torch.audio.wav import pad_to_bucket
    from usdm_tpu_torch.models import xlsr as XL

    padded, n = pad_to_bucket(wav, cfg.sample_rate, 0.5)
    dev = params["proj_w"].device
    with torch.no_grad():
        feats, flen = XL.encode(params, cfg, torch.from_numpy(padded[None]).to(dev),
                                torch.tensor([n], device=dev), attn_impl="plain")
        feats = feats[0, : int(flen[0])]
        want = XL.kmeans_assign(feats, params["centroids"]).tolist()
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        gap = 0.0
        c = params["centroids"]
        for i in diff:
            da, db = ((feats[i] - c[got[i]]) ** 2).sum(), ((feats[i] - c[want[i]]) ** 2).sum()
            gap = max(gap, float((da - db).abs() / db))
    if len(got) != len(want) or gap > 1e-5:
        raise AssertionError(f"phase 14: stage1's units leave the plain route's: "
                             f"{len(diff)} of {len(want)} differ, gap {gap}")
    return {"frames": len(want), "differ": len(diff), "worst_gap": gap}


def preprocess_run(dev, xlsr_path: str, kmeans_path: str, tmp: str) -> dict:
    """Phase 14 (inside phase 10, on its export): the preprocessing CLI on
    the card over write_corpus's clips.  (a) stage1 at full width (the
    exported XLS-R, 10,000 centroids): every clip's units equal the same
    params' extract_units_bucketed, K2's f32 route launched on the 45 s clip
    and its units held to the plain-attention route's (_near_tie_units);
    extraction's audio seconds per second logged; (b) stage2 over the
    TextGrids (build_test(num_units=10000)), stage3 to 8,192-token bins with
    the g++ FFD core (efficiency logged), dailytalk, then decoder-filelist;
    (c) the same CLI over a tiny XLS-R (32 centroids, head_dim 8: K2 at d 8
    on clips past 2.56 s), whose outputs the --tiny trainers can index
    (their models have 512 LM ids and 32 Voicebox units): two steps each of
    cli.train_pt on stage3's parts, cli.train_sft on the dailytalk files and
    cli.train_voicebox on the decoder filelist (bf16: K2 and K5 at d 8 and
    16).  -> the phase's numbers and launches."""
    import torch

    from usdm_tpu_torch.audio.wav import load_wav
    from usdm_tpu_torch.cli import preprocess as PP
    from usdm_tpu_torch.cli import train_pt, train_sft, train_voicebox
    from usdm_tpu_torch.core import checkpoint as CK
    from usdm_tpu_torch.core.config import XlsrConfig
    from usdm_tpu_torch.models import xlsr as XL
    from usdm_tpu_torch.ops.flash_attention import flash_attention

    root = os.path.join(tmp, "prep")
    c = write_corpus(root, clips=PREP_CLIPS_S)
    on = ["--device", str(dev)]
    xl = ["--xlsr_dir", xlsr_path, "--kmeans", kmeans_path, *on]
    out = {}

    def cli(name, argv):
        t0 = time.perf_counter()
        if PP.main(argv) != 0:
            raise AssertionError(f"phase 14: preprocess {argv[0]} failed")
        out.setdefault("cli_s", {})[name] = time.perf_counter() - t0

    # (a) full-width stage1
    s1 = os.path.join(root, "s1")
    reset_counts()
    cli("stage1", ["stage1", "--data_path", c["wavs"], "--output_path", s1, *xl])
    k2_stage1 = flash_attention.tf32_launches
    if not k2_stage1:
        raise AssertionError("phase 14: full-width stage1 launched no K2 on the 45 s clip")
    params, cfg = CK.load_xlsr(xlsr_path, kmeans_path, device=dev)
    wavs = [load_wav(os.path.join(c["wavs"], f"utt{i}.wav"), sr=16000)[0]
            for i in range(len(PREP_CLIPS_S))]
    t0 = time.perf_counter()
    units = [XL.extract_units_bucketed(params, cfg, w) for w in wavs]  # .tolist() syncs
    extract_s = time.perf_counter() - t0
    for i, u in enumerate(units):
        with open(os.path.join(s1, f"utt{i}_unit.txt")) as f:
            if f.read() != " ".join(map(str, u)):
                raise AssertionError(f"phase 14: stage1's utt{i} units are not the extractor's")
    out["stage1"] = {"clips_s": list(PREP_CLIPS_S), "k2_launches": k2_stage1,
                     "extract_s": extract_s, "audio_s_per_s": sum(PREP_CLIPS_S) / extract_s,
                     "units_45s_vs_plain": _near_tie_units(params, cfg, wavs[-1], units[-1])}
    del params
    # (b) the rest of the pipeline at full width
    for tg in os.listdir(c["tg"]):
        shutil.copy(os.path.join(c["tg"], tg), s1)
    s2, s3 = os.path.join(root, "s2"), os.path.join(root, "s3")
    cli("stage2", ["stage2", "--data_path", s1, "--output_path", s2])
    cli("stage3", ["stage3", "--data_path", s2, "--output_path", s3])
    with open(os.path.join(s2, "data_epoch1.json")) as f:
        lengths = json.load(f)
    with open(os.path.join(s3, "part0.txt")) as f:
        bins = [len(line.split()) for line in f if line.strip()]
    out["stage3"] = {"rows": len(lengths), "tokens": sum(lengths), "bins": len(bins),
                     "efficiency": sum(bins) / (8192 * len(bins))}
    dt_out, flist = os.path.join(root, "dt"), os.path.join(root, "decoder.txt")
    cli("dailytalk", ["dailytalk", "--train_metadata_path", c["train"], "--test_metadata_path",
                      c["test"], "--data_dir", c["dailytalk"], "--output_path", dt_out, *xl])
    cli("decoder-filelist", ["decoder-filelist", "--wav_dir", c["wavs"], "--output_path", flist,
                             *xl])
    with open(flist) as f:
        if len(f.read().splitlines()) != len(PREP_CLIPS_S):
            raise AssertionError("phase 14: the decoder filelist lacks clips")
    # (c) a tiny extractor's outputs, read by the --tiny trainers
    tcfg = XlsrConfig.tiny().replace(num_clusters=32)
    tx = os.path.join(root, "tiny_xlsr")
    save_xlsr(tx, XL.init_params(tcfg, torch.Generator().manual_seed(3)), tcfg, layout="hf")
    np.save(os.path.join(root, "tiny_kmeans.npy"), np.random.default_rng(1).standard_normal(
        (32, tcfg.hidden_size)).astype(np.float32))
    txl = ["--xlsr_dir", tx, "--kmeans", os.path.join(root, "tiny_kmeans.npy"), *on]
    t1, t2, t3 = (os.path.join(root, f"tiny_s{i}") for i in (1, 2, 3))
    reset_counts()
    cli("tiny stage1", ["stage1", "--data_path", c["wavs"], "--output_path", t1, *txl])
    if not flash_attention.tf32_launches:
        raise AssertionError("phase 14: the tiny extractor launched no K2 at head_dim 8")
    for tg in os.listdir(c["tg"]):
        shutil.copy(os.path.join(c["tg"], tg), t1)
    cli("tiny stage2", ["stage2", "--data_path", t1, "--output_path", t2,
                        "--num_unit_tokens", "32"])
    cli("tiny stage3", ["stage3", "--data_path", t2, "--output_path", t3])
    tdt, tlist = os.path.join(root, "tiny_dt"), os.path.join(root, "tiny_decoder.txt")
    cli("tiny dailytalk", ["dailytalk", "--train_metadata_path", c["train"],
                           "--test_metadata_path", c["test"], "--data_dir", c["dailytalk"],
                           "--output_path", tdt, "--num_unit_tokens", "32", *txl])
    cli("tiny decoder-filelist", ["decoder-filelist", "--wav_dir", c["wavs"], "--output_path",
                                  tlist, *txl])
    trainers = {
        "train_pt": lambda d: train_pt.main(["--tiny", "--data_path", t3, "--output_dir", d,
                                             "--max_steps", "2", "--save_steps", "0",
                                             "--logging_steps", "1", *on]),
        "train_sft": lambda d: train_sft.main(["--tiny", "--train_path",
                                               os.path.join(tdt, "train.txt"), "--output_dir",
                                               d, "--max_steps", "2", "--train_batch_size",
                                               "1", "--logging_steps", "1", *on]),
        "train_voicebox": lambda d: train_voicebox.main([
            "--tiny", "--train_filelist", tlist, "--output_dir", d, "--batch_size", "2",
            "--max_steps", "2", "--out_size_second", "2", "--synthesize_every", "0", *on]),
    }
    out["trainers"] = {}
    for name, run in trainers.items():
        reset_counts()
        t0 = time.perf_counter()
        if run(os.path.join(root, name)) not in (0, None):
            raise AssertionError(f"phase 14: {name} failed")
        counts = {**launch_counts(), **{f"{k}_mma": v for k, v in mma_counts().items()}}
        rows = _train_metrics(os.path.join(root, name))
        out["trainers"][name] = {"s": time.perf_counter() - t0, "steps": len(rows),
                                 "loss": [r.get("train/loss", r.get("loss")) for r in rows],
                                 "launches": {k: v for k, v in counts.items() if v}}
        if not (counts["flash_attention_mma"] and counts["flash_attention_bwd_dq_mma"]
                and counts["flash_attention_bwd_dkv_mma"]):
            raise AssertionError(f"phase 14: {name} did not run K2 and K5 bf16: {counts}")
    log("phase 14 preprocessing: " + json.dumps(out))
    return out


def export_steps(pipe, root: str) -> tuple:
    """Every component of `pipe` as the reference's checkpoint files under
    `root`: the LM (with its tokenizer) by save_mistral_hf, XLS-R as a
    fairseq2 .pt (save_xlsr), the centroids as kmeans.npy, the Voicebox by
    save_voicebox_hub, BigVGAN by save_bigvgan_generator.  -> (from_pretrained's
    paths, [(component, path, writer)])."""
    from usdm_tpu_torch.core import checkpoint as CK

    dirs = {"llm_dir": os.path.join(root, "llm"), "xlsr_dir": os.path.join(root, "xlsr2.pt"),
            "kmeans_path": os.path.join(root, "kmeans.npy"),
            "voicebox_dir": os.path.join(root, "voicebox"),
            "bigvgan_dir": os.path.join(root, "bigvgan")}
    d = pipe.decoder
    steps = [
        ("llm", dirs["llm_dir"], lambda: CK.save_mistral_hf(
            dirs["llm_dir"], pipe.lm_params, pipe.lm_cfg, pipe.tokenizer)),
        ("xlsr", dirs["xlsr_dir"], lambda: save_xlsr(
            dirs["xlsr_dir"], pipe.xlsr_params, pipe.xlsr_cfg)),
        ("kmeans", dirs["kmeans_path"], lambda: np.save(
            dirs["kmeans_path"], pipe.xlsr_params["centroids"].cpu().numpy())),
        ("voicebox", dirs["voicebox_dir"], lambda: CK.save_voicebox_hub(
            dirs["voicebox_dir"], d.voicebox_params, d.voicebox_cfg)),
        ("bigvgan", dirs["bigvgan_dir"], lambda: CK.save_bigvgan_generator(
            dirs["bigvgan_dir"], d.vocoder_params, d.vocoder_cfg)),
    ]
    return dirs, steps


def _file_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def _largest_pickle(root: str) -> int:
    """Bytes of the largest .pt/.bin file under `root`: what torch.load holds
    on the host at once (a safetensors file is mapped tensor by tensor)."""
    return max((os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(root) for f in fs
                if f.endswith((".pt", ".bin"))), default=0)


def _rss() -> int:
    """VmRSS of this process, bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _host_step(fn) -> tuple:
    """(fn(), wall seconds, VmRSS before the step, the largest VmRSS sampled
    every 2 ms while it ran).  Sampled, since the card's machine refuses
    /proc/self/clear_refs, which would reset VmHWM for the step."""
    import threading

    import torch

    rss0 = _rss()
    peak = [rss0]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.002):
            peak[0] = max(peak[0], _rss())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    wall = time.perf_counter() - t0
    return out, wall, rss0, max(peak[0], _rss())


def _agent_mel(pipe, units, seed: int) -> tuple:
    """(the normalized mel [1, n_mels, n] that pipe.decoder.synthesize(units,
    seed=seed) vocodes (no reference): the same rows, bucket and generator;
    the initial noise z the ODE started from, cut to the same frames)."""
    import torch

    from usdm_tpu_torch.audio.units import expand_and_pool
    from usdm_tpu_torch.models import voicebox as VB

    dec = pipe.decoder
    mc, dev = dec.mel_cfg, dec.device
    pooled, _ = expand_and_pool(np.asarray(units), mc.sampling_rate, mc.token_sr, mc.hop_size)
    n, t = len(pooled), dec._bucket(len(pooled))
    x = torch.zeros((1, t), dtype=torch.int64, device=dev)
    x[0, :n] = torch.from_numpy(pooled.astype(np.int64)).to(dev)
    cond = torch.zeros((1, mc.num_mels, t), device=dev)
    z = torch.randn(cond.shape, generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)  # generate's own first draw from that generator
    with torch.no_grad():
        mel = VB.generate(dec.voicebox_params, dec.voicebox_cfg, x, cond,
                          torch.tensor([n], device=dev), n_timesteps=50, z=z)
    return mel[:, :, :n].float().cpu().numpy(), z[:, :, :n].cpu().numpy()


def _loaded_turn(pipe, wav_in: str, want: dict, label: str) -> dict:
    """One graphed respond() turn of a loaded pipeline as phase 4 runs it
    (seed 1, budgets 48/32/256): the user units and every stage's tokens
    must equal phase 4's (`want`), and K1, K2 and K3 must have launched."""
    import dataclasses

    import torch

    reset_counts()
    trace = {}
    t0 = time.perf_counter()
    res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, n_timesteps=50, seed=1,
                                   trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    mma = mma_counts()["flash_attention"]
    got = {**dataclasses.asdict(res), "user_units": list(trace["user_units"])}
    audio = trace["audio"]
    audio_s = len(audio) / pipe.decoder.mel_cfg.sampling_rate
    info = {"wall_s": wall, "xlsr_s": trace["xlsr_s"], "dialog_s": trace["dialog_s"],
            "synth_s": trace["synth_s"], "audio_s": audio_s,
            "rtf": wall / audio_s if audio_s else None,
            "tokens": "equal" if got == want else "DIFFER", "launches": counts,
            "flash_attention_mma_launches": mma}
    log(f"phase 10, {label} turn: " + json.dumps(info))
    if got != want:
        raise AssertionError(f"phase 10 {label}: the loaded pipeline's turn differs from phase "
                             f"4's: {got} vs {want}")
    if not (counts["paged_decode_attention"] and mma and counts["flash_attention_f32"]
            and counts["fused_activation1d"] == K3_PER_TURN):
        raise AssertionError(f"phase 10 {label}: a kernel of the path did not launch: {counts}")
    info["audio"] = audio
    return info


def load_run(dev, pipe, wav_in: str, want: dict, want_audio, tmp: str, smi: str) -> dict:
    """Phase 10: export phase 4's full-width pipeline to the reference's
    checkpoint formats, load it back with UsdmPipeline.from_pretrained
    (vb_int8=False: phase 4's turn, the mel and wav within their bounds; then
    the default vb_int8=True: the same dialog tokens, the mel within nRMS
    1e-2 of the float one at each of DRIFT_SEEDS), run the port of
    scripts/bench_vb_int8.py, and print the cold-start numbers as one JSON
    line.  The export and each load may add at most the largest pickled
    file plus LOAD_HOST_SLACK of host memory: the LM's safetensors never
    sits there whole."""
    import gc
    import shutil

    import torch

    from usdm_tpu_torch.core.config import VoiceboxConfig
    from usdm_tpu_torch.pipeline import UsdmPipeline
    from usdm_tpu_torch.scripts import bench_vb_int8

    pipe.close()  # phase 4's engine pools and dense caches
    root = os.path.join(tmp, "checkpoints")
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < LOAD_DISK_BYTES:
        raise AssertionError(f"phase 10 needs {LOAD_DISK_BYTES:.0f} bytes of local disk under "
                             f"{root} for the full stack's files; {free} bytes are free")
    try:
        mel4, _ = _agent_mel(pipe, want["agent_units"], seed=1)
        dirs, steps = export_steps(pipe, root)
        export, rss_start, rss_peak = {}, _rss(), 0
        for name, path, write in steps:
            gc.collect()
            _, wall, rss0, peak = _host_step(write)
            n = _file_bytes(path)
            export[name] = {"wall_s": wall, "bytes_written": n, "gb_per_s": n / wall / 1e9,
                            "host_bytes_added": peak - rss0}
            rss_peak = max(rss_peak, peak)
        files = {k: v["bytes_written"] for k, v in export.items()}
        export_s = sum(v["wall_s"] for v in export.values())
        export_host = rss_peak - rss_start
        host_bound = _largest_pickle(root) + LOAD_HOST_SLACK
        log(f"phase 10 export: {export_s:.1f} s, {sum(files.values())} bytes, host memory "
            f"added {export_host} bytes (bound {host_bound:.0f}: the largest pickled file + "
            f"{LOAD_HOST_SLACK:g}); by component {json.dumps(export)}")
        if export_host > host_bound:
            raise AssertionError(f"phase 10: the export added {export_host} bytes of host "
                                 f"memory, more than {host_bound:.0f}")
        loads, out = {}, {}
        for label, vb_int8 in (("float", False), ("default", True)):
            alloc0 = torch.cuda.memory_allocated()
            loaded, load_s, rss0, peak = _host_step(
                lambda: UsdmPipeline.from_pretrained(**dirs, vb_int8=vb_int8, device=dev))
            load_host = peak - rss0
            alloc = torch.cuda.memory_allocated()
            try:
                log(f"phase 10 {label} load: host memory added {load_host} bytes (bound "
                    f"{host_bound:.0f})")
                if load_host > host_bound:
                    raise AssertionError(f"phase 10: the {label} load added {load_host} bytes "
                                         f"of host memory, more than {host_bound:.0f}")
                turn = _loaded_turn(loaded, wav_in, want, label)
                mels = {seed: _agent_mel(loaded, want["agent_units"], seed=seed)
                        for seed in DRIFT_SEEDS}
            finally:
                loaded.close()
                del loaded
                gc.collect()
                torch.cuda.empty_cache()
            audio = turn.pop("audio")
            mel, z = mels[DRIFT_SEEDS[0]]
            if label == "float":
                mel_err = float(np.abs(mel - mel4).max())
                wav_err = float(np.abs(audio - want_audio).max()) if len(audio) == len(
                    want_audio) else float("inf")
                mel_peak, wav_peak = float(np.abs(mel4).max()), float(np.abs(want_audio).max())
                turn.update(mel_max_abs_err=mel_err, mel_peak=mel_peak, wav_max_abs_err=wav_err,
                            wav_peak=wav_peak)
                log(f"phase 10 float load against phase 4: mel max|d| {mel_err:.3e} (bound "
                    f"{LOAD_MEL_BOUND:g} x peak {mel_peak:.3e}), wav max|d| {wav_err:.3e} (bound "
                    f"{LOAD_WAV_BOUND:g} x peak {wav_peak:.3e})")
                if not (mel_err <= LOAD_MEL_BOUND * mel_peak
                        and wav_err <= LOAD_WAV_BOUND * wav_peak):
                    raise AssertionError("phase 10: the loaded pipeline's mel or wav is out of "
                                         "bounds of phase 4's")
                mel_float = {seed: m for seed, (m, _) in mels.items()}
                # how far the f32 estimator's velocity moved the mel from its
                # initial noise: the part that W8A8 products can reach
                turn["ode_share"] = float(np.sqrt(np.mean((mel - z) ** 2))
                                          / np.sqrt(np.mean(mel ** 2)))
            else:
                nrms = {seed: float(np.sqrt(np.mean((m - mel_float[seed]) ** 2))
                                    / np.sqrt(np.mean(mel_float[seed] ** 2)))
                        for seed, (m, _) in mels.items()}
                turn["mel_nrms_vs_float"] = nrms[DRIFT_SEEDS[0]]
                turn["mel_nrms_vs_float_by_seed"] = nrms
                log(f"phase 10 default (vb_int8) load: mel nRMS against the float load's, by "
                    f"ODE seed, {nrms} (gate {VB_INT8_NRMS_GATE:g}); the float mel's "
                    f"ode_share {out['float']['ode_share']:.4f}")
                if not max(nrms.values()) < VB_INT8_NRMS_GATE:
                    raise AssertionError(f"phase 10: the W8A8 Voicebox drifts {nrms}, not all "
                                         f"< {VB_INT8_NRMS_GATE}")
            read = sum(files.values())
            loads[label] = {"load_s": load_s, "bytes_read": files,
                            "gb_per_s": read / load_s / 1e9,
                            "host_bytes_added": load_host, "host_bytes_bound": host_bound,
                            "device_bytes_after_load": alloc, "device_bytes_added": alloc - alloc0}
            out[label] = turn
        t0 = time.perf_counter()
        prep = preprocess_run(dev, dirs["xlsr_dir"], dirs["kmeans_path"], tmp)
        log(f"phase time: preprocessing (phase 14) {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    bench = bench_vb_int8.run(VoiceboxConfig(), dev)
    print(json.dumps({"bench_vb_int8": bench}), flush=True)
    log(f"phase time: bench_vb_int8 {time.perf_counter() - t0:.1f} s")
    cold = {"card": smi, "export": {"wall_s": export_s, "bytes_written": files,
                                    "gb_per_s": sum(files.values()) / export_s / 1e9,
                                    "host_bytes_added": export_host,
                                    "host_bytes_bound": host_bound, "by_component": export},
            "load": loads,
            "turn": {k: {f: v[f] for f in ("wall_s", "rtf", "dialog_s", "synth_s")}
                     for k, v in out.items()}}
    print(json.dumps({"cold_start": cold}), flush=True)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return {"turns": out, "cold_start": cold, "bench_vb_int8": bench, "preprocess": prep}


# --------------------------------------------------------------- phase 11
LM_SEGMENTS = (5000, 2000, 1192)  # one packed 8,192-token row; the first segment is longer
# than the 4,096-token window, so the window masks keys inside it
LM_T = sum(LM_SEGMENTS)
LM_WRITE_BYTES = 15e9  # (b)'s bf16 export of the 7B, 14.6 GB; (d) and (e) write ~0.1 GB
TRAIN_LR = 1e-3  # large enough that one AdamW step moves a weight by more than its bf16 ulp
# host memory (b) may add beyond the budget's moments: the profiler's event
# buffers of its traced step, the export's host copy of one tensor at a
# time, the page tables that pin the 54.6 GiB registered buffer
LM_HOST_SLACK_GB = 3.0


def _lm_rows(n: int, vocab: int, seed: int) -> list:
    """`n` packed rows of LM_SEGMENTS, each segment BOS (1)-led, random ids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        row = rng.integers(3, vocab, LM_T)
        row[np.cumsum((0,) + LM_SEGMENTS[:-1])] = 1
        out.append(row.tolist())
    return out


def _lm_seg_pos(dev):
    """The segment ids and positions pack_collate gives one LM_SEGMENTS row."""
    import torch

    from usdm_tpu_torch.data.collators import pack_collate

    b = pack_collate(_lm_rows(1, 100, 0), pad_id=99)
    return (torch.from_numpy(b["segment_ids"]).to(dev),
            torch.from_numpy(b["positions"]).to(dev))


def row_ratio(got, want, rows: slice) -> float:
    """The largest err / bound over `rows` (dim 1 of [B, T, H, d]), each row
    held to its own bf16_bound: 2^-7 * max|want[row]| + 1e-4."""
    g, w = got[:, rows].float(), want[:, rows].float()
    err = (g - w).abs().amax(dim=(0, 2, 3))
    return float((err / (2.0**-7 * w.abs().amax(dim=(0, 2, 3)) + 1e-4)).max())


def window_rows_check(name: str, got, want, rows: slice, nowin,
                      without: str = "the window") -> dict:
    """The rows where the window masks keys of their own segment, each held
    to its own bound (the whole tensor's bound comes from its largest rows,
    the early ones, and lets a kernel that ignores the window pass there).
    Negative control: `nowin`, the same kernel run without the window (or
    without what `without` names), must fail the same check."""
    import torch

    ratio, control = row_ratio(got, want, rows), row_ratio(nowin, want, rows)
    ok = bool(torch.isfinite(got.float()).all()) and ratio <= 1.0 < control
    log(f"  {name} [rows {rows.start}-{rows.stop - 1}, each to its own bound] err/bound "
        f"{ratio:.3f}; without {without} {control:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the window rows' err/bound {ratio} (must be <= 1), "
                             f"the negative control's {control} (must be > 1)")
    return {"err_over_bound": ratio, "control_err_over_bound": control}


def lm_kernel_checks(dev) -> dict:
    """Phase 11 (a): K2 and K5 at the 7B training shape (bf16, B 1, T 8192,
    GQA 32/8, d 128, causal, window 4096, segments 5000 + 2000 + 1192)
    against their plain versions with round_operands=True (bound 2^-7 *
    max|want| + 1e-4 per output; the log-sum-exp 1e-4; the rows where the
    window bites, each to its own bound, against the same kernels run
    without the window as a negative control), then eager and
    CUDA-graph times, each bound, the plain versions' times and
    scaled_dot_product_attention's with the same boolean mask (K/V repeated
    to 32 heads outside the timed call), forward and backward."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    gen = torch.Generator(device=dev).manual_seed(11)
    h, hkv, d, window = 32, 8, 128, 4096
    seg, pos = _lm_seg_pos(dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, do = randn(1, LM_T, h, d), randn(1, LM_T, h, d)
    k, v = randn(1, LM_T, hkv, d), randn(1, LM_T, hkv, d)
    mask = attn_mask(seg, seg, pos, pos, True, window)
    by_window = int((attn_mask(seg, seg, pos, pos, True, None) & ~mask).sum())
    if not by_window:
        raise AssertionError("phase 11 (a): the window masks no key")
    case = "LM bf16 B=1 T=8192 GQA 32/8 d=128 causal window 4096 segments 5000+2000+1192"
    log(f"phase 11 (a) K2 / K5 at the 7B training shape: {case}; the window masks {by_window} "
        f"(query, key) pairs of the causal segments")
    # segment 0 holds positions 0-4999: queries 4097-4999 lose keys 0 to
    # (pos - 4097) to the window (attn_mask keeps pos_q - pos_k <= window)
    win_q, win_k = slice(window + 1, LM_SEGMENTS[0]), slice(0, LM_SEGMENTS[0] - window - 1)
    o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, True, window, return_lse=True)
    o_nw, lse_nw = FL.flash_attention(q, k, v, seg, seg, pos, pos, True, None, return_lse=True)
    want_o, want_lse = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, True, window,
                                                    None, False, True)
    errs = {"fwd": check("K2", f"{case} o", o, want_o, bf16_bound(want_o))}
    check("K2 lse", case, lse, want_lse, 1e-4)
    rows = {"K2 o": window_rows_check("K2 o", o, want_o, win_q, o_nw)}
    del want_o, want_lse
    ref_args = (q, k, v, o, lse, do, seg, seg, pos, pos, True, window, None, False)
    want = FL.flash_attention_bwd_reference(*ref_args, True)
    got = FL.flash_attention_bwd(*ref_args)
    nowin = FL.flash_attention_bwd(q, k, v, o_nw, lse_nw, do, seg, seg, pos, pos, True, None,
                                   None, False)
    out = [check("K5", f"{case} {n}", g, w, bf16_bound(w))
           for n, g, w in zip(("dq", "dk (summed over the GQA group)", "dv"), got, want)]
    errs["dq"], errs["dkv"] = out[0], max(out[1:])
    for n, g, w, c, r in zip(("K5 dq", "K5 dk", "K5 dv"), got, want, nowin,
                             (win_q, win_k, win_k)):
        rows[n] = window_rows_check(n, g, w, r, c)
    del want, got, nowin, o_nw, lse_nw
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, seg, seg, pos, pos, True, window, None, False)
    calls = {"fwd": lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos, True, window),
             "dq": lambda: FL.flash_attention_bwd_dq(*args),
             "dkv": lambda: FL.flash_attention_bwd_dkv(*args)}
    eager = {n: cuda_ms(fn) for n, fn in calls.items()}
    graph = {n: graph_ms(lambda fn=fn: [fn() for _ in range(10)], dev) / 10
             for n, fn in calls.items()}
    plain = {"fwd": cuda_ms(lambda: FL.flash_attention_reference(
                 q, k, v, seg, seg, pos, pos, True, window, None, False, True)),
             "bwd": cuda_ms(lambda: FL.flash_attention_bwd_reference(*ref_args, True))}
    pairs = h * int(mask.sum())
    ins = nbytes(q, k, v, do, lse, delta, seg, pos)
    bounds = {"fwd": least_time(2 * nbytes(q) + nbytes(k, v, seg, pos), 4 * d * pairs, "bf16"),
              "dq": least_time(ins + nbytes(q), 6 * d * pairs, "bf16"),
              "dkv": least_time(ins + nbytes(k, v), 8 * d * pairs, "bf16")}
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // hkv, dim=2).transpose(1, 2).detach().requires_grad_()
              for x in (k, v))
    sdpa_mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        library_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask))
    ot = sdpa(qt, kt, vt, attn_mask=sdpa_mask)
    dot = do.transpose(1, 2)
    library_bwd = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    info = {"case": case, "pairs": pairs, "window_masked_pairs": by_window, "max_abs_err": errs,
            "window_rows": rows,
            "ms": eager, "graph_ms": graph, "plain_ms": plain,
            "bound_ms": {n: b["bound_ms"] for n, b in bounds.items()},
            "bound_by": {n: b["bound_by"] for n, b in bounds.items()},
            "library_ms": {"sdpa_fwd": library_fwd, "sdpa_bwd": library_bwd},
            "tflops_graph": {n: {"fwd": 4, "dq": 6, "dkv": 8}[n] * d * pairs / ms / 1e9
                             for n, ms in graph.items()}}
    log("phase 11 (a) lm_train_kernels: " + json.dumps(info))
    del q, k, v, do, o, lse, delta, qt, kt, vt, ot, mask, sdpa_mask
    return info


def _train_metrics(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def _free_device() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _pt_run(dev, root: str, smi: str) -> dict:
    """Phase 11 (b): python -m usdm_tpu_torch.cli.train_pt --offload at full
    width (MistralConfig(), 32 layers, random init), batch 1 of 8,192-token
    rows, 3 steps, exported as an HF dir.  Step 1 runs under the profiler
    (the device's busy share); steps 2 and 3 run without it and give the
    step time and tokens/s."""
    import torch

    from usdm_tpu_torch.cli import train_pt
    from usdm_tpu_torch.core import safetensors as ST
    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import lm as T

    cfg = MistralConfig()
    steps, seed = 3, 42
    rows = os.path.join(root, "rows")
    os.makedirs(rows)
    with open(os.path.join(rows, "part0.txt"), "w") as f:
        for row in _lm_rows(steps, cfg.vocab_size, 1):
            f.write(" ".join(map(str, row)) + "\n")
    out, hf = os.path.join(root, "pt"), os.path.join(root, "pt_hf")
    hbm = torch.cuda.get_device_properties(dev).total_memory / 2**30
    budget = T.memory_budget(cfg, dp=1, tp=1, seq_len=LM_T, batch_per_chip=1, offload=True,
                             hbm_gb=hbm)
    _free_device()
    reset_counts()
    rc, wall, rss0, rss_peak = _host_step(lambda: train_pt.main([
        "--data_path", rows, "--output_dir", out, "--max_steps", str(steps),
        "--train_batch_size", "1", "--max_input_length", str(LM_T), "--offload",
        "--logging_steps", "1", "--save_steps", "0", "--profile_steps", "1",
        "--learning_rate", str(TRAIN_LR), "--seed", str(seed), "--export_hf", hf,
        "--device", str(dev)]))
    counts = launch_counts()
    mma = mma_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = _train_metrics(out)
    with open(os.path.join(out, "trace", "summary.json")) as f:
        prof = json.load(f)
    launches = {k: counts[k] for k in ("flash_attention", "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")}
    want = {"flash_attention": 2 * steps * cfg.num_layers,  # forward and remat recompute
            "flash_attention_bwd_dq": steps * cfg.num_layers,
            "flash_attention_bwd_dkv": steps * cfg.num_layers}
    host_gb = (rss_peak - rss0) / 2**30
    info = {"rc": rc, "wall_s": wall, "steps": [
        {k.split("/")[-1]: r[k] for k in ("step", "train/loss", "train/grad_norm",
                                            "train/step_s", "train/max_memory_gib")}
        for r in metrics],
        "profiled_step_1": prof, "max_memory_allocated_gib": peak,
        "budget_device_gb": budget["device_gb"], "budget_host_gb": budget["host_gb"],
        "host_memory_added_gib": host_gb, "host_memory_after_gib": (_rss() - rss0) / 2**30,
        "launches": launches,
        "mma_launches": {k: mma[k] for k in launches}, "card": smi,
        "tokens_per_s": LM_T / statistics.median(r["train/step_s"] for r in metrics[1:])}
    log("phase 11 (b) train_pt --offload, full width: " + json.dumps(info))
    with open(os.path.join(out, "trace", "kernels.txt")) as f:
        lines = f.read().splitlines()
    log("phase 11 (b) the profiled step's device time by name:\n"
        + "\n".join(lines[:20] + lines[-3:]))
    if rc != 0 or len(metrics) != steps or not np.isfinite([r["train/loss"] for r in metrics]).all():
        raise AssertionError(f"phase 11 (b): {len(metrics)} steps logged, rc {rc}")
    if launches != want or any(mma[k] != n for k, n in launches.items()):
        raise AssertionError(f"phase 11 (b): K2/K5 launched {launches} ({mma} on the bf16 route), "
                             f"want {want}")
    if peak > budget["device_gb"]:
        raise AssertionError(f"phase 11 (b): {peak:.2f} GiB of device memory over the budget's "
                             f"{budget['device_gb']:.2f}")
    if host_gb > budget["host_gb"] + LM_HOST_SLACK_GB:
        raise AssertionError(f"phase 11 (b): {host_gb:.2f} GiB of host memory added, the budget "
                             f"says {budget['host_gb']:.2f} + {LM_HOST_SLACK_GB}")
    # the parameters moved once lr > 0: layer 0 of the init (init_params draws layer by
    # layer, so depth 1 from the same seed draws the CLI's layer 0) against the export
    init = M.init_params(cfg.replace(num_layers=1), torch.Generator(device=dev).manual_seed(seed),
                         dev, dtype="float32")["layers"][0]
    f = ST.SafeOpen(os.path.join(hf, "model.safetensors"))
    moved = {}
    for name, key in (("wq", "self_attn.q_proj"), ("w_down", "mlp.down_proj")):
        exported = f.get_tensor(f"model.layers.0.{key}.weight").to(dev).float().t()
        moved[name] = float((exported != init[name].to(torch.bfloat16).float()).float().mean())
    del init
    log(f"phase 11 (b) share of layer 0's weights the 3 steps moved (bf16 export against the "
        f"bf16 init): {moved}")
    if not all(x > 0.5 for x in moved.values()):
        raise AssertionError(f"phase 11 (b): the parameters did not move: {moved}")
    return {"info": info, "hf": hf, "launches": launches}


def _offload_equals_resident(dev) -> dict:
    """Phase 11 (c): make_train_step on an init_offload_state state against
    it on an init_state state at full width and depth 2, 3 steps on the same 8,192-token rows from the same
    f32 masters: the same arithmetic with the moments on the host, so the
    params and moments must come out bit for bit (bound 0: both run the
    same deterministic kernels in the same order on one stream)."""
    import torch

    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.data.collators import pack_collate
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import lm as T

    cfg = MistralConfig().replace(num_layers=2)
    tc = TrainConfig(batch_size=1, max_steps=3, learning_rate=TRAIN_LR)
    init = M.init_params(cfg, torch.Generator(device=dev).manual_seed(5), dev, dtype="float32")
    res = T.init_state(cfg, tc, dev, params=init)
    off = T.init_offload_state(cfg, tc, dev, params={**init, "layers": [
        {k: w.clone() for k, w in lp.items()} for lp in init["layers"]],
        "embed": init["embed"].clone(), "lm_head": init["lm_head"].clone(),
        "final_norm": init["final_norm"].clone()})
    del init
    step = T.make_train_step(cfg, tc)
    times = {"resident": [], "offload": []}
    losses = {"resident": [], "offload": []}
    for row in _lm_rows(3, cfg.vocab_size, 2):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pack_collate([row], 42002).items()}
        for name, state in (("resident", res), ("offload", off)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[name].append(float(step(state, batch)["loss"]))
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    pairs = list(zip(tree_leaves(res.params) + res.opt_state.m + res.opt_state.v,
                     tree_leaves(off.params) + off.opt_state.m + off.opt_state.v))
    diff = max(float((a.detach() - b.detach().to(dev)).abs().max()) for a, b in pairs)
    info = {"max_abs_diff": diff, "losses": losses, "step_s": times}
    log("phase 11 (c) offload step against the resident step (full width, 2 layers, 3 steps): "
        + json.dumps(info))
    if diff != 0.0 or losses["resident"] != losses["offload"]:
        raise AssertionError(f"phase 11 (c): the offload step leaves the resident one by {diff}")
    del res, off, pairs
    return info


def _sft_rows(path: str, vocab: int, n: int, seed: int) -> None:
    """`n` ids|labels lines of ~1,536 tokens, the first (user) half masked."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            t = int(rng.integers(1400, 1600))
            ids = [1] + rng.integers(3, vocab, t - 1).tolist()
            labels = [-100] * (t // 2) + ids[t // 2:]
            f.write(" ".join(map(str, ids)) + "|" + " ".join(map(str, labels)) + "\n")


def _captured_trainer(run):
    """run() with cli.lm_trainer.make_trainer recording the Trainer it
    builds -> (run()'s result, that Trainer: its base and trained state)."""
    from usdm_tpu_torch.cli import lm_trainer as LT

    made, real = [], LT.make_trainer
    LT.make_trainer = lambda *a, **kw: made.append(real(*a, **kw)) or made[-1]
    try:
        return run(), made[0]
    finally:
        LT.make_trainer = real


def _sft_lora_run(dev, root: str, hf: str) -> dict:
    """Phase 11 (d): cli.train_sft --lora at full width and depth from (b)'s
    export, 3 steps of batch 2 of ~1,536-token rows, the user half masked.
    The CLI's base after training equals (b)'s export bit for bit, the
    adapters moved, and merge_lora (what --export_hf writes, less its bf16
    rounding) gives the logits of base + adapters on one row within 2^-10
    of the adapters' own effect on them (f32 compute on both sides; only
    the order of the sums differs).  The merged export is not written on
    the card (see lm_train_run)."""
    import torch

    from usdm_tpu_torch.cli import train_sft
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.data.collators import sft_collate
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import lora as LO

    data, out = os.path.join(root, "sft.txt"), os.path.join(root, "sft_lora")
    _sft_rows(data, 42003, 6, 3)
    _free_device()
    reset_counts()
    t0 = time.perf_counter()
    rc, trainer = _captured_trainer(lambda: train_sft.main([
        "--model_dir", hf, "--train_path", data, "--output_dir", out, "--max_steps", "3",
        "--train_batch_size", "2", "--lora", "--logging_steps", "1",
        "--learning_rate", str(TRAIN_LR), "--device", str(dev)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = _train_metrics(out)
    base, lora = trainer.base, trainer.state.params
    exported, cfg = ckpt.load_mistral(hf, dtype="bfloat16", device=dev)
    same_base = all(torch.equal(a, b.float()) for a, b in zip(tree_leaves(base),
                                                              tree_leaves(exported)))
    del exported
    b_moved = max(float(lw[k]["b"].detach().abs().max()) for lw in lora for k in lw)
    ids = torch.from_numpy(sft_collate(_sft_line(data), 42002)["input_ids"]).to(dev)
    f32 = cfg.replace(dtype="float32")
    with torch.no_grad():
        side = M.forward(base, f32, ids, lora=lora)
        merged = M.forward(LO.merge_lora(base, lora), f32, ids)
        effect = float((side - M.forward(base, f32, ids)).abs().max())
    err = float((side - merged).abs().max())
    info = {"rc": rc, "wall_s": wall, "loss": [r["train/loss"] for r in metrics],
            "step_s": [r["train/step_s"] for r in metrics], "max_memory_allocated_gib": peak,
            "k2_launches": k2, "base_bit_unchanged": bool(same_base), "adapter_b_max": b_moved,
            "logits_max_abs_err": err, "adapters_effect_max_abs": effect,
            "logits_peak": float(side.abs().max()),
            "argmax_agree": float((side.argmax(-1) == merged.argmax(-1)).float().mean())}
    log("phase 11 (d) train_sft --lora, full width and depth: " + json.dumps(info))
    del base, lora, trainer, side, merged
    if rc != 0 or len(metrics) != 3 or k2 != 2 * 3 * 32:
        raise AssertionError(f"phase 11 (d): rc {rc}, {len(metrics)} steps, {k2} K2 launches")
    if not (same_base and b_moved > 0):
        raise AssertionError(f"phase 11 (d): base unchanged {same_base}, adapters moved {b_moved}")
    if not err <= 2.0**-10 * effect:
        raise AssertionError(f"phase 11 (d): merged logits leave base + adapters by {err}, "
                             f"against the adapters' own effect {effect}")
    return info


def _sft_line(path: str):
    from usdm_tpu_torch.cli.train_sft import read_sft_file

    return read_sft_file(path)[:1]


def _sft_resume_run(dev, root: str) -> dict:
    """Phase 11 (e): cli.train_sft every parameter, resident, --tiny on the
    card (see lm_train_run): 4 steps of batch 2 saving at 2 and 4, then a
    run resumed from the first run's step 2 must reach its step 4 bit for
    bit (params, moments, count)."""
    import torch

    from usdm_tpu_torch.cli import train_sft
    from usdm_tpu_torch.core.tree import tree_leaves

    data = os.path.join(root, "sft_tiny.txt")
    _sft_rows(data, 512, 8, 4)
    runs = {}
    for name in ("a", "b"):
        out = os.path.join(root, f"sft_full_{name}")
        if name == "b":
            os.makedirs(os.path.join(out, "checkpoints", "step_2"))
            shutil.copy(os.path.join(runs["a"]["out"], "checkpoints", "step_2", "state.pt"),
                        os.path.join(out, "checkpoints", "step_2", "state.pt"))
        reset_counts()
        t0 = time.perf_counter()
        rc = train_sft.main(["--tiny", "--train_path", data, "--output_dir", out,
                             "--max_steps", "4", "--train_batch_size", "2", "--save_steps", "2",
                             "--logging_steps", "1", "--learning_rate", str(TRAIN_LR),
                             "--device", str(dev)] + (["--resume"] if name == "b" else []))
        torch.cuda.synchronize()
        runs[name] = {"out": out, "rc": rc, "wall_s": time.perf_counter() - t0,
                      "k5_dkv_launches": launch_counts()["flash_attention_bwd_dkv"],
                      "loss": [r["train/loss"] for r in _train_metrics(out)]}
    states = [torch.load(os.path.join(runs[n]["out"], "checkpoints", "step_4", "state.pt"),
                         map_location="cpu", weights_only=True) for n in "ab"]
    ta, tb = ([*tree_leaves(s["params"]), *s["opt_state"]["m"], *s["opt_state"]["v"]]
              for s in states)
    equal = (states[0]["step"] == states[1]["step"] == 4
             and all(torch.equal(x, y) for x, y in zip(ta, tb)))
    info = {n: {k: v for k, v in r.items() if k != "out"} for n, r in runs.items()}
    info["resumed_equals_uninterrupted"] = bool(equal)
    log("phase 11 (e) train_sft every parameter, resident, --tiny, resumed at step 2 of 4: "
        + json.dumps(info))
    if not equal or any(r["rc"] for r in runs.values()):
        raise AssertionError("phase 11 (e): the resumed run's step 4 differs from the "
                             "uninterrupted run's")
    if not all(r["k5_dkv_launches"] for r in runs.values()):
        raise AssertionError("phase 11 (e): K5 did not launch")
    return info


def lm_train_run(dev, smi: str) -> dict:
    """Phase 11: (a) K2/K5 at the 7B training shape, (b) train_pt --offload
    at full width, (c) the offload step against the resident step, (d)
    train_sft --lora from (b)'s export, (e) train_sft with --resume.  Runs
    last, on an empty card.  The whole run keeps its disk writes, deleted
    files included, within 45 GiB: phases 6 and 10 write ~24.5 GB and
    (b)'s export 14.6 GB, so (d) checks the merge in process rather than
    writing the merged 14.6 GB export, and (e) runs --tiny rather than
    writing three 14.6 GB depth-4 train states (the CPU tests run both CLI
    paths whole).  -> the results; "launches": (b)'s K2/K5."""
    _free_device()
    t0 = time.perf_counter()
    kernels = lm_kernel_checks(dev)
    _free_device()
    log(f"phase time: 11 (a) {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        free = shutil.disk_usage(root).free
        log(f"phase 11: {free} bytes of local disk free under {root}")
        if free < LM_WRITE_BYTES:
            raise AssertionError(f"phase 11 needs {LM_WRITE_BYTES:.0f} bytes of local disk under "
                                 f"{root}; {free} bytes are free")
        out = {"kernels": kernels}
        for key, fn in (("pt", lambda: _pt_run(dev, root, smi)),
                        ("offload", lambda: _offload_equals_resident(dev)),
                        ("lora", lambda: _sft_lora_run(dev, root, out["pt"]["hf"])),
                        ("resume", lambda: _sft_resume_run(dev, root))):
            t0 = time.perf_counter()
            out[key] = fn()
            _free_device()
            log(f"phase time: 11 {key} {time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    out["launches"] = out["pt"]["launches"]
    return out


# --------------------------------------------------------------- phase 12
GAN_B, GAN_SEG = 32, 8192  # usdm_tpu's train_vocoder defaults: batch 32 of 8,192-sample crops
# the activations' (channels, samples) for one 8,192-sample crop (32 mel frames)
GAN_STAGES = ((768, 128), (384, 512), (192, 1024), (96, 2048), (48, 4096), (24, 8192))
K3_PER_GAN_STEP = 2 * K3_PER_TURN  # the disc step's generator forward and the gen step's
GAN_STEPS = 3
K3_GRAD_BOUND = 1e-5  # of each gradient's peak: the Function's backward against autograd
DISTILL_B, DISTILL_SEGMENTS = 2, (2500, 1000, 596)  # two packed 4,096-token rows
DISTILL_T = sum(DISTILL_SEGMENTS)
DISTILL_LAYERS = 8  # cli.train_draft's default --draft_layers


def k3_grad_checks(dev) -> dict:
    """Phase 12 (a): K3's autograd Function at the six stage shapes of a
    full-width generator, at (b)'s batch (32 of an 8,192-sample crop), f32,
    snake-beta, log-scale: its forward within K3's bound (1e-4) of the plain version,
    and its dx, dalpha, dbeta within 1e-5 of each gradient's peak of
    autograd through activation1d_reference on the card (the Function's
    backward recomputes that composition, so they agree to the last bits
    or exactly).  Negative control: the bare launch's output carries no
    grad_fn, so a gradient cannot reach alpha, beta or x through it, and
    the check can tell.  Times: the forward (K3), the backward (the
    recompute) and the plain forward + backward, per stage."""
    import torch

    from usdm_tpu_torch.ops import fused_act as FA

    gen = torch.Generator(device=dev).manual_seed(12)
    stages, errs = [], {"fwd": 0.0, "dx": 0.0, "dalpha": 0.0, "dbeta": 0.0}
    for ch, tlen in GAN_STAGES:
        x = torch.randn(GAN_B, ch, tlen, generator=gen, device=dev).requires_grad_()
        a = (torch.randn(ch, generator=gen, device=dev) * 0.3).requires_grad_()
        b = (torch.randn(ch, generator=gen, device=dev) * 0.3).requires_grad_()
        g = torch.randn(GAN_B, ch, tlen, generator=gen, device=dev)
        y = FA.fused_activation1d(x, a, b, True)
        want = FA.activation1d_reference(x, a, b, True)
        errs["fwd"] = max(errs["fwd"], check("K3 Function forward",
                                             f"B={GAN_B} C={ch} T={tlen} f32", y, want, 1e-4))
        got = torch.autograd.grad(y, (x, a, b), g, retain_graph=True)
        ref = torch.autograd.grad(want, (x, a, b), g, retain_graph=True)
        for name, gv, rv in zip(("dx", "dalpha", "dbeta"), got, ref):
            bound = K3_GRAD_BOUND * float(rv.abs().max())
            errs[name] = max(errs[name], check(f"K3 Function {name}",
                                               f"B={GAN_B} C={ch} T={tlen}", gv, rv, bound)
                             / float(rv.abs().max()))
        bare = FA._launch(x.detach(), a.detach(), b.detach(), True)
        if y.grad_fn is None or bare.grad_fn is not None or bare.requires_grad:
            raise AssertionError("phase 12 (a): the Function's output has no grad_fn, or the "
                                 "bare launch's has one")
        st = {"C": ch, "T": tlen,
              "fwd_ms": cuda_ms(lambda: FA.fused_activation1d(x, a, b, True)),
              "bwd_ms": cuda_ms(lambda: torch.autograd.grad(y, (x, a, b), g, retain_graph=True)),
              "plain_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                  FA.activation1d_reference(x, a, b, True), (x, a, b), g))}
        stages.append(st)
        del x, a, b, g, y, want, got, ref, bare
    info = {"batch": GAN_B, "fwd_max_abs_err": errs.pop("fwd"), "grad_max_err_over_peak": errs,
            "stages": stages,
            "negative_control": "the bare launch's output has no grad_fn"}
    log("phase 12 (a) K3 autograd Function: " + json.dumps(info))
    return info


def _write_gan_corpus(root: str, n: int) -> tuple:
    """`n` 22,050 Hz clips of 2-4 s, each a linear chirp plus noise, and a
    filelist of their names."""
    from usdm_tpu_torch.audio.wav import write_wav

    rng = np.random.default_rng(12)
    wavs = os.path.join(root, "gan_wavs")
    os.makedirs(wavs)
    names = []
    for i in range(n):
        sec = float(rng.uniform(2.0, 4.0))
        tt = np.arange(int(22050 * sec)) / 22050
        f0, f1 = rng.uniform(80, 400), rng.uniform(1000, 6000)
        wav = 0.5 * np.sin(2 * np.pi * (f0 * tt + (f1 - f0) * tt**2 / (2 * sec)))
        wav = wav + 0.05 * rng.standard_normal(len(tt))
        write_wav(os.path.join(wavs, f"clip{i}.wav"), wav.astype(np.float32), 22050)
        names.append(f"clip{i}")
    filelist = os.path.join(root, "gan_train.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(f"{n}|chirp" for n in names))
    return wavs, filelist


def _gan_profile(dev, wavs: str, filelist: str, out_dir: str) -> dict:
    """One GAN iteration (disc step, gen step) of a fresh full-width state
    on a batch of the corpus, after one warm-up iteration, under
    profile_trace: wall, busy share, the top device ops by self time, the
    K3 backward recompute's span (fused_activation1d.backward) and K3's
    forward launches."""
    import torch

    from usdm_tpu_torch.core.config import BigVGANConfig, MelConfig
    from usdm_tpu_torch.core.logging import profile_trace, union_seconds
    from usdm_tpu_torch.data.mel_dataset import (MelAudioDataset, collate_mel_batch,
                                                 loss_mel_config, read_vocoder_filelist)
    from usdm_tpu_torch.ops import fused_act as FA
    from usdm_tpu_torch.train import vocoder as V

    cfg, mc = BigVGANConfig(), MelConfig()
    state, gopt, dopt = V.init_state(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    disc_step, gen_step = V.make_train_steps(cfg, gopt, dopt, loss_mel_config(mc))
    ds = MelAudioDataset(read_vocoder_filelist(filelist, wavs), GAN_SEG, mc)
    rng = np.random.default_rng(0)
    batch = collate_mel_batch([ds.__getitem__(i, rng) for i in range(GAN_B)], mc, dev)
    disc_step(state, batch)
    gen_step(state, batch)
    reset_counts()
    trace = os.path.join(out_dir, "gan_trace")
    spans = []
    with profile_trace(trace):
        with torch.profiler.record_function("gan_iteration"):
            disc_step(state, batch)
            gen_step(state, batch)
    with open(os.path.join(trace, "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(trace, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    for e in events:
        if e.get("name") == FA.BACKWARD_SPAN and e.get("cat") == "gpu_user_annotation":
            spans.append((e["ts"], e["ts"] + e["dur"]))
    recompute_s = union_seconds([(max(a, s), min(b, t)) for a, b in kernels for s, t in spans
                           if min(b, t) > max(a, s)])
    with open(os.path.join(trace, "kernels.txt")) as f:
        table = f.read().splitlines()
    info = {**summary, "k3_launches": launch_counts()["fused_activation1d"],
            "k3_backward_spans_on_device": len(spans), "k3_backward_recompute_s": recompute_s,
            "k3_backward_recompute_share_of_busy": recompute_s / summary["busy_s"]
            if spans else None}
    log("phase 12 (b) one profiled GAN iteration: " + json.dumps(info))
    log("phase 12 (b) its device time by name:\n" + "\n".join(table[:24] + table[-3:]))
    del state, batch
    return info


def vocoder_train_run(dev, root: str, out_dir: str, smi: str) -> dict:
    """Phase 12 (b): python -m usdm_tpu_torch.cli.train_vocoder at full
    width (BigVGANConfig(), MPD periods 2-11, MRD at the three default
    resolutions), batch 32 of 8,192-sample crops from 96 synthetic chirp
    clips, 3 steps, --export: per step the wall, losses, mel L1 and peak
    device memory; K3 218 launches a step; the export loaded by
    load_bigvgan equals the trained generator (every weight within 2^-21
    of its peak |w|: the reference layout's weight-norm split and fold
    round a weight by about an ulp; biases and snake parameters bit for
    bit); then one profiled iteration (_gan_profile)."""
    import torch

    from usdm_tpu_torch.cli import train_vocoder
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core.tree import tree_leaves

    wavs, filelist = _write_gan_corpus(root, GAN_STEPS * GAN_B)
    out, exp = os.path.join(root, "gan"), os.path.join(root, "gan_export")
    _free_device()
    reset_counts()
    t0 = time.perf_counter()
    rc = train_vocoder.main(["--output_dir", out, "--input_wavs_dir", wavs,
                             "--input_training_file", filelist, "--max_steps", str(GAN_STEPS),
                             "--batch_size", str(GAN_B), "--segment_size", str(GAN_SEG),
                             "--export", exp, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = launch_counts()["fused_activation1d"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(out, "metrics.jsonl")) as f:
        metrics = [r for r in map(json.loads, f) if "train/gen_loss" in r]
    saved = torch.load(os.path.join(out, "checkpoints", f"step_{GAN_STEPS}", "state.pt"),
                       map_location="cpu", weights_only=True)
    loaded, _ = ckpt.load_bigvgan(exp, device="cpu")
    worst, exact = 0.0, True
    for (key, got), want in zip(_named_leaves(loaded), tree_leaves(saved["params"]["gen"])):
        if key.endswith("w"):
            worst = max(worst, float((got - want).abs().max()) / float(want.abs().max()))
        else:
            exact = exact and torch.equal(got, want)
    n_gen = sum(t.numel() for t in tree_leaves(saved["params"]["gen"]))
    n_disc = sum(t.numel() for k in ("mpd", "mrd") for t in tree_leaves(saved["params"][k]))
    state_bytes = _file_bytes(os.path.join(out, "checkpoints", f"step_{GAN_STEPS}"))
    del saved, loaded
    info = {"rc": rc, "wall_s": wall, "card": smi, "generator_params": n_gen,
            "discriminator_params": n_disc, "batch": GAN_B, "segment": GAN_SEG,
            "steps": [{k.split("/")[-1]: r.get(k) for k in
                       ("step", "train/disc_loss", "train/gen_loss", "train/gen_adv",
                        "train/gen_fm", "train/gen_mel_l1", "train/step_s",
                        "train/max_memory_gib")} for r in metrics],
            "max_memory_allocated_gib": peak, "k3_launches": k3,
            "export_weight_err_over_peak": worst, "export_other_leaves_bit_equal": exact,
            "train_state_bytes": state_bytes, "export_bytes": _file_bytes(exp)}
    log("phase 12 (b) train_vocoder, full width: " + json.dumps(info))
    if rc != 0 or len(metrics) != GAN_STEPS or not all(
            np.isfinite([r["train/gen_loss"], r["train/disc_loss"]]).all() for r in metrics):
        raise AssertionError(f"phase 12 (b): rc {rc}, {len(metrics)} steps logged")
    if k3 != GAN_STEPS * K3_PER_GAN_STEP:
        raise AssertionError(f"phase 12 (b): K3 launched {k3} times in {GAN_STEPS} steps, want "
                             f"{GAN_STEPS * K3_PER_GAN_STEP}")
    if not (worst <= 2.0**-21 and exact):
        raise AssertionError(f"phase 12 (b): the export loads back {worst} of a weight's peak "
                             f"off, other leaves equal: {exact}")
    _free_device()
    info["profile"] = _gan_profile(dev, wavs, filelist, out_dir)
    return info


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _distill_batch(vocab: int, seed: int, dev) -> dict:
    """DISTILL_B packed rows of DISTILL_SEGMENTS, each segment BOS-led."""
    import torch

    from usdm_tpu_torch.data.collators import pack_collate

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(DISTILL_B):
        row = rng.integers(3, vocab, DISTILL_T)
        row[np.cumsum((0,) + DISTILL_SEGMENTS[:-1])] = 1
        rows.append(row.tolist())
    return {k: torch.from_numpy(v).to(dev) for k, v in pack_collate(rows, vocab - 1).items()}


def distill_kernel_checks(dev) -> dict:
    """Phase 12 (c)'s K2 and K5 at one layer of the distill step (bf16, B 2,
    T 4096, GQA 32/8, d 128, causal, window 4096, segments 2500 + 1000 +
    596 as _distill_batch packs them) against their plain versions with
    round_operands=True: o, dq, dk (summed over the GQA group) and dv
    within 2^-7 * max|want| + 1e-4, the log-sum-exp within 1e-4.  Negative
    control: the same kernels run with one segment id for the whole row
    (the positions still restart) must fail, each row held to its own
    bound, on the rows the segments separate: the queries of segments 2-3
    (o, dq) and the keys of segments 1-2 (dk, dv)."""
    import torch

    from usdm_tpu_torch.core.config import MistralConfig
    from usdm_tpu_torch.ops import flash_attention as FL

    cfg = MistralConfig()
    h, hkv, d, window = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window
    batch = _distill_batch(cfg.vocab_size, 19, dev)
    seg, pos = batch["segment_ids"], batch["positions"]
    one = torch.zeros_like(seg)
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, do = randn(DISTILL_B, DISTILL_T, h, d), randn(DISTILL_B, DISTILL_T, h, d)
    k, v = randn(DISTILL_B, DISTILL_T, hkv, d), randn(DISTILL_B, DISTILL_T, hkv, d)
    case = (f"distill bf16 B={DISTILL_B} T={DISTILL_T} GQA {h}/{hkv} d={d} causal window "
            f"{window} segments {'+'.join(map(str, DISTILL_SEGMENTS))}")
    log(f"phase 12 (c) K2 / K5 at the distill step's shape: {case}")
    later_q = slice(DISTILL_SEGMENTS[0], DISTILL_T)
    early_k = slice(0, DISTILL_SEGMENTS[0] + DISTILL_SEGMENTS[1])
    o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, True, window, return_lse=True)
    o1, lse1 = FL.flash_attention(q, k, v, one, one, pos, pos, True, window, return_lse=True)
    want_o, want_lse = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, True, window,
                                                    None, False, True)
    errs = {"fwd": check("K2", f"{case} o", o, want_o, bf16_bound(want_o))}
    check("K2 lse", case, lse, want_lse, 1e-4)
    rows = {"K2 o": window_rows_check("K2 o", o, want_o, later_q, o1, "the segments")}
    del want_o, want_lse
    ref_args = (q, k, v, o, lse, do, seg, seg, pos, pos, True, window, None, False)
    want = FL.flash_attention_bwd_reference(*ref_args, True)
    got = FL.flash_attention_bwd(*ref_args)
    control = FL.flash_attention_bwd(q, k, v, o1, lse1, do, one, one, pos, pos, True, window,
                                     None, False)
    out = [check("K5", f"{case} {n}", g, w, bf16_bound(w))
           for n, g, w in zip(("dq", "dk (summed over the GQA group)", "dv"), got, want)]
    errs["dq"], errs["dkv"] = out[0], max(out[1:])
    for n, g, w, c, r in zip(("K5 dq", "K5 dk", "K5 dv"), got, want, control,
                             (later_q, early_k, early_k)):
        rows[n] = window_rows_check(n, g, w, r, c, "the segments")
    info = {"case": case, "max_abs_err": errs, "segment_rows": rows}
    log("phase 12 (c) distill_kernels: " + json.dumps(info))
    del q, k, v, do, o, lse, o1, lse1, want, got, control
    return info


def _distill_steps(dev, step, state, target, label: str) -> dict:
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = []
    for i in range(3):
        batch = _distill_batch(state.params["embed"].shape[0], 20 + i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, target, batch)
        vals = {k: float(v) for k, v in m.items()}
        wall = time.perf_counter() - t0
        out.append({**vals, "step_s": wall, "tokens_per_s": DISTILL_B * DISTILL_T / wall,
                    "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    counts, mma = launch_counts(), mma_counts()
    launches = {k: counts[k] for k in ("flash_attention", "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")}
    want = {"flash_attention": 3 * (32 + 2 * DISTILL_LAYERS),
            "flash_attention_bwd_dq": 3 * DISTILL_LAYERS,
            "flash_attention_bwd_dkv": 3 * DISTILL_LAYERS}
    info = {"steps": out, "launches": launches, "mma_launches": {k: mma[k] for k in launches},
            "stream_qmv": counts["stream_qmv"]}
    log(f"phase 12 (c) distill steps, {label} target: " + json.dumps(info))
    if launches != want or any(mma[k] != n for k, n in launches.items()):
        raise AssertionError(f"phase 12 (c) {label}: K2/K5 launched {launches} ({mma}), "
                             f"want {want}")
    if not all(np.isfinite(s["loss"]) and s["ntokens"] > 0 for s in out):
        raise AssertionError(f"phase 12 (c) {label}: {out}")
    return info


def distill_run(dev, smi: str) -> dict:
    """Phase 12 (c): the distill step at full width, in process: K2 and K5
    at one of its layers against their plain versions
    (distill_kernel_checks), a random
    MistralConfig() target in bf16 (7.24 B parameters), the oracle (the
    whole target as its own draft: agree >= 0.95, loss < 0.05, usdm_tpu's
    own check), then an 8-layer early-exit draft (f32 masters, resident
    AdamW, remat) for 3 steps of 2 packed 4,096-token rows against the
    bf16 target and 3 against the W8A8 target (quantize_llm_params; a
    fresh draft from it, as --quantize_target makes one): per step wall,
    tokens/s, loss, agree and peak memory; K2 48 and K5 8 + 8 launches a
    step, all on the bf16 route.  The train state is not written (the
    run's disk budget)."""
    import torch

    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.models.quant import quantize_llm_params
    from usdm_tpu_torch.train import distill as DI
    from usdm_tpu_torch.train import lm as T

    _free_device()
    kernels = distill_kernel_checks(dev)
    _free_device()
    cfg = MistralConfig()
    target = M.init_params(cfg, torch.Generator(device=dev).manual_seed(7), dev)
    target_gb = sum(t.numel() * t.element_size() for t in tree_leaves(target)) / 1e9
    with torch.no_grad():
        _, oracle = DI.distill_loss_fn(target, target, cfg, cfg, _distill_batch(cfg.vocab_size,
                                                                                 19, dev))
    oracle = {k: float(v) for k, v in oracle.items()}
    log(f"phase 12 (c) oracle, the whole target as its own draft: {json.dumps(oracle)}")
    if not (oracle["agree"] >= 0.95 and oracle["loss"] < 0.05):
        raise AssertionError(f"phase 12 (c): the oracle gives {oracle}")
    tc = TrainConfig(batch_size=DISTILL_B, max_steps=1000, learning_rate=1e-4)
    out = {"kernels": kernels, "oracle": oracle, "target_gb": target_gb, "card": smi}
    for label in ("bf16", "w8a8"):
        if label == "w8a8":
            quantize_llm_params(target)
            _free_device()
        draft, cfg_d = DI.init_draft_from_target(target, cfg, DISTILL_LAYERS)
        state = T.init_state(cfg_d, tc, dev, params=draft)
        del draft
        masters = sum(t.numel() for t in tree_leaves(state.params))
        step = DI.make_distill_step(cfg_d, cfg, tc)
        res = _distill_steps(dev, step, state, target, label)
        res.update({"draft_params": masters, "draft_masters_gb": 4 * masters / 1e9,
                    "moments_gb": 8 * masters / 1e9,
                    "target_gb": sum(t.numel() * t.element_size()
                                     for t in tree_leaves(target)) / 1e9})
        out[label] = res
        del state, step
        _free_device()
    del target
    _free_device()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return out


# phase 12 (d)'s K1 geometry: MistralConfig.tiny() at head_dim 32 (K1's
# least), its bf16 pools in 16-token pages, 16 pages a sequence, window 64
K1_TINY = {"hkv": 2, "group": 2, "d": 32, "page": 16, "max_pages": 16, "window": 64}


def k1_tiny_checks(dev) -> float:
    """K1 at phase 12 (d)'s shapes against its plain version: B 1 and 2 (the
    decode links of a 2-slot engine) and 8 (the verify step's B x (K + 1)
    rows at spec_k 3), contexts 1-256 across page edges and the window,
    shuffled page tables, bound 2^-7 * max|want| + 1e-4.  Negative control:
    the kernel run without the window (or with half of it) must exceed the
    bound where the window cuts most of a 200-token context.
    -> the largest error."""
    import torch

    from usdm_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator(device=dev).manual_seed(14)
    c = K1_TINY

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    errs = []
    for b in (1, 2, 8):
        n_pages = b * c["max_pages"] + 1
        kp, vp = (randn(c["hkv"], n_pages, c["page"], c["d"]) for _ in range(2))
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev).to(torch.int32)
        table = perm[: b * c["max_pages"]].reshape(b, c["max_pages"]).contiguous()
        for seq in (1, 15, 16, 17, 64, 65, 200, 256):
            lens = torch.full((b,), seq, dtype=torch.int32, device=dev)
            lens[1:] = torch.randint(1, seq + 1, (b - 1,), generator=gen, device=dev)
            q = randn(b, c["hkv"], c["group"], c["d"])
            want = PA.paged_decode_attention_reference(q, kp, vp, table, lens, c["window"])
            bound = bf16_bound(want)
            errs.append(check("K1", f"d=32 B={b} seq={seq} window={c['window']}",
                              PA.paged_decode_attention(q, kp, vp, table, lens, c["window"]),
                              want, bound))
            if seq == 200:
                for wrong in (None, c["window"] // 2):
                    err = max_err(PA.paged_decode_attention(q, kp, vp, table, lens, wrong), want)
                    log(f"  K1 [d=32 B={b} seq={seq}] kernel with window {wrong} against the "
                        f"plain version with {c['window']}: max_abs_err={err:.3e}, must exceed "
                        f"{bound:.3e}")
                    if err <= bound:
                        raise AssertionError(f"phase 12 (d): the K1 bound cannot tell window "
                                             f"{wrong} from {c['window']}")
    return max(errs)


def draft_cli_run(dev, root: str) -> dict:
    """Phase 12 (d): cli.train_draft at tiny width on the card from a tiny
    target dir (MistralConfig.tiny() at head_dim 32;
    save_mistral_hf; loaded in bf16 as --model_dir loads it),
    a 1-layer draft, 4 steps saving at 2 and 4, then a run resumed from
    step 2 reaches step 4 bit for bit (params, moments, count); the
    --export_hf dir, loaded by load_mistral as --draft_dir loads it, drafts
    for a PagedEngine over the target (spec_k 3): its greedy tokens equal
    plain greedy's, and K1 launches; before it, K1 at those shapes against
    its plain version (k1_tiny_checks)."""
    import torch

    from usdm_tpu_torch.cli import train_draft
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.engine.paged import PagedEngine, Request
    from usdm_tpu_torch.models import mistral as M

    k1_err = k1_tiny_checks(dev)
    rng = np.random.default_rng(13)
    rows = os.path.join(root, "draft_rows")
    os.makedirs(rows)
    with open(os.path.join(rows, "part0.txt"), "w") as f:
        for _ in range(8):
            segs = [[1] + rng.integers(3, 500, int(rng.integers(40, 120))).tolist()
                    for _ in range(3)]
            f.write(" ".join(str(t) for s in segs for t in s) + "\n")
    cfg = MistralConfig.tiny(vocab_size=512).replace(head_dim=K1_TINY["d"])  # K1: d 32-128
    tdir = os.path.join(root, "draft_target")
    ckpt.save_mistral_hf(tdir, M.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                                             dtype="float32"), cfg)
    common = ["--model_dir", tdir, "--data_path", rows, "--device", str(dev),
              "--draft_layers", "1", "--max_steps", "4", "--save_steps", "2",
              "--logging_steps", "1", "--chunk", "64", "--learning_rate", "1e-3"]
    a, b, hf = (os.path.join(root, n) for n in ("draft_a", "draft_b", "draft_hf"))
    rc_a = train_draft.main(common + ["--output_dir", a, "--export_hf", hf])
    os.makedirs(os.path.join(b, "checkpoints"))
    shutil.copytree(os.path.join(a, "checkpoints", "step_2"),
                    os.path.join(b, "checkpoints", "step_2"))
    rc_b = train_draft.main(common + ["--output_dir", b, "--resume"])
    sa, sb = (torch.load(os.path.join(p, "checkpoints", "step_4", "state.pt"),
                         map_location="cpu", weights_only=True) for p in (a, b))
    ta = tree_leaves(sa["params"]) + sa["opt_state"]["m"] + sa["opt_state"]["v"]
    tb = tree_leaves(sb["params"]) + sb["opt_state"]["m"] + sb["opt_state"]["v"]
    resumed = sa["step"] == sb["step"] == 4 and all(torch.equal(x, y) for x, y in zip(ta, tb))
    tparams, tcfg = ckpt.load_mistral(tdir, dtype="bfloat16", device=dev)
    dparams, dcfg = ckpt.load_mistral(hf, dtype="bfloat16", device=dev)
    ecfg = EngineConfig(page_size=16, max_pages_per_seq=16, max_batch_size=2, prefill_chunk=16)
    allow = np.ones(tcfg.vocab_size, bool)
    prompts = [rng.integers(3, 500, 40).tolist(), rng.integers(3, 500, 23).tolist()]

    def reqs():
        return [Request(i, list(p), allow, eos_id=2, max_new_tokens=32)
                for i, p in enumerate(prompts)]

    reset_counts()
    spec = PagedEngine(tparams, tcfg, ecfg.replace(spec_k=3), device=dev, draft=(dparams, dcfg))
    got = [r.output_ids for r in spec.run(reqs())]
    k1 = launch_counts()["paged_decode_attention"]
    want = [r.output_ids for r in PagedEngine(tparams, tcfg, ecfg, device=dev).run(reqs())]
    info = {"rc": [rc_a, rc_b], "resumed_equals_uninterrupted": bool(resumed),
            "spec_rounds": spec.spec_rounds, "tokens": "equal" if got == want else "DIFFER",
            "k1_launches": k1, "new_tokens": [len(x) for x in got]}
    log("phase 12 (d) train_draft --tiny, resume and the exported draft served: "
        + json.dumps(info))
    if rc_a or rc_b or not resumed:
        raise AssertionError(f"phase 12 (d): the resumed run differs from the uninterrupted "
                             f"one: {info}")
    if got != want or not spec.spec_rounds or not k1:
        raise AssertionError(f"phase 12 (d): the distilled draft's speculative tokens differ "
                             f"from plain greedy's, or nothing speculated: {info}")
    del spec, tparams, dparams
    return {**info, "launches": {"paged_decode_attention": k1}, "k1_max_abs_err": k1_err}


def gan_distill_run(dev, out_dir: str, smi: str) -> dict:
    """Phase 12: (a) K3's autograd Function, (b) cli.train_vocoder at full
    width, (c) the distill step at full width, (d) cli.train_draft at tiny
    width with resume and its draft served.  Runs after phase 11, on an
    emptied card; writes ~2.4 GB ((b)'s train state and export).
    -> the results; "launches": K3 of (b), K2/K5 of (c), K1 of (d);
    "max_abs_err": each of those kernels' largest error against its plain
    version at the shapes these paths give it ((a), and the checks that
    open (c) and (d))."""
    out = {}
    _free_device()
    t0 = time.perf_counter()
    out["k3_grad"] = k3_grad_checks(dev)
    log(f"phase time: 12 (a) {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        for key, fn in (("gan", lambda: vocoder_train_run(dev, root, out_dir, smi)),
                        ("distill", lambda: distill_run(dev, smi)),
                        ("draft_cli", lambda: draft_cli_run(dev, root))):
            t0 = time.perf_counter()
            out[key] = fn()
            _free_device()
            log(f"phase time: 12 {key} {time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    d = out["distill"]
    out["launches"] = {"fused_activation1d": out["gan"]["k3_launches"],
                       **{k: d["bf16"]["launches"][k] + d["w8a8"]["launches"][k]
                          for k in d["bf16"]["launches"]},
                       "paged_decode_attention": out["draft_cli"]["launches"][
                           "paged_decode_attention"]}
    dk = d["kernels"]["max_abs_err"]
    out["max_abs_err"] = {"fused_activation1d": out["k3_grad"]["fwd_max_abs_err"],
                          "flash_attention": dk["fwd"], "flash_attention_bwd_dq": dk["dq"],
                          "flash_attention_bwd_dkv": dk["dkv"],
                          "paged_decode_attention": out["draft_cli"]["k1_max_abs_err"]}
    return out


# ------------------------------------------------------- parent vs change
def _reply(obj: dict) -> None:
    print("RESULT " + json.dumps(obj), flush=True)


def _worker_kernels(dev) -> dict:
    """K2's f32 cases (b) and (c) beside one scaled_dot_product_attention
    call on the same f32 operands, K1 at its two timed cases over 32 layer
    regions, K6 at M 1 / 8 / 16 at the four 7B projection shapes, K4's
    forward and autograd backward at the training shape, K3 at the six
    BigVGAN stage shapes (f32) and K5's f32 route at the small f32 train
    step's and the full-width f32 CFM step's attention (dq, dk/dv and the
    whole backward), through the public wrappers (the same in parent and
    change): eager and CUDA-graph ms."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import quant_kv_token
    from usdm_tpu_torch.models import quant as Q
    from usdm_tpu_torch.ops import flash_attention as FL
    from usdm_tpu_torch.ops import fused_act as FA
    from usdm_tpu_torch.ops import fused_ln as LN
    from usdm_tpu_torch.ops import paged_attention as PA
    from usdm_tpu_torch.ops import stream_matvec as SM

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for key, (b, t, d, alibi, short) in {"b": (2, 449, 64, True, 301),
                                          "c": (1, 2100, 80, False, 2100)}.items():
        q, k, v = (torch.randn(b, t, 16, d, generator=gen, device=dev) for _ in range(3))
        pos = torch.arange(t, device=dev)[None].expand(b, t)
        seg = torch.where(pos < torch.tensor([[t], [short]], device=dev)[:b], 0, -1)
        args = (q, k, v, seg, seg, pos, pos, False, None, d**-0.5, alibi)
        bias = None
        if alibi:
            slopes = FL.alibi_slopes_pow2(16).to(dev)[None, :, None, None]
            dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
            bias = torch.where((seg >= 0)[:, None, None, :],
                               -slopes * dist * (pos[:, None, None, :] != 0),
                               torch.finfo(torch.float32).min)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

        out[f"k2_{key}"] = {
            "ms": cuda_ms(lambda: FL.flash_attention(*args)),
            "graph_ms": graph_ms(lambda: [FL.flash_attention(*args) for _ in range(10)], dev) / 10,
            "sdpa_ms": cuda_ms(sdpa),
            "sdpa_graph_ms": graph_ms(lambda: [sdpa() for _ in range(10)], dev) / 10}
        del q, k, v, qt, kt, vt, bias
    hkv, g, d, n_layers = 8, 4, 128, 32
    for key, (page, b, kv) in {"k1_bf16": (64, 1, "bf16"), "k1_int8": (256, 8, "int8")}.items():
        maxp = -(-4200 // page)
        n_pages = b * maxp + 1
        nt = n_layers * n_pages
        scales = {}
        if kv == "bf16":
            kp, vp = (torch.randn(hkv, nt, page, d, generator=gen, device=dev).bfloat16()
                      for _ in range(2))
        else:
            (kp, ks), (vp, vs) = (quant_kv_token(torch.randn(hkv, nt, page, d, generator=gen,
                                                             device=dev)) for _ in range(2))
            scales = {"k_scales": ks.transpose(0, 1).contiguous(),
                      "v_scales": vs.transpose(0, 1).contiguous()}
            del ks, vs
        table = torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * maxp]
        table = table.to(torch.int32).reshape(b, maxp)
        tables = [(table + li * n_pages).contiguous() for li in range(n_layers)]
        lens = torch.full((b,), 700, dtype=torch.int32, device=dev)
        lens[b // 2] = 350 if b > 1 else 700
        q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()

        def step():
            return [PA.paged_decode_attention(q, kp, vp, tb, lens, 4096, **scales)
                    for tb in tables]

        out[key] = {"ms": cuda_ms(step) / n_layers, "graph_ms": graph_ms(step, dev) / n_layers}
        del kp, vp, scales
    # K6 at M 1 / 8 / 16 over 8 weights in turn, the four 7B projections
    for dout, din in ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096)):
        ws = [Q.quantize_weight(torch.randn(din, dout, generator=gen, device=dev) * 0.02)
              for _ in range(8)]
        for m in (1, 8, 16):
            y = torch.randn(m, din, generator=gen, device=dev).bfloat16()

            def calls():
                return [SM.stream_qmv(y, w) for w in ws]

            out[f"k6_{dout}x{din}_m{m}"] = {"ms": cuda_ms(calls) / 8,
                                            "graph_ms": graph_ms(calls, dev) / 8}
        del ws
    # K4 at the training shape, bf16: the forward, and the backward as the
    # trainer runs it (autograd through add_mask_ln)
    lens = torch.tensor([1379, 900, 1379, 1200, 640, 1379, 1000, 1301], device=dev,
                        dtype=torch.int32)
    x, r, go = (torch.randn(8, 1379, 1024, generator=gen, device=dev).bfloat16()
                for _ in range(3))
    w, b = (torch.randn(1024, generator=gen, device=dev).bfloat16() for _ in range(2))
    leaves = [a.detach().requires_grad_() for a in (x, r, w, b)]
    o = LN.add_mask_ln(*leaves[:2], lens, *leaves[2:], True)
    out["k4"] = {"fwd_ms": cuda_ms(lambda: LN.add_mask_ln(x, r, lens, w, b, True)),
                 "fwd_graph_ms": graph_ms(lambda: [LN.add_mask_ln(x, r, lens, w, b, True)
                                                   for _ in range(10)], dev) / 10,
                 "bwd_ms": cuda_ms(lambda: torch.autograd.grad(o, leaves, go,
                                                               retain_graph=True))}
    del x, r, go, leaves, o
    # K3 at the six stage shapes of a 448-frame mel, f32, snake-beta, log-scale
    for ch, tlen in STAGES:
        x = torch.randn(1, ch, tlen, generator=gen, device=dev)
        alpha, beta = (torch.randn(ch, generator=gen, device=dev) * 0.3 for _ in range(2))

        def act():
            return FA.fused_activation1d(x, alpha, beta, True)

        out[f"k3_{ch}x{tlen}"] = {"ms": cuda_ms(act),
                                  "graph_ms": graph_ms(lambda: [act() for _ in range(10)],
                                                       dev) / 10}
    for key, name in (("small", "small train step"), ("full", "full-width CFM")):
        q, k, v, do, seg, pos = k5_f32_inputs(
            dev, lambda *shape: torch.randn(*shape, generator=gen, device=dev), name)
        o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, False, None, alibi=True,
                                    return_lse=True)
        ref = (q, k, v, o, lse, do, seg, seg, pos, pos, False, None, None, True)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, seg, seg, pos, pos, False, None, None, True)
        fns = {"dq": lambda: FL.flash_attention_bwd_dq(*args),
               "dkv": lambda: FL.flash_attention_bwd_dkv(*args),
               "bwd": lambda: FL.flash_attention_bwd(*ref)}
        out[f"k5_f32_{key}"] = {
            **{f"{n}_ms": cuda_ms(fn) for n, fn in fns.items()},
            **{f"{n}_graph_ms": graph_ms(lambda fn=fn: [fn() for _ in range(10)], dev) / 10
               for n, fn in fns.items()}}
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return out


def _worker_train(dev, tmp: str) -> dict:
    """10 full-width CFM steps through the trainer CLI, as the train phase
    runs them: median step time of steps 3-9, mel frames/s, peak memory."""
    import shutil

    import torch

    from usdm_tpu_torch.cli import train_voicebox
    from usdm_tpu_torch.core.config import CfmTrainConfig, MelConfig

    filelist = os.path.join(tmp, "train.txt")
    if not os.path.exists(filelist):
        _write_train_data(tmp)
    out = os.path.join(tmp, "train_out")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_voicebox.main(["--train_filelist", filelist, "--output_dir", out, "--max_steps", "10",
                         "--synthesize_every", "0", "--save_every", "1000", "--seed", "37",
                         "--device", str(dev)])
    torch.cuda.synchronize()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        step_s = [r["train/step_s"] for r in map(json.loads, f) if "train/loss" in r]
    tc, mel_cfg = CfmTrainConfig(), MelConfig()
    frames = tc.batch_size * (tc.out_size_seconds * mel_cfg.sampling_rate // mel_cfg.hop_size)
    med = statistics.median(step_s[2:-1])
    shutil.rmtree(out, ignore_errors=True)
    return {"median_step_s": med, "frames_per_s": frames / med, "step_s": step_s,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}


def _stats_delta(after: dict, before: dict) -> dict:
    """An engine's decode links, prefill chunks and (where its tree has
    them) graph replays, run-ahead chains and perf_s seconds over one run."""
    out = {k: after[k] - before[k] for k in ("steps", "prefill_chunks", "graph_replays",
                                              "runahead_chains", "mixed_links", "mixed_rows")
           if k in after}
    if "perf_s" in after:
        out["perf_s"] = {k: round(v - before["perf_s"].get(k, 0.0), 4)
                         for k, v in after["perf_s"].items()}
    return out


def turn_worker(root: str) -> int:
    """One tree's side of --compare-with: imports usdm_tpu_torch from `root`,
    builds its kernels, then answers one JSON command per stdin line
    ("kernels", "bf16_build", "w8a8_build", "turn", "bf16_close",
    "server_build", "load", "server16_build", "load16", "server_close",
    "train", "exit") with one RESULT line."""
    import gc

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import usdm_tpu_torch
    from usdm_tpu_torch.audio.wav import write_wav
    from usdm_tpu_torch.core.config import EngineConfig
    from usdm_tpu_torch.ops import _build
    from usdm_tpu_torch.pipeline import UsdmPipeline

    pkg = os.path.dirname(os.path.abspath(usdm_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise AssertionError(f"usdm_tpu_torch came from {pkg}, not {root}")
    dev = torch.device("cuda", 0)
    # both trees' f32 convolutions at full f32: a parent tree from before
    # usdm_tpu_torch/ops/conv.py follows the process's cuDNN flag
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    _reply({"package": pkg, "nvcc_s": _build.build_seconds})
    tmp = tempfile.mkdtemp()
    wav_in = os.path.join(tmp, "user.wav")
    write_wav(wav_in, (np.random.default_rng(0).standard_normal(48000) * 0.1)
              .astype(np.float32), 16000)
    pipe = server = None
    rng = np.random.default_rng(0)
    n_clients, per_client, prompt_len, max_new = 8, 2, 384, 128
    for line in sys.stdin:
        op = json.loads(line)["op"]
        if op == "kernels":
            _reply(_worker_kernels(dev))
        elif op in ("bf16_build", "w8a8_build"):
            int8 = op == "w8a8_build"
            pipe = UsdmPipeline.full_random(device=dev, seed=0, lm_int8=int8, vb_int8=int8)
            _reply({})
        elif op == "train":
            _reply(_worker_train(dev, tmp))
        elif op == "turn":
            trace = {}
            before = pipe._dialog_server().engine.stats()
            t0 = time.perf_counter()
            res = pipe.respond_with_policy(_paged_policy(pipe, seed=1), wav_in, n_timesteps=50,
                                           seed=1, trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            audio_s = len(trace["audio"]) / pipe.decoder.mel_cfg.sampling_rate
            _reply({"wall_s": wall, "xlsr_s": trace["xlsr_s"], "dialog_s": trace["dialog_s"],
                    "synth_s": trace["synth_s"], "audio_s": audio_s, "rtf": wall / audio_s,
                    "stage_tokens": {k: len(v) for k, v in res.stage_tokens.items()},
                    "engine": _stats_delta(pipe._dialog_server().engine.stats(), before)})
        elif op in ("bf16_close", "server_close"):
            if server is not None:
                server.close()
            if pipe is not None:
                pipe.close()
            pipe = server = None
            gc.collect()
            torch.cuda.empty_cache()
            _reply({})
        elif op in ("server_build", "server16_build"):
            # the load's server (8 clients), or part (C)'s (16 staggered
            # clients) with the EngineConfig defaults: a parent that ignores
            # mixed_prefill alternates there
            batch = n_clients if op == "server_build" else LOAD16["clients"]
            pipe = UsdmPipeline.full_random(device=dev, seed=0, lm_int8=True, vb_int8=True)
            server = pipe.make_server(EngineConfig(page_size=256, max_pages_per_seq=3,
                                                   max_batch_size=batch, prefill_chunk=256,
                                                   kv_dtype="int8"))
            allow = np.ones(pipe.lm_cfg.vocab_size, bool)
            allow[:3] = False  # EOS unreachable: every request runs its budget
            _serve_load(server, [[rng.integers(3, 32000, prompt_len).tolist()]
                                 for _ in range(batch)], allow, 8)  # warm-up
            _reply({})
        elif op in ("load", "load16"):
            batch, stagger = ((n_clients, 0.0) if op == "load"
                              else (LOAD16["clients"], LOAD16["stagger_s"]))
            prompts = [[rng.integers(3, 32000, prompt_len).tolist() for _ in range(per_client)]
                       for _ in range(batch)]
            server.engine._ttfts.clear()
            before = server.engine.stats()
            done, wall = _serve_load(server, prompts, allow, max_new, stagger)
            torch.cuda.synchronize()
            ttfts = sorted(server.engine._ttfts)
            n_tok = sum(len(t) for outs in done.values() for t in outs)
            tokens = json.dumps([done[ci] for ci in range(batch)]).encode()
            _reply({"wall_s": wall, "generated_tokens": n_tok, "tok_s": n_tok / wall,
                    "ttft_p50_s": ttfts[len(ttfts) // 2],
                    "ttft_p95_s": ttfts[min(int(0.95 * len(ttfts)), len(ttfts) - 1)],
                    "ttfts_s": [round(t, 4) for t in server.engine._ttfts],  # in order
                    "tokens_sha1": hashlib.sha1(tokens).hexdigest(),
                    "engine": _stats_delta(server.engine.stats(), before)})
        elif op == "exit":
            break
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    return 0


COMPARE_CELLS = ("bf16", "w8a8", "load", "load16", "train")


def compare_run(parent: str, out_dir: str, cells=COMPARE_CELLS) -> dict:
    """Parent and change, each in a worker process that imports its own
    tree's usdm_tpu_torch and builds its own kernels (nvcc one after the
    other: the build time is the host's speed marker), driven in turns on
    one card: the kernels' times (parent, change, change, parent); then per
    cell of `cells`: bf16 and W8A8 turns (one warm-up turn each, then 3 each
    in the order P C C P P C), the int8 server load (warm-up inside the
    build; twice each, P C C P), part (C)'s 16 staggered clients with the
    EngineConfig defaults (load16; twice each, P C C P; each worker draws the
    same prompts, so `tokens_sha1` compares their tokens), the CFM trainer's
    10 steps (P C C P)."""
    import subprocess as sp

    roots = {"parent": os.path.abspath(parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    workers = {}
    out = {k: {"kernels": [], "turns": [], "w8a8_turns": [], "loads": [], "loads16": [],
               "train": []} for k in roots}

    def call(name, op):
        w = workers[name]
        w.stdin.write(json.dumps({"op": op}) + "\n")
        w.stdin.flush()
        return read(name)

    def read(name):
        for line in workers[name].stdout:
            if line.startswith("RESULT "):
                return json.loads(line[7:])
            log(f"  [{name}] {line.rstrip()}")
        raise RuntimeError(f"the {name} worker ended (exit {workers[name].wait()})")

    def turns(build, key, label):
        for name in roots:
            call(name, build)
            log(f"compare: {name} warm-up {label} turn {json.dumps(call(name, 'turn'))}")
        for name in ("parent", "change", "change", "parent", "parent", "change"):
            out[name][key].append(call(name, "turn"))
            log(f"compare: {name} {label} turn {json.dumps(out[name][key][-1])}")
        for name in roots:
            call(name, "bf16_close")

    try:
        for name, root in roots.items():
            workers[name] = sp.Popen([sys.executable, os.path.abspath(__file__), "--turn-worker",
                                      root], stdin=sp.PIPE, stdout=sp.PIPE, text=True, bufsize=1)
            out[name]["build"] = read(name)
            log(f"compare: {name} from {out[name]['build']['package']}, nvcc "
                f"{out[name]['build']['nvcc_s']:.1f} s")
        for name in ("parent", "change", "change", "parent"):
            out[name]["kernels"].append(call(name, "kernels"))
            log(f"compare: {name} kernels {json.dumps(out[name]['kernels'][-1])}")
        if "bf16" in cells:
            turns("bf16_build", "turns", "bf16")
        if "w8a8" in cells:
            turns("w8a8_build", "w8a8_turns", "W8A8")
        for cell, build, key in (("load", "server_build", "loads"),
                                 ("load16", "server16_build", "loads16")):
            if cell not in cells:
                continue
            for name in roots:
                call(name, build)
            for name in ("parent", "change", "change", "parent"):
                out[name][key].append(call(name, cell))
                log(f"compare: {name} int8 server {cell} {json.dumps(out[name][key][-1])}")
            for name in roots:
                call(name, "server_close")
        if "train" in cells:
            for name in ("parent", "change", "change", "parent"):
                out[name]["train"].append(call(name, "train"))
                log(f"compare: {name} CFM train {json.dumps(out[name]['train'][-1])}")
        for name in roots:
            w = workers[name]
            w.stdin.write(json.dumps({"op": "exit"}) + "\n")
            w.stdin.close()
            if w.wait(timeout=120) != 0:
                raise AssertionError(f"the {name} worker exited with {w.returncode}")
    finally:
        for w in workers.values():
            if w.poll() is None:
                w.kill()
                w.wait()
    with open(os.path.join(out_dir, "compare.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# --------------------------------------------------------------- phase 17
TP_DEGREES = (2, 4, 8)  # the tp above 1 that the 7B's 8 kv heads allow


def tp_group(dev) -> None:
    """Phase 17 (a)'s one-rank NCCL group, formed at its first use (its
    collectives are real NCCL calls)."""
    from usdm_tpu_torch.core import distributed as D

    D.initialize(f"localhost:{_free_port()}", 1, 0, dev)


def tp_engine_run(pipe, label: str, w8a8: bool) -> dict:
    """Phase 17 (a) on phase 4's bf16 7B (bf16 pools) or phase 5's W8A8 7B
    (int8 pools): PagedEngine(mesh=make_tp_mesh(1)) in a one-rank NCCL
    group, 2 requests of 128-token prompts and 64 greedy tokens (EOS masked
    out), then the same with ngram speculation, must give the tokens of the
    single-device graphed engine; every collective, eager link and kernel
    launch must be what the code implies: per decode link, round or
    prefill chunk 2 all-reduces a layer and one vocab gather; K1 once a
    layer per link or round, K6 7 times a layer (W8A8), K2 once a layer per
    chunk; no graph replay."""
    import torch

    from usdm_tpu_torch.core.config import EngineConfig
    from usdm_tpu_torch.engine import tp as TP
    from usdm_tpu_torch.engine.paged import PagedEngine, Request

    tp_group(pipe.device)
    cfg, params, dev = pipe.lm_cfg, pipe.lm_params, pipe.device
    n_layers = cfg.num_layers
    ecfg = EngineConfig(page_size=64, max_pages_per_seq=4, max_batch_size=2, prefill_chunk=128,
                        kv_dtype="int8" if w8a8 else None)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, min(32000, cfg.vocab_size), 128).tolist() for _ in range(2)]
    allow = np.ones(cfg.vocab_size, bool)
    allow[:3] = False  # EOS (2) unreachable: 64 tokens each

    def requests():
        return [Request(i, list(p), allow, 2, 64) for i, p in enumerate(prompts)]

    t0 = time.perf_counter()
    want = [r.output_ids for r in PagedEngine(params, cfg, ecfg, device=dev).run(requests())]
    log(f"phase 17 (a) {label}: the single-device graphed engine in "
        f"{time.perf_counter() - t0:.1f} s")
    k1_name = "paged_decode_attention_int8" if w8a8 else "paged_decode_attention"
    out, launches = {}, {}
    for kind in ("chain", "ngram"):
        mesh = TP.make_tp_mesh(1, dev)
        eng = PagedEngine(params, cfg, ecfg.replace(spec_k=4), mesh=mesh,
                          draft="ngram" if kind == "ngram" else None)
        reset_counts()
        t0 = time.perf_counter()
        got = [r.output_ids for r in eng.run(requests())]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, st = launch_counts(), eng.stats()
        bodies = st["steps"] + st["prefill_chunks"]
        implied = {"all_reduces": 2 * n_layers * bodies, "gathers": bodies,
                   "eager_links": st["steps"], "graph_replays": 0, "K1": n_layers * st["steps"],
                   "K6": 7 * n_layers * st["steps"] if w8a8 else 0,
                   "K2": n_layers * st["prefill_chunks"]}
        seen = {"all_reduces": st["tp"]["all_reduces"], "gathers": st["tp"]["gathers"],
                "eager_links": st["eager_links"], "graph_replays": st["graph_replays"],
                "K1": counts[k1_name], "K6": counts["stream_qmv"],
                "K2": counts["flash_attention"]}
        info = {"wall_s": wall, "steps": st["steps"], "prefill_chunks": st["prefill_chunks"],
                "spec_rounds": st["spec_rounds"], "counts": seen,
                "tokens_equal_single_device": got == want, "perf_s": st["perf_s"]}
        log(f"phase 17 (a) {label}, tp engine in a one-rank NCCL group, {kind}: "
            + json.dumps(info))
        if got != want:
            raise AssertionError(f"phase 17 (a) {label} {kind}: the TP engine's tokens differ "
                                 f"from the single-device engine's")
        if seen != implied:
            raise AssertionError(f"phase 17 (a) {label} {kind}: counts {seen}, the code "
                                 f"implies {implied}")
        if kind == "ngram" and not st["spec_rounds"]:
            raise AssertionError(f"phase 17 (a) {label}: no ngram round ran under TP")
        out[kind] = info
        for k in (k1_name, "stream_qmv", "flash_attention"):
            launches[k] = launches.get(k, 0) + counts[k]
        del eng
    return {"runs": out, "launches": launches}


def _tp_k6_checks(dev) -> tuple:
    """K6 at every per-rank projection of the 7B at tp 2, 4, 8 (column
    split [Dout/tp, 4096]: wq, wk/wv, gate/up; row split [4096, Din/tp]: wo,
    down), M 1, 8 and 16: f32 bit for bit, bf16 within one ulp; timed over
    enough weights in turn to pass the 50 MB L2, eager and from a CUDA
    graph, beside the torch._int_mm route's graph (the plain version at
    M 1) -> (the largest error, the times)."""
    import torch

    from usdm_tpu_torch.models import quant as Q
    from usdm_tpu_torch.ops import stream_matvec as SM
    from usdm_tpu_torch.scripts.common import int_mm

    gen = torch.Generator(device=dev).manual_seed(19)
    errs, times = [], []

    def library(yy, w):
        qy, ys = SM.quantize_rows(yy)
        return SM.epilogue(int_mm(qy, w["q"].t()), ys, w["s"], yy.dtype)

    for tp in TP_DEGREES:
        for name, dout, din in (("wq", 4096 // tp, 4096), ("wk/wv", 1024 // tp, 4096),
                                ("gate/up", 14336 // tp, 4096), ("wo", 4096, 4096 // tp),
                                ("down", 4096, 14336 // tp)):
            n = max(8, -(-64_000_000 // (dout * din)))
            ws = [Q.quantize_weight(torch.randn(din, dout, generator=gen, device=dev) * 0.02)
                  for _ in range(n)]
            for m in (1, 8, 16):
                y = torch.randn(m, din, generator=gen, device=dev) * 2.0
                case = f"tp {tp} {name} M={m} [{dout}, {din}]"
                errs.append(check("K6", f"{case} f32", SM.stream_qmv(y, ws[0], torch.float32),
                                  SM.stream_qmv_reference(y, ws[0], torch.float32), 0.0))
                yb = y.bfloat16()
                got, want = (fn(yb, ws[0], torch.bfloat16).float()
                             for fn in (SM.stream_qmv, SM.stream_qmv_reference))
                ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
                worst = ((got - want).abs() / ulp).max().item()
                if worst > 1:
                    raise AssertionError(f"K6 bf16 {case} off by {worst} ulps")
                errs.append(max_err(got, want))
                t = {"tp": tp, "proj": name, "m": m, "dout": dout, "din": din, "weights": n,
                     "ms": cuda_ms(lambda: [SM.stream_qmv(yb, w) for w in ws]) / n,
                     "graph_ms": graph_ms(lambda: [SM.stream_qmv(yb, w) for w in ws], dev) / n,
                     "library_graph_ms": graph_ms(lambda: [library(yb, w) for w in ws], dev) / n,
                     **least_time(nbytes(yb, ws[0]["q"], ws[0]["s"]) + m * dout * 2,
                                  2 * m * dout * din, "int8")}
                if m == 1:
                    t["plain_ms"] = cuda_ms(lambda: [SM.stream_qmv_reference(yb, w)
                                                     for w in ws]) / n
                times.append(t)
            del ws
    log("  K6 per-rank times: " + json.dumps(times))
    return max(errs), times


def _tp_k1_checks(dev, randn) -> tuple:
    """K1 at the 7B's per-rank kv heads (8 / tp: 4, 2, 1; group 4, d 128),
    B 1 at ctx 1,219, page 256, bf16 and int8 pools of 32 layer regions,
    against its plain version (phase 3's bounds); timed per layer over the
    32 regions in turn, eager and from a CUDA graph -> ({bf16, int8} errors,
    the times)."""
    import torch

    from usdm_tpu_torch.engine.paged_ops import quant_kv_token
    from usdm_tpu_torch.ops import paged_attention as PA

    g, d, page, maxp, n_layers, ctx = 4, 128, 256, 5, 32, 1219
    n_pages = maxp + 1
    lens = torch.full((1,), ctx, dtype=torch.int32, device=dev)
    errs, times = {"bf16": 0.0, "int8": 0.0}, []
    for tp in TP_DEGREES:
        hkv = 8 // tp
        q = randn(1, hkv, g, d).bfloat16()
        tables = [(torch.arange(maxp, device=dev, dtype=torch.int32) + li * n_pages)[None]
                  .contiguous() for li in range(n_layers)]
        for kind in ("bf16", "int8"):
            scales = {}
            if kind == "int8":
                pools = []
                for key in ("k_scales", "v_scales"):
                    qv, sv = quant_kv_token(randn(hkv, n_layers * n_pages, page, d))
                    pools.append(qv)
                    scales[key] = sv.transpose(0, 1).contiguous()
            else:
                pools = [randn(hkv, n_layers * n_pages, page, d).bfloat16() for _ in range(2)]
            args = (q, *pools, tables[3], lens, 4096)
            got = PA.paged_decode_attention(*args, **scales)
            want = PA.paged_decode_attention_reference(*args, **scales)
            case = f"tp {tp}: {hkv} kv heads, B=1 ctx {ctx}, {kind} pools"
            if kind == "bf16":
                err = check("K1", case, got, want, bf16_bound(want))
            else:
                fold = PA.paged_decode_attention_reference(q.float(), *pools, tables[3], lens,
                                                           4096, **scales)
                err = check("K1 int8", case, got, want, bf16_bound(fold) + max_err(want, fold))
            errs[kind] = max(errs[kind], err)

            def step(fn):
                return lambda: [fn(q, *pools, t, lens, 4096, **scales) for t in tables]

            row = hkv * d * pools[0].element_size() + (4 * hkv if scales else 0)
            t = {"tp": tp, "kv_heads": hkv, "pools": kind,
                 "ms": cuda_ms(step(PA.paged_decode_attention)) / n_layers,
                 "graph_ms": graph_ms(step(PA.paged_decode_attention), dev) / n_layers,
                 "plain_ms": cuda_ms(step(PA.paged_decode_attention_reference)) / n_layers,
                 "library_ms": None,
                 **least_time(2 * nbytes(q) + nbytes(tables[3], lens) + 2 * row * ctx,
                              4 * g * hkv * d * ctx, "bf16")}
            times.append(t)
            del pools
    log("  K1 per-rank times: " + json.dumps(times))
    return errs, times


def _tp_k2_checks(dev, randn) -> tuple:
    """K2 bf16 at a prefill chunk with the 7B's per-rank heads (32 / tp: 16,
    8, 4 over 4, 2, 1 kv heads; phase 3 (a)'s chunk: 512 queries at 768,
    300 valid, a 2,048-slot context, window 4096) against its plain version
    with round_operands=True, timed eager and from a CUDA graph beside
    SDPA's -> (the largest error, the times)."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    c, s_ctx, start, n_valid, d = 512, 2048, 768, 300, 128
    qpos = (start + torch.arange(c, device=dev, dtype=torch.int32))[None]
    kpos = torch.arange(s_ctx, device=dev, dtype=torch.int32)[None]
    qseg = torch.where(torch.arange(c, device=dev)[None] < n_valid, 0, -1).to(torch.int32)
    kseg = torch.where(kpos < start + n_valid, 0, -1).to(torch.int32)
    mask = attn_mask(qseg, kseg, qpos, kpos, True, 4096)
    errs, times = [], []
    for tp in TP_DEGREES:
        h, hkv = 32 // tp, 8 // tp
        q = randn(1, c, h, d).bfloat16()
        k, v = randn(1, s_ctx, hkv, d).bfloat16(), randn(1, s_ctx, hkv, d).bfloat16()
        args = (q, k, v, qseg, kseg, qpos, kpos, True, 4096, None, False)
        case = f"tp {tp}: prefill bf16 {h}/{hkv} heads Tq=512 Tk=2048 start=768"
        got, got_lse = FL.flash_attention(*args, return_lse=True)
        want, want_lse = FL.flash_attention_reference(*args, round_operands=True)
        errs.append(check("K2", case, got, want, bf16_bound(want)))
        check("K2 lse", case, got_lse, want_lse, 1e-4)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)

        t = {"tp": tp, "heads": h, "kv_heads": hkv,
             "ms": cuda_ms(lambda: FL.flash_attention(*args)),
             "graph_ms": graph_ms(lambda: [FL.flash_attention(*args) for _ in range(10)],
                                  dev) / 10,
             "plain_ms": cuda_ms(lambda: FL.flash_attention_reference(*args)),
             "library_ms": cuda_ms(sdpa),
             "library_graph_ms": graph_ms(lambda: [sdpa() for _ in range(10)], dev) / 10,
             **least_time(2 * nbytes(q) + nbytes(k, v, qseg, kseg, qpos, kpos),
                          4 * d * h * int(mask.sum()), "bf16")}
        times.append(t)
    log("  K2 per-rank times: " + json.dumps(times))
    return max(errs), times


def tp_run(dev, tmp: str, out_dir: str) -> dict:
    """Phase 17 (b)-(d), on an emptied card after phase 16 (c): the kernels
    at the per-rank shapes, the one-card refusal of cli.infer --tp 2, and
    the real tp 2 run where the host has two cards."""
    import torch

    _free_device()
    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    log("phase 17 (b): K6, K1 and K2 at the per-rank shapes of tp 2, 4 and 8 against their "
        "plain versions")
    k6_err, k6 = _tp_k6_checks(dev)
    k1_errs, k1 = _tp_k1_checks(dev, randn)
    k2_err, k2 = _tp_k2_checks(dev, randn)
    with open(os.path.join(out_dir, "tp_kernels.json"), "w") as f:
        json.dump({"K6": k6, "K1": k1, "K2": k2}, f)
    wav = user_wav(tmp)
    argv = [sys.executable, "-m", "usdm_tpu_torch.cli.infer", "--input_path", wav, "--demo"]
    root = os.path.dirname(os.path.abspath(__file__))
    n_cards = torch.cuda.device_count()
    out = {"cards": n_cards}
    if n_cards < 2:  # (c) the refusal: two ranks cannot share one card
        r = subprocess.run(argv + ["--output_path", os.path.join(tmp, "tp2.wav"), "--tp", "2"],
                           cwd=root, capture_output=True, text=True, timeout=300)
        refused = r.returncode != 0 and "need 2 devices for tp=2" in r.stderr
        log(f"phase 17 (c) cli.infer --tp 2 on {n_cards} card: exit {r.returncode}, "
            f"{r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ''}")
        if not refused:
            raise AssertionError("phase 17 (c): cli.infer --tp 2 did not refuse one card by name")
        out["tp2_run"] = f"not run: {n_cards} card"
    else:  # (d) two ranks over NCCL against one rank
        said = {}
        for tp in (1, 2):
            text = run_module("usdm_tpu_torch.cli.infer", *argv[3:], "--output_path",
                              os.path.join(tmp, f"tp{tp}.wav"), "--tp", str(tp))
            said[tp] = [ln for ln in text.splitlines() if ln.startswith(("user_", "agent_"))]
        same = said[1] == said[2] and open(os.path.join(tmp, "tp1.wav"), "rb").read() == open(
            os.path.join(tmp, "tp2.wav"), "rb").read()
        if not same:
            raise AssertionError(f"phase 17 (d): cli.infer --demo --tp 2 differs from --tp 1: "
                                 f"{said}")
        out["tp2_run"] = "cli.infer --demo --tp 2 equals --tp 1"
    log("phase 17: " + json.dumps({"tp2_run": out["tp2_run"], "cards": n_cards}))
    return {**out, "max_abs_err": {"stream_qmv": k6_err, "paged_decode_attention": k1_errs["bf16"],
                                   "paged_decode_attention_int8": k1_errs["int8"],
                                   "flash_attention": k2_err}}


# --------------------------------------------------------------- phase 18
DP_DEGREES = (2, 4, 8)  # the data-parallel degrees whose per-rank rows (d) times
CFM_B, CFM_T1 = 8, 1379  # the CFM step: batch 8 of 16 s crops, T + 1 estimator rows
CFM_LENS = (1379, 900, 1379, 1200, 640, 1379, 1000, 1301)  # phase 3's ragged rows
MESH_STEPS = 2


def _captured_mesh(run):
    """run() with core/distributed.py make_cli_mesh recording the mesh a
    CLI builds -> (run's result, the mesh)."""
    from usdm_tpu_torch.core import distributed as D

    seen, orig = [], D.make_cli_mesh

    def keep(*a, **kw):
        mesh = orig(*a, **kw)
        seen.append(mesh)
        return mesh

    D.make_cli_mesh = keep
    try:
        out = run()
    finally:
        D.make_cli_mesh = orig
    return out, seen[0] if seen else None


def _mesh_pt_run(dev, root: str, want_steps: list, smi: str) -> dict:
    """Phase 18 (a): cli.train_pt with phase 11 (b)'s flags (full-width 7B,
    --offload, 1 x 8,192-token rows from the same seed) in a one-rank NCCL
    group (--coordinator localhost --num_processes 1 --process_id 0 --dp 1
    --tp 1), the sharded path, 2 steps, no checkpoint or export: each
    step's loss and grad_norm equal phase 11 (b)'s bit for bit (steps 1-2
    do not depend on --max_steps: step 1 runs at lr 0 and both schedules
    give step 2 the peak lr); every collective counted as train/lm.py
    step_collectives implies; K2/K5 as in (b); peak device memory and the
    host memory added within memory_budget's."""
    import torch

    from usdm_tpu_torch.cli import train_pt
    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.train import lm as T

    cfg = MistralConfig()
    rows = os.path.join(root, "mesh_rows")
    os.makedirs(rows)
    with open(os.path.join(rows, "part0.txt"), "w") as f:
        for row in _lm_rows(MESH_STEPS, cfg.vocab_size, 1):
            f.write(" ".join(map(str, row)) + "\n")
    out = os.path.join(root, "mesh_pt")
    hbm = torch.cuda.get_device_properties(dev).total_memory / 2**30
    budget = T.memory_budget(cfg, dp=1, tp=1, seq_len=LM_T, batch_per_chip=1, offload=True,
                             hbm_gb=hbm)
    _free_device()
    reset_counts()
    (rc, mesh), wall, rss0, rss_peak = _host_step(lambda: _captured_mesh(lambda: train_pt.main([
        "--data_path", rows, "--output_dir", out, "--max_steps", str(MESH_STEPS),
        "--train_batch_size", "1", "--max_input_length", str(LM_T), "--offload",
        "--logging_steps", "1", "--save_steps", "0", "--learning_rate", str(TRAIN_LR),
        "--seed", "42", "--device", str(dev), "--coordinator", f"localhost:{_free_port()}",
        "--num_processes", "1", "--process_id", "0", "--dp", "1", "--tp", "1"])))
    counts, mma = launch_counts(), mma_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    host_gb = (rss_peak - rss0) / 2**30
    metrics = _train_metrics(out)
    got = [[r["train/loss"], r["train/grad_norm"]] for r in metrics]
    want = [[s["loss"], s["grad_norm"]] for s in want_steps[:MESH_STEPS]]
    implied = {k: MESH_STEPS * n for k, n in
               T.step_collectives(cfg, TrainConfig(), LM_T, mesh.axis_names).items()}
    collectives = dict(mesh.counts)
    launches = {k: counts[k] for k in ("flash_attention", "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")}
    want_launches = {"flash_attention": 2 * MESH_STEPS * cfg.num_layers,
                     "flash_attention_bwd_dq": MESH_STEPS * cfg.num_layers,
                     "flash_attention_bwd_dkv": MESH_STEPS * cfg.num_layers}
    info = {"rc": rc, "wall_s": wall, "mesh": mesh.shape, "steps": got,
            "phase_11b_steps": want, "bit_equal": got == want,
            "step_s": [r["train/step_s"] for r in metrics],
            "collectives": collectives, "implied": implied, "launches": launches,
            "max_memory_allocated_gib": peak, "budget_device_gb": budget["device_gb"],
            "host_memory_added_gib": host_gb, "budget_host_gb": budget["host_gb"], "card": smi}
    log("phase 18 (a) train_pt --offload, full width, one-rank NCCL mesh: " + json.dumps(info))
    if rc != 0 or got != want:
        raise AssertionError(f"phase 18 (a): the mesh path's steps {got} are not phase 11 (b)'s "
                             f"{want} bit for bit (rc {rc})")
    if collectives != implied:
        raise AssertionError(f"phase 18 (a): collectives {collectives}, the code implies "
                             f"{implied}")
    if launches != want_launches or any(mma[k] != n for k, n in launches.items()):
        raise AssertionError(f"phase 18 (a): K2/K5 launched {launches}, want {want_launches}")
    if peak > budget["device_gb"] or host_gb > budget["host_gb"] + LM_HOST_SLACK_GB:
        raise AssertionError(f"phase 18 (a): {peak:.2f} GiB on the card, {host_gb:.2f} GiB of "
                             f"host memory added; the budget says {budget['device_gb']:.2f} "
                             f"and {budget['host_gb']:.2f} + {LM_HOST_SLACK_GB}")
    return {**info, "launches": launches}


def _bit_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (the flags
    restored after): a step is then bit-reproducible run to run."""
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _cfm_mesh_batch(dev, n_tokens: int, n_feats: int) -> dict:
    """A CFM batch at the trainer's shape: 8 rows of 1,378 frames (16 s),
    ragged lengths, context spans in two rows."""
    import torch

    rng = np.random.default_rng(18)
    t = CFM_T1 - 1
    mask = np.zeros((CFM_B, 1, t), np.float32)
    mask[1, 0, 40:400] = 1.0
    mask[5, 0, 100:700] = 1.0
    batch = {"x": rng.integers(0, n_tokens, (CFM_B, t)), "mask": mask,
             "y": rng.standard_normal((CFM_B, n_feats, t)).astype(np.float32),
             "y_lengths": np.asarray(CFM_LENS) - 1}
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def _dp_equal_runs(dev, mesh) -> dict:
    """Phase 18 (b): the CFM step (VoiceboxConfig(), bf16 over f32, batch 8
    of 16 s crops) and the GAN steps (BigVGANConfig(), batch 32 x 8,192
    samples) each from one seeded state, 2 steps on one device and 2 on
    the one-rank mesh, cuDNN's deterministic algorithms on for both:
    metrics and final params bit for bit; the mesh runs' launches
    (K2/K4/K5, K3) and all-reduces.  The GAN step is also run twice on one
    device with the default flags, and whether those two agree is logged."""
    import torch

    from usdm_tpu_torch.core.config import BigVGANConfig, CfmTrainConfig, MelConfig, VoiceboxConfig
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.data.mel_dataset import loss_mel_config
    from usdm_tpu_torch.train import cfm as C
    from usdm_tpu_torch.train import vocoder as V

    out = {}
    cfg, tc = VoiceboxConfig(), CfmTrainConfig()
    batch = _cfm_mesh_batch(dev, cfg.n_tokens, cfg.n_feats)
    res = {}
    for label, m in (("single", None), ("mesh", mesh)):
        _free_device()
        state, opt = C.init_state(cfg, tc, dev, torch.Generator(device=dev).manual_seed(37))
        step = C.make_train_step(cfg, tc, opt, mesh=m)
        gen = torch.Generator(device=dev).manual_seed(5)
        reset_counts()
        before = dict(m.counts) if m is not None else {}
        with _deterministic_cudnn():
            metrics = [{k: float(v) for k, v in step(state, batch, gen).items()}
                       for _ in range(MESH_STEPS)]
            torch.cuda.synchronize()
        res[label] = {"metrics": metrics, "params": [t.detach() for t in tree_leaves(state.params)],
                      "launches": {k: v for k, v in launch_counts().items()
                                   if k in _train_counters()},
                      "collectives": {k: v - before.get(k, 0) for k, v in m.counts.items()}
                      if m is not None else {}}
        del state, opt, step
    cfm = {"metrics": res["mesh"]["metrics"], "single_metrics": res["single"]["metrics"],
           "params_bit_equal": _bit_equal(res["mesh"]["params"], res["single"]["params"]),
           "launches": res["mesh"]["launches"], "collectives": res["mesh"]["collectives"]}
    del res
    log("phase 18 (b) CFM step, one device against the one-rank mesh: " + json.dumps(cfm))
    if cfm["metrics"] != cfm["single_metrics"] or not cfm["params_bit_equal"]:
        raise AssertionError(f"phase 18 (b): the CFM mesh step differs from one device: {cfm}")
    if not all(cfm["launches"].values()):
        raise AssertionError(f"phase 18 (b): a kernel of the CFM step did not launch: "
                             f"{cfm['launches']}")
    out["cfm"] = cfm

    gcfg, mc = BigVGANConfig(), loss_mel_config(MelConfig())
    rng = np.random.default_rng(19)
    frames = GAN_SEG // gcfg.total_upsample
    gb = {"mel": torch.from_numpy((rng.standard_normal((GAN_B, gcfg.num_mels, frames)) - 5.0)
                                  .astype(np.float32)).to(dev),
          "wav": torch.from_numpy((rng.standard_normal((GAN_B, 1, GAN_SEG)) * 0.1)
                                  .astype(np.float32)).to(dev)}
    res = {}
    # with PyTorch's default cuDNN flags a GAN step is not bit-reproducible
    # run to run (its convolutions' backward may sum in any order), so the
    # gate compares one device and the mesh with cudnn.deterministic on for
    # both; the default flags' run-to-run check is logged
    for label, m, det in (("single", None, False), ("single_again", None, False),
                          ("single_det", None, True), ("mesh_det", mesh, True)):
        _free_device()
        state, gopt, dopt = V.init_state(gcfg, torch.Generator(device=dev).manual_seed(1),
                                         device=dev)
        d_step, g_step = V.make_train_steps(gcfg, gopt, dopt, mc, mesh=m)
        reset_counts()
        before = dict(m.counts) if m is not None else {}
        t0 = time.perf_counter()
        with _deterministic_cudnn() if det else contextlib.nullcontext():
            metrics = [{k: float(v) for k, v in {**d_step(state, gb),
                                                  **g_step(state, gb)}.items()}
                       for _ in range(MESH_STEPS)]
            torch.cuda.synchronize()
        res[label] = {"metrics": metrics, "wall_s": time.perf_counter() - t0,
                      "params": [t.detach() for t in tree_leaves(state.params)],
                      "k3": launch_counts()["fused_activation1d"],
                      "collectives": {k: v - before.get(k, 0) for k, v in m.counts.items()}
                      if m is not None else {}}
        del state, d_step, g_step
    gan = {"metrics": res["mesh_det"]["metrics"], "single_metrics": res["single_det"]["metrics"],
           "params_bit_equal": _bit_equal(res["mesh_det"]["params"],
                                          res["single_det"]["params"]),
           "default_flags_reproducible": _bit_equal(res["single"]["params"],
                                                    res["single_again"]["params"]),
           "wall_s": {k: r["wall_s"] for k, r in res.items()},
           "k3_launches": res["mesh_det"]["k3"], "collectives": res["mesh_det"]["collectives"]}
    del res, gb
    _free_device()
    log("phase 18 (b) GAN steps, one device against the one-rank mesh (cudnn.deterministic "
        "for both): " + json.dumps(gan))
    if gan["metrics"] != gan["single_metrics"] or not gan["params_bit_equal"]:
        raise AssertionError(f"phase 18 (b): the GAN mesh steps differ from one device: {gan}")
    if gan["k3_launches"] != MESH_STEPS * K3_PER_GAN_STEP:
        raise AssertionError(f"phase 18 (b): K3 launched {gan['k3_launches']}, want "
                             f"{MESH_STEPS * K3_PER_GAN_STEP}")
    out["gan"] = gan
    return out


def _mesh_distill_run(dev, mesh, want: dict) -> dict:
    """Phase 18 (c): phase 12 (c)'s first step (the bf16 MistralConfig()
    target from seed 7, the 8-layer early-exit draft, batch seed 20) with
    the draft's state on the one-rank mesh: loss, agree, grad_norm and
    ntokens equal phase 12 (c)'s bit for bit; K2 32 + 2 x 8 and K5 8 + 8."""
    import torch

    from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
    from usdm_tpu_torch.models import mistral as M
    from usdm_tpu_torch.train import distill as DI
    from usdm_tpu_torch.train import lm as T

    _free_device()
    cfg = MistralConfig()
    target = M.init_params(cfg, torch.Generator(device=dev).manual_seed(7), dev)
    draft, cfg_d = DI.init_draft_from_target(target, cfg, DISTILL_LAYERS)
    tc = TrainConfig(batch_size=DISTILL_B, max_steps=1000, learning_rate=1e-4)
    state = T.init_state(cfg_d, tc, dev, params=draft, mesh=mesh)
    del draft
    step = DI.make_distill_step(cfg_d, cfg, tc, mesh=mesh)
    reset_counts()
    before = dict(mesh.counts)
    m = step(state, target, _distill_batch(cfg.vocab_size, 20, dev))
    got = {k: float(v) for k, v in m.items()}
    counts = launch_counts()
    launches = {k: counts[k] for k in ("flash_attention", "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")}
    info = {"step": got, "phase_12c_step": {k: want[k] for k in got},
            "launches": launches,
            "collectives": {k: v - before.get(k, 0) for k, v in mesh.counts.items()}}
    del state, target, step
    _free_device()
    log("phase 18 (c) distill step, the draft on the one-rank mesh: " + json.dumps(info))
    if got != info["phase_12c_step"]:
        raise AssertionError(f"phase 18 (c): {got} is not phase 12 (c)'s first step "
                             f"{info['phase_12c_step']} bit for bit")
    want_l = {"flash_attention": 32 + 2 * DISTILL_LAYERS, "flash_attention_bwd_dq": DISTILL_LAYERS,
              "flash_attention_bwd_dkv": DISTILL_LAYERS}
    if launches != want_l:
        raise AssertionError(f"phase 18 (c): K2/K5 launched {launches}, want {want_l}")
    return info


def _flash_rank_case(dev, case: str, q, k, v, do, seg, pos, causal, window, alibi) -> dict:
    """K2 and K5 bf16 at one per-rank shape against their plain versions
    (round_operands=True, bf16_bound), then times: eager and from a CUDA
    graph, the plain versions', and SDPA's forward and backward with the
    same mask (K/V repeated to the query heads outside the timed call,
    ALiBi as an added bias), beside each bound -> its row."""
    import torch

    from usdm_tpu_torch.ops import flash_attention as FL

    b, t, h, d = q.shape
    o, lse = FL.flash_attention(q, k, v, seg, seg, pos, pos, causal, window, alibi=alibi,
                                return_lse=True)
    want_o, want_lse = FL.flash_attention_reference(q, k, v, seg, seg, pos, pos, causal, window,
                                                    None, alibi, True)
    errs = {"fwd": check("K2", f"{case} o", o, want_o, bf16_bound(want_o))}
    check("K2 lse", case, lse, want_lse, 1e-4)
    del want_o, want_lse
    ref_args = (q, k, v, o, lse, do, seg, seg, pos, pos, causal, window, None, alibi)
    got = FL.flash_attention_bwd(*ref_args)
    want = FL.flash_attention_bwd_reference(*ref_args, True)
    out = [check("K5", f"{case} {n}", g, w, bf16_bound(w))
           for n, g, w in zip(("dq", "dk", "dv"), got, want)]
    errs["dq"], errs["dkv"] = out[0], max(out[1:])
    del got, want
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, seg, seg, pos, pos, causal, window, None, alibi)
    calls = {"fwd": lambda: FL.flash_attention(q, k, v, seg, seg, pos, pos, causal, window,
                                               alibi=alibi),
             "dq": lambda: FL.flash_attention_bwd_dq(*args),
             "dkv": lambda: FL.flash_attention_bwd_dkv(*args)}
    eager = {n: cuda_ms(fn) for n, fn in calls.items()}
    graph = {n: graph_ms(lambda fn=fn: [fn() for _ in range(10)], dev) / 10
             for n, fn in calls.items()}
    plain = {"fwd": cuda_ms(lambda: FL.flash_attention_reference(
                 q, k, v, seg, seg, pos, pos, causal, window, None, alibi, True)),
             "bwd": cuda_ms(lambda: FL.flash_attention_bwd_reference(*ref_args, True))}
    mask = attn_mask(seg, seg, pos, pos, causal, window)
    pairs = h * int(mask.sum())
    ins = nbytes(q, k, v, do, lse, delta, seg, pos)
    bounds = {"fwd": least_time(2 * nbytes(q) + nbytes(k, v, seg, pos), 4 * d * pairs, "bf16"),
              "dq": least_time(ins + nbytes(q), 6 * d * pairs, "bf16"),
              "dkv": least_time(ins + nbytes(k, v), 8 * d * pairs, "bf16")}
    bias = mask[:, None]
    if alibi:
        slopes = FL.alibi_slopes_pow2(h).to(dev)[None, :, None, None]
        dist = (pos[:, None, :, None] - pos[:, None, None, :]).abs().float()
        bias = torch.where(bias, -slopes * dist * (pos[:, None, None, :] != 0),
                           torch.finfo(torch.bfloat16).min).to(torch.bfloat16)
        del dist
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // k.shape[2], dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        library_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias))
    ot = sdpa(qt, kt, vt, attn_mask=bias)
    dot = do.transpose(1, 2)
    library_bwd = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    del qt, kt, vt, ot, bias, mask, o, lse, delta
    return {"case": case, "heads": h, "kv_heads": k.shape[2], "rows": b, "max_abs_err": errs,
            "ms": eager, "graph_ms": graph, "plain_ms": plain,
            "bound_ms": {n: x["bound_ms"] for n, x in bounds.items()},
            "bound_by": {n: x["bound_by"] for n, x in bounds.items()},
            "library_ms": {"sdpa_fwd": library_fwd, "sdpa_bwd": library_bwd}}


def rank_kernel_checks(dev, out_dir: str) -> dict:
    """Phase 18 (d), on an emptied card: each kernel of the sharded
    trainers at the shapes one rank gives it, against its plain version,
    timed eagerly and from a CUDA graph beside its bound and its library
    call: K2/K5 bf16 at the 7B training shape (T 8,192, segments 5000 +
    2000 + 1192, window 4,096) with the heads of tp 2, 4 and 8 (16/4, 8/2,
    4/1); K2/K5 (ALiBi, non-causal, d 64) and K4's forward and backward at
    the CFM step's rows of dp 2, 4 and 8 (4, 2, 1 of its 8); K3's Function
    at the GAN step's rows of dp 2, 4 and 8 (16, 8, 4 of its 32), the six
    stage shapes.  -> {kernel: largest error}; the rows to
    <out-dir>/train_rank_kernels.json."""
    import torch

    from usdm_tpu_torch.ops import fused_act as FA
    from usdm_tpu_torch.ops import fused_ln as LN

    _free_device()
    gen = torch.Generator(device=dev).manual_seed(18)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rows = {"lm_tp": [], "cfm_dp": [], "k4_dp": [], "k3_dp": []}
    log("phase 18 (d): K2/K5 at the 7B's per-rank heads of tp 2, 4, 8; K2/K4/K5 at the CFM "
        "step's per-rank rows of dp 2, 4, 8; K3's Function at the GAN step's")
    seg, pos = _lm_seg_pos(dev)
    for tp in TP_DEGREES:
        h, hkv = 32 // tp, 8 // tp
        q, do, k, v = (randn(1, LM_T, n, 128) for n in (h, h, hkv, hkv))
        rows["lm_tp"].append({"tp": tp, **_flash_rank_case(
            dev, f"tp {tp}: LM bf16 {h}/{hkv} heads T=8192 window 4096", q, k, v, do, seg, pos,
            True, 4096, False)})
        del q, do, k, v
    for dp in DP_DEGREES:
        b = CFM_B // dp
        lens = torch.tensor(CFM_LENS[:b], device=dev)
        cpos = torch.arange(CFM_T1, device=dev, dtype=torch.int32)[None].expand(b, CFM_T1)
        cpos = cpos.contiguous()
        cseg = torch.where(cpos < lens[:, None], 0, -1).to(torch.int32)
        q, k, v, do = (randn(b, CFM_T1, 16, 64) for _ in range(4))
        rows["cfm_dp"].append({"dp": dp, **_flash_rank_case(
            dev, f"dp {dp}: voicebox bf16 B={b} T=1379 ALiBi", q, k, v, do, cseg, cpos, False,
            None, True)})
        del q, k, v, do
        x, r, go = (randn(b, CFM_T1, 1024) for _ in range(3))
        w, bb = (randn(1024) * 0.1 + 1.0), randn(1024) * 0.1
        ln_lens = lens.to(torch.int32)
        got = LN.add_mask_ln(x, r, ln_lens, w, bb, True)
        want = LN.add_mask_ln_reference(x, r, ln_lens, w, bb, True)
        err = check("K4", f"dp {dp}: [{b}, 1379, 1024] bf16", got, want,
                    2.0**-6 * want.float().abs().max().item())
        gb = LN.add_mask_ln_bwd(x, r, ln_lens, w, go, True)
        wb = LN.add_mask_ln_backward_reference(x, r, ln_lens, w, go, True)
        berr = max(check("K4 backward", f"dp {dp}: [{b}, 1379, 1024] bf16 {n}", g, ww, bound)
                   for n, g, ww, bound in zip(("dx", "dr", "dw", "db"), gb, wb,
                                              _ln_bwd_bounds(x, r, ln_lens, go, True, wb)))
        rows["k4_dp"].append({
            "dp": dp, "rows": b, "max_abs_err": {"fwd": err, "bwd": berr},
            "ms": {"fwd": cuda_ms(lambda: LN.add_mask_ln(x, r, ln_lens, w, bb, True)),
                   "bwd": cuda_ms(lambda: LN.add_mask_ln_bwd(x, r, ln_lens, w, go, True))},
            "graph_ms": {
                "fwd": graph_ms(lambda: [LN.add_mask_ln(x, r, ln_lens, w, bb, True)
                                         for _ in range(10)], dev) / 10,
                "bwd": graph_ms(lambda: [LN.add_mask_ln_bwd(x, r, ln_lens, w, go, True)
                                         for _ in range(10)], dev) / 10},
            "plain_ms": {
                "fwd": cuda_ms(lambda: LN.add_mask_ln_reference(x, r, ln_lens, w, bb, True)),
                "bwd": cuda_ms(lambda: LN.add_mask_ln_backward_reference(x, r, ln_lens, w, go,
                                                                         True))},
            "bound_ms": {"fwd": least_time(3 * nbytes(x) + nbytes(w, bb, ln_lens),
                                           8 * x.numel(), "bf16")["bound_ms"],
                         "bwd": least_time(4 * nbytes(x) + 3 * nbytes(w) + nbytes(ln_lens),
                                           20 * x.numel(), "bf16")["bound_ms"]},
            "library_ms": None})
        del x, r, go, got, want, gb, wb
    k3_err = 0.0
    for dp in DP_DEGREES:
        b = GAN_B // dp
        stage_rows = []
        for ch, tlen in GAN_STAGES:
            x = randn(b, ch, tlen, dtype=torch.float32).requires_grad_()
            a = (randn(ch, dtype=torch.float32) * 0.3).requires_grad_()
            bt = (randn(ch, dtype=torch.float32) * 0.3).requires_grad_()
            g = randn(b, ch, tlen, dtype=torch.float32)
            y = FA.fused_activation1d(x, a, bt, True)
            want = FA.activation1d_reference(x, a, bt, True)
            k3_err = max(k3_err, check("K3 Function forward", f"dp {dp}: B={b} C={ch} T={tlen}",
                                       y, want, 1e-4))
            got = torch.autograd.grad(y, (x, a, bt), g, retain_graph=True)
            ref = torch.autograd.grad(want, (x, a, bt), g, retain_graph=True)
            for name, gv, rv in zip(("dx", "dalpha", "dbeta"), got, ref):
                check(f"K3 Function {name}", f"dp {dp}: B={b} C={ch} T={tlen}", gv, rv,
                      K3_GRAD_BOUND * float(rv.abs().max()))
            xd, ad, bd = x.detach(), a.detach(), bt.detach()
            stage_rows.append({
                "C": ch, "T": tlen,
                "ms": cuda_ms(lambda: FA.fused_activation1d(xd, ad, bd, True)),
                "graph_ms": graph_ms(lambda: [FA.fused_activation1d(xd, ad, bd, True)
                                              for _ in range(10)], dev) / 10,
                "bwd_ms": cuda_ms(lambda: torch.autograd.grad(y, (x, a, bt), g,
                                                              retain_graph=True)),
                "plain_ms": cuda_ms(lambda: FA.activation1d_reference(xd, ad, bd, True)),
                # phase 3's K3 count: x in, y out, alpha and beta, f32; ~60
                # operations an output
                **least_time(8 * xd.numel() + 8 * ch, 60 * xd.numel(), "f32"),
                "library_ms": None})
            del x, a, bt, g, y, want, got, ref
        rows["k3_dp"].append({"dp": dp, "rows": b, "stages": stage_rows})
    with open(os.path.join(out_dir, "train_rank_kernels.json"), "w") as f:
        json.dump(rows, f)
    log("phase 18 (d) train_rank_kernels: " + json.dumps(rows))
    return {"flash_attention": max(r["max_abs_err"]["fwd"] for r in rows["lm_tp"]
                                   + rows["cfm_dp"]),
            "flash_attention_bwd_dq": max(r["max_abs_err"]["dq"] for r in rows["lm_tp"]
                                          + rows["cfm_dp"]),
            "flash_attention_bwd_dkv": max(r["max_abs_err"]["dkv"] for r in rows["lm_tp"]
                                           + rows["cfm_dp"]),
            "add_mask_ln": max(r["max_abs_err"]["fwd"] for r in rows["k4_dp"]),
            "add_mask_ln_bwd": max(r["max_abs_err"]["bwd"] for r in rows["k4_dp"]),
            "fused_activation1d": k3_err}


def _mesh_refusals(dev, tmp: str) -> dict:
    """Phase 18 (e): with one card cli.train_pt --tp 2 and
    cli.train_voicebox --num_processes 2 refuse by name (in process, before
    any group forms); with two or more, a tiny train_pt --dp 2 over two
    processes against --dp 1 (losses within 2e-2 rel, bf16 compute)."""
    import torch

    from usdm_tpu_torch.cli import train_pt, train_voicebox

    n = torch.cuda.device_count()
    out = {"cards": n}
    if n < 2:
        said = {}
        for name, call in (
                ("train_pt --tp 2", lambda: train_pt.main([
                    "--tiny", "--data_path", tmp, "--output_dir", os.path.join(tmp, "r1"),
                    "--device", str(dev), "--tp", "2"])),
                ("train_voicebox --num_processes 2", lambda: train_voicebox.main([
                    "--train_filelist", "x", "--output_dir", os.path.join(tmp, "r2"),
                    "--device", str(dev), "--num_processes", "2"]))):
            try:
                call()
                said[name] = "ran"
            except ValueError as e:
                said[name] = str(e)
        log(f"phase 18 (e) refusals on {n} card: " + json.dumps(said))
        if not all("need 2 devices" in s for s in said.values()):
            raise AssertionError(f"phase 18 (e): a sharded CLI did not refuse one card by name: "
                                 f"{said}")
        out.update({"refusals": said, "dp2_run": f"not run: {n} card"})
        return out
    rows = os.path.join(tmp, "dp2_rows")
    os.makedirs(rows)
    rng = np.random.default_rng(18)
    with open(os.path.join(rows, "part0.txt"), "w") as f:
        for _ in range(8):
            f.write(" ".join(map(str, [1] + rng.integers(3, 500, 60).tolist())) + "\n")
    common = ["--tiny", "--data_path", rows, "--max_steps", "4", "--train_batch_size", "2",
              "--logging_steps", "1", "--save_steps", "0"]
    root = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-m", "usdm_tpu_torch.cli.train_pt", *common,
                               "--output_dir", os.path.join(tmp, "dp2"), "--dp", "2",
                               "--coordinator", f"localhost:{port}", "--num_processes", "2",
                               "--process_id", str(r)], cwd=root) for r in range(2)]
    rcs = [p.wait(timeout=300) for p in procs]
    run_module("usdm_tpu_torch.cli.train_pt", *common, "--output_dir", os.path.join(tmp, "dp1"))
    a, b = _train_metrics(os.path.join(tmp, "dp2")), _train_metrics(os.path.join(tmp, "dp1"))
    close = all(abs(x["train/loss"] / y["train/loss"] - 1) <= 2e-2 for x, y in zip(a, b))
    if any(rcs) or len(a) != 4 or not close:
        raise AssertionError(f"phase 18 (e): train_pt --dp 2 (rc {rcs}) against --dp 1: {a} {b}")
    out["dp2_run"] = "cli.train_pt --tiny --dp 2 over two cards within 2e-2 of --dp 1"
    return out


def mesh_train_run(dev, lm: dict, gan: dict, out_dir: str, smi: str) -> dict:
    """Phase 18: the sharded trainers on one card.  (a) train_pt in a
    one-rank NCCL group against phase 11 (b); (b) the CFM and GAN steps on
    a one-rank mesh against one device; (c) the distill step against phase
    12 (c); (d) the kernels at every per-rank shape of dp / tp 2, 4, 8;
    (e) the one-card refusals.  -> the results; "launches": (a)-(c)'s."""
    import torch

    from usdm_tpu_torch.core import distributed as D
    from usdm_tpu_torch.core import mesh as MS

    out, t0 = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out["pt"] = _mesh_pt_run(dev, root, lm["pt"]["info"]["steps"], smi)
        log(f"phase time: 18 (a) {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        tp_group(dev)
        mesh = MS.single_device_mesh(dev)
        out["dp"] = _dp_equal_runs(dev, mesh)
        out["distill"] = _mesh_distill_run(dev, mesh, gan["distill"]["bf16"]["steps"][0])
        D.finish()
        log(f"phase time: 18 (b)-(c) {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        out["max_abs_err"] = rank_kernel_checks(dev, out_dir)
        log(f"phase time: 18 (d) {time.perf_counter() - t1:.1f} s")
        out["e"] = _mesh_refusals(dev, root)
    if torch.distributed.is_initialized():
        raise AssertionError("phase 18 left a process group behind")
    launches = dict(out["pt"]["launches"])
    for k, n in out["distill"]["launches"].items():
        launches[k] += n
    for k, n in out["dp"]["cfm"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    launches["fused_activation1d"] = out["dp"]["gan"]["k3_launches"]
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log("phase 18: " + json.dumps({"dp2_run": out["e"]["dp2_run"], "cards": out["e"]["cards"],
                                   "launches": launches}))
    log(f"phase time: sharded training (phase 18) {out['seconds']:.1f} s")
    return out


def _write_profile(prof, out_dir: str, name: str = "respond_profile.txt") -> None:
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile: kernel table in {path}")
    lines = table.splitlines()
    log("\n".join(lines[:25] + lines[-3:]))  # the top rows and the self-time totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="run a third bf16 and a third W8A8 turn, a second server load and "
                         "one train step under torch.profiler")
    ap.add_argument("--out-dir", default="chip_smoke_out",
                    help="where the run's log (chip_smoke.log), the nvcc log and the profile "
                         "table are written")
    ap.add_argument("--compare-with", metavar="PARENT",
                    help="instead of the phases: time kernels, bf16 and W8A8 turns, int8 "
                         "server loads and CFM train steps of the usdm_tpu_torch in PARENT (a "
                         "checkout of another commit) and of this checkout, in turns on one "
                         "card")
    ap.add_argument("--compare-cells", default=",".join(COMPARE_CELLS),
                    help="with --compare-with: which of " + ", ".join(COMPARE_CELLS)
                         + " to time after the kernels (comma-separated)")
    ap.add_argument("--turn-worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.turn_worker:
        return turn_worker(args.turn_worker)
    from usdm_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    # PyTorch's default flags, as the CLIs run: the port's f32 convolutions
    # turn cuDNN's TF32 off themselves (usdm_tpu_torch/ops/conv.py)
    log(f"tf32: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    if args.compare_with:  # each worker builds its own tree's kernels
        os.makedirs(args.out_dir, exist_ok=True)
        cells = tuple(c for c in args.compare_cells.split(",") if c)
        if not set(cells) <= set(COMPARE_CELLS):
            ap.error(f"--compare-cells: {cells} not among {COMPARE_CELLS}")
        print(json.dumps({"compare": compare_run(args.compare_with, args.out_dir, cells)}))
        print(smi.stdout.strip())
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    os.makedirs(args.out_dir, exist_ok=True)
    # everything printed from here on also goes to <out-dir>/chip_smoke.log
    sys.stdout = _Tee(sys.stdout, open(os.path.join(args.out_dir, "chip_smoke.log"), "w"))
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    t_start = t0
    with open(os.path.join(args.out_dir, "nvcc_build.log"), "w") as f:
        f.write(_build.build_log)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    kres = kernel_checks(dev)
    kres.update(train_kernel_checks(dev))
    kres.update(int8_kernel_checks(dev))
    for k, err in tiny_kernel_checks(dev).items():
        kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"], err)
    k4_prompt_err = k4_prompt_case(dev)
    kres["add_mask_ln"]["max_abs_err"] = max(kres["add_mask_ln"]["max_abs_err"], k4_prompt_err)
    train_err = kres.pop("flash_attention_train_err")
    for key, err in zip(("flash_attention", "flash_attention_f32"), train_err):
        kres[key]["max_abs_err"] = max(kres[key]["max_abs_err"], err)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # each kernel's launches come from the run of the path it serves:
        # K1-K3 the bf16 turn, K6 the W8A8 turn (A) and the server (B) together,
        # K1's int8 branch (B), K4 and K5 the trainer, X1-X3 the probe entry
        # points (phase 7; eager calls and CUDA graph replays)
        t_phase = time.perf_counter()
        tiny = tiny_entry_points_run(dev, tmp, user_wav(tmp))
        log(f"phase time: tiny entry points (phase 13) {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        bf16_run = slice_run(dev, args.profile, tmp, args.out_dir, smi.stdout.strip())
        bf16_turn = bf16_run["turns"][-1]
        bf16 = {**bf16_turn["launches"],
                "flash_attention": bf16_turn["flash_attention_mma_launches"]}
        log(f"phase time: bf16 turns {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        int8 = int8_run(dev, tmp, os.path.join(tmp, "user.wav"), args.profile, args.out_dir)
        log(f"phase time: int8 serving {time.perf_counter() - t_phase:.1f} s")
        torch.distributed.destroy_process_group()  # phase 17 (a)'s one-rank NCCL group
        t_phase = time.perf_counter()
        train_info = train_run(dev, args.profile, tmp, args.out_dir)
        train = {**train_info["launches"], **train_info["small_f32_launches"]}
        log(f"phase time: training {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    kres.update(probe_kernel_checks(dev))
    probes = probe_run(dev)["launches"]
    log(f"phase time: probes {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    vocoder = vocoder_gate(dev)
    log("vocoder gate (bench_fused_act): " + json.dumps(vocoder))
    log(f"phase time: vocoder gate {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    spec = spec_run(dev)["launches"]
    log(f"phase time: speculation {time.perf_counter() - t_phase:.1f} s (its two turns: "
        f"phases 4 and 5)")
    t_phase = time.perf_counter()
    lm = lm_train_run(dev, smi.stdout.strip())
    log(f"phase time: LM training (phase 11) {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    gan = gan_distill_run(dev, args.out_dir, smi.stdout.strip())
    log(f"phase time: GAN and distillation training (phase 12) "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    tail = measure_tail_run(dev)
    tail_s = time.perf_counter() - t_phase
    log(f"phase time: 16 (c) kernels, exp_stream_qmv, validate_memory_budget {tail_s:.1f} s")
    log(f"phase time: measuring scripts (phase 16) "
        f"{bf16_run['measure']['seconds'] + int8['measure']['seconds'] + tail_s:.1f} s")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tp = tp_run(dev, tmp, args.out_dir)
    tp_s = time.perf_counter() - t_phase
    log(f"phase time: 17 (b)-(d) kernels at the per-rank shapes, the tp 2 refusal {tp_s:.1f} s")
    log(f"phase time: tp (phase 17) "
        f"{bf16_run['tp']['seconds'] + int8['tp']['seconds'] + tp_s:.1f} s")
    mesh = mesh_train_run(dev, lm, gan, args.out_dir, smi.stdout.strip())
    a, b = int8["A"]["launches"], int8["B"]["launches"]
    # K1 and K6 add the speculative paths: the ngram turns (c) and the
    # bench ports' engines (b)
    spec_k1 = (bf16_run["spec"]["launches"]["paged_decode_attention"]
               + spec["paged_decode_attention"])
    spec_k6 = int8["A_spec"]["launches"]["stream_qmv"] + spec["stream_qmv"]
    launches = {**{k: bf16[k] for k in ("paged_decode_attention", "flash_attention",
                                         "flash_attention_f32", "fused_activation1d")},
                **{k: train[k] for k in ("add_mask_ln", "add_mask_ln_bwd",
                                         "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                                         "flash_attention_bwd_dq_f32",
                                         "flash_attention_bwd_dkv_f32")},
                "stream_qmv": a["stream_qmv"] + b["stream_qmv"] + spec_k6,
                "paged_decode_attention_int8": b["paged_decode_attention_int8"],
                **{k: probes[k] for k in ("mv_io_bf16", "mv_io_i8", "qmv4", "stream_probe")}}
    launches["paged_decode_attention"] += spec_k1
    # the speaker reference's turn (f) and 16 s synthesis (g), and the dense
    # turns (h) and phase 5's: each path's counts, reset just before it
    ref_f, dense_h = bf16_run["ref"]["f"]["launches"], bf16_run["dense"]["turns"][-2]
    launches["flash_attention"] += dense_h["flash_attention_mma_launches"]
    launches["flash_attention_f32"] += ref_f["flash_attention_f32"]
    launches["fused_activation1d"] += ref_f["fused_activation1d"]
    launches["add_mask_ln"] += bf16_run["ref"]["g"]["k4_launches"]
    launches["stream_qmv"] += int8["A_dense"]["turns"][-1]["launches"]["stream_qmv"]
    # phase 4 (i)'s three served turns: K1-K3
    served = bf16_run["serve"]
    for k in ("paged_decode_attention", "flash_attention_f32", "fused_activation1d"):
        launches[k] += served["launches"][k]
    launches["flash_attention"] += served["flash_attention_mma_launches"]
    # phase 11 (b)'s three full-width LM train steps: K2 (forward and remat
    # recompute) and K5, all on the bf16 route
    for k, n in lm["launches"].items():
        launches[k] += n
    lmk = lm["kernels"]["max_abs_err"]
    for key, err in (("flash_attention", lmk["fwd"]), ("flash_attention_bwd_dq", lmk["dq"]),
                     ("flash_attention_bwd_dkv", lmk["dkv"])):
        kres[key]["max_abs_err"] = max(kres[key]["max_abs_err"], err)
    # phase 12: (b)'s three GAN steps (K3), (c)'s six distill steps (K2, K5,
    # bf16 route), (d)'s served draft (K1)
    for k, n in gan["launches"].items():
        launches[k] += n
    # and its checks of each kernel at the shapes those paths give it
    for k, err in gan["max_abs_err"].items():
        kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"], err)
    # phase 13's tiny turn on the card (f32: K1, K2's f32 route, K3)
    for k in ("paged_decode_attention", "flash_attention_f32", "fused_activation1d"):
        launches[k] += tiny["turn_launches"][k]
    # phase 10's two loaded turns (float and default Voicebox): K1-K3
    for turn in bf16_run["load"]["turns"].values():
        for k in ("paged_decode_attention", "flash_attention_f32", "fused_activation1d"):
            launches[k] += turn["launches"][k]
        launches["flash_attention"] += turn["flash_attention_mma_launches"]
    # phase 16: the measuring scripts' runs (each module's counts, reset
    # just before it), and each kernel's checks at their shapes
    for part in (bf16_run["measure"], int8["measure"], tail):
        for k, n in part["launches"].items():
            launches[k] += n
    for k, err in tail["max_abs_err"].items():
        kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"], err)
    # phase 17: (a)'s tensor-parallel engine runs (K1, K2, K6 and K1's int8
    # branch; counts reset just before each run), (b)'s per-rank shapes
    for part in (bf16_run["tp"], int8["tp"]):
        for k, n in part["launches"].items():
            launches[k] += n
    for k, err in tp["max_abs_err"].items():
        kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"], err)
    # phase 18: the sharded trainers' runs on one card ((a) train_pt: K2/K5;
    # (b) CFM: K2/K4/K5, GAN: K3; (c) distill: K2/K5; counts reset just
    # before each run) and (d)'s checks at every per-rank shape
    for k, n in mesh["launches"].items():
        launches[k] += n
    for k, err in mesh["max_abs_err"].items():
        kres[k]["max_abs_err"] = max(kres[k]["max_abs_err"], err)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", **KERNELS[k], "launches": launches[k],
         **{f: kres[k][f] for f in keys}} for k in KERNELS]}))
    print(smi.stdout.strip())
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build on")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
