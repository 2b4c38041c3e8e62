"""CLI: offline data preprocessing (pre-training stages 1-4, DailyTalk SFT,
decoder filelists) on one GPU.

Port of usdm_tpu/cli/preprocess.py, with the same subcommands and flags plus
`--device` (default cuda, which raises without a card) where XLS-R runs:

  python -m usdm_tpu_torch.cli.preprocess stage1 --data_path wavs/ --output_path out/ \\
      --xlsr_dir xlsr.pt --kmeans kmeans.npy
  python -m usdm_tpu_torch.cli.preprocess stage2 --data_path aligned/ --output_path out/ --epoch 1
  python -m usdm_tpu_torch.cli.preprocess stage3 --data_path out/ --output_path packed/ --epoch 1
  python -m usdm_tpu_torch.cli.preprocess stage4 --data_path packed/ --output_path cache/
  python -m usdm_tpu_torch.cli.preprocess dailytalk --train_metadata_path ... --data_dir ...
  python -m usdm_tpu_torch.cli.preprocess decoder-filelist --wav_dir ... --output_path ...

Units come from the port's XLS-R (core/checkpoint.py::load_xlsr, then
models/xlsr.py::extract_units_bucketed on the device: on the card a clip of
2,048 or more frames runs K2's f32 route); the tokenizer is
core/tokenizer.py's.  stage3 packs with data/packing.py's g++-built FFD
core.  stage4 needs the `datasets` package, imported when it runs; the
trainers read stage3's `part*.txt` without it.  MFA alignment stays an
external artifact, as in usdm_tpu.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import sys

import numpy as np


def _build_unit_extractor(args):
    """-> wav16k np.ndarray -> List[int], through XLS-R on args.device."""
    from usdm_tpu_torch.core import checkpoint as ckpt
    from usdm_tpu_torch.models import xlsr as XL

    params, cfg = ckpt.load_xlsr(args.xlsr_dir, args.kmeans, device=args.device)

    def extract(wav: np.ndarray):
        # bucketed, as usdm_tpu: the padded tail is masked, so the units
        # equal an exact-length run's
        return XL.extract_units_bucketed(params, cfg, wav)

    return extract


def _tokenizer(args):
    from usdm_tpu_torch.core.tokenizer import UsdmTokenizer

    if args.tokenizer_dir:
        return UsdmTokenizer.load(args.tokenizer_dir)
    return UsdmTokenizer.build_test(num_units=args.num_unit_tokens)


def cmd_stage1(args) -> int:
    """wav -> 16 kHz units + normalized transcript."""
    from usdm_tpu_torch.audio.wav import load_wav
    from usdm_tpu_torch.data.interleave import normalize_transcript

    extract = _build_unit_extractor(args)
    wavs = sorted(glob.glob(os.path.join(args.data_path, "**", "*.wav"), recursive=True))
    os.makedirs(args.output_path, exist_ok=True)
    for wav_path in wavs:
        base = os.path.splitext(os.path.basename(wav_path))[0]
        txt_path = os.path.splitext(wav_path)[0] + ".txt"
        wav, _ = load_wav(wav_path, sr=16000)
        units = extract(wav)
        with open(os.path.join(args.output_path, f"{base}_unit.txt"), "w") as f:
            f.write(" ".join(str(u) for u in units))
        if os.path.exists(txt_path):
            with open(txt_path) as f:
                text = f.read().strip()
            with open(os.path.join(args.output_path, f"{base}.txt"), "w") as f:
                f.write(normalize_transcript(text))
    print(f"stage1: processed {len(wavs)} wavs")
    return 0


_S2 = {}  # per-process stage2 worker state (the tokenizer is not picklable)


def _stage2_init(tokenizer_dir, num_unit_tokens, epoch, seed):
    _S2["tok"] = _tokenizer(argparse.Namespace(tokenizer_dir=tokenizer_dir,
                                               num_unit_tokens=num_unit_tokens))
    _S2["epoch"] = epoch
    _S2["seed"] = seed


def _stage2_one(job):
    """One utterance -> per-epoch (token string, length), or None.
    Deterministic per file (its rng seeded by (seed, file index)), so the
    output is the same whatever the worker count or completion order."""
    from usdm_tpu_torch.data.interleave import interleave_tokens, prepare_alignment

    idx, tg = job
    tok = _S2["tok"]
    ts = tok.ts
    unit_path = tg.replace(".TextGrid", "_unit.txt").replace("-textgrid", "")
    if not os.path.exists(unit_path):
        return None
    with open(unit_path) as f:
        units = [int(u) for u in f.readline().split("\t")[0].split()]
    unit_ids = [ts.unit_id(u) for u in units]
    try:
        res = prepare_alignment(tg, len(unit_ids))
    except ValueError:  # an alignment that does not scale to the units
        return None
    if res is None:
        return None
    merged, _ = res
    rng = random.Random(_S2["seed"] * 1000003 + idx)
    out = []
    for _ in range(_S2["epoch"]):
        seq = interleave_tokens(
            merged, unit_ids, lambda s: tok.encode(s, add_bos=False),
            [ts.continue_id], [ts.correspond_id], ts.bos_id, ts.eos_id, rng,
        )
        if any(x >= ts.vocab_size for x in seq):
            raise ValueError(f"{tg}: a token id past the vocabulary ({ts.vocab_size})")
        out.append((" ".join(str(i) for i in seq), len(seq)))
    return out


def cmd_stage2(args) -> int:
    """TextGrid alignments + units -> per-epoch interleaved token streams:
    data_epochN.txt (space-separated ids, a line an utterance) and
    data_epochN.json (the lengths).  --workers N processes utterances in
    parallel; the output is byte-identical for any worker count."""
    tg_list = sorted(glob.glob(os.path.join(args.data_path, "**", "*.TextGrid"), recursive=True))
    init_args = (args.tokenizer_dir, args.num_unit_tokens, args.epoch, args.seed)
    jobs = list(enumerate(tg_list))
    if args.workers > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # fork is unsafe in a process with threads (torch's)
        with ctx.Pool(args.workers, initializer=_stage2_init, initargs=init_args) as pool:
            results = pool.map(_stage2_one, jobs, chunksize=16)
    else:
        _stage2_init(*init_args)
        results = [_stage2_one(j) for j in jobs]

    totals = [[] for _ in range(args.epoch)]
    lengths = [[] for _ in range(args.epoch)]
    for res in results:
        if res is None:
            continue
        for e, (s, n) in enumerate(res):
            totals[e].append(s)
            lengths[e].append(n)

    os.makedirs(args.output_path, exist_ok=True)
    for e in range(args.epoch):
        with open(os.path.join(args.output_path, f"data_epoch{e + 1}.json"), "w") as f:
            json.dump(lengths[e], f, indent=4)
        with open(os.path.join(args.output_path, f"data_epoch{e + 1}.txt"), "w") as f:
            f.write("\n".join(totals[e]))
    print(f"stage2: {len(totals[0])} utterances x {args.epoch} epochs")
    return 0


def cmd_stage3(args) -> int:
    """Filter rows longer than max_length, FFD-pack the rest (shuffled by
    the sampler's seed) into bins, write each bin as one row: partN.txt."""
    from usdm_tpu_torch.data.packing import MultipackSampler

    for epoch in range(1, args.epoch + 1):
        path = os.path.join(args.data_path, f"data_epoch{epoch}.txt")
        with open(path) as f:
            rows = [line.split() for line in f.read().splitlines() if line]
        rows = [r for r in rows if len(r) <= args.max_length]
        lengths = np.asarray([len(r) for r in rows], np.int64)

        sampler = MultipackSampler(args.max_length, lengths, num_replicas=1, rank=0,
                                   seed=args.seed + epoch)
        batches = sampler.generate_batches(set_stats=True)
        os.makedirs(args.output_path, exist_ok=True)
        out_path = os.path.join(args.output_path, f"part{epoch - 1}.txt")
        with open(out_path, "w") as f:
            for batch in batches:
                packed = []
                for idx in batch:
                    packed += rows[int(idx)]
                f.write(" ".join(packed) + "\n")
        print(f"stage3 epoch {epoch}: {len(batches)} bins, "
              f"efficiency {sampler.efficiency():.4f}")
    return 0


def cmd_stage4(args) -> int:
    """Packed text -> an HF datasets cache with a train/test split."""
    try:
        import datasets
    except ImportError as e:
        raise ModuleNotFoundError("stage4 writes an HF datasets cache and needs the `datasets` "
                                  "package, which is not installed (the trainers read "
                                  "stage3's part*.txt without it)") from e

    files = sorted(glob.glob(os.path.join(args.data_path, "part*.txt")))
    rows = []
    for fp in files:
        with open(fp) as f:
            rows += [line for line in f.read().splitlines() if line]
    ids = [{"input_ids": [int(t) for t in r.split()]} for r in rows]
    n_test = max(1, int(len(ids) * args.test_ratio))
    ds = datasets.DatasetDict({
        "train": datasets.Dataset.from_list(ids[n_test:]),
        "test": datasets.Dataset.from_list(ids[:n_test]),
    })
    ds.save_to_disk(args.output_path)
    print(f"stage4: {len(ids)} packed rows -> {args.output_path}")
    return 0


def cmd_dailytalk(args) -> int:
    """DailyTalk metadata + wavs -> train/test `ids|labels` files."""
    from usdm_tpu_torch.audio.wav import load_wav
    from usdm_tpu_torch.data.dailytalk import build_dataset

    tok = _tokenizer(args)
    ts = tok.ts
    extract = _build_unit_extractor(args)

    def units_str(dialog_id: str) -> str:
        wav_path = os.path.join(args.data_dir, dialog_id.split("_")[-1][1:], f"{dialog_id}.wav")
        wav, _ = load_wav(wav_path, sr=16000)
        return "".join(f"<|unit{u}|>" for u in extract(wav))

    os.makedirs(args.output_path, exist_ok=True)
    for split, meta_path in (("train", args.train_metadata_path),
                             ("test", args.test_metadata_path)):
        with open(meta_path) as f:
            metadata = [line.strip() for line in f if line.strip()]
        ids = sorted({line.split("|")[0] for line in metadata})
        units_by_id = {i: units_str(i) for i in ids}
        data = build_dataset(metadata, units_by_id, tok.encode, ts.newline_id, ts.correspond_id)
        with open(os.path.join(args.output_path, f"{split}.txt"), "w") as f:
            f.write("\n".join(" ".join(map(str, ids_)) + "|" + " ".join(map(str, labs))
                              for ids_, labs in data))
        print(f"dailytalk {split}: {len(data)} samples")
    return 0


def cmd_decoder_filelist(args) -> int:
    """wav dir -> `path|units|durations` filelist (durations all 1)."""
    from usdm_tpu_torch.data.unit_mel import build_filelist

    extract = _build_unit_extractor(args)
    n = build_filelist(args.wav_dir, extract, args.output_path)
    print(f"decoder-filelist: {n} files -> {args.output_path}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def xlsr_args(sp):
        sp.add_argument("--xlsr_dir", required=True)
        sp.add_argument("--kmeans", required=True)
        sp.add_argument("--device", default="cuda",
                        help="torch device XLS-R runs on (default cuda, which raises without "
                             "a card)")

    s1 = sub.add_parser("stage1")
    s1.add_argument("--data_path", required=True)
    s1.add_argument("--output_path", required=True)
    xlsr_args(s1)

    s2 = sub.add_parser("stage2")
    s2.add_argument("--data_path", required=True)
    s2.add_argument("--output_path", required=True)
    s2.add_argument("--tokenizer_dir", default=None)
    s2.add_argument("--num_unit_tokens", type=int, default=10000)
    s2.add_argument("--epoch", type=int, default=1)
    s2.add_argument("--seed", type=int, default=43)
    s2.add_argument("--workers", type=int, default=0,
                    help="parallel utterance workers (0/1 = serial; output is "
                         "identical for any worker count)")

    s3 = sub.add_parser("stage3")
    s3.add_argument("--data_path", required=True)
    s3.add_argument("--output_path", required=True)
    s3.add_argument("--epoch", type=int, default=1)
    s3.add_argument("--max_length", type=int, default=8192)
    s3.add_argument("--seed", type=int, default=0)

    s4 = sub.add_parser("stage4")
    s4.add_argument("--data_path", required=True)
    s4.add_argument("--output_path", required=True)
    s4.add_argument("--test_ratio", type=float, default=0.01)

    dt = sub.add_parser("dailytalk")
    dt.add_argument("--train_metadata_path", required=True)
    dt.add_argument("--test_metadata_path", required=True)
    dt.add_argument("--data_dir", required=True)
    dt.add_argument("--output_path", required=True)
    dt.add_argument("--tokenizer_dir", default=None)
    dt.add_argument("--num_unit_tokens", type=int, default=10000)
    xlsr_args(dt)

    df = sub.add_parser("decoder-filelist")
    df.add_argument("--wav_dir", required=True)
    df.add_argument("--output_path", required=True)
    xlsr_args(df)

    args = p.parse_args(argv)
    return {
        "stage1": cmd_stage1,
        "stage2": cmd_stage2,
        "stage3": cmd_stage3,
        "stage4": cmd_stage4,
        "dailytalk": cmd_dailytalk,
        "decoder-filelist": cmd_decoder_filelist,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
