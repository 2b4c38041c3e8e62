"""The port's data preprocessing (usdm_tpu_torch/data/interleave.py,
data/dailytalk.py, data/unit_mel.py::build_filelist, audio/units.py::
dedup_units and cli/preprocess.py) against usdm_tpu's, on the CPU.

Inputs are made from numpy seeds: word TextGrids with blanks and zero-width
words, DailyTalk-style metadata, noise clips, and a tiny XLS-R checkpoint
written by chip_smoke.py's exporter and read by both packages' load_xlsr.
The pure-Python functions are held equal output for output; each CLI
subcommand's files are held byte-identical to usdm_tpu's CLI on the same
inputs (stage4: the saved splits row for row); JAX runs its XLS-R under
`highest` matmul precision.  Then stage1 -> stage3's rows drive one step of
cli.train_pt --tiny on the CPU.
"""

import dataclasses
import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from usdm_tpu.audio import units as JUN
from usdm_tpu.cli import preprocess as JPP
from usdm_tpu.core.tokenizer import UsdmTokenizer as JTok
from usdm_tpu.data import dailytalk as JDT
from usdm_tpu.data import interleave as JIL
from usdm_tpu_torch.audio import units as UN
from usdm_tpu_torch.cli import preprocess as PP
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.data import dailytalk as DT
from usdm_tpu_torch.data import interleave as IL

from chip_smoke import WORDS, dailytalk_metadata, word_textgrid, write_corpus  # noqa: E402


def _iv(intervals):
    return [dataclasses.astuple(i) for i in intervals]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interleave_functions_match_jax(tmp_path, seed):
    """TextGrid parsing, blank redistribution, frame scaling, zero-width
    merging, prepare_alignment, segment sampling and interleave_tokens
    (seeded random.Random on both sides) equal usdm_tpu's output for
    output, on clips of 3-25 s (more than one 10 s segment)."""
    rng = np.random.default_rng(seed)
    seconds = float(rng.uniform(3, 25))
    path = tmp_path / "a.TextGrid"
    path.write_text(word_textgrid(rng, round(seconds, 2), zero_width=seed % 2 == 1))
    raw, jraw = IL.parse_textgrid_words(str(path)), JIL.parse_textgrid_words(str(path))
    assert _iv(raw) == _iv(jraw)
    words, jwords = IL.redistribute_blanks(raw), JIL.redistribute_blanks(jraw)
    assert _iv(words) == _iv(jwords)
    n_units = int(seconds * 50)
    scaled = IL.scale_to_frames(words, n_units, raw[-1].max_time)
    assert _iv(scaled) == _iv(JIL.scale_to_frames(jwords, n_units, jraw[-1].max_time))
    assert _iv(IL.merge_zero_width(scaled)) == _iv(JIL.merge_zero_width(
        JIL.scale_to_frames(jwords, n_units, jraw[-1].max_time)))
    res, jres = IL.prepare_alignment(str(path), n_units), JIL.prepare_alignment(str(path), n_units)
    assert (res is None) == (jres is None)
    if res is None:
        return
    assert _iv(res[0]) == _iv(jres[0]) and res[1] == jres[1]
    assert (IL.sample_segment_indices(res[0], random.Random(seed))
            == JIL.sample_segment_indices(jres[0], random.Random(seed)))
    tok = UsdmTokenizer.build_test(num_units=32)
    ts = tok.ts
    unit_ids = [ts.unit_id(int(u)) for u in rng.integers(0, 32, n_units)]
    args = (unit_ids, lambda s: tok.encode(s, add_bos=False), [ts.continue_id],
            [ts.correspond_id], ts.bos_id, ts.eos_id)
    assert (IL.interleave_tokens(res[0], *args, random.Random(seed))
            == JIL.interleave_tokens(jres[0], *args, random.Random(seed)))
    text = " ".join(str(w) for w in rng.choice(WORDS + ("A,B!", "C.D"), 8))
    assert IL.normalize_transcript(text) == JIL.normalize_transcript(text)


def test_dailytalk_functions_match_jax():
    """speech_template, group_dialogs, mask_labels, build_single_turn_samples
    and build_dataset equal usdm_tpu's on seeded metadata and unit strings,
    each package with its own test tokenizer (the two give the same ids)."""
    rng = np.random.default_rng(5)
    meta = dailytalk_metadata(rng, 6)
    assert DT.group_dialogs(meta) == JDT.group_dialogs(meta)
    assert 1 not in [int(k[1:]) for k in DT.group_dialogs(meta)]
    ids = sorted({m.split("|")[0] for m in meta})
    units = {i: "".join(f"<|unit{u}|>" for u in rng.integers(0, 32, int(rng.integers(3, 30))))
             for i in ids}
    assert DT.speech_template("<|unit1|>", "Hi", "Yo", "<|unit2|>") == JDT.speech_template(
        "<|unit1|>", "Hi", "Yo", "<|unit2|>")
    tok, jtok = UsdmTokenizer.build_test(num_units=32), JTok.build_test(num_units=32)
    ts = tok.ts
    data = DT.build_dataset(meta, units, tok.encode, ts.newline_id, ts.correspond_id)
    jdata = JDT.build_dataset(meta, units, jtok.encode, ts.newline_id, ts.correspond_id)
    assert data == jdata and len(data) > 4
    for ids_, labels in data[:3]:
        assert DT.mask_labels(ids_, ts.newline_id, ts.correspond_id) == labels
        assert JDT.mask_labels(ids_, ts.newline_id, ts.correspond_id) == labels
    turns = [(i, units[i], "some text") for i in ids[:4]]
    assert (DT.build_single_turn_samples(turns, tok.encode, ts.newline_id, ts.correspond_id)
            == JDT.build_single_turn_samples(turns, jtok.encode, ts.newline_id,
                                             ts.correspond_id))


def test_dedup_units_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 300):
        units = np.repeat(rng.integers(0, 5, n), rng.integers(1, 4, n)).tolist()
        assert UN.dedup_units(units) == JUN.dedup_units(units)


# ------------------------------------------------------- the CLI, end to end
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """chip_smoke's corpus at four clips of 2 and 3.5 s (noise at 16 kHz with
    transcripts, a word TextGrid over each, DailyTalk metadata over 2-4 s
    turns), and a tiny XLS-R (32 clusters) as an HF directory written by
    chip_smoke's exporter, with its k-means centroids."""
    from chip_smoke import save_xlsr
    from usdm_tpu_torch.core.config import XlsrConfig
    from usdm_tpu_torch.models import xlsr as XL

    root = tmp_path_factory.mktemp("corpus")
    paths = write_corpus(str(root), seed=11, clips=(2.0, 3.5, 2.0, 3.5))
    cfg = XlsrConfig.tiny().replace(num_clusters=32)
    save_xlsr(str(root / "xlsr"), XL.init_params(cfg, torch.Generator().manual_seed(3)), cfg,
              layout="hf")
    np.save(root / "kmeans.npy", np.random.default_rng(11).standard_normal(
        (32, cfg.hidden_size)).astype(np.float32))
    return {**paths, "xlsr": str(root / "xlsr"), "kmeans": str(root / "kmeans.npy")}


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _both(tmp_path, argv: list, device_args=()):
    """Run one subcommand through usdm_tpu's CLI and the port's into
    separate output paths (`{out}` in argv) -> (jax_out, port_out)."""
    outs = []
    for name, main, extra in (("jax", JPP.main, []), ("port", PP.main, list(device_args))):
        out = str(tmp_path / name)
        with jax.default_matmul_precision("highest"):
            assert main([a.replace("{out}", out) for a in argv] + extra) == 0
        outs.append(out)
    return outs


def _xlsr_args(corpus):
    return ["--xlsr_dir", corpus["xlsr"], "--kmeans", corpus["kmeans"]]


def test_stage1_units_match_jax(corpus, tmp_path):
    """stage1's `<name>_unit.txt` and normalized transcripts, byte for byte."""
    j, p = _both(tmp_path, ["stage1", "--data_path", corpus["wavs"], "--output_path",
                            "{out}", *_xlsr_args(corpus)], ("--device", "cpu"))
    got = _files(p)
    assert got == _files(j) and len(got) == 8
    assert all(len(v.split()) > 50 for k, v in got.items() if k.endswith("_unit.txt"))


@pytest.fixture(scope="module")
def stage1_out(corpus, tmp_path_factory):
    """stage1's units (the port's) beside the TextGrids, as stage2 finds them."""
    out = tmp_path_factory.mktemp("aligned")
    assert PP.main(["stage1", "--data_path", corpus["wavs"], "--output_path", str(out),
                    *_xlsr_args(corpus), "--device", "cpu"]) == 0
    for tg in os.listdir(corpus["tg"]):
        shutil.copy(os.path.join(corpus["tg"], tg), out)
    return out


@pytest.mark.parametrize("workers", [0, 2])
def test_stage2_stage3_stage4_match_jax(stage1_out, tmp_path, workers):
    """stage2 (serial and --workers 2) and stage3 files byte-identical to
    usdm_tpu's CLI; stage4's saved splits equal row for row."""
    datasets = pytest.importorskip("datasets")
    common = ["--num_unit_tokens", "32", "--epoch", "2", "--seed", "7"]
    s2 = _both(tmp_path / "s2", ["stage2", "--data_path", str(stage1_out), "--output_path",
                                 "{out}", *common, "--workers", str(workers)])
    assert _files(s2[0]) == _files(s2[1])
    assert len(_files(s2[1])["data_epoch1.txt"].splitlines()) >= 2
    s3 = _both(tmp_path / "s3", ["stage3", "--data_path", s2[1], "--output_path", "{out}",
                                 "--epoch", "2"])
    assert _files(s3[0]) == _files(s3[1]) and sorted(_files(s3[1])) == ["part0.txt",
                                                                        "part1.txt"]
    s4 = _both(tmp_path / "s4", ["stage4", "--data_path", s3[1], "--output_path", "{out}",
                                 "--test_ratio", "0.3"])
    for split in ("train", "test"):
        rows = [datasets.load_from_disk(d)[split]["input_ids"] for d in s4]
        assert rows[0] == rows[1] and rows[1]


def test_dailytalk_and_decoder_filelist_match_jax(corpus, tmp_path):
    """dailytalk's train/test `ids|labels` files and decoder-filelist's
    `path|units|durations` lines, byte-identical to usdm_tpu's CLI."""
    dt = _both(tmp_path / "dt", ["dailytalk", "--train_metadata_path", corpus["train"],
                                 "--test_metadata_path", corpus["test"], "--data_dir",
                                 corpus["dailytalk"], "--output_path", "{out}",
                                 "--num_unit_tokens", "32", *_xlsr_args(corpus)],
               ("--device", "cpu"))
    got = _files(dt[1])
    assert got == _files(dt[0]) and got["train.txt"] and got["test.txt"]
    lists = []
    for name, main, extra in (("jax", JPP.main, []), ("port", PP.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.txt")
        with jax.default_matmul_precision("highest"):
            assert main(["decoder-filelist", "--wav_dir", corpus["wavs"], "--output_path",
                         out, *_xlsr_args(corpus), *extra]) == 0
        lists.append(open(out, "rb").read())
    assert lists[0] == lists[1] and len(lists[1].splitlines()) == 4


def test_preprocess_raises_without_card_and_names_formats(corpus, tmp_path):
    """--device cuda (the default) raises without a card; a .flac the wav
    reader cannot decode raises naming its format."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PP.main(["stage1", "--data_path", corpus["wavs"], "--output_path",
                 str(tmp_path / "o"), *_xlsr_args(corpus)])
    flac = tmp_path / "flac"
    flac.mkdir()
    (flac / "a.flac").write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(ValueError, match="fLaC"):
        PP.main(["decoder-filelist", "--wav_dir", str(flac), "--output_path",
                 str(tmp_path / "l.txt"), *_xlsr_args(corpus), "--device", "cpu"])


def test_stage3_rows_train_one_step(stage1_out, tmp_path):
    """stage1 -> stage2 -> stage3 of the port, then cli.train_pt --tiny
    --device cpu reads stage3's part*.txt for one step (a finite loss)."""
    import json

    from usdm_tpu_torch.cli import train_pt

    s2, s3 = str(tmp_path / "s2"), str(tmp_path / "s3")
    assert PP.main(["stage2", "--data_path", str(stage1_out), "--output_path", s2,
                    "--num_unit_tokens", "32"]) == 0
    assert PP.main(["stage3", "--data_path", s2, "--output_path", s3]) == 0
    out = str(tmp_path / "pt")
    assert train_pt.main(["--tiny", "--device", "cpu", "--data_path", s3, "--output_dir", out,
                          "--max_steps", "1", "--max_input_length", "8192", "--save_steps",
                          "0", "--train_batch_size", "1"]) == 0
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert np.isfinite(rows[-1]["train/loss"])
