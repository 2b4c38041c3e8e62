"""The LM trainer CLIs of usdm_tpu_torch (cli/train_pt.py, cli/train_sft.py)
end to end at --tiny on the CPU: a few steps on rows written here, --resume
equal to an uninterrupted run, --offload equal to the resident step,
--export_hf read back by checkpoint.load_mistral (and usdm_tpu's loader),
LoRA over a frozen base, and the refusals (no card, a mesh or process
count that one process cannot serve, train_pt --lora, an HF datasets cache
without `datasets`)."""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from usdm_tpu.core import checkpoint as JCK
from usdm_tpu_torch.cli import train_pt, train_sft
from usdm_tpu_torch.core import checkpoint as CK
from usdm_tpu_torch.core.tree import tree_leaves


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Packed pre-training rows (two files) and ids|labels SFT lines."""
    root = tmp_path_factory.mktemp("lmdata")
    rng = np.random.default_rng(0)
    rows = root / "rows"
    rows.mkdir()
    for part in range(2):
        with open(rows / f"part{part}.txt", "w") as f:
            for _ in range(3):
                segs = [[1] + rng.integers(3, 500, int(rng.integers(8, 20))).tolist()
                        for _ in range(3)]
                f.write(" ".join(str(t) for s in segs for t in s) + "\n")
    sft = root / "sft.txt"
    with open(sft, "w") as f:
        for _ in range(6):
            n = int(rng.integers(12, 30))
            ids = [1] + rng.integers(3, 500, n).tolist()
            labels = [-100] * (n // 2) + ids[n // 2:]  # the user half masked
            f.write(" ".join(map(str, ids)) + "|" + " ".join(map(str, labels)) + "\n")
    return {"rows": str(rows), "sft": str(sft)}


def _state(path, step):
    return torch.load(os.path.join(path, "checkpoints", f"step_{step}", "state.pt"),
                      map_location="cpu", weights_only=True)


def _same_state(a, b) -> bool:
    ta = tree_leaves(a["params"]) + a["opt_state"]["m"] + a["opt_state"]["v"]
    tb = tree_leaves(b["params"]) + b["opt_state"]["m"] + b["opt_state"]["v"]
    return (a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
            and all(torch.equal(x, y) for x, y in zip(ta, tb)))


def _resumed(src, dst, step, run):
    """`run(dst)` after copying only src's checkpoint step_<step> into dst."""
    os.makedirs(os.path.join(dst, "checkpoints"))
    shutil.copytree(os.path.join(src, "checkpoints", f"step_{step}"),
                    os.path.join(dst, "checkpoints", f"step_{step}"))
    run(dst)


def _metrics(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def test_train_pt_tiny_resume_offload_export(data, tmp_path):
    """4 steps (checkpoints at 2 and 4); a run resumed from step 2 reaches
    step 4's state bit for bit (params, moments, count: the rows its first
    steps read are skipped); --offload gives the resident run's params bit
    for bit on the CPU; the HF export loads back through the port's
    load_mistral as the bf16 cast of the final masters, and usdm_tpu's
    loader reads the same values."""
    a, b, c = (str(tmp_path / n) for n in "abc")
    common = ["--tiny", "--device", "cpu", "--data_path", data["rows"], "--max_steps", "4",
              "--logging_steps", "1", "--train_batch_size", "2"]
    assert train_pt.main(common + ["--output_dir", a, "--save_steps", "2", "--export_hf",
                                   str(tmp_path / "hf")]) == 0
    assert [r["step"] for r in _metrics(a)] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/loss"]) and r["train/step_s"] > 0 for r in _metrics(a))
    _resumed(a, b, 2, lambda d: train_pt.main(common + ["--output_dir", d, "--save_steps", "2",
                                                        "--resume"]))
    assert _same_state(_state(a, 4), _state(b, 4))
    assert train_pt.main(common + ["--output_dir", c, "--save_steps", "4", "--offload"]) == 0
    assert _same_state(_state(a, 4), _state(c, 4))
    params, cfg = CK.load_mistral(str(tmp_path / "hf"), dtype="float32", device="cpu")
    final = _state(a, 4)["params"]
    assert cfg.vocab_size == 512 and cfg.num_layers == 2
    for got, want in zip(tree_leaves(params), tree_leaves(final)):
        assert torch.equal(got, want.to(torch.bfloat16).float())
    jparams, _ = JCK.load_mistral(str(tmp_path / "hf"), dtype="float32")
    np.testing.assert_array_equal(np.asarray(jax.device_get(jparams["embed"])),
                                  params["embed"].numpy())


def test_train_pt_lora_and_profile(data, tmp_path, capsys):
    """--lora is refused by name (usdm_tpu's train_pt parses it and trains
    every parameter); --profile_steps writes the trace, the kernel table and
    its summary for the first steps and trains on; --eval_data_path logs the
    held-out loss every --eval_steps and at the end."""
    out = str(tmp_path / "pt")
    args = ["--tiny", "--device", "cpu", "--data_path", data["rows"], "--output_dir", out,
            "--max_steps", "3", "--logging_steps", "1"]
    with pytest.raises(SystemExit):
        train_pt.main(args + ["--lora"])
    assert "--lora" in capsys.readouterr().err
    assert train_pt.main(args + ["--profile_steps", "2", "--eval_data_path", data["rows"],
                                 "--eval_steps", "2", "--eval_batches", "2"]) == 0
    assert len(_metrics(out)) == 3
    for f in ("trace.json", "kernels.txt", "summary.json"):
        assert os.path.exists(os.path.join(out, "trace", f))
    with open(os.path.join(out, "trace", "summary.json")) as f:
        summary = json.load(f)
    assert summary["wall_s"] > 0  # no card: no device time
    assert summary["device_sum_s"] == summary["busy_s"] == summary["device_busy"] == 0.0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval/loss" in r]
    assert [r["step"] for r in evals] == [2, 3] and all(np.isfinite(r["eval/loss"]) for r in evals)
    assert _state(out, 3)["step"] == 3


def test_train_sft_full_resume_and_lora_export(data, tmp_path):
    """train_sft --tiny, every parameter: a run resumed from step 2 of 4
    equals the uninterrupted one bit for bit (the same batch order).  Then
    --lora from that run's export: the merged export equals the base plus
    the saved adapters' product (bf16 on disk), and every weight the
    adapters do not touch is the base's bit for bit."""
    a, b, lo = (str(tmp_path / n) for n in ("a", "b", "lora"))
    common = ["--tiny", "--device", "cpu", "--train_path", data["sft"], "--max_steps", "4",
              "--logging_steps", "1", "--save_steps", "2"]
    assert train_sft.main(common + ["--output_dir", a, "--export_hf", str(tmp_path / "hf"),
                                    "--eval_path", data["sft"]]) == 0  # accepted, unused
    _resumed(a, b, 2, lambda d: train_sft.main(common + ["--output_dir", d, "--resume"]))
    assert _same_state(_state(a, 4), _state(b, 4))
    assert train_sft.main(["--device", "cpu", "--model_dir", str(tmp_path / "hf"),
                           "--train_path", data["sft"], "--output_dir", lo, "--max_steps", "3",
                           "--lora", "--learning_rate", "1e-2", "--export_hf",
                           str(tmp_path / "merged")]) == 0
    base, _ = CK.load_mistral(str(tmp_path / "hf"), dtype="float32", device="cpu")
    merged, _ = CK.load_mistral(str(tmp_path / "merged"), dtype="float32", device="cpu")
    adapters = _state(lo, 3)["params"]
    for lb, lm, lw in zip(base["layers"], merged["layers"], adapters):
        for k in lb:
            if k not in lw:
                assert torch.equal(lb[k], lm[k]), k
                continue
            a_ = lw[k]
            want = (lb[k] + (a_["a"] @ a_["b"]) * a_["scale"]).to(torch.bfloat16).float()
            assert torch.equal(lm[k], want), k
        assert float((lm["wq"] - lb["wq"]).abs().max()) > 0  # the adapters moved


def test_cli_refusals(data, tmp_path, monkeypatch):
    """Without a card --device cuda (the default) raises; the multi-process
    flags are served, and where one process stands alone they raise by name
    what is missing (the ranks of --dp/--tp/--num_slices, a rendezvous for
    --num_processes, a rank for --coordinator) rather than train on one
    device; a datasets cache without `datasets` names the package."""
    base = ["--tiny", "--output_dir", str(tmp_path / "o"), "--max_steps", "1"]
    pt, sft = base + ["--data_path", data["rows"]], base + ["--train_path", data["sft"]]
    for k in ("WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for main, args in ((train_pt.main, pt), (train_sft.main, sft)):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                main(args)
        for extra, said in ((["--dp", "2"], "needs 2 processes"),
                            (["--tp", "2"], "needs 2 processes"),
                            (["--coordinator", "h:1"], "needs --num_processes and --process_id"),
                            (["--num_processes", "2"], "rendezvous"),
                            (["--num_slices", "2"], "needs 2 processes")):
            with pytest.raises(ValueError, match=said):
                main(args + ["--device", "cpu"] + extra)
    assert not torch.distributed.is_initialized()
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ModuleNotFoundError, match="datasets"):
        next(train_pt.iter_packed_rows(str(tmp_path)))
