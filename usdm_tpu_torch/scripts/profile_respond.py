"""Time one full-width respond() turn phase by phase, on the card.

Port of scripts/profile_respond.py.  The pinned-budget turn of chip_smoke's
phase 4 (stage budgets 48/32/256, greedy, seed 1, 50 Heun steps, 3 s of
16 kHz noise) runs twice on one pipeline, a warm-up and the measured turn;
the measured one is timed by phase: the wav load, XLS-R unit extraction,
each dialog stage (its wall, split into the engine's prefill seconds, read
from `stats()["perf_s"]`, and the rest, decode), the host gap between the
stages, the Voicebox ODE, BigVGAN and the wav write.  The two synthesis
phases are timed by wrapping `models/voicebox.py::generate` and
`models/bigvgan.py::generator` for the call, each between device
synchronizations.  Prints one JSON line (with the engine's `perf_s` and
`stats()`), then the device line.

The pipeline is UsdmPipeline.full_random (W8A8 7B as the TPU script's
"7B-int8", XLS-R, Voicebox and BigVGAN in f32), seeded: zero weights, as
the TPU script uses, make every logit equal, so each stage's argmax picks
its lowest allowed id, `</s>`, and the turn has no tokens to time.
`run()` takes any pipeline (chip_smoke passes phases 4 and 5's).  Without a
card it raises; `--device cpu --tiny` runs the tiny pipeline's plain
versions (a plumbing check: its times are no device metric).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from usdm_tpu_torch.audio.wav import load_wav, write_wav
from usdm_tpu_torch.engine.server import PagedDialogPolicy
from usdm_tpu_torch.models import bigvgan as BV
from usdm_tpu_torch.models import voicebox as VB
from usdm_tpu_torch.ops.sampling import STAGE_TEXT2TEXT, STAGE_TEXT2UNIT, STAGE_UNIT2TEXT
from usdm_tpu_torch.scripts.common import device, device_info

BUDGETS = {STAGE_UNIT2TEXT: 48, STAGE_TEXT2TEXT: 32, STAGE_TEXT2UNIT: 256}
STAGE_KEYS = {STAGE_UNIT2TEXT: "stageA_unit2text", STAGE_TEXT2TEXT: "stageB_text2text",
              STAGE_TEXT2UNIT: "stageC_text2unit"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _timed(module, name: str, record: dict, key: str, dev: torch.device):
    """module.name wrapped for the block: each call's wall, between device
    synchronizations, added to record[key]."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(dev)
        record[key] = record.get(key, 0.0) + time.perf_counter() - t0
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _turn(pipe, wav_path: str, out_path: str, seed: int, budgets: dict) -> dict:
    """One turn, phase by phase -> the record."""
    dev = pipe.device
    server = pipe._dialog_server()
    eng = server.engine
    rec, stages = {}, []

    class TimedPolicy(PagedDialogPolicy):
        def _run_stage(self, stage, prompt):
            if budgets:
                self.max_new_tokens = budgets[stage]
            steps, prefill = eng.steps, eng.stats()["perf_s"].get("prefill", 0.0)
            t0 = time.perf_counter()
            out = super()._run_stage(stage, prompt)
            dt = time.perf_counter() - t0
            pf = eng.stats()["perf_s"].get("prefill", 0.0) - prefill
            stages.append({"stage": STAGE_KEYS[stage], "s": dt, "prefill_s": pf,
                           "decode_s": dt - pf, "prompt_toks": len(self.tok.encode(prompt)),
                           "new_toks": len(out), "steps": eng.steps - steps})
            return out

    policy = TimedPolicy(server, pipe.tokenizer, max_new_tokens=pipe.max_new_tokens, seed=seed)
    t_all = time.perf_counter()
    wav, _ = load_wav(wav_path, sr=pipe.xlsr_cfg.sample_rate)
    rec["load_wav_s"] = time.perf_counter() - t_all
    t0 = time.perf_counter()
    units = pipe.extract_units(wav)
    _sync(dev)
    rec["xlsr_units_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = policy.respond_to_units(units)
    rec["dialog_total_s"] = time.perf_counter() - t0
    rec["stages"] = stages
    rec["dialog_host_gap_s"] = rec["dialog_total_s"] - sum(s["s"] for s in stages)
    t0 = time.perf_counter()
    with _timed(VB, "generate", rec, "voicebox_ode_s", dev), \
            _timed(BV, "generator", rec, "bigvgan_s", dev):
        audio = pipe.decoder.synthesize(res.agent_units, seed=seed, n_timesteps=50)
    rec["synthesis_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if len(audio):
        write_wav(out_path, audio, pipe.decoder.mel_cfg.sampling_rate)
    rec["write_wav_s"] = time.perf_counter() - t0
    rec["wall_s"] = time.perf_counter() - t_all
    rec["user_units"] = len(units)
    rec["agent_units"] = len(res.agent_units)
    rec["audio_s"] = len(audio) / pipe.decoder.mel_cfg.sampling_rate
    rec["rtf"] = rec["wall_s"] / rec["audio_s"] if rec["audio_s"] else None
    return rec


def run(pipe, wav_path: str, seed: int = 1, budgets: dict = BUDGETS) -> dict:
    """A warm-up turn, then the measured one on the engine's cleared
    `perf_s` -> the measured turn's record, with that turn's `perf_s` and
    the engine's numeric `stats()` after both turns (each stage's record
    holds its own steps)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "agent.wav")
        _turn(pipe, wav_path, out, seed, budgets)
        eng = pipe._dialog_server().engine
        eng.perf.clear()
        rec = _turn(pipe, wav_path, out, seed, budgets)
    stats = eng.stats()
    rec["perf_s"] = stats.pop("perf_s")
    rec["engine_stats"] = {k: v for k, v in stats.items() if isinstance(v, (int, float))}
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="UsdmPipeline.tiny_random and its own budgets (plumbing check)")
    args = ap.parse_args(argv)
    dev = device(args.device)
    from usdm_tpu_torch.pipeline import UsdmPipeline

    if args.tiny:
        pipe, budgets = UsdmPipeline.tiny_random(device=dev), None
    else:
        pipe, budgets = UsdmPipeline.full_random(device=dev, lm_int8=True), BUDGETS
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wav = os.path.join(tmp, "user.wav")
            write_wav(wav, (np.random.default_rng(0).standard_normal(48000) * 0.1)
                      .astype(np.float32), 16000)
            rec = run(pipe, wav, budgets=budgets)
    finally:
        pipe.close()
    print(json.dumps(rec), flush=True)
    print(json.dumps({"device": device_info(dev)}))
    return rec


if __name__ == "__main__":
    main()
