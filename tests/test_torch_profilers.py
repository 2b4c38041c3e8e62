"""The port's measuring scripts (usdm_tpu_torch/scripts/profile_decode_step.py
and profile_respond.py) on the CPU: their plumbing at toy size with the
kernels' plain versions (no device metric), the weight-byte bound the
decode-step split is read against, and their refusal without a card.
"""

import pytest
import torch

from usdm_tpu_torch.core.config import MistralConfig
from usdm_tpu_torch.scripts import profile_decode_step as PDS
from usdm_tpu_torch.scripts import profile_respond as PR


def test_profile_decode_step_tiny_cpu():
    """Both weight kinds give the link over bf16 and int8 pools and every
    part; rest_ms is the link less the scan, the tail, K1 and embed + RoPE."""
    lines = PDS.main(["--device", "cpu", "--tiny", "--replays", "2"])
    assert [ln["weights"] for ln in lines] == ["bfloat16", "w8a8"]
    for ln in lines:
        assert set(ln["link_ms"]) == {"kv_bf16", "kv_int8"}
        p = ln["parts"]
        assert set(p) == {"weights_only_scan_ms", "lm_head_ms", "tail_ms", "k1_32_layers_ms",
                          "embed_rope_ms", "rest_ms"}
        assert p["rest_ms"] == pytest.approx(ln["link_ms"]["kv_bf16"] - sum(
            p[k] for k in ("weights_only_scan_ms", "tail_ms", "k1_32_layers_ms",
                           "embed_rope_ms")))
    assert lines[1]["weight_bytes"] < lines[0]["weight_bytes"]


def test_link_bytes_at_full_width():
    """The 7B's link reads 13.96 GB of bf16 layers and 0.34 GB of lm_head
    (4.27 ms at 3.35 TB/s); W8A8 layers halve the projections' bytes; the
    sliced lm_head reads its 10,002 rows.  Counted from meta tensors."""
    cfg = MistralConfig()
    dev = torch.device("meta")
    bf16, w8a8 = PDS.zero_params(cfg, dev, False), PDS.zero_params(cfg, dev, True)
    proj = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336  # elements a layer
    norms = 32 * 2 * 4096 * 2  # ln1 and ln2, bf16
    head, row = 42003 * 4096 * 2, 4096 * 2  # and final_norm's or embed's one row
    assert PDS.link_bytes(bf16) == 32 * proj * 2 + norms + head + 2 * row
    assert PDS.link_bytes(bf16, PDS.LOGITS_SLICE) == 32 * proj * 2 + norms + 10002 * row + 2 * row
    assert abs(PDS.link_bytes(bf16) / PDS.HBM_BYTES_PER_S * 1e3 - 4.27) < 0.01
    scales = 32 * 2 * (4096 + 1024 + 1024 + 4096 + 14336 + 14336 + 4096)  # bf16, per channel
    assert PDS.link_bytes(w8a8) == 32 * proj + scales + norms + head + 2 * row


def test_profile_respond_tiny_cpu():
    """The tiny turn timed by phase: three stages with their prefill and
    decode seconds, the host gap, the ODE and BigVGAN inside synthesis, the
    engine's perf_s and counters."""
    rec = PR.main(["--device", "cpu", "--tiny"])
    assert [s["stage"] for s in rec["stages"]] == list(PR.STAGE_KEYS.values())
    for s in rec["stages"]:
        assert s["prefill_s"] > 0 and s["new_toks"] > 0
        assert s["decode_s"] == pytest.approx(s["s"] - s["prefill_s"])
    assert 0 < rec["voicebox_ode_s"] + rec["bigvgan_s"] <= rec["synthesis_s"]
    assert rec["agent_units"] > 0 and "prefill" in rec["perf_s"]
    assert rec["engine_stats"]["steps"] > 0


def test_profilers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (PDS.main, PR.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
