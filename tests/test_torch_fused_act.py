"""K3's host-side parts and the ported bench_fused_act, on the CPU.

The CUDA kernel (usdm_tpu_torch/csrc/fused_act.cu) runs only on the card
(tests/test_torch_cuda.py, which also checks its tiling: every output, edges
included, at lengths around the tile and at the stage shapes); here: the
constants the kernel carries against the wrapper's, the vector width the
wrapper picks, the kernel's sin^2 emulated in plain PyTorch against f64, and
the ported scripts/bench_fused_act.py end to end at BigVGANConfig.tiny() (the
plain versions: K3 does not launch on the CPU).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from usdm_tpu_torch.core.config import BigVGANConfig
from usdm_tpu_torch.ops import fused_act as FA
from usdm_tpu_torch.scripts import bench_fused_act

SRC = (Path(FA.__file__).resolve().parents[1] / "csrc" / "fused_act.cu").read_text()


def test_kernel_constants_match_wrapper():
    """The taps the kernel carries are the plain version's filter, bit for
    bit, and its tiling is the one the wrapper assumes."""
    g = [np.float32(v) for v in re.findall(r"#define USDM_G\d (\S+)f", SRC)]
    f = FA._resample_filter()
    assert len(g) == 6
    np.testing.assert_array_equal(np.array(g + g[::-1], np.float32), f)
    assert int(re.search(r"constexpr int kR = (\d+);", SRC).group(1)) == FA.R
    assert int(re.search(r"constexpr int kLanes = (\d+);", SRC).group(1)) == FA.LANES
    for name, want in (("kInvPi", FA.INV_PI), ("kPiHi", FA.PI_HI), ("kPiLo", FA.PI_LO)):
        got = float(re.search(rf"constexpr float {name} = (\S+)f;", SRC).group(1))
        assert np.float32(got) == np.float32(want), name


@pytest.mark.parametrize("dtype,t_len,offset,want", [
    (torch.float32, 1792, 0, 16), (torch.float32, 3444, 0, 16), (torch.float32, 10, 0, 8),
    (torch.float32, 5, 0, 4), (torch.float32, 1792, 1, 4), (torch.float32, 1792, 2, 8),
    (torch.bfloat16, 1792, 0, 16), (torch.bfloat16, 3444, 0, 8), (torch.bfloat16, 6, 0, 4),
    (torch.bfloat16, 5, 0, 2), (torch.bfloat16, 1792, 1, 2), (torch.bfloat16, 1792, 4, 8)])
def test_vector_bytes_follow_row_alignment(dtype, t_len, offset, want):
    buf = torch.zeros(2 * 3 * t_len + 8, dtype=dtype)
    x = buf[offset: offset + 2 * 3 * t_len].view(2, 3, t_len)
    y = torch.empty_like(x)
    assert y.data_ptr() % 16 == 0
    assert FA.vector_bytes(x, y) == want


def test_sin_sq_emulation_within_bound_of_f64():
    """The kernel's sin^2 against f64 sin^2 over |v| <= 64, above the largest
    |a u| of the stage shapes with alpha of std 0.3 in log-scale (|a u| < 30),
    near every multiple of pi / 2 and at tiny arguments: within 3e-7 of the
    value, relative (a few f32 ulps), so 1/b's amplification cannot lift
    the error above the f32 plain version's own; 1e-18 absolute next to the
    zeros v = k pi, where r = v - k pi carries pi_lo's own rounding."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(np.concatenate([
        np.linspace(-64, 64, 400_001), rng.standard_normal(200_000) * 20,
        rng.standard_normal(20_000) * 1e-3,
        (np.arange(-40, 41) * np.pi / 2) + rng.uniform(-1e-3, 1e-3, 81),
        (np.arange(-40, 41) * np.pi / 2)]).astype(np.float32))
    got = FA.sin_sq_reduced(v).double()
    want = torch.sin(v.double()) ** 2
    assert ((got - want).abs() <= 3e-7 * want + 1e-18).all()


def test_sin_sq_coefficients_match_source():
    got = [float(re.search(rf"constexpr float kS{n} = (\S+)f;", SRC).group(1))
           for n in (3, 5, 7, 9)]
    assert [np.float32(g) for g in got] == [np.float32(c) for c in FA.SIN_COEFFS]


def test_plain_version_computes_in_f64_for_f64_input():
    """chip_smoke holds the kernel to the plain version in f64 (the sine's
    error): f64 in, f64 out, within f32 rounding of the f32 composition."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 300)))
    alpha, beta = (torch.from_numpy(rng.standard_normal(6) * 0.3) for _ in range(2))
    got = FA.activation1d_reference(x, alpha, beta, True)
    want = FA.activation1d_reference(x.float(), alpha.float(), beta.float(), True)
    assert got.dtype == torch.float64
    assert (got - want.double()).abs().max().item() <= 1e-5


def test_bench_fused_act_runs_tiny_on_cpu():
    out = bench_fused_act.run(BigVGANConfig.tiny(), torch.device("cpu"), seconds=0.5, reps=2)
    assert out["frames"] == int(0.5 * 22050) // 256
    assert out["device"]["platform"] == "cpu"
    for key in ("unfused", "fused"):
        r = out["runs"][key]
        assert len(r["times_s"]) == 2 and r["min_s"] <= r["median_s"]
        assert r["k3_launches_per_call"] == 0  # plain versions on the CPU
    assert out["parity"]["rel"] < bench_fused_act.REL_GATE
    assert np.isfinite(out["parity"]["max_abs"])


def test_bench_counts_one_k3_launch_per_activation():
    assert bench_fused_act.k3_launches_per_call(BigVGANConfig()) == 109
    assert bench_fused_act.k3_launches_per_call(BigVGANConfig.tiny()) == 2 * 6 + 1


def test_bench_fused_act_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_fused_act.main([])
