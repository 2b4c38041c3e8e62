"""The port's measuring scripts (usdm_tpu_torch/scripts/: exp_decode2,
exp_decode, bench_batch_decode, bench_runahead, trace_estimator,
exp_stream_qmv, validate_memory_budget) on the CPU.

`exp_decode2.step_variant`, every flag set of the eight variants, with f32
and W8A8 weights, against scripts/exp_decode2.py's `step_variant` on the
same seeded weights through the bridge (JAX under `highest` matmul
precision, its paged attention through its jnp reference, as usdm_tpu's
engine runs it on a CPU): the same tokens, and the K/V pools within 1e-5 of
their peak.  validate_memory_budget's three geometries against
usdm_tpu.train.lm.memory_budget; bench_batch_decode's pages, K/V bytes and
bounds from meta tensors; exp_stream_qmv's plain route against usdm_tpu's
`qmm` (bit for bit).  Then each entry point at toy size on the CPU, its
JSON keys checked (a plumbing check: no device metric), and each raising
without a card.

Importing the TPU scripts points JAX's persistent compilation cache at
their own directory for the whole process; `_script` restores the three
settings, as tests/test_torch_probes.py does.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import usdm_tpu.ops.paged_attention as JPA
from usdm_tpu.core.config import MistralConfig as JMistralConfig
from usdm_tpu.engine.paged_ops import PagedKV as JPagedKV
from usdm_tpu.models import mistral as JLM
from usdm_tpu.models import quant as JQ
from usdm_tpu.train import lm as JT
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.engine.paged_ops import PagedKV
from usdm_tpu_torch.ops import stream_matvec as SM
from usdm_tpu_torch.scripts import bench_batch_decode as BBD
from usdm_tpu_torch.scripts import bench_runahead as BRA
from usdm_tpu_torch.scripts import exp_decode as ED
from usdm_tpu_torch.scripts import exp_decode2 as ED2
from usdm_tpu_torch.scripts import exp_stream_qmv as ESQ
from usdm_tpu_torch.scripts import profile_decode_step as PDS
from usdm_tpu_torch.scripts import trace_estimator as TE
from usdm_tpu_torch.scripts import validate_memory_budget as VMB

REPO = pathlib.Path(__file__).resolve().parents[1]
CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
                  "jax_persistent_cache_min_compile_time_secs")
CFG = JMistralConfig.tiny()
PAGE, MAXP, B = 8, 4, 2


def _script(name: str):
    """Import scripts/<name>.py with JAX's cache settings left as they were."""
    saved = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    try:
        spec = importlib.util.spec_from_file_location(f"tpu_{name}",
                                                      REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def port_cfg(jcfg):
    return getattr(PC, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def _jax_fused(jp: dict) -> dict:
    """The TPU script's fused tree: wqkv and w_gu concatenated on Dout
    (plain [L, Din, Dout] or quantized {"q", "s"}), lm_head_q per column."""
    lw = jp["layers"]

    def cat(names):
        if isinstance(lw[names[0]], dict):
            return {k: jnp.concatenate([lw[n][k] for n in names], axis=-1) for k in ("q", "s")}
        return jnp.concatenate([lw[n] for n in names], axis=-1)

    return {**jp, "layers": {**lw, "wqkv": cat(("wq", "wk", "wv")),
                             "w_gu": cat(("w_gate", "w_up"))},
            "lm_head_q": JQ.quantize_weight(jp["lm_head"], axis=-2)}


@pytest.fixture(scope="module")
def trees():
    """{"float", "w8a8"} -> (usdm_tpu's fused tree, the port's fused tree).
    lm_head is scaled up (peaked logits) so no argmax is decided by a
    margin within f32 rounding of the two implementations."""
    jp = JLM.init_params(CFG, jax.random.PRNGKey(7))
    jp["lm_head"] = jp["lm_head"] * 8.0
    out = {}
    for kind, tree in (("float", jp), ("w8a8", JQ.quantize_llm_params(jp))):
        port = ED2.fuse_weights(bridge.mistral_from_jax(jax.device_get(tree)))
        out[kind] = (_jax_fused(tree), port)
    return out


@pytest.fixture(scope="module")
def jax_step():
    return _script("exp_decode2").step_variant


@pytest.mark.parametrize("variant", list(ED2.VARIANTS))
@pytest.mark.parametrize("kind", ["float", "w8a8"])
def test_step_variant_matches_jax(trees, jax_step, monkeypatch, kind, variant):
    """Two slots, the second inactive (it writes the trash pages), over
    seeded random f32 pools: the same tokens, the pools within 1e-5 of
    their peak (the new rows differ by f32 summation order only)."""
    monkeypatch.setattr(JPA, "paged_decode_attention", JPA.paged_decode_attention_reference)
    jp, tp = trees[kind]
    kw = ED2.VARIANTS[variant]
    rng = np.random.default_rng(3)
    n_pages = B * MAXP + 1
    shape = (CFG.num_kv_heads, CFG.num_layers * n_pages, PAGE, CFG.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = rng.permutation(n_pages - 1)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    tok = np.asarray([5, 17], np.int32)
    lens = np.asarray([13, 27], np.int32)
    act = np.asarray([True, False])
    allow = np.ones((B, CFG.vocab_size), bool)
    allow[:, :3] = False
    with jax.default_matmul_precision("highest"):
        want, jkv = jax_step(jp, JPagedKV(jnp.asarray(kp), jnp.asarray(vp)), CFG,
                             jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(table),
                             jnp.asarray(act), jnp.asarray(allow), PAGE, **kw)
    kv = PagedKV(torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    got = ED2.step_variant(tp, kv, port_cfg(CFG), torch.from_numpy(tok).long(),
                           torch.from_numpy(lens), torch.from_numpy(table),
                           torch.from_numpy(act), torch.from_numpy(allow), PAGE, **kw)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[1] == 0
    for mine, theirs, before in ((kv.k_pages, jkv.k_pages, kp), (kv.v_pages, jkv.v_pages, vp)):
        theirs = np.asarray(theirs)
        peak = np.abs(theirs).max()
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0, atol=1e-5 * peak)
        assert (mine.numpy() != before).any() == kw.get("use_write", True)


def test_fuse_weights_matches_jax(trees):
    """The port's fused leaves are the TPU script's concatenations and its
    int8 lm_head is usdm_tpu's quantize_weight of the head, bit for bit."""
    for jp, tp in trees.values():
        for key in ("wqkv", "w_gu"):
            want = jax.device_get(jp["layers"][key])
            got = tp["layers"][1][key]
            if isinstance(want, dict):
                np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"][1]).T)
                np.testing.assert_array_equal(got["s"].float().numpy(),
                                              np.asarray(want["s"][1], np.float32))
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want[1], np.float32))
        head = jax.device_get(jp["lm_head_q"])
        np.testing.assert_array_equal(tp["lm_head_q"]["q"].numpy(), np.asarray(head["q"]).T)
        np.testing.assert_array_equal(tp["lm_head_q"]["s"].float().numpy(),
                                      np.asarray(head["s"], np.float32))
    base = bridge.mistral_from_jax(jax.device_get(JLM.init_params(CFG, jax.random.PRNGKey(1))))
    fused = ED2.fuse_weights(base)  # new containers over the same tensors
    assert "wqkv" not in base["layers"][0] and "lm_head_q" not in base
    assert fused["layers"][0]["wq"] is base["layers"][0]["wq"]


@pytest.mark.parametrize("geometry", range(3))
def test_memory_budget_rows_match_jax(geometry):
    """Each of validate_memory_budget's geometries: memory_budget's row
    equals usdm_tpu's at one device, no offload, 80 GB, on every key
    test_torch_lm_train::test_memory_budget_matches_jax compares (exactly)."""
    g = VMB.GEOMETRIES[geometry]
    jcfg = JMistralConfig(**g)
    got = VMB.budget(port_cfg(jcfg))
    want = JT.memory_budget(jcfg, dp=1, seq_len=jcfg.max_seq_len, batch_per_chip=1, hbm_gb=80.0)
    assert got.keys() == want.keys()
    for k in want.keys() - {"streamed_gb", "update_peak_gb", "device_gb", "fits"}:
        assert got[k] == want[k], k
    assert set(VMB.BUDGET_KEYS) <= got.keys()


def test_bench_batch_decode_bytes_and_bounds():
    """6 pages of 256 a sequence at ctx 1,219; 131,072 bf16 K/V bytes a
    token, 5.117 GB at b 32 (1,220 tokens a slot), int8 pools 67,584 a
    token; the step's bound from meta tensors: 6.98 GB of W8A8 layers +
    0.344 GB of bf16 lm_head + the K/V, over 3.35 TB/s: ~2.57, 2.95, 3.71 ms
    at b 8, 16, 32 (bf16 pools)."""
    cfg = PC.MistralConfig()
    assert BBD.pages_per_seq() == 6
    assert BBD.kv_bytes(cfg, 1, 0) == 131072
    assert BBD.kv_bytes(cfg, 32) == 131072 * 1220 * 32 == 5_117_050_880
    assert BBD.kv_bytes(cfg, 1, 0, "int8") == 2 * 32 * 8 * (128 + 4)
    params = PDS.zero_params(cfg, torch.device("meta"), True)
    layers = PDS._nbytes(params["layers"])
    assert abs(layers / 1e9 - 6.98) < 0.01
    for b, want in ((8, 2.57), (16, 2.95), (32, 3.71)):
        bound = (BBD.weight_bytes(params, b) + BBD.kv_bytes(cfg, b)) / PDS.HBM_BYTES_PER_S * 1e3
        assert abs(bound - want) < 0.01, (b, bound)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exp_stream_qmv_plain_matches_jax_qmm(m, dtype):
    """stream_qmv on CPU tensors (K6's plain version, "oi" weights) and the
    script's io_reference against usdm_tpu's qmm on the "io" weights of
    the same quantize_weight, at M 1 and 4: bit for bit (bound 0: exact
    integer products and the same f32 epilogue)."""
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((256, 512)) * 0.02).astype(np.float32)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    jw = JQ.quantize_weight(jnp.asarray(w), axis=-2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(JQ.qmm(jnp.asarray(x).astype(jdt), jw).astype(jnp.float32))
    qw = {"q": torch.from_numpy(np.asarray(jw["q"]).T.copy()),
          "s": torch.from_numpy(np.asarray(jw["s"], np.float32)).bfloat16()}
    xt = torch.from_numpy(x).to(dtype)
    np.testing.assert_array_equal(SM.stream_qmv(xt, qw, dtype).float().numpy(), want)
    np.testing.assert_array_equal(ESQ.io_reference(xt, qw, dtype).float().numpy(), want)


def _lines(capsys, key: str) -> list:
    return [json.loads(ln)[key] for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{") and key in json.loads(ln)]


def test_exp_decode2_tiny_cpu(capsys):
    lines = ED2.main(["--device", "cpu", "--tiny"])
    assert [ln["weights"] for ln in lines] == ["w8a8", "bfloat16"]
    for ln in lines:
        assert set(ln["ms"]) == {f"{v}_ms" for v in ED2.VARIANTS}
        assert set(ln["tokens"]) == set(ED2.VARIANTS) and ln["fused_tokens_equal"]
    assert _lines(capsys, "exp_decode2") == lines


def test_exp_decode_tiny_cpu(capsys):
    line = ED.main(["--device", "cpu", "--tiny"])
    assert set(ED.KEYS) <= line.keys() and line["weights"] == "w8a8"
    assert line["mm_only_ms"] == line["profile_decode_step"]["parts"]["weights_only_scan_ms"]
    assert line["attn_x4_ms"] == pytest.approx(4e-3 * line["attn_per_layer_us"])
    assert _lines(capsys, "exp_decode") == [line]


def test_bench_batch_decode_tiny_cpu(capsys):
    lines = BBD.main(["--device", "cpu", "--tiny"])
    assert [(ln["b"], ln["kv"]) for ln in lines] == [(2, "bf16"), (2, "int8"), (4, "bf16"),
                                                     (4, "int8")]
    for ln in lines:
        assert {"eager_ms", "graph_ms", "tok_s", "tok_s_per_seq", "bound_ms", "kv_gb",
                "launches_per_step"} <= ln.keys()
        assert ln["pages_per_seq"] == BBD.pages_per_seq(40, 16)
    assert lines[2]["kv_gb"] == 2 * lines[0]["kv_gb"] > lines[1]["kv_gb"]
    assert _lines(capsys, "bench_batch_decode") == lines


def test_bench_runahead_tiny_cpu(capsys):
    """Every configuration prints every rep and gives the first one's
    tokens (sweep raises otherwise); the EOS check stops each rep at the
    probe's EOS, with run-ahead on and off."""
    lines = BRA.main(["--device", "cpu", "--tiny"])
    assert [(ln["horizon"], ln["runahead"]) for ln in lines] == list(BRA.CONFIGS)
    for ln in lines:
        assert len(ln["reps_s"]) == len(ln["tok_s_reps"]) == BRA.REPS and ln["tokens_equal"]
        assert ln["median_s"] == sorted(ln["reps_s"])[1]
    assert lines[1]["runahead_chains"] > 0 and lines[-1]["runahead_chains"] == 0
    assert _lines(capsys, "bench_runahead") == lines
    eos = BRA.main(["--device", "cpu", "--tiny", "--eos"])
    assert [ln["runahead"] for ln in eos] == [True, False]
    assert eos[0]["stop_at"] >= 12 and eos[0]["n_tokens"] == eos[0]["stop_at"] + 1
    assert eos[0]["eos_id"] == eos[1]["eos_id"] and len(eos[1]["reps_s"]) == BRA.REPS


def test_trace_estimator_tiny_cpu(tmp_path, capsys):
    lines = TE.main(["--device", "cpu", "--tiny", "--out-dir", str(tmp_path)])
    assert [ln["weights"] for ln in lines] == list(TE.KINDS)
    for ln in lines:
        assert ln["clock"] == "host" and set(ln["groups_ms"]) == set(TE.GROUPS)
        assert all(v > 0 for v in ln["groups_ms"].values())
        assert pathlib.Path(ln["trace"]).stat().st_size > 0
    assert [ln["dtype"] for ln in lines] == ["bfloat16", "float32", "float32"]
    assert _lines(capsys, "trace_estimator") == lines


def test_exp_stream_qmv_tiny_cpu():
    line = ESQ.main(["--device", "cpu", "--layers", "2", "--d", "256", "--f", "512"])
    res = line["results"]
    assert set(res) == {"check_m1", "check_m4", "stream_qmv_chain"}
    assert all(r["ok"] and r["max_abs_err"] == 0.0 for k in ("check_m1", "check_m4")
               for r in res[k].values())
    assert res["stream_qmv_chain"]["gbps"] > 0


def test_validate_memory_budget_tiny_cpu(capsys):
    lines = VMB.main(["--device", "cpu", "--tiny"])
    assert [(ln["layers"], ln["seq"]) for ln in lines] == [(2, 256), (4, 256), (2, 128)]
    for ln in lines:
        assert set(VMB.BUDGET_KEYS) <= ln.keys() and ln["measured_peak_gb"] is None
        assert np.isfinite(ln["loss"])
    assert lines[1]["device_gb"] > lines[0]["device_gb"] > lines[2]["device_gb"]
    assert "7B_dp8" in capsys.readouterr().out


@pytest.mark.parametrize("module", [ED2, ED, BBD, BRA, TE, ESQ, VMB],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_measure_entry_points_raise_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
