"""The port's matvec probes (X1-X3) against the TPU scripts' Pallas kernels, on the CPU.

X1 (ops/matvec_io.py) against scripts/exp_matvec.py's `_mv_bf16_kernel` and
`_mv_i8_kernel`, X2 (ops/int4_matvec.py) against
scripts/exp_int4_pallas.py's `qmv4` (the same function as exp_int4.py's
nested kernel) and an int64 numpy product, X3 (ops/stream_probe.py) against
every mode of scripts/exp_stream_variants.py's `make_kernel` (whose
`run_multi_dma` kernel computes the same function), all in interpret mode
at small sizes (Din 256, Dout 512, BF 128, L 2).  Both the plain versions
and the wrappers on CPU tensors are held; inputs come from numpy
generators.  Tolerances: exact for X1b, X2 and every X3 mode (at D 256 a
row's f32 sum of exact integer products stays below 2^24, so every order
gives the same f32); one bf16 ulp of the largest output + 1e-4 for X1a.
Then each probe entry point runs on the CPU at a tiny size.

Importing the TPU scripts points JAX's persistent compilation cache at
their own directory for the whole process; `_script` restores the three
settings, so other tests in the same worker are untouched.
"""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from usdm_tpu_torch.ops import int4_matvec as I4
from usdm_tpu_torch.ops import matvec_io as MV
from usdm_tpu_torch.ops import stream_probe as SP
from usdm_tpu_torch.scripts import exp_int4, exp_matvec, exp_stream_variants

REPO = pathlib.Path(__file__).resolve().parents[1]
CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
                  "jax_persistent_cache_min_compile_time_secs")
DIN, DOUT, BF, L = 256, 512, 128, 2


def _script(name: str):
    """Import scripts/<name>.py with JAX's cache settings left as they were."""
    saved = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    try:
        path = REPO / "scripts" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"tpu_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def tpu():
    return {n: _script(n) for n in ("exp_matvec", "exp_int4_pallas", "exp_stream_variants")}


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))


def _bf16_bound(want: np.ndarray) -> float:
    return 2.0**-7 * float(np.abs(want).max()) + 1e-4


def _i8(rng, *shape, lo=-127, hi=127):
    return rng.integers(lo, hi, shape).astype(np.int8)


def test_script_import_keeps_jax_cache_settings():
    before = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    _script("exp_stream_variants")
    assert {k: getattr(jax.config, k) for k in CACHE_SETTINGS} == before


# ------------------------------------------------------------------ X1
@pytest.mark.parametrize("din,dout", [(DIN, DOUT), (DOUT, DIN)])
def test_mv_io_bf16_matches_pallas(tpu, interpret, rng, din, dout):
    """X1a: bf16 activations, io int8 weight, bf16 scales -> bf16."""
    q, y = _i8(rng, din, dout), rng.standard_normal((1, din)).astype(np.float32)
    s = (rng.uniform(0.001, 0.02, dout)).astype(np.float32)
    yb, sb = jnp.asarray(y, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16)[None]
    jmv = tpu["exp_matvec"]
    mv = jmv.make_mv(jmv._mv_bf16_kernel, din, dout, BF, jnp.bfloat16)
    want = np.asarray(mv(yb, jnp.asarray(q), sb).astype(jnp.float32))
    args = (torch.from_numpy(y).bfloat16(), torch.from_numpy(q), torch.from_numpy(s).bfloat16())
    for got in (MV.mv_io_bf16_reference(*args), MV.mv_io_bf16(*args)):
        assert got.dtype == torch.bfloat16 and got.shape == (1, dout)
        assert np.abs(got.float().numpy() - want).max() <= _bf16_bound(want)


@pytest.mark.parametrize("din,dout", [(DIN, DOUT), (DOUT, DIN)])
def test_mv_io_i8_matches_pallas(tpu, interpret, rng, din, dout):
    """X1b: int8 activations, exact int32 products -> bf16, bit for bit."""
    q, qx = _i8(rng, din, dout), _i8(rng, 1, din)
    s = (rng.uniform(0.001, 0.02, dout)).astype(np.float32)
    mv = tpu["exp_matvec"].make_mv(tpu["exp_matvec"]._mv_i8_kernel, din, dout, BF, jnp.int8)
    want = np.asarray(mv(jnp.asarray(qx), jnp.asarray(q),
                         jnp.asarray(s, jnp.bfloat16)[None]).astype(jnp.float32))
    args = (torch.from_numpy(qx), torch.from_numpy(q), torch.from_numpy(s).bfloat16())
    for got in (MV.mv_io_i8_reference(*args), MV.mv_io_i8(*args)):
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_mv_io_raises_on_shapes_it_does_not_take():
    q, s = torch.zeros(256, 512, dtype=torch.int8), torch.ones(512, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        MV.mv_io_i8(torch.zeros(2, 256, dtype=torch.int8), q, s)  # one row only
    with pytest.raises(ValueError):
        MV.mv_io_i8(torch.zeros(1, 254, dtype=torch.int8), q[:254], s)  # Din % 4
    with pytest.raises(ValueError):
        MV.mv_io_i8(torch.zeros(1, 256, dtype=torch.int8), q[:, :504], s[:504])  # Dout % 16
    with pytest.raises(ValueError):
        MV.mv_io_bf16(torch.zeros(1, 256, dtype=torch.bfloat16), q, s, bf=128)
    with pytest.raises(TypeError):
        MV.mv_io_bf16(torch.zeros(1, 256), q, s)


# ------------------------------------------------------------------ X2
def test_pack_halves_is_the_scripts_layout(rng):
    """pack_halves is exp_int4.py's pack_adj / exp_int4_pallas.py's inline
    packing; unpack_halves inverts it; pack_pairs / unpack_pairs are
    exp_int4.py's pack / unpack."""
    w = _i8(rng, DOUT, DIN, lo=-8, hi=8)
    dh = DIN // 2
    want = (w[:, :dh] & 0xF).astype(np.uint8) | ((w[:, dh:] & 0xF).astype(np.uint8) << 4)
    packed = I4.pack_halves(torch.from_numpy(w))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(I4.unpack_halves(packed).numpy(), w)
    io = _i8(rng, L, DIN, DOUT, lo=-8, hi=8)
    want = (io[..., 0::2, :] & 0xF).astype(np.uint8) | ((io[..., 1::2, :] & 0xF).astype(np.uint8)
                                                        << 4)
    pairs = I4.pack_pairs(torch.from_numpy(io))
    np.testing.assert_array_equal(pairs.numpy(), want)
    np.testing.assert_array_equal(I4.unpack_pairs(pairs).numpy(), io)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dout,din", [(DOUT, DIN), (DIN, DOUT)])
def test_qmv4_matches_pallas_and_int64(tpu, interpret, rng, b, dout, din):
    """X2 bit for bit against exp_int4_pallas.qmv4 and the int64 product."""
    w = _i8(rng, dout, din, lo=-8, hi=8)
    qy = _i8(rng, b, din)
    s = rng.uniform(0.001, 0.02, dout).astype(np.float32)
    wp = I4.pack_halves(torch.from_numpy(w))
    want = np.asarray(tpu["exp_int4_pallas"].qmv4(jnp.asarray(qy), jnp.asarray(wp.numpy()),
                                                  jnp.asarray(s)[None]))
    exact = (qy.astype(np.int64) @ w.astype(np.int64).T).astype(np.float32) * s
    np.testing.assert_array_equal(want, exact)
    args = (torch.from_numpy(qy), wp, torch.from_numpy(s))
    for got in (I4.qmv4_reference(*args), I4.qmv4(*args)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_qmv4_raises_on_shapes_it_does_not_take():
    wp, s = torch.zeros(64, 128, dtype=torch.uint8), torch.ones(64)
    with pytest.raises(ValueError):
        I4.qmv4(torch.zeros(17, 256, dtype=torch.int8), wp, s)
    with pytest.raises(ValueError):
        I4.qmv4(torch.zeros(1, 240, dtype=torch.int8), wp[:, :120], s)  # Din % 32
    with pytest.raises(ValueError):
        I4.qmv4(torch.zeros(1, 256, dtype=torch.int8), wp, s[:63])
    with pytest.raises(TypeError):
        I4.qmv4(torch.zeros(1, 256, dtype=torch.int8), wp.to(torch.int8), s)


# ------------------------------------------------------------------ X3
def _pallas_stream(mod, mode, x, w):
    """run_mode's pallas_call of make_kernel(mode, bpad), at the patched sizes."""
    bpad = x.shape[0]
    return pl.pallas_call(
        mod.make_kernel(mode, bpad), grid=(1,),
        in_specs=[pl.BlockSpec((bpad, mod.D), lambda i: (0, 0)),
                  pl.BlockSpec(memory_space=pltpu.MemorySpace.ANY)],
        out_specs=pl.BlockSpec((1, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, mod.BF, mod.D), jnp.int8),
                        pltpu.SemaphoreType.DMA((2,))])(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("tpu_mode,mode,bpad", [
    ("dma_only", "dma_only", 1), ("dot_b1", "dot", 1), ("dot_b8", "dot", 8),
    ("dot_b32", "dot", 32), ("wlhs", "dot", 1), ("vpu", "vpu", 1), ("dot_bf16", "dot_bf16", 1)])
def test_stream_probe_matches_pallas(tpu, interpret, monkeypatch, rng, tpu_mode, mode, bpad):
    """X3 over the scripts' chain of L layers, [F, D] = [512, 256], tiles of
    128 rows: c = 0; c = c + one(x, w) per layer, f32."""
    mod = tpu["exp_stream_variants"]
    for k, v in (("D", DIN), ("F", DOUT), ("L", L), ("BF", BF), ("NT", DOUT // BF)):
        monkeypatch.setattr(mod, k, v)
    ws, x = _i8(rng, L, DOUT, DIN), _i8(rng, bpad, DIN)
    want = np.zeros((1, 128), np.float32)
    for w in ws:
        want = want + np.asarray(_pallas_stream(mod, tpu_mode, x, w))
    tx, tws = torch.from_numpy(x), torch.from_numpy(ws)
    for fn in (SP.stream_probe_reference, SP.stream_probe):
        got = torch.zeros(1, 128)
        for w in tws:
            got = got + fn(tx, w, mode, BF)
        np.testing.assert_array_equal(got.numpy(), want)
    if mode == "dot":  # and the exact int64 product, tile by tile
        rows = (x[0].astype(np.int64) @ ws.astype(np.int64).transpose(0, 2, 1))
        tiles = rows.reshape(L, -1, BF)[:, :, :128].astype(np.float32)
        exact = np.zeros((1, 128), np.float32)
        for layer in tiles:
            acc = np.zeros(128, np.float32)
            for t in layer:
                acc = acc + t
            exact = exact + acc
        np.testing.assert_array_equal(want, exact)


def test_stream_probe_f32_order_is_the_kernels(rng):
    """vpu's rows at D 4112 (chunks not a whole number of warps): lane l's
    share is its chunks l, l + 32, ... summed exactly, then lane 0 gathers
    the 32 shares as an xor shuffle tree does; the sum rounds only there,
    within 5 adds' worth of 2^-24 of the exact dot."""
    d, f = 4112, 64
    w, x = _i8(rng, f, d, lo=-128, hi=128), _i8(rng, 1, d, lo=-128, hi=128)
    prod = w.astype(np.int64) * x[0].astype(np.int64)
    chunks = prod.reshape(f, d // 16, 16).sum(-1)
    shares = np.stack([chunks[:, lane::32].sum(-1) for lane in range(32)], -1)
    tree = shares.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        tree = np.stack([tree[:, i] + tree[:, i ^ o] for i in range(32)], -1)
    got = SP.lane_order_rows(torch.from_numpy(x[0]), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, tree[:, 0])
    exact = prod.sum(-1)
    assert (np.abs(got - exact) <= 5 * 2.0**-24 * np.abs(shares).sum(-1)).all()


def test_stream_probe_raises_on_what_it_does_not_take():
    w = torch.zeros(1024, 256, dtype=torch.int8)
    for x, mode, bf, loads in ((torch.zeros(2, 256, dtype=torch.int8), "dot", 512, 4),
                               (torch.zeros(8, 256, dtype=torch.int8), "vpu", 512, 4),
                               (torch.zeros(1, 256, dtype=torch.int8), "dot", 64, 4),
                               (torch.zeros(1, 256, dtype=torch.int8), "dot", 384, 4),
                               (torch.zeros(1, 256, dtype=torch.int8), "dot", 512, 3),
                               (torch.zeros(1, 256, dtype=torch.int8), "copy", 512, 4)):
        with pytest.raises(ValueError):
            SP.stream_probe(x, w, mode, bf, loads)
    wide = torch.zeros(128, SP.MAX_F32_D + 16, dtype=torch.int8)  # a lane's share past 2^24
    for mode in ("vpu", "dot_bf16"):
        with pytest.raises(ValueError):
            SP.stream_probe(torch.zeros(1, SP.MAX_F32_D + 16, dtype=torch.int8), wide, mode, 128)


# ------------------------------------------------------- probe entry points
@pytest.mark.parametrize("main,keys", [
    (exp_matvec.main, ("w8a8_io", "w8a8_oi", "bf16_deq", "w8a8_io_b8", "pallas_bf16_512",
                       "pallas_i8_512", "pallas_bf16_1024", "pallas_i8_1024", "stream_qmv_oi")),
    (exp_int4.main, ("w8a8_io", "w8a8_k6", "w4a8_native", "w4a4_native", "w4a8_unpack",
                     "w4a8_pallas")),
    (exp_stream_variants.main, ("dma_only", "dot_b1", "dot_b8", "dot_b32", "wlhs", "vpu",
                                "dot_bf16", "dma_only_c1_bf1024", "dot_c8_bf2048")),
])
def test_probe_entry_points_run_on_the_cpu(capsys, main, keys):
    """`--device cpu` at a tiny size: the plain versions run every formulation,
    and the last line printed is the JSON result."""
    out = main(["--device", "cpu", "--layers", "2", "--d", "256", "--f", "2048"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out)) and line["device"]["platform"] == "cpu"
    assert set(keys) <= set(line["results"])
    for k in keys:
        r = line["results"][k]
        assert "error" in r or "same_function_and_kernel_as" in r or r["gbps"] > 0
    if "w4a8_pallas" in keys:
        assert line["results"]["check"] == {"max_abs_err": 0.0, "chain_up_max_abs_err": 0.0}
        assert "error" in line["results"]["w4a8_native"]


def test_probe_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (exp_matvec.main, exp_int4.main, exp_stream_variants.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
