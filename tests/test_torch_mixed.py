"""usdm_tpu_torch's mixed prefill + decode links, fused multi-step decode and
streaming generate against usdm_tpu, on the CPU.

The same tiny Mistral weights (through the bridge) and numpy-seeded inputs
go through usdm_tpu's `paged_mixed_step` / `paged_decode_multi` and the
port's, and the same requests through both packages' PagedEngines with
mixed prefill on (the EngineConfig default) and off.  JAX runs under
default_matmul_precision("highest") in f32, like the port.  Every engine
case ends with the page pool whole.  tests/test_torch_cuda.py holds the
mixed link on the card.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import EngineConfig, MistralConfig
from usdm_tpu.engine import paged_ops as JOPS
from usdm_tpu.engine.paged import PagedEngine as JaxEngine
from usdm_tpu.engine.paged import Request as JaxRequest
from usdm_tpu.models import mistral as JLM
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine import paged_ops as P
from usdm_tpu_torch.engine.paged import DECODE, FREE, PREFILL, PagedEngine, Request
from usdm_tpu_torch.engine.server import DialogAborted, EngineServer, PagedDialogPolicy
from usdm_tpu_torch.models import mistral as M

CFG = MistralConfig.tiny()
PCFG = C.MistralConfig.from_dict(dataclasses.asdict(CFG))
# the mixed tests of tests/test_paged.py: page 16, chunk 16, batch 4
BASE = dict(page_size=16, max_pages_per_seq=8, max_batch_size=4, prefill_chunk=16)


def ecfgs(**kw):
    """(usdm_tpu's, the port's) EngineConfig of the same fields."""
    jc = EngineConfig(**{**BASE, **kw})
    return jc, C.EngineConfig.from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def weights():
    jp = JLM.init_params(CFG, jax.random.PRNGKey(7))
    return jp, bridge.mistral_from_jax(jax.device_get(jp))


def _whole(eng):
    assert len(eng.free_pages) == eng.n_pages - 1
    assert not eng.busy and eng._inflight is None and not eng._pending_first


# ------------------------------------------------------ paged_mixed_step
P_SIZE, N_PAGES, MAXP, CHUNK = 16, 24, 4, 16  # N_PAGES includes the trash page
B = 4
# chunk-row cases: (request, start, n_valid) per row; a request's pages are
# its own.  "consecutive": two chunks of one prompt in one link; None rows
# are padding (n_valid 0, every table entry the trash page)
ROWS = {
    "npf1": [("x", 16, 16)],
    "npf2": [("x", 0, 16), ("y", 32, 9)],
    "npf4_padded": [("x", 16, 16), ("y", 0, 16), ("z", 48, 5), None],
    "consecutive": [("x", 0, 16), ("x", 16, 10)],
}
REQ_PAGES = {"x": [3, 7, 11, 15], "y": [4, 8, 12, 16], "z": [5, 9, 13, 17]}
DEC_TABLE = np.array([[0, 1, 2, 18], [6, 10, 14, 19], [20, 21, 22, 2], [2, 2, 2, 2]], np.int32)


def _mixed_inputs(case, kv, seed=0):
    """Numpy inputs of one mixed link: packed rows, the decode side (slot 1
    done, slot 3 inactive), and pools holding random earlier context."""
    r = np.random.default_rng(seed)
    rows = ROWS[case]
    npf = len(rows)
    packed = np.zeros((npf, CHUNK + 2 + MAXP), np.int32)
    packed[:, CHUNK + 2:] = N_PAGES - 1
    for i, row in enumerate(rows):
        if row is None:
            continue
        name, start, n = row
        packed[i, :n] = r.integers(3, CFG.vocab_size, n)
        packed[i, CHUNK], packed[i, CHUNK + 1] = start, n
        packed[i, CHUNK + 2:] = REQ_PAGES[name]
    dec = dict(tokens=r.integers(3, CFG.vocab_size, B).astype(np.int32),
               seq_lens=np.array([20, 33, 5, 0], np.int32), page_table=DEC_TABLE,
               active=np.array([True, True, True, False]),
               done=np.array([False, True, False, False]),
               eos=np.array([2, 2, 2, 2], np.int32))
    shape = (CFG.num_kv_heads, CFG.num_layers * N_PAGES, P_SIZE, CFG.head_dim)
    if kv == "int8":
        pools = [r.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        sshape = (shape[1], shape[0], P_SIZE)
        pools += [r.uniform(0.001, 0.02, sshape).astype(np.float32) for _ in range(2)]
    else:  # bf16-typed pools hold bf16-representable values (numpy has no bf16)
        pools = [r.standard_normal(shape).astype(np.float32) for _ in range(2)]
        if kv == "bf16":
            pools = [torch.from_numpy(p).bfloat16().float().numpy() for p in pools]
    return packed, dec, pools


def _pools(kv, pools, jax_side):
    """The numpy pools as either package's PagedKV of the case's dtype."""
    if jax_side:
        dt = jnp.bfloat16 if kv == "bf16" else None
        return JOPS.PagedKV(*(jnp.asarray(p, dt if i < 2 else None) for i, p in enumerate(pools)))
    ts = [torch.from_numpy(p.copy()) for p in pools]
    if kv == "bf16":
        ts = [t.bfloat16() for t in ts]
    return P.PagedKV(*ts)


def _written(packed, dec):
    """[L*N, P] bool: the pool rows that the link's valid tokens write."""
    w = np.zeros((CFG.num_layers * N_PAGES, P_SIZE), bool)
    for li in range(CFG.num_layers):
        base = li * N_PAGES
        for row in packed:
            start, n = int(row[CHUNK]), int(row[CHUNK + 1])
            for pos in range(start, start + n):
                w[base + row[CHUNK + 2 + pos // P_SIZE], pos % P_SIZE] = True
        live = dec["active"] & ~dec["done"]
        for b in np.flatnonzero(live):
            pos = int(dec["seq_lens"][b])
            w[base + dec["page_table"][b, pos // P_SIZE], pos % P_SIZE] = True
    return w


@pytest.mark.parametrize("case", list(ROWS))
@pytest.mark.parametrize("sample_chunk,lslice", [(True, None), (False, None),
                                                  (True, (40, 200, 5))])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_mixed_step_matches_jax(weights, case, sample_chunk, lslice, kv):
    """One mixed link of the port against usdm_tpu's: tokens, done and
    lengths exactly; chunk logits and the K/V rows the link's valid tokens
    write within 1e-5 of the largest value (f32 pools); every other row of
    every real page untouched (padding and frozen slots write to the trash
    page only).  The two packages' f32 sums differ in the last bits, so a
    value within that noise of a rounding boundary rounds apart, and the
    next layers read a context one step apart there: bf16 pools, rows and
    logits within one bf16 ulp of the largest value (2^-7 of it); int8
    codes within 1 (fewer than 0.1 % apart: 8.0e-4 of the written values
    in the padded NPF 4 case, none elsewhere).  int8 scales within 2e-6
    relative on layer 0, whose K/V come from the projections alone (4.4e-7
    the largest measured), and 3e-4 on later layers, which read a context
    with those codes (7.0e-5 the largest)."""
    jp, tp = weights
    packed, dec, pools = _mixed_inputs(case, kv)
    ncp = 4 if case.startswith("npf4") else 2
    allow = np.ones((B, CFG.vocab_size), bool)
    allow[:, 100:120] = False
    with jax.default_matmul_precision("highest"):
        jkv = _pools(kv, pools, True)
        jl, jtok, jdone, jlens, _, jkv = JOPS.paged_mixed_step(
            jp, jkv, CFG, jnp.asarray(packed), jnp.asarray(dec["tokens"]),
            jnp.asarray(dec["seq_lens"]), jnp.asarray(dec["page_table"]),
            jnp.asarray(dec["active"]), jnp.asarray(dec["done"]), jnp.asarray(dec["eos"]),
            jnp.asarray(allow), P_SIZE, ncp, CHUNK, jnp.zeros((B, 2), jnp.uint32),
            jnp.ones(B, jnp.int32), jnp.ones(B, jnp.float32), jnp.ones(B, jnp.float32),
            sample_chunk=sample_chunk, logits_slice=lslice)
    tkv = _pools(kv, pools, False)
    t = torch.from_numpy
    tl, ttok, tdone, tlens = P.paged_mixed_step(
        tp, tkv, PCFG, t(packed), t(dec["tokens"]).long(), t(dec["seq_lens"]),
        t(dec["page_table"]), t(dec["active"]), t(dec["done"]), t(dec["eos"]).long(),
        t(allow), P_SIZE, ncp, CHUNK, sample_chunk, lslice)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tdone.tolist() == np.asarray(jdone).tolist()
    assert tlens.tolist() == np.asarray(jlens).tolist()
    assert ttok[3] == 0 and ttok[1] == 0 and tlens[1] == 33 and tlens[0] == 21
    tol = 2.0**-7 if kv == "bf16" else 1e-5  # of the largest value
    if sample_chunk:
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    else:
        assert tl is None and jl is None
    written = _written(packed, dec)
    real = np.arange(CFG.num_layers * N_PAGES) % N_PAGES != N_PAGES - 1
    untouched = real[:, None] & ~written
    got = [x.float().numpy() if kv == "bf16" else x.numpy() for x in (tkv.k_pages, tkv.v_pages)]
    want = [np.asarray(x, np.float32 if kv == "bf16" else None)
            for x in (jkv.k_pages, jkv.v_pages)]
    for g, w, before in zip(got, want, pools):
        assert np.array_equal(g[:, untouched], before[:, untouched])
        if kv == "int8":
            assert np.abs(g[:, written].astype(int) - w[:, written]).max() <= 1
            assert (g[:, written] != w[:, written]).mean() < 1e-3
        else:
            np.testing.assert_allclose(g[:, written], w[:, written], rtol=0,
                                       atol=tol * np.abs(w[:, written]).max())
    if kv == "int8":
        first = (np.arange(CFG.num_layers * N_PAGES) < N_PAGES)[:, None]
        for g, w, before in zip((tkv.k_scales, tkv.v_scales), (jkv.k_scales, jkv.v_scales),
                                pools[2:]):
            g, w = g.numpy().transpose(0, 2, 1), np.asarray(w).transpose(0, 2, 1)
            assert np.array_equal(g[untouched], before.transpose(0, 2, 1)[untouched])
            for rows, rtol in ((written & first, 2e-6), (written & ~first, 3e-4)):
                np.testing.assert_allclose(g[rows], w[rows], rtol=rtol)


def test_decode_multi_matches_jax(weights):
    """paged_decode_multi: n greedy chained links with an EOS mid-way in
    one row and one inactive row -> usdm_tpu's tokens and emitted counts."""
    jp, tp = weights
    _, dec, pools = _mixed_inputs("npf1", "f32", seed=3)
    allow = np.ones((B, CFG.vocab_size), bool)
    dec["done"][:] = False

    def run_jax(eos):
        with jax.default_matmul_precision("highest"):
            jkv = JOPS.PagedKV(*(jnp.asarray(p) for p in pools))
            out, n, _, _ = JOPS.paged_decode_multi(
                jp, jkv, CFG, jnp.asarray(dec["tokens"]), jnp.asarray(dec["seq_lens"]),
                jnp.asarray(dec["page_table"]), jnp.asarray(dec["active"]), jnp.asarray(allow),
                jnp.asarray(eos), P_SIZE, jnp.zeros((B, 2), jnp.uint32), jnp.ones(B, jnp.int32),
                jnp.ones(B, jnp.float32), jnp.ones(B, jnp.float32), n_steps=6)
        return np.asarray(out), np.asarray(n)

    probe, _ = run_jax(np.full(B, -1, np.int32))
    eos = np.full(B, -1, np.int32)
    eos[0] = probe[0, 2]  # row 0 stops at its third token
    want_out, want_n = run_jax(eos)
    t = torch.from_numpy
    kv = P.PagedKV(*(t(p.copy()) for p in pools))
    out, n = P.paged_decode_multi(tp, kv, PCFG, t(dec["tokens"]).long(), t(dec["seq_lens"]),
                                  t(dec["page_table"]), t(dec["active"]), t(allow),
                                  t(eos).long(), P_SIZE, 6)
    assert out.tolist() == want_out.tolist() and n.tolist() == want_n.tolist()
    assert n.tolist()[0] == 3 and n.tolist()[3] == 0


def test_packed_prefill_is_one_copy(weights, monkeypatch):
    """A prefill chunk uploads its ids, start, n_valid and table row as one
    int32 array (one host-to-device copy), as usdm_tpu packs them."""
    _, tp = weights
    seen = []
    real = P.paged_prefill_chunk_packed
    monkeypatch.setattr("usdm_tpu_torch.engine.paged.paged_prefill_chunk_packed",
                        lambda *a: seen.append(a[3]) or real(*a))
    eng = PagedEngine(tp, PCFG, ecfgs()[1], device="cpu")
    eng.run([Request(0, list(range(3, 40)), np.ones(CFG.vocab_size, bool), 2, 4)])
    assert len(seen) == 3 and all(x.dtype == torch.int32 and x.shape == (16 + 2 + 8,)
                                  for x in seen)
    assert [int(x[17]) for x in seen] == [16, 16, 5] and [int(x[16]) for x in seen] == [0, 16, 32]


# --------------------------------------------------------------- engines
def _prompts(seed=0, sizes=(20, 35, 18, 40)):
    r = np.random.default_rng(seed)
    return [r.integers(3, CFG.vocab_size, size=n).tolist() for n in sizes]


def _staggered(eng, mk, prompts, kws, max_new=10):
    """tests/test_paged.py::_staggered: submit prompts[0], tick until it
    decodes, then the rest at once -> (tokens per request, stats)."""
    allow = np.ones(CFG.vocab_size, bool)
    reqs = [mk(i, list(p), allow, eos_id=1, max_new_tokens=max_new, **kw)
            for i, (p, kw) in enumerate(zip(prompts, kws))]
    eng.submit(reqs[0])
    for _ in range(3):
        eng.tick()
    for r in reqs[1:]:
        eng.submit(r)
    while eng.busy:
        eng.tick()
    eng.drain_inflight()
    assert all(r.finished and r.error is None for r in reqs)
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_mixed_engine_matches_jax(weights, rows):
    """The port's mixed engine against usdm_tpu's (both with mixed links,
    rows 1 / 2 / 4): the same tokens, and the same links and chunks."""
    jp, tp = weights
    jc, pc = ecfgs(mixed_min_decode=1, mixed_prefill_rows=rows)
    kws = [{}] * 4
    with jax.default_matmul_precision("highest"):
        jeng = JaxEngine(jp, CFG, jc)
        want = _staggered(jeng, JaxRequest, _prompts(), kws)
    eng = PagedEngine(tp, PCFG, pc, device="cpu")
    got = _staggered(eng, Request, _prompts(), kws)
    assert got == want
    assert eng.mixed_links > 0 and {"mixed_dispatch", "mixed_sync"} <= set(eng.perf)
    assert (eng.steps, eng.prefill_chunks) == (jeng.steps, jeng.prefill_chunks)
    _whole(eng)


@pytest.mark.parametrize("sampled,rows", [(False, 4), (True, 4), (True, 1), (False, 2)])
def test_mixed_matches_alternating(weights, sampled, rows):
    """mixed_prefill on and off give the same tokens, greedy and sampled
    (each sampled slot draws its first token's noise at completion and one
    draw per link it decodes in, whichever way the links are scheduled)."""
    _, tp = weights
    kws = [dict(top_k=12, temperature=0.9, seed=i) if sampled else {} for i in range(4)]
    outs = []
    for mixed in (True, False):
        eng = PagedEngine(tp, PCFG, ecfgs(mixed_prefill=mixed, mixed_min_decode=1,
                                          mixed_prefill_rows=rows)[1], device="cpu")
        outs.append(_staggered(eng, Request, _prompts(), kws))
        assert (eng.mixed_links > 0) == mixed and ("mixed_dispatch" in eng.perf) == mixed
        _whole(eng)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("rows,gain", [(4, 1), (1, 3)])
def test_mixed_advances_decode_during_burst(weights, rows, gain):
    """tests/test_paged.py:1236: every mixed link also advances the decoding
    slot; at rows 4 a 4-chunk prompt prefills in one link (one tick), at
    rows 1 one chunk a link, the decoding slot gaining a token each."""
    _, tp = weights
    allow = np.ones(CFG.vocab_size, bool)
    r = np.random.default_rng(1)
    eng = PagedEngine(tp, PCFG, ecfgs(prefill_chunks_per_tick=4, mixed_min_decode=1,
                                      mixed_prefill_rows=rows)[1], device="cpu")
    ra = Request(0, r.integers(3, 96, size=8).tolist(), allow, eos_id=1, max_new_tokens=30)
    eng.submit(ra)
    for _ in range(3):
        eng.tick()
    eng.drain_inflight()
    base, chunks0, links0 = len(ra.output_ids), eng.prefill_chunks, eng.mixed_links
    rb = Request(1, r.integers(3, 96, size=64).tolist(), allow, eos_id=1, max_new_tokens=4)
    eng.submit(rb)
    eng.tick()
    assert len(ra.output_ids) >= base + gain
    if rows == 4:
        assert eng.prefill_chunks - chunks0 == 4 and eng.mixed_links - links0 == 1
        assert eng.mixed_rows == 4
    eng.run([])
    assert ra.finished and rb.finished
    _whole(eng)


def test_mixed_int8_kv_matches_solo(weights):
    """tests/test_paged.py:1343: mixed links over int8 pools, batched ==
    solo."""
    _, tp = weights
    pc = ecfgs(mixed_min_decode=1, kv_dtype="int8")[1]
    prompts = _prompts(sizes=(20, 35))
    eng = PagedEngine(tp, PCFG, pc, device="cpu")
    outs = _staggered(eng, Request, prompts, [{}] * 2, max_new=30)
    assert eng.mixed_links > 0 and eng.kv.quantized
    _whole(eng)
    allow = np.ones(CFG.vocab_size, bool)
    for i, p in enumerate(prompts):
        solo = PagedEngine(tp, PCFG, pc, device="cpu")
        assert solo.run([Request(i, list(p), allow, 1, 30)])[0].output_ids == outs[i]


@pytest.mark.parametrize("impl", ["chain", "fused"])
def test_multi_impl_matches_single_step(weights, impl):
    """tests/test_paged.py:342: chained and fused multi-step decode emit what
    per-token stepping emits, and usdm_tpu's fused engine emits the same."""
    jp, tp = weights
    r = np.random.default_rng(4)
    allow = np.ones(CFG.vocab_size, bool)
    prompts = [r.integers(3, CFG.vocab_size, 8 + i).tolist() for i in range(3)]

    def run(horizon, multi_impl="chain"):
        eng = PagedEngine(tp, PCFG, ecfgs(decode_horizon=horizon)[1], device="cpu")
        eng.multi_impl = multi_impl
        out = [q.output_ids for q in eng.run([Request(i, p, allow, 2, 7)
                                              for i, p in enumerate(prompts)])]
        _whole(eng)
        return out, eng

    step, _ = run(1)
    got, eng = run(8, impl)
    assert got == step
    assert ("multi_dispatch" in eng.perf) == (impl == "fused")
    with jax.default_matmul_precision("highest"):
        jeng = JaxEngine(jp, CFG, ecfgs(decode_horizon=8)[0])
        jeng.multi_impl = impl
        want = [q.output_ids for q in jeng.run([JaxRequest(i, p, allow, 2, 7)
                                                for i, p in enumerate(prompts)])]
    assert got == want


def test_fused_sampled_matches_chain(weights):
    """Sampled slots under the fused multi-step decode (one
    paged_decode_multi call a tick on the CPU) draw their noise link by link
    as chains and per-token steps draw it: the same tokens, one of the three
    sampled requests with a top_p cut."""
    _, tp = weights
    r = np.random.default_rng(6)
    allow = np.ones(CFG.vocab_size, bool)
    prompts = [r.integers(3, CFG.vocab_size, 9 + 3 * i).tolist() for i in range(4)]
    kws = [dict(top_k=12, temperature=0.9, seed=1), {}, dict(top_k=40, top_p=0.8, seed=2),
           dict(temperature=1.3, top_k=5, seed=3)]

    def run(horizon, impl):
        eng = PagedEngine(tp, PCFG, ecfgs(decode_horizon=horizon)[1], device="cpu")
        eng.multi_impl = impl
        out = [q.output_ids for q in eng.run([Request(i, p, allow, 2, 11, **kw) for i, (p, kw)
                                              in enumerate(zip(prompts, kws))])]
        _whole(eng)
        return out, eng

    fused, eng = run(8, "fused")
    assert eng.perf["multi_dispatch"] > 0 and eng.links.replays == 0
    assert fused == run(8, "chain")[0] == run(1, "chain")[0]


def test_defer_first_gate_refuses_stream_and_fused(weights):
    """usdm_tpu's gate: no first-token deferral to a streaming consumer or
    under the fused multi-step decode."""
    _, tp = weights
    eng = PagedEngine(tp, PCFG, ecfgs()[1], device="cpu")
    allow = np.ones(CFG.vocab_size, bool)
    plain = Request(0, [5, 6, 7], allow, eos_id=2)
    assert eng._defer_first_ok(plain)
    assert not eng._defer_first_ok(Request(1, [5, 6, 7], allow, eos_id=2, stream=True))
    eng.multi_impl = "fused"
    assert not eng._defer_first_ok(plain)


def test_streaming_first_token_recorded_mid_burst(weights):
    """tests/test_paged.py:1287: a streaming request that completes its
    prompt inside a mixed burst has its first token recorded at that link,
    not at the burst's sync; its tokens are a solo run's."""
    _, tp = weights
    allow = np.ones(CFG.vocab_size, bool)
    r = np.random.default_rng(2)
    pc = ecfgs(mixed_min_decode=1, mixed_prefill_rows=1, prefill_chunks_per_tick=8)[1]
    eng = PagedEngine(tp, PCFG, pc, device="cpu")
    eng.submit(Request(0, r.integers(3, CFG.vocab_size, 8).tolist(), allow, 1, 20))
    for _ in range(3):
        eng.tick()
    rb = Request(1, r.integers(3, 96, size=30).tolist(), allow, eos_id=1, max_new_tokens=6,
                 stream=True)
    seen = []
    record = eng._record_first
    eng._record_first = lambda slot, tok: (seen.append(eng.mixed_links), record(slot, tok))
    eng.submit(rb)
    eng.tick()  # one burst: rb's two chunks in two links, then the burst's sync
    assert rb.output_ids and rb.ttft_s is not None
    assert eng.mixed_links == 2 and seen == [2]
    eng.run([])
    solo = PagedEngine(tp, PCFG, pc, device="cpu")
    clone = solo.run([Request(2, list(rb.prompt_ids), allow, 1, 6)])[0]
    assert rb.output_ids == clone.output_ids
    _whole(eng)


def test_mixed_first_token_rides_the_burst_sync(weights):
    """A non-streaming request completing mid-burst learns its first token
    at the burst's one sync (after every link), with the decode tokens."""
    _, tp = weights
    allow = np.ones(CFG.vocab_size, bool)
    r = np.random.default_rng(2)
    pc = ecfgs(mixed_min_decode=1, mixed_prefill_rows=1, prefill_chunks_per_tick=8)[1]
    eng = PagedEngine(tp, PCFG, pc, device="cpu")
    eng.submit(Request(0, r.integers(3, CFG.vocab_size, 8).tolist(), allow, 1, 20))
    for _ in range(3):
        eng.tick()
    rb = Request(1, r.integers(3, 96, size=30).tolist(), allow, eos_id=1, max_new_tokens=6)
    seen = []
    record = eng._record_first
    eng._record_first = lambda slot, tok: (seen.append(eng.perf.get("absorb")),
                                           record(slot, tok))
    eng.submit(rb)
    eng.tick()
    assert eng.mixed_links == 2 and len(seen) == 1 and seen[0] is not None
    eng.run([])
    _whole(eng)


# ---------------------------------------------------------------- server
def _server(tp, **kw):
    return EngineServer(PagedEngine(tp, PCFG, ecfgs(**kw)[1], device="cpu"))


def test_generate_stream_equals_generate(weights):
    """The yields of generate_stream concatenated are generate's tokens, for
    a lone request and for three streaming clients beside two plain ones
    (mixed links engage with three slots decoding)."""
    _, tp = weights
    allow = np.ones(CFG.vocab_size, bool)
    prompts = _prompts(sizes=(20, 35, 18, 40, 26))
    server = _server(tp, max_batch_size=5)
    try:
        want = [server.generate(p, allow, -1, 12, timeout=60) for p in prompts]
        parts = [list(server.generate_stream(prompts[0], allow, -1, 12, timeout=60))]
        assert [t for part in parts[0] for t in part] == want[0]
        got, errors = {}, []

        def client(i):
            try:
                if i < 3:
                    got[i] = [t for part in server.generate_stream(prompts[i], allow, -1, 12,
                                                                    timeout=60) for t in part]
                else:
                    got[i] = server.generate(prompts[i], allow, -1, 12, timeout=60)
            except Exception as e:  # re-raised on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors
        assert [got[i] for i in range(5)] == want
    finally:
        server.close()
    assert len(server.engine.free_pages) == server.engine.n_pages - 1


def _wait_idle(server, cancelled, timeout=30.0):
    deadline = time.monotonic() + timeout
    eng = server.engine
    while time.monotonic() < deadline and (eng.busy or eng.total_cancelled < cancelled):
        time.sleep(0.005)


def test_closing_a_stream_cancels(weights):
    """Closing the generator after its first yield cancels the request: the
    slot is free and every page is back."""
    _, tp = weights
    server = _server(tp, max_batch_size=2)
    try:
        gen = server.generate_stream(_prompts()[1], np.ones(CFG.vocab_size, bool), -1, 80,
                                     timeout=60)
        first = next(gen)
        gen.close()
        _wait_idle(server, 1)
        eng = server.engine
        assert first and eng.total_cancelled == 1 and eng.total_finished == 1
        assert (eng.status == FREE).all() and len(eng.free_pages) == eng.n_pages - 1
        assert not server._reqs and not server._events
    finally:
        server.close()


def test_stream_stall_times_out_per_wait(weights):
    """A request that makes no progress raises TimeoutError after `timeout`
    on the monotonic clock, although the loop thread notifies after every
    tick; the request is cancelled."""
    _, tp = weights
    server = _server(tp)
    eng = server.engine
    eng.tick = lambda: time.sleep(0.005) or 1  # ticks that never advance anything
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            for _ in server.generate_stream(_prompts()[0], np.ones(CFG.vocab_size, bool), -1,
                                            5, timeout=0.3):
                pass
        waited = time.monotonic() - t0
        assert 0.3 <= waited < 10
        _wait_idle(server, 1)
        assert eng.total_cancelled == 1 and not eng.waiting
    finally:
        server.close()
    assert not server._thread.is_alive()


@pytest.fixture(scope="module")
def dialog_model():
    tok = UsdmTokenizer.build_test(num_units=32)
    cfg = C.MistralConfig.tiny(vocab_size=tok.vocab_size)
    return tok, cfg, M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")


def _dialog(dialog_model, **kw):
    tok, cfg, params = dialog_model
    eng = PagedEngine(params, cfg, C.EngineConfig(max_batch_size=1, page_size=16,
                                                  max_pages_per_seq=64, prefill_chunk=64),
                      device="cpu")
    server = EngineServer(eng)
    return server, PagedDialogPolicy(server, tok, max_new_tokens=12, **kw)


def test_dialog_policy_streams_stage_deltas(dialog_model):
    """on_tokens gets each stage's new tokens in order; they add up to the
    stage tokens, and the turn equals the non-streaming policy's."""
    units = list(range(5, 21))
    server, policy = _dialog(dialog_model)
    try:
        want = policy.respond_to_units(units)
    finally:
        server.close()
    got_deltas = []
    server, policy = _dialog(dialog_model, on_tokens=lambda st, d: got_deltas.append((st, d)))
    try:
        got = policy.respond_to_units(units)
    finally:
        server.close()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    stages = [st for st, _ in got_deltas]
    assert stages == sorted(stages, key=["unit2text", "text2text", "text2unit"].index)
    for st, toks in want.stage_tokens.items():
        assert [t for s, d in got_deltas if s == st for t in d] == list(toks)


def test_dialog_policy_abort(dialog_model):
    """abort_check returning True raises DialogAborted and leaves no request
    running on the engine (the stage's request is cancelled, the session's
    pages released)."""
    server, policy = _dialog(dialog_model, abort_check=lambda: True)
    try:
        with pytest.raises(DialogAborted):
            policy.respond_to_units(list(range(5, 21)))
        _wait_idle(server, 1)
        eng = server.engine
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(eng.free_pages) != eng.n_pages - 1:
            time.sleep(0.005)  # the session's release reaches the loop thread
        assert eng.total_cancelled == 1
        assert not ((eng.status == PREFILL) | (eng.status == DECODE)).any()
        assert len(eng.free_pages) == eng.n_pages - 1
    finally:
        server.close()
