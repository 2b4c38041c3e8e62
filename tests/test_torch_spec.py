"""usdm_tpu_torch's speculative decoding against usdm_tpu, on the CPU.

The same tiny Mistral weights (through the bridge) and numpy-seeded inputs
go through usdm_tpu's `ngram_propose`, `paged_verify_step`,
`paged_spec_accept`, `paged_ngram_round` and its step_spec round body, and
through the port's; the same requests through both packages' PagedEngines
with a draft model or "ngram" and through the port's plain engine.  JAX
runs under default_matmul_precision("highest") in f32, like the port.

Tolerances: tokens, n_emit, next tokens, done flags, lengths and the ngram
history exactly; the K/V rows a round writes as tests/test_torch_mixed.py
holds a mixed link's: f32 pools within 1e-5 of the largest value, bf16
pools within 2^-7 of it (one bf16 ulp), int8 codes within 1 on fewer than
0.1 % of the written values and their scales within 3e-4 relative (the two
packages' f32 sums differ in the last bits, so a value at a rounding
boundary rounds apart); every other row of every real page untouched.
tests/test_torch_cuda.py holds the rounds on the card.
"""

import dataclasses

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
from usdm_tpu_torch.engine import paged_ops as P
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models import quant as Q

CFG = MistralConfig.tiny(vocab_size=96)  # tests/test_paged.py's speculation config
PCFG = C.MistralConfig.from_dict(dataclasses.asdict(CFG))
BASE = dict(page_size=16, max_pages_per_seq=8, max_batch_size=2, prefill_chunk=16)


def ecfgs(**kw):
    """(usdm_tpu's, the port's) EngineConfig of the same fields."""
    jc = EngineConfig(**{**BASE, **kw})
    return jc, C.EngineConfig.from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def weights():
    """tests/test_paged.py's target (PRNGKey 0) and random draft (PRNGKey
    99), f32, in both packages' layouts."""
    jp = JLM.init_params(CFG, jax.random.PRNGKey(0), dtype="float32")
    jd = JLM.init_params(CFG, jax.random.PRNGKey(99), dtype="float32")
    return (jp, bridge.mistral_from_jax(jax.device_get(jp)),
            jd, bridge.mistral_from_jax(jax.device_get(jd)))


# ------------------------------------------------------------ ngram_propose
def test_ngram_propose_unit_cases():
    """usdm_tpu's two unit cases: the continuation after the longest
    suffix match, repeat-current when nothing recurs, and a longer earlier
    match beating a more recent shorter one."""
    hist = torch.zeros((2, 16), dtype=torch.long)
    hist[0, :6] = torch.tensor([10, 11, 12, 13, 10, 11])  # suffix [10, 11] recurs at 0..1
    hist[1, :4] = torch.tensor([1, 2, 3, 4])  # token 4 never recurs
    props = P.ngram_propose(hist, torch.tensor([6, 4]), torch.tensor([11, 4]), k=3, max_n=3)
    assert props.tolist() == [[12, 13, 10], [4, 4, 4]]
    hist = torch.zeros((1, 20), dtype=torch.long)
    hist[0, :12] = torch.tensor([7, 8, 9, 50, 0, 0, 8, 9, 60, 7, 8, 9])
    props = P.ngram_propose(hist, torch.tensor([12]), torch.tensor([9]), k=2, max_n=3)
    assert props.tolist() == [[50, 0]]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("vocab,k,max_n", [(3, 4, 3), (6, 4, 3), (50, 2, 1), (4, 5, 4)])
def test_ngram_propose_matches_jax(seed, vocab, k, max_n):
    """Seeded random histories (small vocabularies, so suffixes recur at
    every length; a length-1 and a full-length row among them) -> usdm_tpu's
    proposals exactly."""
    r = np.random.default_rng(seed)
    b, s = 6, 40
    hist = r.integers(0, vocab, (b, s)).astype(np.int32)
    hist_len = r.integers(1, s + 1, b).astype(np.int32)
    hist_len[0], hist_len[1] = 1, s
    cur = hist[np.arange(b), hist_len - 1]
    want = JOPS.ngram_propose(jnp.asarray(hist), jnp.asarray(hist_len), jnp.asarray(cur),
                              k, max_n)
    got = P.ngram_propose(torch.from_numpy(hist).long(), torch.from_numpy(hist_len),
                          torch.from_numpy(cur).long(), k, max_n)
    assert got.tolist() == np.asarray(want).tolist()


# --------------------------------------------------- verify, accept, rounds
P_SIZE, N_PAGES, MAXP, K = 16, 24, 4, 3  # N_PAGES includes the trash page
B = 4
TABLE = np.array([[0, 1, 2, 18], [6, 10, 14, 19], [20, 21, 22, 2], [2, 2, 2, 2]], np.int32)
SEQ_LENS = np.array([20, 33, 5, 0], np.int32)  # slot 3 inactive


def _round_inputs(kv, seed=0):
    """Numpy inputs of one round: tokens, pools holding random context."""
    r = np.random.default_rng(seed)
    shape = (CFG.num_kv_heads, CFG.num_layers * N_PAGES, P_SIZE, CFG.head_dim)
    if kv == "int8":
        pools = [r.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        sshape = (shape[1], shape[0], P_SIZE)
        pools += [r.uniform(0.001, 0.02, sshape).astype(np.float32) for _ in range(2)]
    else:  # bf16-typed pools hold bf16-representable values (numpy has no bf16)
        pools = [r.standard_normal(shape).astype(np.float32) for _ in range(2)]
        if kv == "bf16":
            pools = [torch.from_numpy(p).bfloat16().float().numpy() for p in pools]
    return r.integers(3, CFG.vocab_size, (B, K + 1)).astype(np.int32), pools


def _pools(kv, pools, jax_side):
    """The numpy pools as either package's PagedKV of the case's dtype."""
    if jax_side:
        dt = jnp.bfloat16 if kv == "bf16" else None
        return JOPS.PagedKV(*(jnp.asarray(p, dt if i < 2 else None) for i, p in enumerate(pools)))
    ts = [torch.from_numpy(p.copy()) for p in pools]
    if kv == "bf16":
        ts = [t.bfloat16() for t in ts]
    return P.PagedKV(*ts)


def _written(live, n_tok=K + 1):
    """[L*N, P] bool: the pool rows a round over `live` slots writes."""
    w = np.zeros((CFG.num_layers * N_PAGES, P_SIZE), bool)
    for li in range(CFG.num_layers):
        for b in np.flatnonzero(live):
            for pos in range(int(SEQ_LENS[b]), int(SEQ_LENS[b]) + n_tok):
                w[li * N_PAGES + TABLE[b, pos // P_SIZE], pos % P_SIZE] = True
    return w


def _check_pools(kv, tkv, jkv, pools, written):
    """The port's pools after a round against usdm_tpu's (module docstring's
    tolerances); rows the round does not write are untouched."""
    real = np.arange(CFG.num_layers * N_PAGES) % N_PAGES != N_PAGES - 1
    untouched = real[:, None] & ~written
    tol = 2.0**-7 if kv == "bf16" else 1e-5
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
        for g, w, before in zip((tkv.k_scales, tkv.v_scales), (jkv.k_scales, jkv.v_scales),
                                pools[2:]):
            g, w = g.numpy().transpose(0, 2, 1), np.asarray(w).transpose(0, 2, 1)
            assert np.array_equal(g[untouched], before.transpose(0, 2, 1)[untouched])
            np.testing.assert_allclose(g[written], w[written], rtol=3e-4)


def _allow():
    allow = np.ones((B, CFG.vocab_size), bool)
    allow[:, 70:80] = False
    return allow


LSLICES = [None, (20, 90, -1), (20, 90, 5)]  # full tail; an interval; interval + low extra


@pytest.mark.parametrize("lslice", LSLICES)
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_verify_step_matches_jax(weights, kv, lslice):
    """paged_verify_step (the port's runs attention through K1's plain
    version, one row per (column, slot); usdm_tpu's over the gathered
    context) -> usdm_tpu's tokens on active slots and its K/V."""
    jp, tp, _, _ = weights
    tokens, pools = _round_inputs(kv)
    active = np.array([True, True, True, False])
    allow = _allow()
    with jax.default_matmul_precision("highest"):
        jkv = _pools(kv, pools, True)
        jout, jkv = JOPS.paged_verify_step(
            jp, jkv, CFG, jnp.asarray(tokens), jnp.asarray(SEQ_LENS), jnp.asarray(TABLE),
            jnp.asarray(active), jnp.asarray(allow), P_SIZE, MAXP, logits_slice=lslice)
    tkv = _pools(kv, pools, False)
    t = torch.from_numpy
    out = P.paged_verify_step(tp, tkv, PCFG, t(tokens).long(), t(SEQ_LENS), t(TABLE), t(active),
                              t(allow), P_SIZE, lslice)
    assert out.shape == (B, K + 1) and out.dtype == torch.long
    assert out[:3].tolist() == np.asarray(jout)[:3].tolist()
    assert out[3].tolist() == [0] * (K + 1)
    _check_pools(kv, tkv, jkv, pools, _written(active))


def _rollout(jp, kv, pools, cur, lslice, allow):
    """Greedy drafts of usdm_tpu's verify on fresh pools: [cur, g1, g2, g3]
    with g_{j+1} the target's token after position j (full acceptance)."""
    ver = np.tile(cur[:, None], (1, K + 1)).astype(np.int32)
    for j in range(K):
        with jax.default_matmul_precision("highest"):
            out, _ = JOPS.paged_verify_step(
                jp, _pools(kv, pools, True), CFG, jnp.asarray(ver), jnp.asarray(SEQ_LENS),
                jnp.asarray(TABLE), jnp.ones(B, bool), jnp.asarray(allow), P_SIZE, MAXP,
                logits_slice=lslice)
        ver[:, j + 1] = np.asarray(out)[:, j]
    return ver


@pytest.mark.parametrize("lslice", LSLICES[:2])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_spec_accept_matches_jax(weights, kv, lslice):
    """paged_spec_accept with slot 0 accepting every draft but stopping at
    an EOS inside the run, slot 1 done earlier, slot 2 rejecting its second
    draft, slot 3 inactive -> usdm_tpu's tokens, n_emit, next tokens, done
    flags (active slots), lengths and K/V."""
    jp, tp, _, _ = weights
    tokens, pools = _round_inputs(kv, seed=1)
    allow = _allow()
    ver = _rollout(jp, kv, pools, tokens[:, 0], lslice, allow)
    ver[2, 2] = (ver[2, 2] + 1 - 3) % (CFG.vocab_size - 3) + 3  # a wrong second draft
    eos = np.array([ver[0, 2], 2, 2, 2], np.int32)  # slot 0 stops at an accepted token
    active = np.array([True, True, True, False])
    done = np.array([False, True, False, False])
    with jax.default_matmul_precision("highest"):
        jkv = _pools(kv, pools, True)
        jout, jn, jcur, jdone, jlens, jkv = JOPS.paged_spec_accept(
            jp, jkv, CFG, jnp.asarray(ver), jnp.asarray(SEQ_LENS), jnp.asarray(done),
            jnp.asarray(eos), jnp.asarray(TABLE), jnp.asarray(active), jnp.asarray(allow),
            P_SIZE, MAXP, logits_slice=lslice)
    tkv = _pools(kv, pools, False)
    t = torch.from_numpy
    out, n, cur, tdone, lens = P.paged_spec_accept(
        tp, tkv, PCFG, t(ver).long(), t(SEQ_LENS), t(done), t(eos).long(), t(TABLE), t(active),
        t(allow), P_SIZE, lslice)
    assert out.tolist() == np.asarray(jout).tolist()
    assert n.tolist() == np.asarray(jn).tolist()
    assert n.tolist()[0] == list(ver[0, 1:]).index(eos[0]) + 1 and n.tolist()[1::2] == [0, 0]
    assert 1 <= n.tolist()[2] <= 2
    assert cur.tolist() == np.asarray(jcur).tolist()
    assert tdone[:3].tolist() == np.asarray(jdone)[:3].tolist() == [True, True, False]
    assert lens.tolist() == np.asarray(jlens).tolist() and lens.dtype == torch.int32
    _check_pools(kv, tkv, jkv, pools, _written(active & ~done))


@pytest.mark.parametrize("lslice", LSLICES[:2])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_ngram_round_matches_jax(weights, kv, lslice):
    """paged_ngram_round over histories that repeat -> usdm_tpu's tokens,
    n_emit, next tokens, done flags, lengths, appended history and K/V."""
    jp, tp, _, _ = weights
    _, pools = _round_inputs(kv, seed=2)
    r = np.random.default_rng(2)
    s = MAXP * P_SIZE
    hist = np.zeros((B, s), np.int32)
    for b in range(B):
        n = int(SEQ_LENS[b]) + 1
        hist[b, :n] = (list(r.integers(20, 90, 4)) * 20)[:n]
    cur = hist[np.arange(B), SEQ_LENS]
    active = np.array([True, True, True, False])
    done = np.zeros(B, bool)
    eos = np.full(B, 2, np.int32)
    allow = _allow()
    with jax.default_matmul_precision("highest"):
        jkv = _pools(kv, pools, True)
        jout, jn, jcur, jdone, jlens, jhist, jkv = JOPS.paged_ngram_round(
            jp, jkv, CFG, jnp.asarray(hist), jnp.asarray(cur), jnp.asarray(SEQ_LENS),
            jnp.asarray(done), jnp.asarray(eos), jnp.asarray(TABLE), jnp.asarray(active),
            jnp.asarray(allow), P_SIZE, MAXP, K, 3, logits_slice=lslice)
    tkv = _pools(kv, pools, False)
    t = torch.from_numpy
    thist = t(hist).long()
    out, n, tcur, tdone, lens = P.paged_ngram_round(
        tp, tkv, PCFG, thist, t(cur).long(), t(SEQ_LENS), t(done), t(eos).long(), t(TABLE),
        t(active), t(allow), P_SIZE, K, 3, lslice)
    assert out.tolist() == np.asarray(jout).tolist()
    assert n.tolist() == np.asarray(jn).tolist() and min(n.tolist()[:3]) >= 1
    assert tcur.tolist() == np.asarray(jcur).tolist()
    assert tdone[:3].tolist() == np.asarray(jdone)[:3].tolist()
    assert lens.tolist() == np.asarray(jlens).tolist()
    assert thist.tolist() == np.asarray(jhist).tolist()
    _check_pools(kv, tkv, jkv, pools, _written(active))


def test_draft_round_matches_jax(weights):
    """paged_draft_round (K+1 draft decode steps over the draft's pool,
    then verify and accept) against usdm_tpu's step_spec round body, with
    the random draft: tokens, n_emit, next tokens, lengths, both pools."""
    jp, tp, jd, td = weights
    tokens, pools = _round_inputs("f32", seed=3)
    _, dpools = _round_inputs("f32", seed=4)
    active = np.array([True, True, True, False])
    done = np.array([False, True, False, False])
    eos = np.full(B, 2, np.int32)
    allow = _allow()
    cur = tokens[:, 0]
    with jax.default_matmul_precision("highest"):
        jkv, jdkv = _pools("f32", pools, True), _pools("f32", dpools, True)
        live = jnp.asarray(active & ~done)
        cols, d = [jnp.asarray(cur)], jnp.asarray(cur)
        for i in range(K + 1):
            d, _, jdkv = JOPS.paged_decode_step(
                jd, jdkv, CFG, d, jnp.asarray(SEQ_LENS) + i, jnp.asarray(TABLE), live,
                jnp.asarray(allow), P_SIZE, jnp.zeros((B, 2), jnp.uint32),
                jnp.ones(B, jnp.int32), jnp.ones(B, jnp.float32), jnp.ones(B, jnp.float32))
            if i < K:
                cols.append(d)
        jout, jn, jcur, _, jlens, jkv = JOPS.paged_spec_accept(
            jp, jkv, CFG, jnp.stack(cols, axis=1), jnp.asarray(SEQ_LENS), jnp.asarray(done),
            jnp.asarray(eos), jnp.asarray(TABLE), jnp.asarray(active), jnp.asarray(allow),
            P_SIZE, MAXP)
    tkv, tdkv = _pools("f32", pools, False), _pools("f32", dpools, False)
    t = torch.from_numpy
    out, n, tcur, _, lens = P.paged_draft_round(
        tp, tkv, PCFG, (td, tdkv, PCFG), t(cur).long(), t(SEQ_LENS), t(done), t(eos).long(),
        t(TABLE), t(active), t(allow), P_SIZE, K)
    assert out.tolist() == np.asarray(jout).tolist()
    assert n.tolist() == np.asarray(jn).tolist()
    assert tcur.tolist() == np.asarray(jcur).tolist()
    assert lens.tolist() == np.asarray(jlens).tolist()
    _check_pools("f32", tkv, jkv, pools, _written(active & ~done))
    _check_pools("f32", tdkv, jdkv, dpools, _written(active & ~done, K + 1))


@pytest.mark.parametrize("w8a8", [False, True])
def test_early_exit_draft_shares_tensors(w8a8):
    """The early-exit draft is the target's first n layers and its embed,
    final norm and lm_head: the same tensors (W8A8 leaves too), no copy."""
    params = M.init_params(PCFG, torch.Generator().manual_seed(0), "cpu")
    if w8a8:
        Q.quantize_llm_params(params)
    draft = Q.early_exit_draft(params, 1)
    assert len(draft["layers"]) == 1 and draft["layers"][0] is params["layers"][0]
    for key in ("embed", "final_norm", "lm_head"):
        assert draft[key] is params[key]
    for k in Q.QUANT_KEYS:
        leaf, want = draft["layers"][0][k], params["layers"][0][k]
        if w8a8:
            assert leaf["q"].data_ptr() == want["q"].data_ptr()
        else:
            assert leaf.data_ptr() == want.data_ptr()


# ------------------------------------------------------------------ engines
def _run_both(weights, draft_kind, ecfg_kw, requests, spec_k=3, kv_dtype=None):
    """The same requests (`requests(mk)` with a package's Request class) on
    usdm_tpu's speculative engine, the port's, and the port's plain engine
    (spec_k 0) -> (outputs of each, the two speculative engines)."""
    jp, tp, jd, td = weights
    jc, pc = ecfgs(**ecfg_kw, kv_dtype=kv_dtype)
    jdraft = {"same": (jp, CFG), "random": (jd, CFG), "ngram": "ngram"}[draft_kind]
    pdraft = {"same": (tp, PCFG), "random": (td, PCFG), "ngram": "ngram"}[draft_kind]
    with jax.default_matmul_precision("highest"):
        ej = JaxEngine(jp, CFG, jc.replace(spec_k=spec_k), draft=jdraft)
        rj = ej.run(requests(JaxRequest))
    ep = PagedEngine(tp, PCFG, pc.replace(spec_k=spec_k), device="cpu", draft=pdraft)
    rp = ep.run(requests(Request))
    plain = PagedEngine(tp, PCFG, pc.replace(spec_k=0), device="cpu")
    rg = plain.run(requests(Request))
    assert len(ep.free_pages) == ep.n_pages - 1 and not ep.busy
    return ([r.output_ids for r in rj], [r.output_ids for r in rp],
            [r.output_ids for r in rg]), (ej, ep)


def _prompts(rng, kind="random"):
    v = CFG.vocab_size
    if kind == "cyclic":
        base = (list(rng.integers(3, v, size=4)) * 4)[:14]
        return [base, (list(rng.integers(3, 96, size=3)) * 5)[:13]]
    return [rng.integers(3, v, size=11 + i).tolist() for i in range(2)]


@pytest.mark.parametrize("draft_kind", ["same", "random"])
def test_speculative_output_equals_greedy(weights, rng, draft_kind):
    """test_paged.py's invariant: for any draft the tokens equal plain
    greedy decode; a perfect draft (the target itself) accepts every round
    in full, a random one next to nothing.  Port speculative == port greedy
    == usdm_tpu speculative, with the same rounds and emitted tokens."""
    prompts = _prompts(rng)
    allow = np.ones(CFG.vocab_size, bool)
    (j, p, g), (ej, ep) = _run_both(
        weights, draft_kind, {},
        lambda mk: [mk(i, list(pr), allow, 2, 13) for i, pr in enumerate(prompts)])
    assert p == g == j
    assert (ep.spec_rounds, ep.spec_emitted) == (ej.spec_rounds, ej.spec_emitted)
    assert ep.spec_rounds > 0
    if draft_kind == "same":
        assert ep.spec_emitted >= ep.spec_rounds * (3 + 1) - 2


@pytest.mark.parametrize("draft_kind", ["same", "ngram"])
def test_speculative_respects_eos_and_budget(weights, rng, draft_kind):
    """An EOS inside an accepted run ends the round there; the tokens equal
    plain greedy's up to and including the stop (draft model and ngram)."""
    _, tp, _, _ = weights
    prompt = rng.integers(3, CFG.vocab_size, size=9).tolist()
    allow = np.ones(CFG.vocab_size, bool)
    _, pc = ecfgs(max_batch_size=1)
    probe = Request(0, list(prompt), allow, eos_id=-1, max_new_tokens=12)
    PagedEngine(tp, PCFG, pc.replace(spec_k=0), device="cpu").run([probe])
    eos = probe.output_ids[3]
    (j, p, g), _ = _run_both(
        weights, draft_kind, {"max_batch_size": 1},
        lambda mk: [mk(1, list(prompt), allow, eos_id=eos, max_new_tokens=12)], spec_k=4)
    assert p == g == j and p[0][-1] == eos


def test_speculative_sampled_requests_fall_back(weights, rng):
    """Sampled requests do not speculate (greedy only) but finish on a
    draft engine with the plain engine's seeded tokens (the port's; its
    torch generators draw other numbers than usdm_tpu's threefry keys)."""
    _, tp, _, _ = weights
    _, pc = ecfgs()
    allow = np.ones(CFG.vocab_size, bool)
    prompt = rng.integers(3, CFG.vocab_size, size=12).tolist()
    mk = lambda i: Request(i, list(prompt), allow, eos_id=2, max_new_tokens=8,  # noqa: E731
                           top_k=0, top_p=1.0, temperature=0.7, seed=5)
    eng = PagedEngine(tp, PCFG, pc.replace(spec_k=3), device="cpu", draft=(tp, PCFG))
    r = eng.run([mk(0)])[0]
    assert eng.spec_rounds == 0
    r2 = PagedEngine(tp, PCFG, pc, device="cpu").run([mk(1)])[0]
    assert r.output_ids == r2.output_ids and len(r.output_ids) == 8


def test_draft_engine_never_chains_without_mirroring(weights, rng):
    """With a draft attached, turns that do not speculate single-step (each
    step mirrors into the draft's pool): a chain or a fused multi-step
    decode would leave holes in it.  Decode links mirror; the draft's pool
    holds the K/V of every position the request decoded."""
    _, tp, _, _ = weights
    _, pc = ecfgs(decode_horizon=8)
    allow = np.ones(CFG.vocab_size, bool)
    prompt = rng.integers(3, CFG.vocab_size, size=12).tolist()
    eng = PagedEngine(tp, PCFG, pc.replace(spec_k=3), device="cpu", draft=(tp, PCFG))

    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("chain path used with a draft attached")

    eng.step_chain = boom
    eng.step_multi = boom
    r = Request(0, list(prompt), allow, eos_id=2, max_new_tokens=6, top_k=0, top_p=1.0,
                temperature=0.8, seed=3)
    eng.run([r])
    assert r.finished and len(r.output_ids) == 6 and eng.spec_rounds == 0
    # the draft is the target: its pool equals the target's on every real page
    keep = torch.ones(eng.kv.total_pages, dtype=torch.bool)
    keep[eng.n_pages - 1::eng.n_pages] = False
    assert torch.equal(eng.draft_kv.k_pages[:, keep], eng.kv.k_pages[:, keep])


@pytest.mark.parametrize("prompt_kind", ["cyclic", "random"])
def test_ngram_output_equals_greedy(weights, rng, prompt_kind):
    """Draft-free prompt lookup is lossless whether the history repeats
    (high acceptance) or not (fallback proposals); the same rounds and
    emitted tokens as usdm_tpu's."""
    prompts = _prompts(rng, prompt_kind)
    allow = np.ones(CFG.vocab_size, bool)
    (j, p, g), (ej, ep) = _run_both(
        weights, "ngram", {},
        lambda mk: [mk(i, list(pr), allow, 2, 13) for i, pr in enumerate(prompts)], spec_k=4)
    assert p == g == j
    assert (ep.spec_rounds, ep.spec_emitted) == (ej.spec_rounds, ej.spec_emitted)
    assert ep.spec_rounds > 0 and ep.draft_params is None


def test_ngram_high_acceptance_on_cyclic_model_output(weights, rng):
    """A 2-token allow mask makes greedy decode cycle (the stage-C unit
    stream's shape): lookup accepts more than 2 tokens a round, and the
    engine's stats say so."""
    prompt = rng.integers(3, CFG.vocab_size, size=8).tolist()
    allow = np.zeros(CFG.vocab_size, bool)
    allow[40:42] = True
    (j, p, g), (ej, ep) = _run_both(
        weights, "ngram", {"max_batch_size": 1},
        lambda mk: [mk(0, list(prompt), allow, 2, 30)], spec_k=4)
    assert p == g == j and len(p[0]) == 30
    st = ep.stats()
    assert st["spec_rounds"] == ej.spec_rounds > 0
    assert st["spec_accept_per_round"] > 2.0


def test_ngram_mixed_paths_history_stays_consistent(weights, rng):
    """Staggered arrivals move the engine between prefill, per-token steps
    and ngram rounds; the device history is rebuilt across them (a stale
    one would still be lossless): every request's tokens equal its solo
    plain run and usdm_tpu's ngram engine's under the same arrivals, and
    speculation resumes after the interlude."""
    jp, tp, _, _ = weights
    jc, pc = ecfgs(spec_k=3)
    allow = np.ones(CFG.vocab_size, bool)
    prompts = [rng.integers(3, CFG.vocab_size, size=10 + i).tolist() for i in range(3)]
    solo = [PagedEngine(tp, PCFG, pc.replace(spec_k=0), device="cpu")
            .run([Request(i, list(p), allow, 2, 11)])[0].output_ids
            for i, p in enumerate(prompts)]

    def staggered(eng, mk):
        reqs = [mk(i, list(p), allow, 2, 11) for i, p in enumerate(prompts)]
        eng.submit(reqs[0])
        eng.tick()
        eng.submit(reqs[1])  # arrives mid-flight: a non-speculative interlude
        while eng.busy and not reqs[1].finished:
            eng.tick()
        eng.submit(reqs[2])
        while eng.busy:
            eng.tick()
        eng.drain_inflight()
        return [r.output_ids for r in reqs]

    with jax.default_matmul_precision("highest"):
        want = staggered(JaxEngine(jp, CFG, jc, draft="ngram"), JaxRequest)
    eng = PagedEngine(tp, PCFG, pc, device="cpu", draft="ngram")
    assert staggered(eng, Request) == solo == want
    assert eng.spec_rounds > 0 and len(eng.free_pages) == eng.n_pages - 1


@pytest.mark.parametrize("draft_kind", ["same", "ngram"])
def test_int8_speculative_equals_greedy(weights, rng, draft_kind):
    """Speculation over int8 pools: verification quantizes each (head,
    token) as decode does, so the tokens stay greedy's (usdm_tpu's too)."""
    prompt = rng.integers(3, CFG.vocab_size, size=10).tolist()
    allow = np.ones(CFG.vocab_size, bool)
    (j, p, g), (ej, ep) = _run_both(
        weights, draft_kind, {"max_pages_per_seq": 8, "max_batch_size": 4},
        lambda mk: [mk(0, list(prompt), allow, 2, 8)], spec_k=4, kv_dtype="int8")
    assert p == g == j
    assert ep.kv.quantized and ep.spec_rounds == ej.spec_rounds > 0


def test_mixed_prefill_with_ngram_engine(weights, rng):
    """ngram engines take mixed prefill + decode links too (the history is
    rebuilt after the burst); the tokens equal the plain engine's and
    usdm_tpu's ngram engine's."""
    jp, tp, _, _ = weights
    allow = np.ones(CFG.vocab_size, bool)
    prompts = [rng.integers(3, CFG.vocab_size, size=n).tolist() for n in (20, 35, 18)]
    kw = dict(max_batch_size=4, mixed_prefill=True, mixed_min_decode=1, spec_k=3)
    jc, pc = ecfgs(**kw)

    def staggered(eng, mk):
        reqs = [mk(i, list(p), allow, eos_id=1, max_new_tokens=10) for i, p in enumerate(prompts)]
        eng.submit(reqs[0])
        for _ in range(3):
            eng.tick()
        for r in reqs[1:]:
            eng.submit(r)
        while eng.busy:
            eng.tick()
        eng.drain_inflight()
        return [r.output_ids for r in reqs]

    with jax.default_matmul_precision("highest"):
        want = staggered(JaxEngine(jp, CFG, jc, draft="ngram"), JaxRequest)
    eng = PagedEngine(tp, PCFG, pc, device="cpu", draft="ngram")
    got = staggered(eng, Request)
    plain = staggered(PagedEngine(tp, PCFG, pc.replace(spec_k=0), device="cpu"), Request)
    assert got == want == plain
    assert eng.mixed_links > 0 and eng.spec_rounds > 0
    assert len(eng.free_pages) == eng.n_pages - 1


@pytest.mark.parametrize("draft_kind", ["same", "ngram"])
def test_rounds_take_one_sync(weights, rng, draft_kind):
    """R chained rounds read their tokens back once: each step_spec /
    step_spec_ngram call fetches and waits once, for every round it ran,
    and the rounds per sync ramp above 1."""
    _, tp, _, _ = weights
    _, pc = ecfgs(max_batch_size=1, decode_horizon=16, spec_k=3)
    draft = (tp, PCFG) if draft_kind == "same" else "ngram"
    eng = PagedEngine(tp, PCFG, pc, device="cpu", draft=draft)
    lk = eng.links
    waits, real = [], lk.wait_rounds
    lk.wait_rounds = lambda h, r: waits.append(r) or real(h, r)
    allow = np.zeros(CFG.vocab_size, bool)
    allow[40:42] = True  # a cycling stream: lookup accepts
    eng.run([Request(0, rng.integers(3, CFG.vocab_size, 9).tolist(), allow, 2, 60)])
    assert sum(waits) == eng.spec_rounds > 0 and max(waits) > 1
    assert eng.stats()["perf_s"]["spec_sync"] >= 0


def test_engine_refuses_bad_drafts(weights):
    """A draft of another vocabulary, an unknown draft string, and a mesh
    that is not engine/tp.py's raise (tensor-parallel speculation itself
    runs: tests/test_torch_tp.py)."""
    _, tp, _, _ = weights
    _, pc = ecfgs()
    other = PCFG.replace(vocab_size=CFG.vocab_size + 1)
    with pytest.raises(ValueError):
        PagedEngine(tp, PCFG, pc, device="cpu", draft=(tp, other))
    with pytest.raises(ValueError):
        PagedEngine(tp, PCFG, pc, device="cpu", draft="medusa")
    with pytest.raises(TypeError, match="TPMesh"):
        PagedEngine(tp, PCFG, pc, device="cpu", draft="ngram", mesh=object())


# ------------------------------------------------------------------- server
@pytest.fixture(scope="module")
def pipe():
    from usdm_tpu_torch.pipeline import UsdmPipeline

    return UsdmPipeline.tiny_random(device="cpu")


def _dialog(server, pipe, units, max_new):
    from usdm_tpu_torch.engine.server import PagedDialogPolicy

    try:
        return PagedDialogPolicy(server, pipe.tokenizer, max_new_tokens=max_new,
                                 seed=0).respond_to_units(units)
    finally:
        server.close()


@pytest.mark.parametrize("draft", ["same", "early-exit:1", "ngram"])
def test_dialog_through_spec_server_matches_plain(pipe, draft):
    """tests/test_server.py's two speculative server tests through the
    port's make_server: a draft model (the target itself), the early-exit
    self-draft and ngram give the plain engine's 3-stage dialog tokens."""
    ecfg = C.EngineConfig(page_size=32, max_pages_per_seq=64, max_batch_size=2,
                          prefill_chunk=256, spec_k=3)
    units = list(range(40))
    want = _dialog(pipe.make_server(ecfg.replace(spec_k=0)), pipe, units, 12)
    spec = pipe.make_server(ecfg, draft=(pipe.lm_params, pipe.lm_cfg) if draft == "same"
                            else draft)
    eng = spec.engine
    got = _dialog(spec, pipe, units, 12)
    assert got.stage_tokens == want.stage_tokens and got.agent_units == want.agent_units
    assert eng.spec_rounds > 0
    if draft == "early-exit:1":
        assert eng.draft_cfg.num_layers == 1
        assert eng.draft_params["layers"][0] is pipe.lm_params["layers"][0]
        st = eng.stats()
        assert st["total_finished"] == 3 and st["free_pages"] > 0


def test_make_server_refuses_unknown_draft(pipe):
    with pytest.raises(ValueError):
        pipe.make_server(C.EngineConfig(), draft="lookahead:3")


def test_enable_speculation_respond_equals_plain(pipe, tmp_path):
    """respond() with enable_speculation("ngram") gives the plain turn's
    tokens and units, through a dialog engine that speculated."""
    from usdm_tpu_torch.audio.wav import write_wav

    wav = str(tmp_path / "user.wav")
    write_wav(wav, (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32),
              16000)
    try:
        want = pipe.respond(wav, n_timesteps=2)
        pipe.enable_speculation("ngram")
        got = pipe.respond(wav, n_timesteps=2)
        eng = pipe._server.engine
        assert eng.ngram and eng.spec_rounds > 0
    finally:
        pipe.enable_speculation(None)
    assert pipe._server is None
    assert got == want


# ------------------------------------------------------------ bench ports
@pytest.mark.parametrize("script", ["bench_ngram", "bench_spec_degraded", "stress_engine"])
def test_bench_ports_run_on_cpu(script, capsys):
    """The ports of scripts/bench_ngram.py, bench_spec_degraded.py and
    stress_engine.py run their plain versions at tiny size (one stress
    round, ngram, mixed links from one decoding slot) and print one JSON
    line last: every speculative run identical to plain greedy, the stress
    round's invariants held."""
    import importlib
    import json

    mod = importlib.import_module(f"usdm_tpu_torch.scripts.{script}")
    args = (["--device", "cpu", "--rounds", "1", "--draft", "ngram"]
            if script == "stress_engine" else ["--device", "cpu", "--tiny"])
    out = mod.main(args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    if script == "bench_ngram":
        assert all(r["verdict"] == {"divergences": 0} for r in out["regimes"].values())
        assert out["regimes"]["zero"]["accept_per_round"] == 5.0
    elif script == "bench_spec_degraded":
        assert all(r["identical"] for k, r in out["runs"].items() if k != "plain")
    else:
        (r,) = out["rounds"]
        assert r["spec_rounds"] > 0 and r["mixed_links"] > 0
