"""usdm_tpu_torch's chain run-ahead and first-token deferral against usdm_tpu.

Counterparts of tests/test_paged.py's run-ahead tests: the same tiny
Mistral weights (through the bridge) and the same requests through the
port's PagedEngine with run-ahead on and off and through usdm_tpu's
PagedEngine with its default run-ahead give identical tokens.  JAX runs
under default_matmul_precision("highest") in f32, like the port.  On the
CPU every decode link runs eagerly through the same scheduler code that
replays CUDA graphs on the card (tests/test_torch_cuda.py holds those).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import EngineConfig, MistralConfig
from usdm_tpu.engine.paged import PagedEngine as JaxEngine
from usdm_tpu.engine.paged import Request as JaxRequest
from usdm_tpu.models import mistral as JLM
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.engine.server import EngineServer
from usdm_tpu_torch.models import mistral as M

CFG = MistralConfig.tiny()
PCFG = C.MistralConfig.from_dict(dataclasses.asdict(CFG))
BASE = dict(page_size=16, max_pages_per_seq=8, max_batch_size=2, decode_horizon=8)


def ecfgs(**kw):
    """(usdm_tpu's, the port's) EngineConfig of the same fields."""
    jc = EngineConfig(**{**BASE, **kw})
    return jc, C.EngineConfig.from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def weights():
    jp = JLM.init_params(CFG, jax.random.PRNGKey(7))
    return jp, bridge.mistral_from_jax(jax.device_get(jp))


def _prompts():
    r = np.random.default_rng(11)
    return [r.integers(3, CFG.vocab_size, size=n).tolist() for n in (9, 14, 11)]


def _scenario(case, eng, mk):
    """Drive one case on an engine (either package) with its Request class
    `mk` -> (the output tokens of every request, the engine's decode links,
    prefill chunks, kv-written lengths and K/V pools without the trash
    pages).  Checks the free-pool invariant at the end: nothing leaked
    across in-flight chains."""
    prompts = _prompts()
    allow = np.ones(CFG.vocab_size, bool)
    if case == "budget":  # a long greedy request that runs into its budget
        reqs = [mk(0, prompts[0], allow, eos_id=2, max_new_tokens=30)]
        eng.run(reqs)
    elif case == "session":  # stage-B/C shape: the second prompt extends the first turn
        r1 = mk(0, prompts[0], allow, eos_id=2, max_new_tokens=20, session=7)
        eng.run([r1])
        r2 = mk(1, prompts[0] + r1.output_ids + prompts[1], allow, eos_id=2,
                max_new_tokens=12, session=7)
        eng.run([r2])
        eng.release_session(7)
        reqs = [r1, r2]
    elif case == "eos_mid_chain":  # the greedy continuation's 3rd token as the EOS
        probe = mk(0, prompts[2], allow, eos_id=2, max_new_tokens=16)
        eng.run([probe])
        eos = probe.output_ids[2] if len(probe.output_ids) > 3 else 2
        r = mk(1, prompts[2], allow, eos_id=eos, max_new_tokens=16)
        eng.run([r])
        reqs = [probe, r]
    elif case == "sampled":  # seeded, and top_p so small that one token survives
        reqs = [mk(0, prompts[1], allow, eos_id=2, max_new_tokens=20, top_k=8, top_p=1e-6,
                   temperature=0.8, seed=5)]
        eng.run(reqs)
    elif case == "two_slots":  # two decoding slots, one ends early, one waits
        reqs = [mk(i, p, allow, eos_id=2, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (6, 25, 13)))]
        eng.run(reqs)
    else:
        raise ValueError(case)
    assert len(eng.free_pages) == eng.n_pages - 1
    assert all(r.finished and r.error is None for r in reqs)
    keep = np.arange(eng.kv.k_pages.shape[1]) % eng.n_pages != eng.n_pages - 1
    pools = [np.asarray(p)[:, keep] for p in (eng.kv.k_pages, eng.kv.v_pages)]
    return ([r.output_ids for r in reqs],
            (eng.steps, eng.prefill_chunks, np.asarray(eng.seq_lens).tolist()), pools)


def _run_jax(jp, case):
    with jax.default_matmul_precision("highest"):
        return _scenario(case, JaxEngine(jp, CFG, ecfgs()[0]), JaxRequest)


@pytest.mark.parametrize("case", ["budget", "session", "eos_mid_chain", "sampled", "two_slots"])
def test_runahead_matches_no_runahead_and_jax(weights, case):
    """Run-ahead and deferral are output-invisible: the port with run-ahead
    on and off and usdm_tpu (run-ahead on) emit the same tokens.  The port
    with run-ahead also runs usdm_tpu's schedule (the same decode links and
    prefill chunks) and leaves the same kv-written lengths, and every K/V
    row it wrote holds usdm_tpu's values there (within f32 rounding of the
    two packages' kernels; usdm_tpu's prefill also writes a page's padding
    rows, which the port sends to the trash page and nothing reads)."""
    jp, tp = weights
    want, want_state, want_pools = _run_jax(jp, case)
    for runahead in (True, False):
        eng = PagedEngine(tp, PCFG, ecfgs(runahead=runahead)[1], device="cpu")
        got, state, pools = _scenario(case, eng, Request)
        assert got == want
        assert eng._inflight is None and not eng._pending_first
        for a, b in zip(pools, want_pools):
            written = np.abs(a).sum(axis=(0, 3)) > 0  # [pages, rows]
            assert written.sum() > 0
            np.testing.assert_allclose(a[:, written], b[:, written], rtol=0, atol=1e-5)
        if runahead:
            assert state == want_state


def test_sampled_chain_same_with_and_without_runahead(weights, rng):
    """A truly sampled request (top-k 8, top-p 0.9): its seeded noise is
    drawn link by link in the same order with run-ahead on and off."""
    _, tp = weights
    allow = np.zeros(CFG.vocab_size, bool)
    allow[100:160] = True
    prompt = rng.integers(0, CFG.vocab_size, size=20).tolist()

    def run(runahead):
        eng = PagedEngine(tp, PCFG, ecfgs(runahead=runahead)[1], device="cpu")
        req = Request(0, prompt, allow, -1, 30, top_k=8, top_p=0.9, temperature=0.8, seed=3)
        eng.run([req])
        return req.output_ids, eng.runahead_chains

    (on, n_ahead), (off, n_off) = run(True), run(False)
    assert on == off and len(on) == 30 and all(allow[t] for t in on)
    assert n_ahead > 0 and n_off == 0


@pytest.mark.parametrize("horizon", [1, 4])
def test_per_token_and_short_chains_match_jax(weights, horizon):
    """decode_horizon 1 decodes through step() alone (a chain of one link
    from the host's state); 4 caps every chain at 4 links."""
    jp, tp = weights
    prompts = _prompts()
    allow = np.ones(CFG.vocab_size, bool)
    jc, pc = ecfgs(decode_horizon=horizon)
    with jax.default_matmul_precision("highest"):
        want = JaxEngine(jp, CFG, jc).run(
            [JaxRequest(i, p, allow, 2, 11) for i, p in enumerate(prompts)])
    got = PagedEngine(tp, PCFG, pc, device="cpu").run(
        [Request(i, p, allow, 2, 11) for i, p in enumerate(prompts)])
    assert [r.output_ids for r in got] == [r.output_ids for r in want]


def test_runahead_engages(weights, rng):
    """A quiet long decode runs ahead (a regression would silently fall
    back to synced chains), and stats() reports it with the phase times."""
    _, tp = weights
    eng = PagedEngine(tp, PCFG, ecfgs(max_batch_size=1)[1], device="cpu")
    eng.submit(Request(0, rng.integers(3, CFG.vocab_size, 10).tolist(),
                       np.ones(CFG.vocab_size, bool), 2, 40))
    seen_inflight = False
    while eng.busy:
        eng.tick()
        seen_inflight = seen_inflight or eng._inflight is not None
    eng.drain_inflight()
    st = eng.stats()
    assert seen_inflight and st["runahead_chains"] > 0
    assert st["graph_replays"] == 0  # CPU links are eager
    assert {"admit", "prefill", "chain_dispatch", "chain_sync", "absorb"} <= set(st["perf_s"])


def test_defer_first_gate(weights):
    """First-token deferral only in the quiet state of a chained engine
    (usdm_tpu's gate also refuses streaming and fused multi-step decode,
    which the port does not have)."""
    _, tp = weights
    eng = PagedEngine(tp, PCFG, ecfgs()[1], device="cpu")
    allow = np.ones(CFG.vocab_size, bool)
    plain = Request(0, [5, 6, 7], allow, eos_id=2)
    assert eng._defer_first_ok(plain)
    eng.waiting.append(plain)
    assert not eng._defer_first_ok(plain)
    eng.waiting.clear()
    eng.prefill_order.append(1)
    assert not eng._defer_first_ok(plain)
    eng.prefill_order.clear()
    eng.decode_horizon = 1
    assert not eng._defer_first_ok(plain)


def test_deferred_first_token_eos_finishes(weights, rng):
    """A deferred first token that is the EOS finishes its request with
    that one token (the device sets `done` at injection), as in usdm_tpu."""
    jp, tp = weights
    prompt = rng.integers(3, CFG.vocab_size, 12).tolist()
    allow = np.ones(CFG.vocab_size, bool)
    probe = Request(0, prompt, allow, 2, 3)
    PagedEngine(tp, PCFG, ecfgs()[1], device="cpu").run([probe])
    first = probe.output_ids[0]
    eng = PagedEngine(tp, PCFG, ecfgs()[1], device="cpu")
    eng.submit(Request(1, prompt, allow, first, 10))
    eng.tick()  # the prefill: the first token stays on the device
    assert list(eng._pending_first) == [0]
    req = eng.slot_req[0]
    eng.run([])
    assert req.finished and req.output_ids == [first] and req.ttft_s is not None
    assert len(eng.free_pages) == eng.n_pages - 1
    with jax.default_matmul_precision("highest"):
        jr = JaxEngine(jp, CFG, ecfgs()[0]).run([JaxRequest(1, prompt, allow, first, 10)])[0]
    assert jr.output_ids == req.output_ids


def test_arrival_flushes_deferred_first_token(weights, rng):
    """A first token deferred in the quiet state is learned as soon as a new
    request arrives (EngineServer hands arrivals over between ticks, so the
    gate could not see it), not after the newcomer's prefill chunks."""
    _, tp = weights
    allow = np.ones(CFG.vocab_size, bool)
    eng = PagedEngine(tp, PCFG, ecfgs(prefill_chunk=16)[1], device="cpu")
    seen = []
    record = eng._record_first
    eng._record_first = lambda slot, first: (seen.append(eng.prefill_chunks),
                                             record(slot, first))
    a = Request(0, rng.integers(3, CFG.vocab_size, 12).tolist(), allow, -1, 10)
    eng.submit(a)
    eng.tick()  # a's one prefill chunk; its first token stays on the device
    assert list(eng._pending_first) == [0] and not a.output_ids
    b = Request(1, rng.integers(3, CFG.vocab_size, 80).tolist(), allow, -1, 10)
    eng.submit(b)
    eng.tick()
    assert seen == [1] and len(a.output_ids) >= 1 and a.ttft_s is not None
    eng.run([])
    assert len(a.output_ids) == len(b.output_ids) == 10


def test_server_drains_on_idle(weights, rng):
    """EngineServer absorbs the run-ahead chain when its work drains: when
    generate() returns nothing is in flight, and stats()["steps"] equals
    that of an engine that ran the same request to the end."""
    _, tp = weights
    prompt = rng.integers(3, CFG.vocab_size, 10).tolist()
    allow = np.ones(CFG.vocab_size, bool)
    ref = PagedEngine(tp, PCFG, ecfgs(max_batch_size=1)[1], device="cpu")
    want = ref.run([Request(0, prompt, allow, -1, 40)])[0].output_ids
    eng = PagedEngine(tp, PCFG, ecfgs(max_batch_size=1)[1], device="cpu")
    server = EngineServer(eng)
    try:
        got = server.generate(prompt, allow, -1, 40, timeout=120)
        assert got == want
        assert eng._inflight is None
        assert eng.stats()["steps"] == ref.stats()["steps"]
        assert eng.stats()["runahead_chains"] > 0
    finally:
        server.close()
    assert not server._thread.is_alive()


def test_cancel_absorbs_inflight_chain(weights, rng):
    """Cancelling a request whose chain runs ahead absorbs that chain first:
    the tokens it emitted stay, and the pool is whole afterwards."""
    _, tp = weights
    eng = PagedEngine(tp, PCFG, ecfgs(max_batch_size=1)[1], device="cpu")
    req = Request(0, rng.integers(3, CFG.vocab_size, 10).tolist(),
                  np.ones(CFG.vocab_size, bool), -1, 60)
    eng.submit(req)
    while eng._inflight is None:
        eng.tick()
    n_before = len(req.output_ids)
    assert eng.cancel(0)
    assert eng._inflight is None and req.cancelled and req.finished
    assert len(req.output_ids) > n_before
    assert len(eng.free_pages) == eng.n_pages - 1 and not eng.busy


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 1000000.0), (64, 500.0)])
def test_rope_tables_cached_bit_equal(head_dim, theta):
    """rope_tables' cached inverse frequencies give the old per-call
    expression's tables bit for bit, and are made once per key."""
    pos = torch.arange(0, 4000, 7)[None]
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = pos[..., None].float() * torch.from_numpy(inv_freq.astype(np.float32))
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = M.rope_tables(pos, head_dim, theta)
    assert torch.equal(cos, torch.cos(emb)) and torch.equal(sin, torch.sin(emb))
    dev = torch.device("cpu")
    assert M._inv_freq(dev, head_dim, theta) is M._inv_freq(dev, head_dim, theta)


def test_concurrent_submits_keep_the_pool(weights):
    """Client threads submit while the loop thread runs chains ahead: every
    request finishes with its budget and the pool is whole afterwards."""
    import sys

    _, tp = weights
    eng = PagedEngine(tp, PCFG, ecfgs()[1], device="cpu")
    allow = np.ones(CFG.vocab_size, bool)
    outs, errors = {}, []
    prompts = _prompts()

    def client(i):
        try:
            outs[i] = [server.generate(prompts[(i + k) % 3], allow, -1, 9 + k, timeout=120)
                       for k in range(2)]
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    server = EngineServer(eng)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        server.close()
        sys.setswitchinterval(old)
    assert not errors
    assert all([len(o) for o in outs[i]] == [9, 10] for i in range(5))
    assert eng._inflight is None and len(eng.free_pages) == eng.n_pages - 1
