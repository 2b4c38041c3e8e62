"""The dense dialog path: usdm_tpu_torch against usdm_tpu at tiny width, f32.

decode_attention, sample_token, the dense KV-cache functions of the LM
(prefill, decode_step, prefill_extend), generate / generate_with_cache, the
dense DialogPolicy and respond(use_paged=False), each on the same seeded
inputs on both sides (JAX under default_matmul_precision("highest")), with
the tolerance stated at each assert; and the port's graphed-loop logic run
eagerly (the host reading `done` every 16 steps) against the step-by-step
loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import MistralConfig
from usdm_tpu.core.tokenizer import UsdmTokenizer as JaxTokenizer
from usdm_tpu.engine import dialog as JD
from usdm_tpu.engine import generate as JG
from usdm_tpu.models import mistral as JM
from usdm_tpu.ops import attention as JA
from usdm_tpu.ops import sampling as JS
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.core.config import EngineConfig
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine import dialog as D
from usdm_tpu_torch.engine import generate as G
from usdm_tpu_torch.engine.paged import PagedEngine
from usdm_tpu_torch.engine.server import EngineServer, PagedDialogPolicy
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.ops import attention as A
from usdm_tpu_torch.ops import sampling as S


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def port_cfg(jcfg):
    return getattr(C, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


@pytest.fixture(scope="module")
def lm():
    """usdm_tpu's tiny f32 LM over the 8-unit test tokenizer, and the port's
    copy of the same weights."""
    tok = JaxTokenizer.build_test(num_units=8)
    cfg = MistralConfig.tiny(vocab_size=tok.vocab_size)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), dtype="float32")
    return (tok, cfg, jp, UsdmTokenizer.build_test(num_units=8), port_cfg(cfg),
            bridge.mistral_from_jax(jax.device_get(jp)))


# ------------------------------------------------------------ decode_attention
@pytest.mark.parametrize("ring,window", [(False, None), (False, 5), (True, None), (True, 4)])
def test_decode_attention_matches(rng, ring, window):
    b, s, h, hkv, d = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    lens = np.asarray([9, 17 if ring else 3], np.int32)
    kv_pos = None
    if ring:  # the positions decode_step gives a ring cache: pos - (pos - slot) % S
        pos = lens - 1
        kv_pos = (pos[:, None] - (pos[:, None] - np.arange(s)[None]) % s).astype(np.int32)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                               sliding_window=window,
                               kv_positions=None if kv_pos is None else jnp.asarray(kv_pos))
    got = A.decode_attention(t(q), t(k), t(v), t(lens, torch.int64), sliding_window=window,
                             kv_positions=None if kv_pos is None else t(kv_pos, torch.int64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)  # f32


def test_decode_attention_bf16_scores_are_f32(rng):
    """bf16 operands on the CPU: f32 scores and softmax (the operands widened
    exactly), probabilities rounded to bf16 for the V product."""
    b, s, h, hkv, d = 1, 40, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    lens = torch.tensor([33])
    got = A.decode_attention(q, k, v, lens)
    qg = q.float().reshape(b, hkv, 2, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * d**-0.5
    scores[..., 33:] = A.NEG_INF
    probs = torch.softmax(scores, -1).bfloat16().float()
    want = torch.einsum("bhgs,bshd->bhgd", probs, v.float()).reshape(b, 1, h, d)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.bfloat16().float(), rtol=0, atol=1e-2)


# ---------------------------------------------------------------- sample_token
@pytest.mark.parametrize("top_k,top_p,temperature", [(1, 1.0, 1.0), (5, 1.0, 0.8),
                                                     (0, 0.9, 0.7), (8, 0.8, 1.3)])
def test_sample_token_with_jax_gumbel(rng, top_k, top_p, temperature):
    """jax.random.categorical is argmax(logits + gumbel(key)): fed that draw,
    the port picks the JAX token in every row."""
    logits = rng.standard_normal((6, 300)).astype(np.float32) * 3
    logits[:, 200:] = S.NEG_INF  # a stage mask
    picks = []
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = JS.sample_token(jnp.asarray(logits), key=key, top_k=top_k, top_p=top_p,
                               temperature=temperature)
        noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = S.sample_token(t(logits), t(noise), top_k, top_p, temperature)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        picks.append(got.numpy())
    assert top_k == 1 or len({tuple(p) for p in picks}) > 1  # the noise mattered


# --------------------------------------------------------- the LM's dense path
def _prompt(rng, cfg, b, t_pad, lens):
    ids = rng.integers(3, cfg.vocab_size, size=(b, t_pad)).astype(np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    return ids


def test_prefill_decode_extend_match(lm, rng):
    """prefill, three decode steps and a prefill_extend on both sides: logits
    within 1e-5 and every row's valid cache prefix within 1e-5 (f32)."""
    _, jcfg, jp, _, cfg, tp = lm
    b, t_pad, s = 2, 10, 40
    lens = np.asarray([10, 6], np.int32)
    ids = _prompt(rng, jcfg, b, t_pad, lens)
    jc = JM.KVCache.create(jcfg, b, s)
    tc = M.KVCache.create(cfg, b, s)

    def same(jlog, jcache, tlog, tcache):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
        jl = np.asarray(jcache.length)
        np.testing.assert_array_equal(tcache.length.numpy(), jl)
        for i, n in enumerate(jl):
            for jx, tx in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
                np.testing.assert_allclose(tx[:, i, :n].numpy(), np.asarray(jx)[:, i, :n],
                                           rtol=0, atol=1e-5)

    jlog, jc = JM.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(lens), jc, attn_impl="xla")
    tlog, tc = M.prefill(tp, cfg, t(ids, torch.int64), t(lens, torch.int64), tc)
    same(jlog, jc, tlog, tc)
    for step in range(3):
        tok = rng.integers(3, jcfg.vocab_size, size=b)
        jlog, jc = JM.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jc)
        tlog, tc = M.decode_step(tp, cfg, t(tok, torch.int64), tc)
        same(jlog, jc, tlog, tc)
    new_len = np.asarray([5, 9], np.int32)
    new = _prompt(rng, jcfg, b, 12, new_len)
    jlog, jc = JM.prefill_extend(jp, jcfg, jc, jnp.asarray(new), jnp.asarray(new_len),
                                 attn_impl="xla")
    tlog, tc = M.prefill_extend(tp, cfg, tc, t(new, torch.int64), t(new_len, torch.int64))
    same(jlog, jc, tlog, tc)


def test_prefill_extend_refuses_to_pass_the_cache(lm):
    _, _, _, _, cfg, tp = lm
    cache = M.KVCache.create(cfg, 1, 32)
    cache.length.fill_(24)
    with pytest.raises(ValueError, match="pass the cache"):
        M.prefill_extend(tp, cfg, cache, torch.zeros((1, 16), dtype=torch.int64),
                         torch.tensor([3]))


def _stage(tok, stage):
    return (S.stage_allow_mask(stage, tok.ts), S.stage_eos(stage, tok.ts))


def test_generate_matches_jax(lm):
    """Two ragged rows, each stopping at its own EOS or at max_new: the same
    tokens and lengths as usdm_tpu's while_loop."""
    jtok, jcfg, jp, tok, cfg, tp = lm
    a, b_ = tok.encode("hello there friend"), tok.encode("bye")
    ids = np.zeros((2, len(a)), np.int32)
    ids[0], ids[1, : len(b_)] = a, b_
    lens = np.asarray([len(a), len(b_)], np.int32)
    for stage in (S.STAGE_UNIT2TEXT, S.STAGE_TEXT2TEXT, S.STAGE_TEXT2UNIT):
        allow, eos = _stage(tok, stage)
        want_t, want_l = JG.generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(lens),
                                     jnp.asarray(allow), jnp.asarray(eos, jnp.int32),
                                     max_new_tokens=20, attn_impl="xla")
        got_t, got_l = G.generate(tp, cfg, t(ids, torch.int64), t(lens, torch.int64), t(allow),
                                  eos, max_new_tokens=20)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_generate_with_cache_matches_jax(lm):
    """A prefilled prefix, rolled back and extended by a suffix: tokens,
    lengths and the returned cache's valid prefix as usdm_tpu's."""
    jtok, jcfg, jp, tok, cfg, tp = lm
    ids = tok.encode("the quick brown fox jumps")
    allow, eos = _stage(tok, S.STAGE_TEXT2TEXT)
    s = 96
    jc = JM.KVCache.create(jcfg, 1, s)
    _, jc = JM.prefill(jp, jcfg, jnp.asarray([ids], jnp.int32), jnp.asarray([len(ids)]), jc,
                       attn_impl="xla")
    tc = M.KVCache.create(cfg, 1, s)
    _, tc = M.prefill(tp, cfg, torch.tensor([ids]), torch.tensor([len(ids)]), tc)
    common = len(ids) - 4
    suffix = tok.encode(" over the lazy dog")
    padded = np.zeros((1, 32), np.int32)
    padded[0, : len(suffix)] = suffix
    jc = JM.KVCache(jc.k, jc.v, jnp.asarray([common], jnp.int32))
    want_t, want_l, jc = JG.generate_with_cache(
        jp, jcfg, jc, jnp.asarray(padded), jnp.asarray([len(suffix)], jnp.int32),
        jnp.asarray(allow), jnp.asarray(eos, jnp.int32), max_new_tokens=24, attn_impl="xla")
    tc = M.KVCache(tc.k, tc.v, torch.tensor([common]))
    got_t, got_l, tc = G.generate_with_cache(tp, cfg, tc, t(padded, torch.int64),
                                             torch.tensor([len(suffix)]), t(allow), eos,
                                             max_new_tokens=24)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    n = int(np.asarray(jc.length)[0])
    assert int(tc.length[0]) == n
    np.testing.assert_allclose(tc.k[:, 0, :n].numpy(), np.asarray(jc.k)[:, 0, :n], atol=1e-5)
    np.testing.assert_allclose(tc.v[:, 0, :n].numpy(), np.asarray(jc.v)[:, 0, :n], atol=1e-5)


def test_ring_bounded_cache_matches_full(lm):
    """A window-6 model decodes 24 tokens on its ring cache (S = max(t, 7))
    exactly as on an oversized identity cache, and as usdm_tpu does."""
    jtok, jcfg, jp, tok, cfg, tp = lm
    jcfg, cfg = jcfg.replace(sliding_window=6), cfg.replace(sliding_window=6)
    ids = tok.encode("hello world test")
    allow, _ = _stage(tok, S.STAGE_TEXT2UNIT)
    args = (t([ids], torch.int64), torch.tensor([len(ids)]), t(allow), -1)
    ring = G.generate(tp, cfg, *args, max_new_tokens=24)
    full = G.generate(tp, cfg, *args, max_new_tokens=24, cache_len=len(ids) + 24)
    assert G.dense_cache_len(cfg, len(ids), 24) == max(len(ids), 7) < len(ids) + 24
    want_t, want_l = JG.generate(jp, jcfg, jnp.asarray([ids], jnp.int32),
                                 jnp.asarray([len(ids)]), jnp.asarray(allow),
                                 jnp.asarray(-1, jnp.int32), max_new_tokens=24,
                                 attn_impl="xla")
    for got_t, got_l in (ring, full):
        assert int(got_l[0]) == int(want_l[0]) == 24
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("max_new", [40, 23])
def test_loop_reading_done_every_16_steps(lm, max_new, monkeypatch):
    """The graphed loop's logic, run eagerly: reading `done` once every 16
    steps (steps after every row finished touch frozen rows only) gives the
    step-by-step loop's tokens, lengths and valid cache prefix, greedy and
    sampled (the same noise draws)."""
    _, _, _, tok, cfg, tp = lm
    a, b_ = tok.encode("hello there friend"), tok.encode("bye")
    ids = torch.zeros((2, len(a)), dtype=torch.int64)
    ids[0], ids[1, : len(b_)] = torch.tensor(a), torch.tensor(b_)
    lens = torch.tensor([len(a), len(b_)])
    for stage in (S.STAGE_UNIT2TEXT, S.STAGE_TEXT2UNIT):
        allow, eos = _stage(tok, stage)
        for top_k in (1, 4):
            runs = []
            for every in (16, 1):
                monkeypatch.setattr(G, "CHECK_EVERY", every)
                loop = G.DenseLoop(tp, cfg, M.KVCache.create(cfg, 2, 64))
                gen = torch.Generator().manual_seed(5)
                tokens, lengths = G.generate(tp, cfg, ids, lens, t(allow), eos,
                                             max_new_tokens=max_new, cache_len=64, loop=loop,
                                             top_k=top_k, temperature=1.5, generator=gen)
                runs.append((tokens, lengths, loop))
            (t16, l16, loop16), (t1, l1, loop1) = runs
            assert torch.equal(t16, t1) and torch.equal(l16, l1)
            assert torch.equal(loop16.cache.length, loop1.cache.length)
            for i, n in enumerate(loop1.cache.length.tolist()):
                assert torch.equal(loop16.cache.k[:, i, :n], loop1.cache.k[:, i, :n])
                assert torch.equal(loop16.cache.v[:, i, :n], loop1.cache.v[:, i, :n])
            # one read after the first token, then one a block of 16 steps
            assert loop1.syncs == min(loop1.steps + 1, max_new - 1)
            assert loop16.syncs == -(-loop16.steps // 16) + (loop16.steps < max_new - 1)
            assert loop16.steps >= loop1.steps and loop16.replays == 0


# ----------------------------------------------------------------- DialogPolicy
@pytest.mark.parametrize("reuse,cache_len", [(True, None), (False, None), (True, 256)])
def test_dialog_policy_matches_jax(lm, reuse, cache_len):
    """The dense policy with prefix reuse, without, and near capacity (a
    256-slot cache that stages B and C must grow): usdm_tpu's DialogResult."""
    jtok, jcfg, jp, tok, cfg, tp = lm
    units = list(range(12)) if cache_len else [1, 4, 2, 7]
    want = JD.DialogPolicy(jp, jcfg, jtok, max_new_tokens=12, reuse_prefix=reuse,
                           cache_len=cache_len).respond_to_units(units)
    policy = D.DialogPolicy(tp, cfg, tok, max_new_tokens=12, reuse_prefix=reuse,
                            cache_len=cache_len)
    got = policy.respond_to_units(units)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if cache_len:  # grew past its 256 slots, to a multiple of 512
        assert policy.cache_len > 256 and policy.cache_len % 512 == 0
    # a second turn on the same policy starts a fresh conversation
    assert dataclasses.asdict(policy.respond_to_units(units)) == dataclasses.asdict(want)


def test_dense_and_paged_policies_agree(lm, rng):
    """The port's dense and paged policies give the same greedy tokens."""
    _, _, _, tok, cfg, tp = lm
    units = rng.integers(0, 8, size=12).tolist()
    dense = D.DialogPolicy(tp, cfg, tok, max_new_tokens=12).respond_to_units(units)
    server = EngineServer(PagedEngine(tp, cfg, EngineConfig(
        page_size=32, max_pages_per_seq=32, max_batch_size=2, prefill_chunk=64), device="cpu"))
    try:
        paged = PagedDialogPolicy(server, tok, max_new_tokens=12).respond_to_units(units)
    finally:
        server.close()
    assert dataclasses.asdict(paged) == dataclasses.asdict(dense)


def test_respond_dense_matches_jax(tmp_path):
    """respond(use_paged=False) on usdm_tpu's tiny_random weights: the same
    DialogResult as usdm_tpu's, and as the port's paged turn."""
    from usdm_tpu.audio.wav import write_wav
    from usdm_tpu.pipeline import UsdmPipeline as JaxPipeline
    from usdm_tpu_torch.engine.synthesis import SpeechDecoder
    from usdm_tpu_torch.pipeline import UsdmPipeline

    user = str(tmp_path / "user.wav")
    write_wav(user, (np.random.default_rng(7).standard_normal(16000) * 0.1)
              .astype(np.float32), 16000)
    jpipe = JaxPipeline.tiny_random(seed=1)
    host, dec = jax.device_get, jpipe.decoder
    tpipe = UsdmPipeline(
        UsdmTokenizer.build_test(num_units=32), bridge.mistral_from_jax(host(jpipe.lm_params)),
        port_cfg(jpipe.lm_cfg), bridge.xlsr_from_jax(host(jpipe.xlsr_params)),
        port_cfg(jpipe.xlsr_cfg),
        SpeechDecoder(bridge.voicebox_from_jax(host(dec.voicebox_params)),
                      port_cfg(dec.voicebox_cfg), bridge.bigvgan_from_jax(host(dec.vocoder_params)),
                      port_cfg(dec.vocoder_cfg), port_cfg(dec.mel_cfg)),
        device="cpu", max_new_tokens=jpipe.max_new_tokens)
    try:
        want = jpipe.respond(user, use_paged=False, n_timesteps=2)
        got = tpipe.respond(user, use_paged=False, n_timesteps=2)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.agent_units
        assert dataclasses.asdict(tpipe.respond(user, n_timesteps=2)) == dataclasses.asdict(got)
        assert tpipe._dense_loops  # kept for the next dense turn
    finally:
        jpipe.close()
        tpipe.close()
    assert not tpipe._dense_loops
