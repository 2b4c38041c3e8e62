"""usdm_tpu_torch paged engine against usdm_tpu's PagedEngine.

Same tiny Mistral weights (through the bridge), same requests: greedy
tokens must be identical, for a 3-request session with prefix reuse, a
multi-chunk prompt, stage masks and stop tokens.  JAX runs under
default_matmul_precision("highest") in f32, like the port.
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
from usdm_tpu_torch.engine import paged_ops
from usdm_tpu_torch.engine.paged import PagedEngine, Request, _ctx_pages_bucket, _mask_slice
from usdm_tpu_torch.engine.server import EngineServer



def port_cfg(jcfg):
    """The port's config of the same fields as a usdm_tpu config."""
    return getattr(C, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


CFG = MistralConfig.tiny()
ECFG = EngineConfig(max_batch_size=2, page_size=8, max_pages_per_seq=16, prefill_chunk=16,
                    decode_horizon=4)
PCFG, PECFG = port_cfg(CFG), port_cfg(ECFG)  # the same configs as the port's classes


@pytest.fixture(scope="module")
def weights():
    jp = JLM.init_params(CFG, jax.random.PRNGKey(7))
    return jp, bridge.mistral_from_jax(jax.device_get(jp))


def _session_requests(rng, mk):
    """Three requests of one session: each prompt extends the previous
    prompt, as the dialog's stage prompts do; the first spans 3 chunks."""
    v = CFG.vocab_size
    allow_text = np.ones(v, bool)
    allow_text[200:] = False  # an interval mask (sliced greedy tail)
    allow_units = np.zeros(v, bool)
    allow_units[250:290] = True
    allow_units[5] = True  # interval + isolated low column, like stage C
    base = rng.integers(0, 200, size=40).tolist()
    ext1 = base + rng.integers(0, 200, size=9).tolist()
    ext2 = ext1 + rng.integers(0, 200, size=21).tolist()
    return [mk(0, base, allow_text, 17, 12), mk(1, ext1, allow_text, 3, 10),
            mk(2, ext2, allow_units, 5, 14)]


def test_session_tokens_match_jax(weights, rng):
    jp, tp = weights
    mk_j = lambda i, p, m, e, n: JaxRequest(i, p, m, e, n, session=1)  # noqa: E731
    mk_t = lambda i, p, m, e, n: Request(i, p, m, e, n, session=1)  # noqa: E731
    reqs_j = _session_requests(np.random.default_rng(3), mk_j)
    reqs_t = _session_requests(np.random.default_rng(3), mk_t)
    with jax.default_matmul_precision("highest"):
        ej = JaxEngine(jp, CFG, ECFG)
        for r in reqs_j:  # one at a time, like the dialog's stages
            ej.run([r])
    et = PagedEngine(tp, PCFG, PECFG, device="cpu")
    for r in reqs_t:
        et.run([r])
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.error is None and rt.finished
        assert rt.output_ids == rj.output_ids
        assert len(rt.output_ids) > 1
    # prefix reuse happened: later prompts prefilled only their suffix
    assert et.prefill_chunks == ej.prefill_chunks
    assert et.prefill_chunks < sum(-(-len(r.prompt_ids) // ECFG.prefill_chunk) for r in reqs_t)
    et.release_session(1)
    assert len(et.free_pages) == et.n_pages - 1


def test_concurrent_requests_match_jax(weights, rng):
    """Two slots decoding at once, one request waiting for capacity."""
    jp, tp = weights
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in (9, 23, 30)]
    allow = np.ones(CFG.vocab_size, bool)
    with jax.default_matmul_precision("highest"):
        rj = JaxEngine(jp, CFG, ECFG).run(
            [JaxRequest(i, p, allow, 1, 9) for i, p in enumerate(prompts)])
    rt = PagedEngine(tp, PCFG, PECFG, device="cpu").run(
        [Request(i, p, allow, 1, 9) for i, p in enumerate(prompts)])
    assert [r.output_ids for r in rt] == [r.output_ids for r in rj]


def test_decode_step_writes_pool_in_place(weights):
    _, tp = weights
    kv = paged_ops.PagedKV.create(PCFG, 5, 8, "cpu")
    ptr = kv.k_pages.data_ptr()
    table = torch.tensor([[0, 1, 4, 4]], dtype=torch.int32)
    allow = torch.ones((1, CFG.vocab_size), dtype=torch.bool)
    paged_ops.paged_decode_step(tp, kv, PCFG, torch.tensor([3]), torch.tensor([9], dtype=torch.int32),
                                table, torch.tensor([True]), allow, 8)
    assert kv.k_pages.data_ptr() == ptr
    # token at position 9 -> page table[0, 1] = 1, row 1, every layer region
    for li in range(CFG.num_layers):
        assert kv.k_pages[:, li * 5 + 1, 1].abs().sum() > 0
    assert kv.k_pages[:, 1 * 5 + 0].abs().sum() == 0


def test_helpers_match_jax():
    from usdm_tpu.engine import paged as JP

    for mask in (np.ones(10, bool), np.r_[np.zeros(4, bool), np.ones(6, bool)],
                 np.r_[True, np.zeros(5, bool), np.ones(4, bool)],
                 np.r_[np.ones(3, bool), np.zeros(5, bool), True, False]):
        assert _mask_slice(mask) == JP._mask_slice(mask)
    for n in (1, 3, 8, 9, 200):
        assert _ctx_pages_bucket(n, 128) == JP._ctx_pages_bucket(n, 128)


@pytest.mark.parametrize("what", ["draft", "int8", "tp"])
def test_unported_options_raise(weights, what):
    """Tensor parallelism is ported (tests/test_torch_tp.py): the "tp" case
    refuses a mesh that is not engine/tp.py's, and one whose size does not
    divide the kv heads, by name.  int8 KV pools and speculation are
    ported: the "int8" case serves the concurrent requests with int8 pools
    and must give usdm_tpu's greedy tokens (an unknown kv_dtype raises); the
    "draft" case serves them on an ngram engine, which must give usdm_tpu's
    ngram engine's tokens and speculate."""
    jp, tp = weights
    if what == "draft":
        prompts = [np.random.default_rng(4).integers(0, CFG.vocab_size, size=n).tolist()
                   for n in (9, 23, 30)]
        allow = np.ones(CFG.vocab_size, bool)
        with jax.default_matmul_precision("highest"):
            rj = JaxEngine(jp, CFG, ECFG, draft="ngram").run(
                [JaxRequest(i, p, allow, 1, 9) for i, p in enumerate(prompts)])
        et = PagedEngine(tp, PCFG, PECFG, device="cpu", draft="ngram")
        rt = et.run([Request(i, p, allow, 1, 9) for i, p in enumerate(prompts)])
        assert [r.output_ids for r in rt] == [r.output_ids for r in rj]
        assert et.ngram and et.spec_rounds > 0
    elif what == "int8":
        ecfg = ECFG.replace(kv_dtype="int8")
        prompts = [np.random.default_rng(4).integers(0, CFG.vocab_size, size=n).tolist()
                   for n in (9, 23, 30)]
        allow = np.ones(CFG.vocab_size, bool)
        with jax.default_matmul_precision("highest"):
            rj = JaxEngine(jp, CFG, ecfg).run(
                [JaxRequest(i, p, allow, 1, 9) for i, p in enumerate(prompts)])
        et = PagedEngine(tp, PCFG, port_cfg(ecfg), device="cpu")
        assert et.kv.quantized and et.kv.k_pages.dtype == torch.int8
        rt = et.run([Request(i, p, allow, 1, 9) for i, p in enumerate(prompts)])
        assert [r.output_ids for r in rt] == [r.output_ids for r in rj]
        with pytest.raises(ValueError):
            PagedEngine(tp, PCFG, PECFG.replace(kv_dtype="fp8"), device="cpu")
    else:
        from usdm_tpu_torch.engine.tp import TPMesh

        with pytest.raises(TypeError, match="TPMesh"):
            PagedEngine(tp, PCFG, PECFG, device="cpu", mesh=object())
        with pytest.raises(ValueError, match="num_kv_heads"):
            PagedEngine(tp, PCFG, PECFG, mesh=TPMesh(None, None, 0, 4, torch.device("cpu")))


def test_server_failure_reaches_every_caller(weights):
    """A tick failure sets the error on every in-flight request and wakes
    every caller with it; later submissions fail fast."""
    _, tp = weights
    engine = PagedEngine(tp, PCFG, PECFG, device="cpu")

    def broken_tick():
        raise RuntimeError("device lost")

    engine.tick = broken_tick
    allow = np.ones(CFG.vocab_size, bool)
    errors = []

    def call():
        try:
            server.generate([1, 2, 3], allow, 1, 4, timeout=30)
        except RuntimeError as e:
            errors.append(str(e))

    server = EngineServer(engine)
    try:
        threads = [threading.Thread(target=call) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        assert len(errors) == 3 and all("device lost" in e for e in errors)
        with pytest.raises(RuntimeError, match="device lost"):
            server.generate([1], allow, 1, 2, timeout=5)
    finally:
        server.close()


def test_sampled_requests_are_seeded_and_masked(weights, rng):
    """top-k/top-p sampling through the chain: tokens stay inside the stage
    mask, and a request's seed fixes its tokens."""
    _, tp = weights
    allow = np.zeros(CFG.vocab_size, bool)
    allow[100:160] = True
    prompt = rng.integers(0, CFG.vocab_size, size=20).tolist()

    def run(seed):
        req = Request(0, prompt, allow, -1, 12, top_k=8, top_p=0.9, temperature=0.8,
                      seed=seed)
        PagedEngine(tp, PCFG, PECFG, device="cpu").run([req])
        return req.output_ids

    a, b, c = run(1), run(1), run(2)
    assert a == b and len(a) == 12
    assert a != c
    assert all(allow[t] for t in a + c)
