"""usdm_tpu_torch's tensor-parallel serving (engine/tp.py) against usdm_tpu's.

The port's ranks are processes over gloo: one spawn of two ranks and one of
four run every scenario (a `-c` script that imports torch and the port
alone), next to one process of the port's single-device engine over the
same scenarios.  usdm_tpu's TP engine runs here, on the 8 virtual CPU
devices of tests/conftest.py, under default_matmul_precision("highest").
The tiny models' weights come across through core/bridge.py.

Greedy tokens are held to usdm_tpu's TP engine on the same weights (float
and W8A8: each rank quantizes its own row slice of the activations in both
packages); sampled tokens to the port's own single-device engine, since
JAX's threefry draws are not torch's.
"""

import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import EngineConfig as JaxEngineConfig
from usdm_tpu.core.config import MistralConfig
from usdm_tpu.engine import tp as JTP
from usdm_tpu.engine.paged import PagedEngine as JaxEngine
from usdm_tpu.engine.paged import PagedKV as JaxKV
from usdm_tpu.engine.paged import Request as JaxRequest
from usdm_tpu.models import mistral as JLM
from usdm_tpu.models import quant as JQ
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.core import distributed as D
from usdm_tpu_torch.engine import tp as TP
from usdm_tpu_torch.engine.paged_ops import PagedKV
from usdm_tpu_torch.models.quant import is_quantized, out_dim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = MistralConfig.tiny(vocab_size=96)  # tests/test_paged.py's: 2 kv heads, tp <= 2
ODD = MistralConfig.tiny()  # vocab 291: no tp > 1 divides it
GQA = MistralConfig(vocab_size=96, hidden_size=256, intermediate_size=128, num_layers=2,
                    num_heads=16, num_kv_heads=4, head_dim=16, sliding_window=64,
                    max_seq_len=256, dtype="float32")  # tests/test_paged.py's tp=4 config
PAGED = dict(page_size=16, max_pages_per_seq=8)
SPEC = dict(PAGED, max_batch_size=2, prefill_chunk=16, spec_k=3)
W8A8 = dict(max_batch_size=2, page_size=8, max_pages_per_seq=16, prefill_chunk=16,
            decode_horizon=4)


def pcfg(cfg):
    return C.MistralConfig.from_dict(dataclasses.asdict(cfg))


def _models():
    """name -> (usdm_tpu's params, config).  The W8A8 model's lm_head is
    scaled up (peaked logits), as tests/test_torch_quant.py's, so no
    greedy argmax is decided within f32 rounding."""
    w8 = JLM.init_params(TINY, jax.random.PRNGKey(7))
    w8["lm_head"] = w8["lm_head"] * 8.0
    return {"f32": (JLM.init_params(TINY, jax.random.PRNGKey(0), dtype="float32"), TINY),
            "w8a8": (JQ.quantize_llm_params(w8), TINY),
            "odd": (JLM.init_params(ODD, jax.random.PRNGKey(3), dtype="float32"), ODD),
            "gqa": (JLM.init_params(GQA, jax.random.PRNGKey(7), dtype="float32"), GQA)}


def _req(prompt, vocab, eos, max_new, mask_eos=False, **kw) -> dict:
    allow = np.ones(vocab, bool)
    if mask_eos:
        allow[:3] = False  # EOS unreachable: the request runs its budget
    return dict(prompt_ids=[int(t) for t in prompt], allow_mask=allow.tolist(), eos_id=eos,
                max_new_tokens=max_new, **kw)


def _scenarios() -> dict:
    """name -> (model, EngineConfig fields, draft, mode, request fields):
    the counterparts of tests/test_paged.py's TP tests, W8A8 ones after
    tests/test_torch_quant.py's, the odd vocab and the serving loop."""
    r = np.random.default_rng(0)
    v = TINY.vocab_size
    basic = [_req(r.integers(3, v, size=7 + i), v, 1, 8, top_k=1 if i % 2 else 12,
                  temperature=1.1, seed=i) for i in range(3)]
    draft = [_req(r.integers(3, v, size=9 + i), v, 1, 9) for i in range(2)]
    ngram = [_req((list(r.integers(3, v, size=4)) * 4)[:13], v, 1, 9),
             _req(r.integers(3, v, size=9), v, 1, 9)]
    runahead = [_req(r.integers(3, v, size=9), v, 2, 24)]
    w8 = [_req(r.integers(3, v, size=n), v, 2, m, mask_eos=True)
          for n, m in ((9, 12), (23, 10), (37, 14))]
    odd = [_req(r.integers(3, ODD.vocab_size, size=7 + i), ODD.vocab_size, 1, 8,
                top_k=1 if i % 2 else 12, temperature=1.1, seed=i) for i in range(3)]
    serve = [_req(r.integers(3, v, size=11), v, 1, 10),
             _req(r.integers(3, v, size=8), v, 1, 10, top_k=12, temperature=1.1, seed=3),
             _req(r.integers(3, v, size=10), v, 1, 7), _req(r.integers(3, v, size=5), v, 1, 6),
             _req(r.integers(3, v, size=6), v, 1, 100, mask_eos=True)]
    gqa = [_req(r.integers(3, GQA.vocab_size, size=8 + 3 * i), GQA.vocab_size, 1, 8)
           for i in range(3)]
    return {
        "basic": ("f32", dict(PAGED, max_batch_size=4), None, "run", basic),
        "draft": ("f32", SPEC, "self", "run", draft),
        "ngram": ("f32", SPEC, "ngram", "run", ngram),
        "runahead": ("f32", dict(PAGED, max_batch_size=1, decode_horizon=8), None, "tick",
                     runahead),
        "w8a8": ("w8a8", W8A8, None, "run", w8),
        "w8a8_kv8": ("w8a8", dict(W8A8, kv_dtype="int8"), None, "run", w8),
        "odd": ("odd", dict(PAGED, max_batch_size=4), None, "run", odd),
        "server": ("f32", dict(PAGED, max_batch_size=4), None, "server", serve),
        "gqa": ("gqa", dict(SPEC, max_batch_size=3), "self", "run", gqa),
    }


# the scenarios each group runs: tp 4 needs the 4 kv heads of GQA
GROUPS = {1: ("basic", "odd", "server"),
          2: ("basic", "draft", "ngram", "runahead", "w8a8", "w8a8_kv8", "odd", "server"),
          4: ("gqa",)}

# One rank of a group (`world` 1: the port's single-device engine, mesh
# None).  Rank 0 writes every scenario's tokens and engine stats.
WORKER = r"""
import json, sys, threading
sys.modules["usdm_tpu"] = None  # the port alone
import numpy as np, torch
torch.set_num_threads(1)
from usdm_tpu_torch.core import distributed as D
from usdm_tpu_torch.core.config import EngineConfig, MistralConfig
from usdm_tpu_torch.engine import tp as TP
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.pipeline import serve_lm

rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
spec = json.load(open(f"{root}/scenarios.json"))
mesh = None
if world > 1:
    D.initialize(f"localhost:{port}", world, rank, "cpu")
    mesh = TP.make_tp_mesh(world, "cpu")
out = {"errors": {}}
if mesh is not None:
    for name, call in (("group_size", lambda: TP.make_tp_mesh(world + 1, "cpu")),
                       ("cuda", lambda: TP.make_tp_mesh(world, "cuda"))):
        try:
            call()
        except (ValueError, RuntimeError) as e:
            out["errors"][name] = f"{type(e).__name__}: {e}"

def requests(reqs):
    return [Request(i, **{**r, "allow_mask": np.asarray(r["allow_mask"])})
            for i, r in enumerate(reqs)]

def serve(params, cfg, ecfg, reqs):
    server = serve_lm(params, cfg, ecfg, world, None, "cpu")
    if server is None:  # a rank other than 0 followed rank 0's turns
        return None
    got = {}
    def call(i):
        r = dict(reqs[i])
        got[i] = server.generate(r.pop("prompt_ids"), np.asarray(r.pop("allow_mask")), **r)
    threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
    for t in threads: t.start()
    for t in threads: t.join()
    s = server.new_session()
    first = dict(reqs[2], session=s)
    got[2] = server.generate(first.pop("prompt_ids"), np.asarray(first.pop("allow_mask")), **first)
    follow = dict(reqs[3], session=s)
    prompt = reqs[2]["prompt_ids"] + got[2] + follow.pop("prompt_ids")
    got[3] = server.generate(prompt, np.asarray(follow.pop("allow_mask")), **follow)
    server.release_session(s)
    long = dict(reqs[4])
    stream = server.generate_stream(long.pop("prompt_ids"), np.asarray(long.pop("allow_mask")),
                                    **long)
    got[4] = next(stream)[:1]  # how many tokens the first yield holds is timing's
    stream.close()  # cancels the request
    got[5] = server.generate(prompt, np.asarray(reqs[3]["allow_mask"]), reqs[3]["eos_id"],
                             reqs[3]["max_new_tokens"])  # after the cancel: a fresh prefill
    server.close()
    return [got[i] for i in range(6)], server.engine

for name in spec["groups"][str(world)]:
    model, ecfg, draft, mode, reqs = spec["scenarios"][name]
    cfg = MistralConfig.from_dict(spec["models"][model])
    params = torch.load(f"{root}/{model}.pt")
    ecfg = EngineConfig(**ecfg)
    if mode == "server":
        res = serve(params, cfg, ecfg, reqs)
        if res is None:
            continue
        tokens, eng = res
        out[name] = {"tokens": tokens, "stats": eng.stats()}
        continue
    if mesh is not None:  # a mesh of its own: its collective counts are this engine's
        mesh = TP.make_tp_mesh(world, "cpu")
    eng = PagedEngine(params, cfg, ecfg, device="cpu", mesh=mesh,
                      draft=(params, cfg) if draft == "self" else draft)
    chains, inflight = [], False
    step_chain = eng.step_chain
    eng.step_chain = lambda n: (chains.append(n), step_chain(n))[1]
    rs = requests(reqs)
    if mode == "tick":
        for r in rs:
            eng.submit(r)
        while eng.busy:
            eng.tick()
            inflight = inflight or eng._inflight is not None
        eng.drain_inflight()
    else:
        eng.run(rs)
    out[name] = {"tokens": [r.output_ids for r in rs], "stats": eng.stats(),
                 "chains": len(chains), "inflight": inflight}
out["jax"] = "jax" in sys.modules
if rank == 0:
    json.dump(out, open(f"{root}/out{world}.json", "w"))
if mesh is not None:
    torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Spawned:
    """The processes of this file, all started at once: the groups of 1, 2
    and 4 ranks and the two cli.infer runs."""

    def __init__(self, root: str):
        self.root = root
        env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               "OMP_NUM_THREADS": "1"}
        self.procs, self.logs = {}, {}
        for world in GROUPS:
            port = str(_free_port())
            self.procs[world] = [self._start(world, r, [sys.executable, "-c", WORKER, str(r),
                                                        str(world), port, root], env)
                                 for r in range(world)]
        wav = os.path.join(root, "u.wav")
        from usdm_tpu_torch.audio.wav import write_wav

        write_wav(wav, (np.random.default_rng(0).standard_normal(16000) * 0.1)
                  .astype(np.float32), 16000)
        for tp in (1, 2):
            self.procs[f"cli{tp}"] = [self._start(f"cli{tp}", 0, [
                sys.executable, "-m", "usdm_tpu_torch.cli.infer", "--input_path", wav,
                "--output_path", os.path.join(root, f"cli{tp}.wav"), "--demo", "--device", "cpu",
                "--n_timesteps", "4", "--tp", str(tp)], env)]

    def _start(self, key, rank: int, argv, env):
        path = os.path.join(self.root, f"{key}r{rank}.log")
        self.logs.setdefault(key, []).append(path)
        with open(path, "w") as log:
            return subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)

    def wait(self, key, timeout: float = 240) -> str:
        """Rank 0's output once every process of `key` has exited 0."""
        deadline = time.monotonic() + timeout
        for p in self.procs[key]:
            p.wait(max(deadline - time.monotonic(), 1))
        texts = [open(path).read() for path in self.logs[key]]
        assert all(p.returncode == 0 for p in self.procs[key]), "\n".join(texts)[-4000:]
        return texts[0]

    def result(self, world: int) -> dict:
        self.wait(world)
        return json.load(open(os.path.join(self.root, f"out{world}.json")))

    def close(self):
        for ps in self.procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def spawned(models, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    for name, (jp, _) in models.items():
        torch.save(bridge.mistral_from_jax(jax.device_get(jp)), os.path.join(root, f"{name}.pt"))
    with open(os.path.join(root, "scenarios.json"), "w") as f:
        json.dump({"models": {k: dataclasses.asdict(c) for k, (_, c) in models.items()},
                   "scenarios": _scenarios(), "groups": GROUPS}, f)
    sp = _Spawned(root)
    yield sp
    sp.close()


def _jax_tokens(models, model: str, tp: int, names, ecfg: dict) -> dict:
    """usdm_tpu's TP engine over the greedy requests of `names` in one run
    (a greedy request's tokens do not depend on what shares its batch)
    -> {(scenario, index): tokens}."""
    jp, cfg = models[model]
    sc = _scenarios()
    keys, reqs = [], []
    for name in names:
        for i, r in enumerate(sc[name][4]):
            if r.get("top_k", 1) == 1:
                keys.append((name, i))
                reqs.append(JaxRequest(len(reqs), list(r["prompt_ids"]), np.asarray(r["allow_mask"]),
                                       eos_id=r["eos_id"], max_new_tokens=r["max_new_tokens"]))
    with jax.default_matmul_precision("highest"):
        JaxEngine(jp, cfg, JaxEngineConfig(**ecfg), mesh=JTP.make_tp_mesh(tp)).run(reqs)
    return {k: r.output_ids for k, r in zip(keys, reqs)}


@pytest.fixture(scope="module")
def jax_tp(models, spawned):
    """usdm_tpu's TP runs, started together in threads (XLA compiles them
    side by side) while the port's groups run -> name -> future of
    `_jax_tokens`' result."""
    runs = {"f32": ("f32", 2, ("basic", "draft", "ngram", "runahead"),
                    dict(PAGED, max_batch_size=4)),
            "gqa": ("gqa", 4, ("gqa",), dict(SPEC, max_batch_size=3)),
            **{name: ("w8a8", 2, (name,), _scenarios()[name][1])
               for name in ("w8a8", "w8a8_kv8")}}
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        yield {k: pool.submit(_jax_tokens, models, *args) for k, args in runs.items()}


@pytest.fixture(scope="module")
def jax_f32(jax_tp):
    return jax_tp["f32"].result()


@pytest.mark.parametrize("name", ["basic", "draft", "ngram", "runahead"])
def test_tp2_greedy_tokens_match_usdm_tpu_tp(spawned, jax_f32, name):
    """Gloo tp 2 (tests/test_paged.py:237, :271, :788, :1095): each greedy
    request's tokens are usdm_tpu's TP engine's."""
    got = spawned.result(2)[name]["tokens"]
    keys = [k for k in jax_f32 if k[0] == name]
    assert keys
    for key in keys:
        assert got[key[1]] == jax_f32[key], key


def test_tp2_engages_chains_speculation_and_runahead(spawned):
    """The TP engine took the chained path, ran speculative rounds with a
    draft model and with ngram proposals, and ran chains ahead."""
    out = spawned.result(2)
    assert out["basic"]["chains"] > 0
    assert out["draft"]["stats"]["spec_rounds"] > 0
    assert out["ngram"]["stats"]["spec_rounds"] > 0
    assert out["runahead"]["inflight"] and out["runahead"]["stats"]["runahead_chains"] > 0
    assert not out["jax"]


def test_tp2_sampled_tokens_match_port_tp1(spawned):
    """Sampled slots draw from the gathered logits with the slot's seeded
    generator on every rank: the port's single-device tokens."""
    two, one = spawned.result(2)["basic"], spawned.result(1)["basic"]
    assert two["tokens"] == one["tokens"]
    assert one["stats"]["tp"] is None and two["stats"]["tp"]["size"] == 2


@pytest.mark.parametrize("name", ["basic", "ngram", "runahead", "w8a8", "odd"])
def test_tp2_collective_counts(spawned, name):
    """Every decode link, round and prefill chunk runs eagerly under TP and
    makes one vocab gather and two all-reduces a layer; no graph."""
    st = spawned.result(2)[name]["stats"]
    tp = st["tp"]
    assert st["graph_replays"] == 0 and st["eager_links"] == st["steps"] - st["mixed_links"]
    assert st["mixed_links"] == 0
    assert tp["gathers"] == st["steps"] + st["prefill_chunks"]
    assert tp["all_reduces"] == 2 * TINY.num_layers * tp["gathers"]


def test_tp4_gqa_draft_matches_usdm_tpu_tp(jax_tp, spawned):
    """Gloo tp 4 at tests/test_paged.py:814's GQA 4:1 config (one kv head a
    rank) with a draft model: usdm_tpu's tp 4 tokens, speculation engaged."""
    want = jax_tp["gqa"].result()
    out = spawned.result(4)["gqa"]
    assert out["tokens"] == [want[("gqa", i)] for i in range(3)]
    assert out["stats"]["spec_rounds"] > 0 and out["stats"]["tp"]["size"] == 4


@pytest.mark.parametrize("name", ["w8a8", "w8a8_kv8"])
def test_tp2_w8a8_matches_usdm_tpu_tp(jax_tp, spawned, name):
    """W8A8 at tp 2, with float and int8 KV pools: usdm_tpu's W8A8 TP
    engine's tokens (each rank quantizes its slice of wo's and w_down's
    inputs against its own amax, in both packages)."""
    want = jax_tp[name].result()
    got = spawned.result(2)[name]["tokens"]
    assert got == [want[(name, i)] for i in range(3)]
    assert all(len(t) == r["max_new_tokens"] for t, r in zip(got, _scenarios()[name][4]))


def test_odd_vocab_served_at_tp2(models, spawned):
    """Vocab 291 at tp 2: usdm_tpu refuses the split; the port pads
    lm_head with a zero row and serves its single-device tokens."""
    jp, cfg = models["odd"]
    with pytest.raises(ValueError, match="vocab"):
        JTP.shard_params(jp, JTP.make_tp_mesh(2), cfg)
    two, one = spawned.result(2)["odd"], spawned.result(1)["odd"]
    assert two["tokens"] == one["tokens"]
    assert all(len(t) for t in two["tokens"])


def test_server_over_tp2_matches_tp1(spawned):
    """EngineServer over a tp 2 engine (rank 0 sends each turn, rank 1
    follows): concurrent greedy and sampled callers, a session follow-up
    that reuses its prefix, a stream closed after its first tokens (its
    request cancelled) and a request after it give the single-device
    server's tokens, and the pool comes back whole."""
    two, one = spawned.result(2)["server"], spawned.result(1)["server"]
    assert two["tokens"] == one["tokens"]
    assert two["stats"]["total_cancelled"] == 1
    assert two["stats"]["free_pages"] == one["stats"]["free_pages"] == 4 * 8
    assert two["stats"]["tp"]["gathers"] > 0


def test_group_refusals(spawned):
    """Inside a 2-rank gloo group: a mesh of another size and a cuda mesh
    on a host without 2 cards raise by name."""
    err = spawned.result(2)["errors"]
    assert "needs a 3-rank group" in err["group_size"]
    if not torch.cuda.is_available():
        assert "need 2 devices for tp=2" in err["cuda"]


def test_cli_infer_tp2_matches_tp1(spawned):
    """cli.infer --demo --device cpu --tp 2 (this process and one spawned
    worker over gloo, the tiny LM's odd vocab padded) prints the texts and
    units of --tp 1 and writes the same wav."""
    lines = {tp: [ln for ln in spawned.wait(f"cli{tp}").splitlines()
                  if ln.startswith(("user_text", "agent_text", "agent_units"))]
             for tp in (1, 2)}
    assert len(lines[1]) == 3 and lines[1] == lines[2]
    wavs = [open(os.path.join(spawned.root, f"cli{tp}.wav"), "rb").read() for tp in (1, 2)]
    assert wavs[0] == wavs[1]


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _jax_shard(x, device):
    return np.asarray(next(s.data for s in x.addressable_shards if s.device == device))


@pytest.mark.parametrize("model,tp,int8", [("f32", 2, False), ("w8a8", 2, True),
                                           ("gqa", 4, False), ("gqa", 4, True)])
def test_shard_params_matches_usdm_tpu(models, model, tp, int8):
    """Each rank's slices are the addressable shards of usdm_tpu's
    shard_params, float and W8A8 (a column split cuts q and s, a row split
    q alone)."""
    jp, cfg = models[model]
    if int8 and model == "gqa":
        jp = JQ.quantize_llm_params(jp)
    mesh = JTP.make_tp_mesh(tp)
    sharded = JTP.shard_params(jp, mesh, cfg)
    whole = bridge.mistral_from_jax(jax.device_get(jp))
    for rank, dev in enumerate(mesh.devices.tolist()):
        want = bridge.mistral_from_jax(jax.tree.map(lambda x: _jax_shard(x, dev), sharded))
        got = TP.shard_params(whole, pcfg(cfg), tp, rank)
        assert _tree_equal(got, want)
        assert out_dim(got["layers"][0]["wq"]) == cfg.num_heads * cfg.head_dim // tp
        assert is_quantized(got["layers"][0]["wo"]) == int8


@pytest.mark.parametrize("int8", [False, True])
def test_sharded_load_is_shard_params(models, tmp_path, int8):
    """load_mistral(shard=(tp, rank)) copies each rank's slices alone from
    the mapped safetensors: shard_params of the whole load (W8A8: the row
    split quantized whole, then cut), the odd vocab padded with a zero row;
    the engine takes such slices as they are."""
    from usdm_tpu_torch.core import checkpoint as ckpt

    jp, cfg = models["odd"]
    ckpt.save_mistral_hf(str(tmp_path), bridge.mistral_from_jax(jax.device_get(jp)), pcfg(cfg))
    full, lcfg = ckpt.load_mistral(str(tmp_path), dtype="float32", device="cpu", int8=int8)
    for rank in range(2):
        part, _ = ckpt.load_mistral(str(tmp_path), dtype="float32", device="cpu", int8=int8,
                                    shard=(2, rank))
        assert _tree_equal(part, TP.shard_params(full, lcfg, 2, rank))
        mesh = TP.TPMesh(None, None, rank, 2, torch.device("cpu"))
        assert TP.local_params(part, lcfg, mesh) is part
        assert _tree_equal(TP.local_params(full, lcfg, mesh), part)
    assert part["lm_head"].shape[0] == 146 and not part["lm_head"][-1].any()


@pytest.mark.parametrize("tp,int8", [(2, False), (2, True), (4, False), (4, True)])
def test_shard_kv_matches_usdm_tpu(tp, int8):
    """Each rank's pool is the addressable shard of usdm_tpu's shard_kv:
    pages split over kv heads, int8 scales [L*N, Hkv, P] on dim 1."""
    r = np.random.default_rng(tp)
    shape = (4, 2 * 5, 8, 16)  # [Hkv, L*N, P, hd]
    if int8:
        arrs = [r.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        arrs += [r.random((10, 4, 8)).astype(np.float32) for _ in range(2)]
    else:
        arrs = [r.standard_normal(shape).astype(np.float32) for _ in range(2)]
    mesh = JTP.make_tp_mesh(tp)
    sharded = JTP.shard_kv(JaxKV(*map(jax.numpy.asarray, arrs)), mesh)
    whole = PagedKV(*map(torch.from_numpy, arrs))
    for rank, dev in enumerate(mesh.devices.tolist()):
        got = TP.shard_kv(whole, tp, rank)
        for name in ("k_pages", "v_pages") + (("k_scales", "v_scales") if int8 else ()):
            assert np.array_equal(getattr(got, name).numpy(),
                                  _jax_shard(getattr(sharded, name), dev)), name
        assert got.k_pages.shape[0] == 4 // tp


def test_refusals_name_what_is_missing(models, tmp_path):
    """tp that does not divide the kv heads, tp beyond the host's cards,
    make_server(tp=2) and cli.infer --tp 2 without a group or cards: each
    raises by name; nothing falls back to one device."""
    jp, cfg = models["f32"]
    whole = bridge.mistral_from_jax(jax.device_get(jp))
    with pytest.raises(ValueError, match="num_kv_heads=2"):
        TP.shard_params(whole, pcfg(cfg), 4, 0)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {n + 1} devices for tp={n + 1}"):
        TP.make_tp_mesh(n + 1, "cuda")
    with pytest.raises(RuntimeError, match="initialized 2-rank"):
        TP.make_tp_mesh(2, "cpu")
    from usdm_tpu_torch.pipeline import serve_lm

    with pytest.raises(RuntimeError, match="initialized 2-rank"):
        serve_lm(whole, pcfg(cfg), C.EngineConfig(), tp=2, device="cpu")
    if n < 2:
        from usdm_tpu_torch.cli import infer

        with pytest.raises(ValueError, match="need 2 devices for tp=2"):
            infer.main(["--input_path", "u.wav", "--output_path", str(tmp_path / "o.wav"),
                        "--demo", "--tp", "2"])
    assert not torch.distributed.is_initialized()


def test_distributed_helpers_without_a_group():
    """core/distributed.py outside a group: one process, rank 0, primary;
    initialize_from_args forms no group for one process."""
    info = D.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1 and D.is_primary()

    class Args:
        coordinator, num_processes, process_id = None, 1, None

    D.initialize_from_args(Args, device="cpu")
    assert not torch.distributed.is_initialized()
