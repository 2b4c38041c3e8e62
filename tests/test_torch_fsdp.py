"""usdm_tpu_torch's sharded LM training (FSDP over data, TP over model)
against usdm_tpu's, on the CPU.

One group of four gloo ranks (a `-c` script that imports torch and the port
alone, one thread each) runs every scenario: train/lm.py's step at dp 2 x tp
2 and on a (replica 2, data 1, model 2) mesh, three steps each, against
usdm_tpu's make_train_step on the same meshes of the 8 virtual devices of
tests/conftest.py; the offloaded sharded step against the resident one; the
distillation step at dp 2 x tp 2 against usdm_tpu's; the dense forward and
generate at tp 2 and tp 4 (tests/test_sharding.py's cases); the checkpoint
gathered by a sharded state and one written at one device, each restored at
dp 2 x tp 2.  The weights come across through core/bridge.py; usdm_tpu runs
under `highest` matmul precision and, where a step is compared, with its
trainers' bf16 cast of the masters replaced by an f32 one, so both sides
compute in f32 and the tolerances stated at each assert are f32's.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from usdm_tpu.core.config import MistralConfig, TrainConfig
from usdm_tpu.core.mesh import create_dcn_mesh, create_mesh
from usdm_tpu.data.collators import pack_collate
from usdm_tpu.engine.generate import generate as jgenerate
from usdm_tpu.models import mistral as JM
from usdm_tpu.train import distill as JD
from usdm_tpu.train import lm as JT
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import checkpoint as CK
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.core.tree import tree_leaves
from usdm_tpu_torch.train import lm as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tp 4 needs 4 kv heads (the port keeps a GQA group on one rank)
CFG = MistralConfig.tiny(vocab_size=128).replace(num_heads=8, num_kv_heads=4, head_dim=8,
                                                 sliding_window=8)
TC = TrainConfig(batch_size=4, max_steps=8, learning_rate=1e-3, ce_chunk=16)
STEPS = 3


def pcfg(c):
    return getattr(PC, type(c).__name__).from_dict(dataclasses.asdict(c))


def _rows() -> dict:
    """Four packed rows of 48 tokens; rows 0-1 (data block 0 at dp 2) have
    their first 30 labels masked, so the data ranks hold 2 x 17 and 2 x 47
    valid tokens."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(4):
        n = 14 + 6 * i
        rows.append([1] + rng.integers(3, 127, n).tolist() + [1]
                    + rng.integers(3, 127, 46 - n).tolist())
    b = pack_collate(rows, pad_id=127, bos_id=1)
    b["labels"][:2, :30] = -100
    return {k: np.asarray(v) for k, v in b.items()}


WORKER = r"""
import json, sys
sys.modules["usdm_tpu"] = None  # the port alone
import numpy as np, torch
torch.set_num_threads(1)
from usdm_tpu_torch.core import checkpoint as CK, distributed as D, mesh as MS
from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.engine.generate import generate
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train import distill as DI, lm as T

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
D.initialize(f"localhost:{port}", 4, rank, "cpu")
spec = json.load(open(f"{root}/spec.json"))
cfg, tc = MistralConfig.from_dict(spec["cfg"]), TrainConfig.from_dict(spec["tc"])
rows = {k: torch.from_numpy(v) for k, v in np.load(f"{root}/rows.npz").items()}
full = torch.load(f"{root}/params.pt")
out = {}

def gathered(state):
    return [sh.gather(t) for sh, t in zip(state.layout, T.tree_leaves(state.params))]

def train(mesh, host=False):
    init = T.init_offload_state if host else T.init_state
    state = init(cfg, tc, "cpu", params=full, mesh=mesh)
    step = T.make_train_step(cfg, tc, mesh)
    batch = MS.shard_batch(mesh, rows)
    metrics, counts = [], None
    for _ in range(spec["steps"]):
        before = dict(mesh.counts)
        m = step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), int(m["ntokens"])])
        counts = {k: v - before.get(k, 0) for k, v in mesh.counts.items()}
    return state, metrics, counts

mesh = MS.create_mesh(2, 2, "cpu")
state, out["dp2tp2"], out["dp2tp2_counts"] = train(mesh)
params = gathered(state)
off, m_off, _ = train(MS.create_mesh(2, 2, "cpu"), host=True)
out["offload_equal"] = m_off == out["dp2tp2"] and all(
    torch.equal(a, b) for a, b in zip(T.tree_leaves(off.params) + off.opt_state.m + off.opt_state.v,
                                      T.tree_leaves(state.params) + state.opt_state.m + state.opt_state.v))
# the mean of per-rank means: each data rank's own loss over its rows
local = MS.shard_batch(mesh, rows)
with torch.no_grad():
    own = M.loss_fn(full, cfg, local["input_ids"], local["labels"], local["segment_ids"],
                    local["positions"], ce_chunk=tc.ce_chunk)[0]
out["per_rank_mean"] = float(MS.all_reduce(own.clone(), mesh, ("data",)) / 2)
# checkpoints: the sharded state's gathered file, and one written at one device
CK.save_train_state(f"{root}/ck_dp2tp2", state, 3)
fresh = T.init_state(cfg, tc, "cpu", params=full, mesh=MS.create_mesh(2, 2, "cpu"))
CK.restore_train_state(f"{root}/ck_dp2tp2", fresh)
out["restore_own"] = all(torch.equal(a, b) for a, b in zip(
    T.tree_leaves(fresh.params) + fresh.opt_state.m + fresh.opt_state.v,
    T.tree_leaves(state.params) + state.opt_state.m + state.opt_state.v)) and fresh.step == 3
fresh = T.init_state(cfg, tc, "cpu", params=full, mesh=MS.create_mesh(2, 2, "cpu"))
CK.restore_train_state(f"{root}/ck_dp1", fresh)
saved = torch.load(f"{root}/ck_dp1/step_2/state.pt")
out["restore_dp1"] = fresh.step == 2 and fresh.opt_state.count == 2 and all(
    torch.equal(a, b) for a, b in zip(gathered(fresh), T.tree_leaves(saved["params"]))) and all(
    torch.equal(sh.gather(a), b) for sh, a, b in zip(fresh.layout, fresh.opt_state.m,
                                                     saved["opt_state"]["m"]))
dcn, out["dcn"], out["dcn_counts"] = train(MS.create_dcn_mesh(2, 1, 2, "cpu"))
dcn_params = gathered(dcn)

# distillation at dp 2 x tp 2: a 1-layer draft from the target's first layer
draft, cfg_d = DI.init_draft_from_target(full, cfg, 1)
dmesh = MS.create_mesh(2, 2, "cpu")
dstate = T.init_state(cfg_d, tc, "cpu", params=draft, mesh=dmesh)
dstep = DI.make_distill_step(cfg_d, cfg, tc, chunk=16, mesh=dmesh)
out["distill"] = []
for _ in range(2):
    m = dstep(dstate, full, MS.shard_batch(dmesh, rows))
    out["distill"].append([float(m["loss"]), float(m["agree"]), float(m["grad_norm"])])
dparams = [sh.gather(t) for sh, t in zip(dstate.layout, T.tree_leaves(dstate.params))]

# the dense forward and generate, params sharded over the mesh
ids = torch.from_numpy(np.asarray(spec["ids"]))
prompt = torch.from_numpy(np.asarray(spec["prompt"]))
for name, (dp, tp) in (("tp2", (2, 2)), ("tp4", (1, 4))):
    fm = MS.create_mesh(dp, tp, "cpu")
    local = T.shard_params(full, cfg, fm)
    with torch.no_grad():
        out[f"forward_{name}"] = M.forward(local, cfg, ids, mesh=fm).numpy().tolist()
    toks, lens = generate(local, cfg, prompt, torch.tensor([prompt.shape[1]]),
                          torch.ones(cfg.vocab_size, dtype=torch.bool), 2, max_new_tokens=8,
                          mesh=fm, eager=True)
    out[f"generate_{name}"] = [toks.tolist(), lens.tolist()]
if rank == 0:
    torch.save({"params": params, "dcn_params": dcn_params, "distill_params": dparams},
               f"{root}/final.pt")
    json.dump(out, open(f"{root}/out.json", "w"))
D.finish()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jp():
    return JM.init_params(CFG, jax.random.PRNGKey(0), dtype="float32")


@pytest.fixture(scope="module")
def spawned(jp, tmp_path_factory):
    """The four ranks, started before usdm_tpu's references compile -> the
    directory they write to, once all four have exited 0 (180 s each)."""
    root = str(tmp_path_factory.mktemp("fsdp"))
    full = bridge.mistral_from_jax(jax.device_get(jp))
    torch.save(full, os.path.join(root, "params.pt"))
    np.savez(os.path.join(root, "rows.npz"), **_rows())
    rng = np.random.default_rng(5)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump({"cfg": dataclasses.asdict(CFG), "tc": dataclasses.asdict(TC), "steps": STEPS,
                   "ids": rng.integers(0, CFG.vocab_size, (2, 16)).tolist(),
                   "prompt": rng.integers(3, CFG.vocab_size, (1, 12)).tolist()}, f)
    # a checkpoint written at one device (two steps), for the dp 2 x tp 2 restore
    state = T.init_state(pcfg(CFG), pcfg(TC), "cpu", params=full)
    step = T.make_train_step(pcfg(CFG), pcfg(TC))
    for _ in range(2):
        step(state, {k: torch.from_numpy(v) for k, v in _rows().items()})
    CK.save_train_state(os.path.join(root, "ck_dp1"), state, 2)
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    logs = [open(os.path.join(root, f"r{r}.log"), "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port, root], cwd=REPO,
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]

    def wait():
        deadline = time.monotonic() + 180
        try:
            for p in procs:
                p.wait(max(deadline - time.monotonic(), 1))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = [open(os.path.join(root, f"r{r}.log")).read() for r in range(4)]
        assert all(p.returncode == 0 for p in procs), "\n".join(texts)[-4000:]
        return root

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def result(spawned):
    root = spawned()
    with open(os.path.join(root, "out.json")) as f:
        out = json.load(f)
    return out, torch.load(os.path.join(root, "final.pt"))


def _f32_trainer_cast():
    """usdm_tpu's trainers cast f32 masters to jnp.bfloat16; this module
    namespace maps that name to float32 for the f32 comparison."""
    names = {k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")}
    return types.SimpleNamespace(**{**names, "bfloat16": jnp.float32})


def _jax_steps(jp, mesh, n=STEPS):
    """usdm_tpu's make_train_step on `mesh`, f32 compute -> (metrics per
    step, final params in the port's layout)."""
    rows = _rows()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(JT, "jnp", _f32_trainer_cast())
        state, sh = JT.init_state(CFG, TC, mesh, jax.random.PRNGKey(0))
        # from host copies: the step donates its state
        state = JT.TrainState(jax.device_put(jax.device_get(jp), sh.params), state.opt_state,
                              state.step)
        bspec = JT.batch_spec(mesh)
        batch = {k: jax.device_put(v, NamedSharding(mesh, bspec[k])) for k, v in rows.items()}
        step = JT.make_train_step(CFG, TC, mesh, attn_impl="xla")
        out = []
        for _ in range(n):
            state, m = step(state, batch)
            out.append([float(m["loss"]), float(m["grad_norm"]), int(m["ntokens"])])
    return out, tree_leaves(bridge.mistral_from_jax(jax.device_get(state.params)))


@pytest.fixture(scope="module")
def jax_dp2tp2(jp, spawned):
    return _jax_steps(jp, create_mesh(dp=2, tp=2, devices=jax.devices()[:4]))


def _close_steps(got, want):
    """Loss within 2e-6 + 1e-6 rel, grad norm within 1e-5 rel, the same
    global token count (f32 on both sides, other summation orders)."""
    for (gl, gn, gt), (wl, wn, wt) in zip(got, want, strict=True):
        assert abs(gl - wl) <= 2e-6 + 1e-6 * abs(wl), (gl, wl)
        assert abs(gn / wn - 1) <= 1e-5, (gn, wn)
        assert gt == wt


def _close_params(got, want):
    """After three AdamW steps at lr 1e-3: every master within lr / 10 (an
    update divides by sqrt(v), so a gradient near zero passes its last-bit
    differences on), 99.9 % of them within 1e-6."""
    diffs = np.concatenate([(g - w).abs().flatten().numpy()
                            for g, w in zip(got, want, strict=True)])
    assert diffs.max() <= 1e-4
    assert np.quantile(diffs, 0.999) <= 1e-6


def test_dp2_tp2_steps_match_usdm_tpu(result, jax_dp2tp2):
    out, final = result
    want, want_params = jax_dp2tp2
    _close_steps(out["dp2tp2"], want)
    _close_params(final["params"], want_params)


def test_dcn_two_slices_match_usdm_tpu(jp, result):
    out, final = result
    want, want_params = _jax_steps(jp, create_dcn_mesh(num_slices=2, dp=1, tp=2,
                                                       devices=jax.devices()[:4]))
    _close_steps(out["dcn"], want)
    _close_params(final["dcn_params"], want_params)


def test_per_rank_mean_fails_the_loss_check(result, jax_dp2tp2):
    """Negative control: the data ranks hold 34 and 94 valid tokens, so the
    mean of the per-rank means is not usdm_tpu's loss (the check above
    would reject it), while the port's global loss passes."""
    out, _ = result
    want = jax_dp2tp2[0][0][0]
    assert abs(out["dp2tp2"][0][0] - want) <= 2e-6 + 1e-6 * abs(want)
    assert abs(out["per_rank_mean"] - want) > 100 * (2e-6 + 1e-6 * abs(want))


def test_offloaded_sharded_step_equals_resident(result):
    assert result[0]["offload_equal"]


def test_collective_counts_per_step(result):
    """One step's collectives, by axis, as train/lm.py step_collectives
    states them (remat on, three CE chunks of 16 over 47 positions)."""
    out, _ = result
    t = _rows()["input_ids"].shape[1]
    assert out["dp2tp2_counts"] == T.step_collectives(pcfg(CFG), pcfg(TC), t)
    assert out["dcn_counts"] == T.step_collectives(pcfg(CFG), pcfg(TC), t,
                                                   ("replica", "data", "model"))


def test_checkpoints_restore_across_layouts(result):
    """A dp 2 x tp 2 state's checkpoint restores into another such state
    bit for bit, and a one-device checkpoint restores at dp 2 x tp 2 to its
    file's leaves (masters and moments, gathered)."""
    out, _ = result
    assert out["restore_own"] and out["restore_dp1"]


def test_distill_dp2_tp2_matches_usdm_tpu(jp, result):
    """Two distillation steps: loss within 2e-3 rel and grad norm within
    2e-2 rel (the draft computes from bf16-rounded weights on both sides),
    agreement within one position of the 4 x 47 - 4 x 30 labelled ones; the
    draft's masters within 2 lr (a bf16 gradient-sign flip) after."""
    out, final = result
    tc = TC
    mesh = create_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        draft, cfg_d = JD.init_draft_from_target(jp, CFG, 1)
        opt = JT.make_optimizer(tc)
        state, sh = JT.init_state(cfg_d, tc, mesh, jax.random.PRNGKey(0), opt)
        state = JT.TrainState(jax.device_put(draft, sh.params), state.opt_state, state.step)
        step = JD.make_distill_step(cfg_d, CFG, tc, mesh, opt, chunk=16, attn_impl="xla")
        bspec = JT.batch_spec()
        batch = {k: jax.device_put(v, NamedSharding(mesh, bspec[k])) for k, v in _rows().items()}
        for got in out["distill"]:
            state, m = step(state, jp, batch)
            assert abs(got[0] / float(m["loss"]) - 1) <= 2e-3
            assert abs(got[1] - float(m["agree"])) <= 1.0 / 68 + 1e-7
            assert abs(got[2] / float(m["grad_norm"]) - 1) <= 2e-2
    want = tree_leaves(bridge.mistral_from_jax(jax.device_get(state.params)))
    for g, w in zip(final["distill_params"], want, strict=True):
        assert float((g - w).abs().max()) <= 2 * tc.learning_rate


def test_dense_forward_and_generate_at_tp2_and_tp4(jp, result):
    """tests/test_sharding.py's cases: the forward with sharded params at
    tp 2 (dp 2) and tp 4 within 2e-4 of usdm_tpu's unsharded forward, and
    greedy generate's tokens equal to its unsharded generate."""
    out, _ = result
    rng = np.random.default_rng(5)
    ids = rng.integers(0, CFG.vocab_size, (2, 16))
    prompt = rng.integers(3, CFG.vocab_size, (1, 12)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JM.forward(jp, CFG, jnp.asarray(ids), attn_impl="xla"))
        toks, lens = jgenerate(jp, CFG, jnp.asarray(prompt), jnp.asarray([12], jnp.int32),
                               jnp.ones(CFG.vocab_size, bool), jnp.asarray(2, jnp.int32),
                               max_new_tokens=8, attn_impl="xla")
    for name in ("tp2", "tp4"):
        np.testing.assert_allclose(np.asarray(out[f"forward_{name}"]), ref, rtol=2e-4,
                                   atol=2e-4)
        got_toks, got_lens = out[f"generate_{name}"]
        assert got_lens == [int(lens[0])]
        assert got_toks == np.asarray(toks).tolist()
