"""The LM training slice of usdm_tpu_torch against usdm_tpu, on the CPU.

The collators, forward_hidden and loss_fn (packed segments, a window that
bites, chunked and unchunked CE; f32 and bf16 compute; LoRA) with every
gradient, the optimizer and its schedule, whole train steps, the offload
step, memory_budget, LoRA and the train-state checkpoints are held to their
usdm_tpu counterparts on the same inputs (numpy generators; the same weights
through usdm_tpu_torch.core.bridge).  JAX runs under `highest` matmul
precision.  Two faults of usdm_tpu are shown beside the port's behaviour
(ROADMAP, known faults R1 and R2).  Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from usdm_tpu.core import checkpoint as JCK
from usdm_tpu.core.config import MistralConfig, TrainConfig
from usdm_tpu.core.mesh import create_mesh
from usdm_tpu.data import collators as JCOL
from usdm_tpu.models import mistral as JM
from usdm_tpu.train import lm as JT
from usdm_tpu.train import lora as JLO
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import checkpoint as CK
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.core.tree import tree_leaves, tree_map
from usdm_tpu_torch.data import collators as COL
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train import lm as T
from usdm_tpu_torch.train import lora as LO

# a window of 8 inside 20-token segments: the window masks keys in every segment
CFG = MistralConfig.tiny(vocab_size=128).replace(sliding_window=8)
BF16 = CFG.replace(dtype="bfloat16")


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


def port_cfg(jcfg):
    return getattr(PC, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def rows(rng, b=2, t=48):
    """Packed rows of three BOS-led segments (the last row shorter: padding)."""
    out = []
    for i in range(b):
        n = t - 5 * i
        cuts = sorted(rng.choice(np.arange(4, n - 4), 2, replace=False))
        ids = rng.integers(3, CFG.vocab_size, size=n)
        ids[[0, *cuts]] = 1
        out.append(ids.tolist())
    return out


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_params(jp):
    params = bridge.mistral_from_jax(jax.device_get(jp))
    return tree_map(lambda a: a.requires_grad_(True), params)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def cast_bf16(tree):
    """usdm_tpu's trainers' compute cast: >= 2-D f32 leaves to bf16."""
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, tree)


@pytest.fixture(scope="module")
def jp():
    return JM.init_params(CFG, jax.random.PRNGKey(0), dtype="float32")


def test_collators_exact(rng):
    """pack_collate and sft_collate equal usdm_tpu's array for array (a
    first row without a leading BOS, pad_to, ragged SFT rows)."""
    batch = rows(rng, b=3) + [[5, 6, 1, 7, 8]]
    for pad_to in (None, 64):
        got = COL.pack_collate(batch, pad_id=127, pad_to=pad_to)
        want = JCOL.pack_collate(batch, pad_id=127, pad_to=pad_to)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    sft = [(r, [-100] * 4 + r[4:]) for r in batch]
    got, want = COL.sft_collate(sft, pad_id=127), JCOL.sft_collate(sft, pad_id=127)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["segment_ids"][3, 5:] == -1).all() and got["positions"][0, 1] == 1


def _jax_loss(jp, jcfg, batch, ce_chunk, compute_bf16=False, lora=None):
    def f(p, lw):
        p = cast_bf16(p) if compute_bf16 else p
        lw = None if lw is None else jax.tree.map(lambda a: a.astype(jnp.bfloat16), lw) \
            if compute_bf16 else lw
        return JM.loss_fn(p, jcfg, batch["input_ids"], batch["labels"], batch["segment_ids"],
                          batch["positions"], attn_impl="xla", remat=True, lora=lw,
                          ce_chunk=ce_chunk)[0]

    if lora is None:
        loss, g = jax.value_and_grad(f)(jp, None)
        return float(loss), bridge.mistral_from_jax(jax.device_get(g))
    loss, g = jax.value_and_grad(f, argnums=1)(jp, lora)
    return float(loss), bridge.lora_from_jax(jax.device_get(g))


def _port_loss(params, cfg, batch, ce_chunk, lora=None, attn_impl="auto"):
    loss, aux = M.loss_fn(params, cfg, batch["input_ids"], batch["labels"],
                          batch["segment_ids"], batch["positions"], attn_impl=attn_impl,
                          remat=True, lora=lora, ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, tree_leaves(lora if lora is not None else params))
    return float(loss.detach()), [g.float().numpy() for g in grads], int(aux["ntokens"])


@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_loss_and_grads_f32_match_jax(jp, rng, ce_chunk):
    """f32 everywhere on both sides, packed segments and a window that
    bites, remat on; chunked (16: 3 chunks of 47 positions) and unchunked
    CE: the loss within 1e-5 and every gradient within 1e-5 + 1e-4 rel
    (f32, other summation orders); chunked equals unchunked within 1e-6."""
    b = COL.pack_collate(rows(rng), pad_id=127)
    want_loss, want_g = _jax_loss(jp, CFG, jbatch(b), ce_chunk)
    got_loss, got_g, ntok = _port_loss(port_params(jp), port_cfg(CFG), tbatch(b), ce_chunk)
    assert ntok == int((b["labels"][:, 1:] != -100).sum())
    assert abs(got_loss - want_loss) < 1e-5
    for g, w in zip(got_g, tree_leaves(want_g)):
        close(g, w.numpy(), rtol=1e-4, atol=1e-5)
    other, _, _ = _port_loss(port_params(jp), port_cfg(CFG), tbatch(b), 16 - ce_chunk)
    assert abs(other - got_loss) < 1e-6


def test_flash_route_trains_like_plain(jp, rng):
    """The training path's attention through flash_attention's autograd
    Function (K2/K5 on the card; on the CPU its plain forward and plain
    backward) gives the loss and gradients of autograd through the plain
    attention: f32, GQA 4/2, packed segments, the window; within 1e-5 +
    1e-4 rel."""
    b = tbatch(COL.pack_collate(rows(rng), pad_id=127))
    params, cfg = port_params(jp), port_cfg(CFG)
    plain_loss, plain_g, _ = _port_loss(params, cfg, b, 16, attn_impl="plain")
    flash_loss, flash_g, _ = _port_loss(params, cfg, b, 16, attn_impl="flash")
    assert abs(flash_loss - plain_loss) < 1e-5
    for g, w in zip(flash_g, plain_g):
        close(g, w, rtol=1e-4, atol=1e-5)


def test_loss_and_grads_bf16_match_jax(jp, rng):
    """bf16 compute over f32 masters (cfg.dtype bfloat16), usdm_tpu given the
    bf16-cast base as its trainers cast it: the loss within 1e-3 (bf16
    products, ~2^-8 relative each, through 2 layers; 8e-5 seen) and each
    gradient within 2e-2 of its largest element plus 2e-2 rel (1.1e-2 seen),
    taken against the masters on both sides."""
    b = COL.pack_collate(rows(rng), pad_id=127)
    want_loss, want_g = _jax_loss(jp, BF16, jbatch(b), 16, compute_bf16=True)
    got_loss, got_g, _ = _port_loss(port_params(jp), port_cfg(BF16), tbatch(b), 16)
    assert abs(got_loss - want_loss) < 1e-3
    for g, w in zip(got_g, tree_leaves(want_g)):
        w = w.numpy()
        close(g, w, rtol=2e-2, atol=2e-2 * np.abs(w).max())


def _lora(seed=1, r=4, alpha=8):
    """usdm_tpu adapters with B nonzero (so every gradient is)."""
    lw = JLO.init_lora(CFG, jax.random.PRNGKey(seed), r=r, alpha=alpha)
    return jax.tree.map(lambda a: a + 0.01, lw)


def test_lora_loss_and_grads_bf16_match_jax(jp, rng):
    """LoRA at bf16 compute, against usdm_tpu with its adapters cast to bf16
    (the form that traces, R2): the loss within 1e-3 (1e-4 seen), the
    adapters' gradients within 4e-2 of their largest element plus 4e-2 rel
    (the rank-4 products round in bf16 twice more than the base's)."""
    b = COL.pack_collate(rows(rng), pad_id=127)
    lw = _lora()
    want_loss, want_g = _jax_loss(jp, BF16, jbatch(b), 16, compute_bf16=True, lora=lw)
    lora = tree_map(lambda a: a.requires_grad_(True), bridge.lora_from_jax(jax.device_get(lw)))
    base = bridge.mistral_from_jax(jax.device_get(jp))
    got_loss, got_g, _ = _port_loss(base, port_cfg(BF16), tbatch(b), 16, lora=lora)
    assert abs(got_loss - want_loss) < 1e-3
    for g, w in zip(got_g, tree_leaves(want_g)):
        w = w.numpy()
        close(g, w, rtol=4e-2, atol=4e-2 * np.abs(w).max())


def test_r2_jax_lora_bf16_does_not_trace_port_trains(jp, rng):
    """R2: usdm_tpu's LoRA with its default f32 adapters over a bf16 config
    fails to trace (the scan carry turns f32); the port casts the adapters
    at use and trains: finite loss, the adapters move, the base does not."""
    b = COL.pack_collate(rows(rng), pad_id=127)
    lw = JLO.init_lora(CFG, jax.random.PRNGKey(1), r=4, alpha=8)

    def f(lora):
        return JM.loss_fn(cast_bf16(jp), BF16, *(jnp.asarray(b[k]) for k in (
            "input_ids", "labels", "segment_ids", "positions")), attn_impl="xla", lora=lora)[0]

    with pytest.raises(TypeError, match="carry"):
        jax.value_and_grad(f)(lw)
    base = bridge.mistral_from_jax(jax.device_get(jp))
    before = [a.clone() for a in tree_leaves(base)]
    lora = LO.init_lora(port_cfg(BF16), torch.Generator().manual_seed(1), r=4, alpha=8)
    a0 = [a.detach().clone() for a in tree_leaves(lora)]
    step, opt = LO.make_lora_train_step(port_cfg(BF16), PC.TrainConfig(learning_rate=1e-3,
                                                                      max_steps=4))
    state = T.TrainState(lora, opt.init(lora), 0)
    losses = [float(step(base, state, tbatch(b))["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all()
    assert all(x.dtype == torch.float32 for x in tree_leaves(lora))
    assert max((x.detach() - y).abs().max() for x, y in zip(tree_leaves(lora), a0)) > 0
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(base), before))


def test_r1_checkpoint_trainer_computes_bf16(jp, tmp_path, rng):
    """R1: from a checkpoint, usdm_tpu's trainers load f32 and their config
    says f32, so forward_hidden returns f32 although the base is bf16-cast;
    the port's trainers keep f32 masters and compute in bf16."""
    path = str(tmp_path / "hf")
    CK.save_mistral_hf(path, bridge.mistral_from_jax(jax.device_get(jp)), port_cfg(CFG))
    jbase, jcfg = JCK.load_mistral(path, dtype="float32")
    ids = jnp.asarray(COL.pack_collate(rows(rng), pad_id=127)["input_ids"])
    assert jcfg.dtype == "float32"
    assert JM.forward_hidden(cast_bf16(jbase), jcfg, ids, attn_impl="xla").dtype == jnp.float32
    base, cfg = T.load_masters(path, "cpu")
    assert cfg.dtype == T.COMPUTE_DTYPE == "bfloat16"
    assert all(a.dtype == torch.float32 for a in tree_leaves(base))
    assert M.forward_hidden(base, cfg, torch.from_numpy(np.array(ids))).dtype == torch.bfloat16


def test_extend_embeddings_layout_matches_jax(jp):
    """usdm_tpu's new rows injected into the port's extend_embeddings give
    usdm_tpu's extended params exactly (lm_head transposed); drawn rows
    have the requested std."""
    ext = JM.extend_embeddings(jp, CFG, 150, jax.random.PRNGKey(3))
    e = np.asarray(ext["embed"])[128:]
    h = np.asarray(ext["lm_head"])[:, 128:].T
    got = M.extend_embeddings(bridge.mistral_from_jax(jax.device_get(jp)), port_cfg(CFG), 150,
                              new_rows=(torch.from_numpy(e), torch.from_numpy(h.copy())))
    want = bridge.mistral_from_jax(jax.device_get(ext))
    for k in ("embed", "lm_head"):
        assert torch.equal(got[k], want[k])
    big = M.extend_embeddings(got, port_cfg(CFG), 150 + 4000, torch.Generator().manual_seed(0))
    assert abs(float(big["embed"][150:].std()) - CFG.initializer_range) < 1e-3


def test_schedule_matches_optax():
    """lr_schedule at every count of a run equals optax's schedule as
    usdm_tpu's make_optimizer builds it (cosine with warmup; linear), within
    1e-6 rel (optax in f32); and the lr a ClipAdamW step applies is the
    schedule at the count before the increment (step 1: 0)."""
    for sched_name, total in (("cosine", 40), ("cosine", 3), ("linear", 40)):
        tc = TrainConfig(max_steps=total, learning_rate=3e-3, lr_schedule=sched_name)
        warmup = max(int(total * tc.warmup_ratio), 1)
        want = (optax.warmup_cosine_decay_schedule(0.0, tc.learning_rate, warmup,
                                                   max(total, warmup + 1))
                if sched_name == "cosine" else
                optax.linear_schedule(tc.learning_rate, 0.0, max(total - warmup, 1), warmup))
        got = T.lr_schedule(port_cfg(tc))
        for c in range(total + 3):
            assert abs(got(c) - float(want(c))) <= 1e-6 * tc.learning_rate, (sched_name, c)
    tc = PC.TrainConfig(max_steps=10, learning_rate=3e-3, weight_decay=1.0)
    opt = T.make_optimizer(tc)
    p = torch.ones(4, requires_grad=True)
    st = opt.init(p)
    for c in range(10):  # zero gradients: the update is the decay, p *= 1 - lr * wd
        before = p.detach().clone()
        p.grad = torch.zeros(4)
        opt.update(p, st)
        lr = float((1 - p.detach()[0].double() / before[0].double()) / tc.weight_decay)
        assert abs(lr - opt.schedule(c)) <= 2.0**-23, c  # one f32 rounding of p near 1
    assert st.count == 10


def test_adamw_matches_optax_and_offload_equals_resident(rng):
    """The port's clipped AdamW against usdm_tpu's make_optimizer (optax) on
    the same gradients, one of them clipped (x10): params within 2e-5 rel +
    2e-7 (usdm_tpu's own tolerance for its manual AdamW); and the host
    moments' staged update (HostMoments) equals the resident one exactly."""
    tc = TrainConfig(max_steps=20, learning_rate=3e-3)
    opt = JT.make_optimizer(tc)
    params = {"a": rng.standard_normal((8, 16)).astype(np.float32),
              "b": {"w": rng.standard_normal((4,)).astype(np.float32)}}
    jparams = jax.tree.map(jnp.asarray, params)
    jst = opt.init(jparams)
    leaves = lambda: [torch.from_numpy(params["a"].copy()), torch.from_numpy(params["b"]["w"].copy())]
    res, off = leaves(), leaves()
    popt = T.make_optimizer(port_cfg(tc))
    st_res, st_off = popt.init(res), popt.init(off, host=True)
    for step in range(4):
        grads = [rng.standard_normal(p.shape).astype(np.float32) * (10.0 if step == 1 else 0.1)
                 for p in (params["a"], params["b"]["w"])]
        jg = {"a": jnp.asarray(grads[0]), "b": {"w": jnp.asarray(grads[1])}}
        upd, jst = opt.update(jg, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        n1 = T.manual_adamw_update(res, [torch.from_numpy(g) for g in grads], st_res,
                                   popt.schedule, popt.tc)
        n2 = T.manual_adamw_update(off, [torch.from_numpy(g) for g in grads], st_off,
                                   popt.schedule, popt.tc)
        assert float(n1) == float(n2) and abs(float(n1) - float(optax.global_norm(jg))) < 1e-5
        for got, want in zip(res, (jparams["a"], jparams["b"]["w"])):
            close(got, want, rtol=2e-5, atol=2e-7)
        assert all(torch.equal(x, y) for x, y in zip(res, off))
        assert all(torch.equal(x, y) for x, y in zip(st_res.m + st_res.v, st_off.m + st_off.v))


def test_train_steps_match_jax_and_offload(jp, rng):
    """Three make_train_step steps at bf16 compute against usdm_tpu's on a
    one-device CPU mesh (usdm_tpu's state through the bridge): each step's
    loss within 1e-2 and grad norm within 3e-2 rel (bf16 products), the
    params within 2 * steps * lr (each AdamW update moves a weight by at
    most ~lr, so a bf16 gradient-sign flip moves it by 2 lr) and most of
    them (99 %) within lr / 10; then the same step on that state with its
    moments on the host (init(host=True)) gives the resident params bit for
    bit on the CPU."""
    tc = TrainConfig(batch_size=2, max_steps=8, learning_rate=1e-3, ce_chunk=16)
    mesh = create_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    jstate, _ = JT.init_state(BF16, tc, mesh, jax.random.PRNGKey(0))
    b = COL.pack_collate(rows(rng), pad_id=127)
    state = bridge.lm_train_state_from_jax(jax.device_get(jstate))
    off = bridge.lm_train_state_from_jax(jax.device_get(jstate))
    off.opt_state = T.make_optimizer(port_cfg(tc)).init(off.params, host=True)
    jstep = JT.make_train_step(BF16, tc, mesh, attn_impl="xla")
    step = T.make_train_step(port_cfg(BF16), port_cfg(tc))
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch(b))
        m = step(state, tbatch(b))
        step(off, tbatch(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-2
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) < 3e-2
    want = tree_leaves(bridge.mistral_from_jax(jax.device_get(jstate.params)))
    diffs = np.concatenate([(g.detach() - w).abs().flatten().numpy()
                            for g, w in zip(tree_leaves(state.params), want)])
    assert diffs.max() <= 2 * 3 * tc.learning_rate
    assert np.quantile(diffs, 0.99) <= tc.learning_rate / 10
    assert state.step == off.step == 3 and state.opt_state.count == off.opt_state.count == 3
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(state.params),
                                                 tree_leaves(off.params)))


def test_memory_budget_matches_jax():
    """memory_budget(MistralConfig()) equals usdm_tpu's on every key but
    streamed_gb and what follows from it (update_peak_gb, device_gb, fits),
    at one device with and without offload and at dp 8; streamed_gb is 3x
    the port's largest leaf, the [42003, 4096] f32 embedding (0.64 GiB)."""
    full = MistralConfig()
    derived = {"streamed_gb", "update_peak_gb", "device_gb", "fits"}
    for kw in (dict(dp=1, offload=True, hbm_gb=80.0), dict(dp=1, offload=False, hbm_gb=80.0),
               dict(dp=8, offload=True)):
        got, want = T.memory_budget(port_cfg(full), **kw), JT.memory_budget(full, **kw)
        assert got.keys() == want.keys()
        for k in want.keys() - derived:
            assert got[k] == want[k], k
        leaf = 42003 * 4096 * 4 // (kw["dp"]) / 2**30
        assert got["streamed_gb"] == (3 * leaf if kw["offload"] else 0.0)
    b = T.memory_budget(port_cfg(full), dp=1, offload=True, hbm_gb=80.0)
    assert abs(b["moments_gb"] - 54.57) < 0.01 and abs(b["fwd_bwd_peak_gb"] - 70.69) < 0.01
    assert b["device_gb"] == b["fwd_bwd_peak_gb"] and b["host_gb"] == b["moments_gb"]


def test_lora_step_only_updates_adapters(jp, rng):
    """Port of usdm_tpu's test: adapters train (the loss falls over 4 steps),
    the base is bit-unchanged, and the first step's loss (B = 0) is the
    base model's within 1e-4."""
    base = bridge.mistral_from_jax(jax.device_get(jp))
    before = [a.clone() for a in tree_leaves(base)]
    lora = LO.init_lora(port_cfg(CFG), torch.Generator().manual_seed(1), r=4, alpha=8)
    step, opt = LO.make_lora_train_step(port_cfg(CFG), PC.TrainConfig(max_steps=8))
    state = T.TrainState(lora, opt.init(lora), 0)
    b = tbatch(COL.pack_collate(rows(rng, b=4), pad_id=127))
    losses = [float(step(base, state, b)["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0]
    base_loss, _ = M.loss_fn(base, port_cfg(CFG), b["input_ids"], b["labels"],
                             b["segment_ids"], b["positions"], remat=False)
    assert abs(losses[0] - float(base_loss)) < 1e-4
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(base), before))
    assert LO.count_lora_params(lora) == sum(int(np.prod(np.shape(x)))
                                             for x in jax.tree.leaves(_lora()))


def test_lora_merge_equivalence(jp, rng):
    """Port of usdm_tpu's test: merge_lora(base, lora)'s forward equals the
    forward with the side paths (f32, within 2e-4)."""
    base = bridge.mistral_from_jax(jax.device_get(jp))
    lora = bridge.lora_from_jax(jax.device_get(_lora()))
    ids = torch.from_numpy(rng.integers(0, CFG.vocab_size, (1, 16)))
    with torch.no_grad():
        side = M.forward(base, port_cfg(CFG), ids, lora=lora)
        merged = M.forward(LO.merge_lora(base, lora), port_cfg(CFG), ids)
    close(side, merged, rtol=2e-4, atol=2e-4)


def test_lora_steps_match_jax(jp, rng):
    """Two LoRA steps at tiny f32 against usdm_tpu's make_lora_train_step
    (step 1 at lr 0 moves nothing; step 2 moves the adapters): losses within
    1e-5, the adapters within 1e-6 + 1e-4 rel."""
    tc = TrainConfig(max_steps=8, learning_rate=1e-3, ce_chunk=1024)
    mesh = create_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    lw = _lora()
    jstep, jopt = JLO.make_lora_train_step(CFG, tc, mesh, attn_impl="xla")
    jst = jopt.init(lw)
    base = bridge.mistral_from_jax(jax.device_get(jp))
    lora = tree_map(lambda a: a.requires_grad_(True), bridge.lora_from_jax(jax.device_get(lw)))
    step, opt = LO.make_lora_train_step(port_cfg(CFG), port_cfg(tc))
    state = T.TrainState(lora, opt.init(lora), 0)
    b = COL.pack_collate(rows(rng), pad_id=127)
    for _ in range(2):
        lw, jst, jm = jstep(jp, lw, jst, jbatch(b))
        m = step(base, state, tbatch(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
    for g, w in zip(tree_leaves(state.params),
                    tree_leaves(bridge.lora_from_jax(jax.device_get(lw)))):
        close(g.detach(), w, rtol=1e-4, atol=1e-6)


def test_lm_train_state_checkpoint_roundtrip(jp, tmp_path):
    """save_train_state / restore_train_state on the LM TrainState (device
    moments, host moments) and a LoRA state: every tensor and the counts
    come back exactly; the newest two are kept."""
    tc = PC.TrainConfig()
    for host in (False, True):
        st = T.init_state(port_cfg(CFG), tc, "cpu", torch.Generator().manual_seed(0))
        if host:
            st.opt_state = T.make_optimizer(tc).init(st.params, host=True)
        for i, t in enumerate(st.opt_state.m + st.opt_state.v):
            t.fill_(i)
        st.opt_state.count, st.step = 7, 7
        path = str(tmp_path / f"ck{host}")
        for s in (5, 6, 7):
            CK.save_train_state(path, st, s, keep=2)
        assert CK.latest_step(path) == 7 and CK._steps(path) == [6, 7]
        fresh = T.init_state(port_cfg(CFG), tc, "cpu", torch.Generator().manual_seed(1))
        CK.restore_train_state(path, fresh)
        assert fresh.step == 7 and fresh.opt_state.count == 7
        for a, b in zip(tree_leaves(fresh.params) + fresh.opt_state.m + fresh.opt_state.v,
                        tree_leaves(st.params) + st.opt_state.m + st.opt_state.v):
            assert torch.equal(a.detach(), b.detach())
    lora = LO.init_lora(port_cfg(CFG), torch.Generator().manual_seed(2))
    lst = T.TrainState(lora, T.make_optimizer(tc).init(lora), 3)
    CK.save_train_state(str(tmp_path / "lora"), lst, 3)
    other = LO.init_lora(port_cfg(CFG), torch.Generator().manual_seed(3))
    ost = T.TrainState(other, T.make_optimizer(tc).init(other), 0)
    CK.restore_train_state(str(tmp_path / "lora"), ost)
    assert ost.step == 3 and all(torch.equal(a.detach(), b.detach())
                                 for a, b in zip(tree_leaves(other), tree_leaves(lora)))
