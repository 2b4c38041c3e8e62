"""Draft distillation of usdm_tpu_torch against usdm_tpu, on the CPU.

init_draft_from_target (float and W8A8 targets), distill_loss_fn in its kl
and top1 modes, one make_distill_step, and cli.train_draft at --tiny width
(a W8A8 target, --resume, --export_hf, the export served as the draft of a
PagedEngine).  The same tiny Mistral weights go to both packages through
usdm_tpu_torch.core.bridge, the batches come from numpy generators, and
JAX runs under `highest` matmul precision.  Tolerances are stated at each
assert.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.core.config import MistralConfig, TrainConfig
from usdm_tpu.core.mesh import create_mesh
from usdm_tpu.data.collators import pack_collate
from usdm_tpu.models import mistral as JM
from usdm_tpu.models.quant import quantize_llm_params as jquantize
from usdm_tpu.train import distill as JD
from usdm_tpu.train import lm as JT
from usdm_tpu_torch.cli import train_draft
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import checkpoint as CK
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.core.tree import tree_leaves
from usdm_tpu_torch.engine.paged import PagedEngine, Request
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train import distill as D
from usdm_tpu_torch.train import lm as T

CFG = MistralConfig.tiny(vocab_size=128)  # tests/test_train.py's distillation config


@pytest.fixture(autouse=True)
def highest():
    with jax.default_matmul_precision("highest"):
        yield


def port_cfg(jcfg):
    return getattr(PC, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


def batch(rng, b=4, t=32):
    """tests/test_train.py's _batch: two BOS-led halves per row, packed."""
    rows = [[1] + rng.integers(2, CFG.vocab_size, t // 2 - 1).tolist() + [1]
            + rng.integers(2, CFG.vocab_size, t // 2 - 1).tolist() for _ in range(b)]
    out = pack_collate(rows, pad_id=0, bos_id=1)
    out["labels"][:, :5] = -100  # some positions unlabelled
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()})


@pytest.fixture(scope="module")
def target():
    """usdm_tpu's tiny f32 target (PRNGKey 7), its W8A8 quantization, and
    both through the bridge."""
    jt = JM.init_params(CFG, jax.random.PRNGKey(7), dtype="float32")
    jq = jax.device_get(jquantize(jt))
    jt = jax.device_get(jt)
    return jt, jq, bridge.mistral_from_jax(jt), bridge.mistral_from_jax(jq)


@pytest.mark.parametrize("quantized", [False, True])
def test_init_draft_from_target_matches_jax(target, quantized):
    """The port's draft equals usdm_tpu's (bridged) bit for bit: f32 copies
    of the first layer, embed, final norm and lm_head, W8A8 leaves sliced
    then dequantized (one f32 product each side); no tensor shares storage
    with the target."""
    jt, jq, pt, pq = target
    jdraft, jcfg = JD.init_draft_from_target(jq if quantized else jt, CFG, 1)
    draft, cfg = D.init_draft_from_target(pq if quantized else pt, port_cfg(CFG), 1)
    assert cfg == port_cfg(jcfg) and cfg.num_layers == 1
    want = bridge.mistral_from_jax(jax.device_get(jdraft))
    for g, w in zip(tree_leaves(draft), tree_leaves(want)):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    ptrs = {t.data_ptr() for t in tree_leaves(pq if quantized else pt)}
    assert not ptrs & {t.data_ptr() for t in tree_leaves(draft)}


@pytest.mark.parametrize("mode", ["kl", "top1"])
def test_distill_loss_matches_jax(target, rng, mode):
    """distill_loss_fn of a 1-layer early-exit draft against the float
    target at temperature 2 (chunk 16 over 31 positions: a partial chunk)
    and, as usdm_tpu's sanity oracle, the whole target as its own draft:
    ntokens exactly, agree within 1 / ntokens (a bf16 near-tie can flip
    one argmax), the loss within 2e-3 relative + 1e-5 (the draft's bf16
    weights, the heads' bf16 products summed in another order); the
    oracle agrees on >= 95 % with a loss < 0.05 (tests/test_train.py)."""
    jt, _, pt, _ = target
    jb, pb = batch(rng)
    for n_layers in (1, CFG.num_layers):
        jdraft, jcfg = JD.init_draft_from_target(jt, CFG, n_layers)
        draft, cfg = D.init_draft_from_target(pt, port_cfg(CFG), n_layers)
        _, want = JD.distill_loss_fn(jdraft, jt, jcfg, CFG, jb, temperature=2.0, mode=mode,
                                     chunk=16, attn_impl="xla")
        _, got = D.distill_loss_fn(draft, pt, cfg, port_cfg(CFG), pb, temperature=2.0,
                                   mode=mode, chunk=16)
        n = int(want["ntokens"])
        assert int(got["ntokens"]) == n == 4 * 31 - 4 * 4
        assert abs(float(got["agree"]) - float(want["agree"])) <= 1.0 / n + 1e-7
        assert abs(float(got["loss"]) - float(want["loss"])) <= 2e-3 * abs(float(want["loss"])) \
            + 1e-5
    if mode == "kl":
        assert float(got["agree"]) >= 0.95 and float(got["loss"]) < 0.05


def test_distill_step_matches_jax(target, rng):
    """One make_distill_step of a 1-layer draft against a W8A8 target, from
    the same state and batch as usdm_tpu's (one-device CPU mesh, remat on):
    loss within 2e-3 relative, grad norm within 2e-2 relative (bf16
    products), and the updated draft leaves within 2 lr of usdm_tpu's
    (AdamW's first update is lr * g / (|g| + eps): a gradient near eps or
    of flipped sign moves a weight by up to 2 lr), 99 % within lr / 10."""
    _, jq, _, pq = target
    tc = TrainConfig(batch_size=4, max_steps=8, learning_rate=3e-3, remat=True)
    mesh = create_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    jdraft, jcfg = JD.init_draft_from_target(jq, CFG, 1)
    opt = JT.make_optimizer(tc)
    jstate, sh = JT.init_state(jcfg, tc, mesh, jax.random.PRNGKey(0), opt)
    jstate = JT.TrainState(params=jax.device_put(jdraft, sh.params),
                           opt_state=jstate.opt_state, step=jstate.step)
    jstep = JD.make_distill_step(jcfg, CFG, tc, mesh, opt, chunk=16, attn_impl="xla")
    draft, cfg = D.init_draft_from_target(pq, port_cfg(CFG), 1)
    state = T.init_state(cfg, port_cfg(tc), "cpu", params=draft)
    step = D.make_distill_step(cfg, port_cfg(CFG), port_cfg(tc), chunk=16)
    jb, pb = batch(rng)
    jstate, jm = jstep(jstate, jq, jb)
    m = step(state, pq, pb)
    assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= 2e-3
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 2e-2
    assert state.step == 1 and state.opt_state.count == 1
    want = tree_leaves(bridge.mistral_from_jax(jax.device_get(jstate.params)))
    diffs = np.concatenate([(g.detach() - w).abs().flatten().numpy()
                            for g, w in zip(tree_leaves(state.params), want)])
    assert diffs.max() <= 2 * tc.learning_rate
    assert np.quantile(diffs, 0.99) <= tc.learning_rate / 10


def _state(path, step):
    return torch.load(os.path.join(path, "checkpoints", f"step_{step}", "state.pt"),
                      map_location="cpu", weights_only=True)


def test_train_draft_tiny_resume_export_and_serve(tmp_path):
    """cli.train_draft from a tiny target dir (save_mistral_hf, as phase 12
    (d) writes one), W8A8 target, a 1-layer draft, 4 steps saving at 2 and
    4: a run resumed from step 2 reaches step 4 bit for bit (params,
    moments, count; its rows skip what steps 1-2 read); the --export_hf dir
    loads through load_mistral as --draft_dir loads it and, as the draft of
    a PagedEngine over the target (spec_k 3), gives plain greedy's tokens;
    the refusals (--tp 2, no card) raise."""
    rng = np.random.default_rng(0)
    rows = tmp_path / "rows"
    rows.mkdir()
    with open(rows / "part0.txt", "w") as f:
        for _ in range(6):
            segs = [[1] + rng.integers(3, 500, int(rng.integers(8, 20))).tolist()
                    for _ in range(3)]
            f.write(" ".join(str(t) for s in segs for t in s) + "\n")
    pcfg = PC.MistralConfig.tiny(vocab_size=512)
    tdir = str(tmp_path / "target")
    CK.save_mistral_hf(tdir, M.init_params(pcfg, torch.Generator().manual_seed(3), "cpu",
                                           dtype="float32"), pcfg)
    common = ["--model_dir", tdir, "--data_path", str(rows), "--device", "cpu",
              "--quantize_target", "--draft_layers", "1", "--max_steps", "4", "--save_steps",
              "2", "--logging_steps", "1", "--chunk", "16", "--learning_rate", "1e-3"]
    a, b, hf = (str(tmp_path / n) for n in ("a", "b", "hf"))
    assert train_draft.main(common + ["--output_dir", a, "--export_hf", hf]) == 0
    os.makedirs(os.path.join(b, "checkpoints"))
    shutil.copytree(os.path.join(a, "checkpoints", "step_2"),
                    os.path.join(b, "checkpoints", "step_2"))
    assert train_draft.main(common + ["--output_dir", b, "--resume"]) == 0
    sa, sb = _state(a, 4), _state(b, 4)
    ta = tree_leaves(sa["params"]) + sa["opt_state"]["m"] + sa["opt_state"]["v"]
    tb = tree_leaves(sb["params"]) + sb["opt_state"]["m"] + sb["opt_state"]["v"]
    assert sa["step"] == sb["step"] == 4 and sa["opt_state"]["count"] == 4
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))

    tparams, tcfg = CK.load_mistral(tdir, dtype="float32", device="cpu")
    dparams, dcfg = CK.load_mistral(hf, dtype="float32", device="cpu")
    assert dcfg.num_layers == 1 and dcfg.vocab_size == tcfg.vocab_size
    for g, w in zip(tree_leaves(dparams), tree_leaves(sa["params"])):
        assert torch.equal(g, w.to(torch.bfloat16).float())
    ecfg = PC.EngineConfig(page_size=16, max_pages_per_seq=8, max_batch_size=2,
                           prefill_chunk=16)
    allow = np.ones(tcfg.vocab_size, bool)
    prompts = [rng.integers(3, 500, 20).tolist(), rng.integers(3, 500, 13).tolist()]

    def reqs():
        return [Request(i, list(p), allow, eos_id=2, max_new_tokens=12)
                for i, p in enumerate(prompts)]

    spec = PagedEngine(tparams, tcfg, ecfg.replace(spec_k=3), device="cpu",
                       draft=(dparams, dcfg))
    got = [r.output_ids for r in spec.run(reqs())]
    want = [r.output_ids for r in PagedEngine(tparams, tcfg, ecfg, device="cpu").run(reqs())]
    assert got == want and spec.spec_rounds > 0
    with pytest.raises(ValueError, match="tp 2, 1 slices\\) needs 2 processes"):
        train_draft.main(common + ["--output_dir", str(tmp_path / "c"), "--tp", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_draft.main(["--tiny", "--data_path", str(rows), "--output_dir",
                          str(tmp_path / "d")])
