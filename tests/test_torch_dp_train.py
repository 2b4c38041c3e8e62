"""usdm_tpu_torch's data-parallel trainers against usdm_tpu's, on the CPU,
and the sharded trainer CLI over two gloo processes.

One group of two gloo ranks (a `-c` script that imports torch and the port
alone, one thread each) runs LoRA at dp 2 (train/lora.py), the CFM step at
dp 2 with t and z given for the global batch (train/cfm.py) and the GAN
steps at dp 2 (train/vocoder.py); each is held to usdm_tpu's step on a
dp 2 mesh of the 8 virtual devices of tests/conftest.py (its CFM step with
the same t and z put in place of its draws).  The same group runs the
in-process dp 2 LM trainer (cli/lm_trainer.py) that `cli.train_pt --dp 2`
over two processes must reproduce: rank 0's metrics.jsonl bit for bit, a
run resumed from step 2 of 4 equal to the uninterrupted one bit for bit,
and its dp 2 checkpoint resumed by one process at dp 1.  Weights come
across through core/bridge.py; usdm_tpu runs under `highest` matmul
precision; tolerances are stated at each assert.
"""

import dataclasses
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from usdm_tpu.core.config import (BigVGANConfig, CfmTrainConfig, MelConfig, MistralConfig,
                                  TrainConfig, VoiceboxConfig)
from usdm_tpu.core.mesh import create_mesh
from usdm_tpu.data import mel_dataset as JMD
from usdm_tpu.data.collators import pack_collate
from usdm_tpu.models import mistral as JM
from usdm_tpu.models import voicebox as JVB
from usdm_tpu.train import cfm as JC
from usdm_tpu.train import lora as JLO
from usdm_tpu.train import vocoder as JV
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = MistralConfig.tiny(vocab_size=128).replace(sliding_window=8)
LM_TC = TrainConfig(batch_size=4, max_steps=8, learning_rate=1e-3, ce_chunk=1024)
VB_CFG = VoiceboxConfig.tiny()
GAN = BigVGANConfig.tiny()
GAN_MEL = MelConfig().replace(num_mels=GAN.num_mels, n_fft=64, win_size=64,
                              hop_size=GAN.total_upsample)
GAN_RES = ((256, 64, 128),)
PERIODS = (2, 3)
GAN_LR = 2e-4
CLI = ["--tiny", "--device", "cpu", "--train_batch_size", "2", "--logging_steps", "1",
       "--save_steps", "2", "--max_input_length", "64"]


def _lm_rows() -> dict:
    """Four packed rows; rows 0-1 (rank 0's) have 20 labels masked."""
    rng = np.random.default_rng(11)
    rows = [[1] + rng.integers(3, 127, 15).tolist() + [1] + rng.integers(3, 127, 15).tolist()
            for _ in range(4)]
    b = pack_collate(rows, pad_id=127, bos_id=1)
    b["labels"][:2, :20] = -100
    return {k: np.asarray(v) for k, v in b.items()}


def _cfm_batch() -> dict:
    """Four rows of 24 frames, context frames in rows 0 and 2 and lengths
    24, 17, 20, 11: the ranks hold different counts of loss frames."""
    rng = np.random.default_rng(12)
    mask = np.zeros((4, 1, 24), np.float32)
    mask[0, 0, 3:9] = 1.0
    mask[2, 0, 10:20] = 1.0
    return {"x": rng.integers(0, VB_CFG.n_tokens, (4, 24)).astype(np.int32), "mask": mask,
            "y": rng.standard_normal((4, VB_CFG.n_feats, 24)).astype(np.float32),
            "y_lengths": np.asarray([24, 17, 20, 11], np.int32),
            "t": rng.uniform(size=4).astype(np.float32),
            "z": rng.standard_normal((4, VB_CFG.n_feats, 24)).astype(np.float32)}


def _gan_batch() -> dict:
    rng = np.random.default_rng(13)
    frames = 32
    return {"mel": (rng.standard_normal((4, GAN.num_mels, frames)) - 5.0).astype(np.float32),
            "wav": (rng.standard_normal((4, 1, frames * GAN.total_upsample)) * 0.1
                    ).astype(np.float32)}


def _tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _sft_rows(root: str) -> str:
    rng = np.random.default_rng(14)
    path = os.path.join(root, "rows")
    os.makedirs(path)
    with open(os.path.join(path, "part0.txt"), "w") as f:
        for _ in range(8):
            segs = [[1] + rng.integers(3, 500, int(rng.integers(8, 20))).tolist()
                    for _ in range(3)]
            f.write(" ".join(str(t) for s in segs for t in s) + "\n")
    return path


WORKER = r"""
import json, sys
sys.modules["usdm_tpu"] = None  # the port alone
import numpy as np, torch
torch.set_num_threads(1)
from usdm_tpu_torch.cli import lm_trainer as LT
from usdm_tpu_torch.cli.train_pt import rows_forever
from usdm_tpu_torch.core import distributed as D, mesh as MS
from usdm_tpu_torch.core.config import (BigVGANConfig, CfmTrainConfig, MelConfig, MistralConfig,
                                        TrainConfig, VoiceboxConfig)
from usdm_tpu_torch.core.tree import tree_leaves, tree_map
from usdm_tpu_torch.data.collators import pack_collate
from usdm_tpu_torch.train import cfm as C, lm as T, lora as LO, vocoder as V

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
D.initialize(f"localhost:{port}", 2, rank, "cpu")
mesh = MS.create_mesh(2, 1, "cpu")
spec = json.load(open(f"{root}/spec.json"))
data = torch.load(f"{root}/inputs.pt")
out = {}

def grad_leaves(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)

# LoRA at dp 2: two steps
cfg, tc = MistralConfig.from_dict(spec["lm"]), TrainConfig.from_dict(spec["lm_tc"])
step, opt = LO.make_lora_train_step(cfg, tc, mesh)
lora = grad_leaves(data["lora"])
state = T.TrainState(lora, opt.init(lora), 0)
batch = MS.shard_batch(mesh, data["lm_rows"])
out["lora"] = [[float(v) for v in step(data["base"], state, batch).values()] for _ in range(2)]
lora_final = [t.detach() for t in tree_leaves(state.params)]

# CFM at dp 2, f32 compute, t and z of the global batch: two steps
vcfg, vtc = VoiceboxConfig.from_dict(spec["vb"]), CfmTrainConfig.from_dict(spec["vb_tc"])
copt = C.make_optimizer(vtc)
params = grad_leaves(data["vb"])
cstate = C.CfmTrainState(params, copt.init(params), 0)
cstep = C.make_train_step(vcfg, vtc, copt, compute_dtype="float32", mesh=mesh)
cb = dict(data["cfm"])
t_, z_ = cb.pop("t"), cb.pop("z")
cb["x"], cb["y_lengths"] = cb["x"].long(), cb["y_lengths"].long()
cb = MS.shard_batch(mesh, cb)
out["cfm"] = [[float(v) for v in cstep(cstate, cb, t=t_, z=z_).values()] for _ in range(2)]
cfm_final = [t.detach() for t in tree_leaves(cstate.params)]

# the GAN steps at dp 2: a discriminator step, then a generator step
gcfg = BigVGANConfig.from_dict(spec["gan"])
gopt, dopt = V.make_optimizer(spec["gan_lr"]), V.make_optimizer(spec["gan_lr"])
g = data["gan"]
gen, mpd, mrd = (grad_leaves(g[k]) for k in ("gen", "mpd", "mrd"))
gstate = V.GanTrainState(gen, mpd, mrd, gopt.init(gen), dopt.init({"mpd": mpd, "mrd": mrd}))
mel_cfg = MelConfig.from_dict(spec["gan_mel"])
res = tuple(tuple(r) for r in spec["gan_res"])
dstep, gstep = V.make_train_steps(gcfg, gopt, dopt, mel_cfg, res, tuple(spec["periods"]), mesh)
gb = MS.shard_batch(mesh, data["gan_batch"])
out["gan"] = {k: float(v) for k, v in {**dstep(gstate, gb), **gstep(gstate, gb)}.items()}
gan_final = [t.detach() for t in tree_leaves(gstate.params)]

# the in-process dp 2 LM trainer that `cli.train_pt --tiny --dp 2` runs
ptc = TrainConfig(learning_rate=2e-5, warmup_ratio=0.03, batch_size=2, max_steps=4, seed=42,
                  dp=2, tp=1, save_every=2, keep_checkpoints=2)
pcfg = MistralConfig.tiny(vocab_size=512).replace(dtype=T.COMPUTE_DTYPE)
tr = LT.make_trainer(pcfg, ptc, torch.device("cpu"),
                     torch.Generator(device="cpu").manual_seed(42), mesh=mesh)
rows = rows_forever(f"{root}/rows")
out["pt"] = []
for _ in range(4):
    b = pack_collate([next(rows)[:64] for _ in range(2)], pad_id=511)
    m = tr.step(LT.to_device(b, "cpu", mesh))
    out["pt"].append([float(m["loss"]), float(m["grad_norm"]), float(m["ntokens"])])
if rank == 0:
    torch.save({"lora": lora_final, "cfm": cfm_final, "gan": gan_final}, f"{root}/final.pt")
    json.dump(out, open(f"{root}/out.json", "w"))
D.finish()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Runs:
    """The processes of this file: the worker group, and `cli.train_pt`
    runs over two gloo processes (A: 4 steps; B: 2 steps, then resumed to
    4) and, after A, one process resuming A's step-2 checkpoint at dp 1."""

    def __init__(self, root: str):
        self.root = root
        self.env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                    "OMP_NUM_THREADS": "1"}
        self.procs = {}
        port = str(_free_port())
        self.procs["worker"] = [self._start("worker", r, ["-c", WORKER, str(r), port, root])
                                for r in range(2)]
        self._cli("A", 4)
        self._cli("B", 2)
        # B's resume and C start as soon as A and B have exited
        self.later = threading.Thread(target=self._resume, daemon=True)
        self.later.start()

    def _start(self, key, rank, argv):
        log = open(os.path.join(self.root, f"{key}{rank}.log"), "w")
        return subprocess.Popen([sys.executable, *argv], cwd=REPO, env=self.env, stdout=log,
                                stderr=subprocess.STDOUT)

    def _cli(self, key, steps, extra=(), world=2):
        port = str(_free_port())
        argv = ["-m", "usdm_tpu_torch.cli.train_pt", *CLI, "--data_path",
                os.path.join(self.root, "rows"), "--output_dir", os.path.join(self.root, key),
                "--max_steps", str(steps), *extra]
        if world > 1:
            self.procs[key] = [self._start(key, r, argv + [
                "--dp", "2", "--coordinator", f"localhost:{port}", "--num_processes", "2",
                "--process_id", str(r)]) for r in range(world)]
        else:
            self.procs[key] = [self._start(key, 0, argv)]

    def wait(self, key, timeout: float = 180):
        deadline = time.monotonic() + timeout
        for p in self.procs[key]:
            try:
                p.wait(max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        texts = [open(os.path.join(self.root, f"{key}{r}.log")).read()
                 for r in range(len(self.procs[key]))]
        assert all(p.returncode == 0 for p in self.procs[key]), "\n".join(texts)[-4000:]
        return os.path.join(self.root, key)

    def _resume(self):
        for p in self.procs["A"] + self.procs["B"]:
            p.wait()
        c = os.path.join(self.root, "C", "checkpoints")
        shutil.copytree(os.path.join(self.root, "A", "checkpoints", "step_2"),
                        os.path.join(c, "step_2"))
        self._cli("B2", 4, ["--resume", "--output_dir", os.path.join(self.root, "B")])
        self._cli("C", 4, ["--resume"], world=1)

    def resumed(self):
        """B resumed to step 4, and A's step 2 resumed at dp 1."""
        self.wait("A")
        self.wait("B")
        self.later.join(60)
        self.wait("B2")  # wrote to B
        return os.path.join(self.root, "B"), self.wait("C")

    def close(self):
        self.later.join(60)
        for ps in self.procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def lm_params():
    return (JM.init_params(LM, jax.random.PRNGKey(0), dtype="float32"),
            JLO.init_lora(LM, jax.random.PRNGKey(1), r=4, alpha=8))


@pytest.fixture(scope="module")
def vb_params():
    return JVB.init_params(VB_CFG, jax.random.PRNGKey(2))


@pytest.fixture(scope="module")
def gan_state():
    return JV.init_state(GAN, jax.random.PRNGKey(0), lr=GAN_LR, periods=PERIODS)


@pytest.fixture(scope="module")
def runs(lm_params, vb_params, gan_state, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp"))
    _sft_rows(root)
    jstate = gan_state[0]
    gs = bridge.gan_train_state_from_jax(jax.device_get(jstate))
    torch.save({"base": bridge.mistral_from_jax(jax.device_get(lm_params[0])),
                "lora": bridge.lora_from_jax(jax.device_get(lm_params[1])),
                "lm_rows": _tensors(_lm_rows()),
                "vb": bridge.voicebox_from_jax(jax.device_get(vb_params)),
                "cfm": _tensors(_cfm_batch()),
                "gan": {"gen": gs.gen_params, "mpd": gs.mpd, "mrd": gs.mrd},
                "gan_batch": _tensors(_gan_batch())}, os.path.join(root, "inputs.pt"))
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump({"lm": dataclasses.asdict(LM), "lm_tc": dataclasses.asdict(LM_TC),
                   "vb": dataclasses.asdict(VB_CFG), "vb_tc": dataclasses.asdict(CfmTrainConfig()),
                   "gan": dataclasses.asdict(GAN), "gan_lr": GAN_LR,
                   "gan_mel": dataclasses.asdict(JMD.loss_mel_config(GAN_MEL)),
                   "gan_res": GAN_RES, "periods": PERIODS}, f)
    r = _Runs(root)
    yield r
    r.close()


@pytest.fixture(scope="module")
def result(runs):
    """-> a call that waits for the worker group (once) and returns rank 0's
    (metrics, final params); each test calls it after its usdm_tpu
    reference, which so compiles while the ranks run."""
    done = []

    def get():
        if not done:
            runs.wait("worker")
            with open(os.path.join(runs.root, "out.json")) as f:
                done.append((json.load(f), torch.load(os.path.join(runs.root, "final.pt"))))
        return done[0]

    return get


def _mesh2():
    return create_mesh(dp=2, tp=1, devices=jax.devices()[:2])


def _max_diff(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want, strict=True))


def test_gan_dp2_matches_usdm_tpu(gan_state, result):
    """One discriminator and one generator step at dp 2: every metric within
    1e-4 rel of usdm_tpu's dp 2 steps; the params within 2 lr and 99 % of
    them within lr / 100 (tests/test_torch_vocoder.py's bounds)."""
    jstate, gopt, dopt = gan_state
    with jax.default_matmul_precision("highest"):
        jd, jg = JV.make_train_steps(GAN, _mesh2(), gopt, dopt, JMD.loss_mel_config(GAN_MEL),
                                     resolutions=GAN_RES, periods=PERIODS)
        batch = {k: jnp.asarray(v) for k, v in _gan_batch().items()}
        jstate, dm = jd(jstate, batch)
        jstate, gm = jg(jstate, batch)
    out, final = result()
    for k, w in {**dm, **gm}.items():
        assert abs(out["gan"][k] - float(w)) <= 1e-4 * abs(float(w)), k
    want = tree_leaves(bridge.gan_train_state_from_jax(jax.device_get(jstate)).params)
    diffs = np.concatenate([(g - w.detach()).abs().flatten().numpy()
                            for g, w in zip(final["gan"], want, strict=True)])
    assert diffs.max() <= 2 * GAN_LR and np.quantile(diffs, 0.99) <= GAN_LR / 100


def test_cfm_dp2_matches_usdm_tpu(vb_params, result):
    """Two CFM steps at dp 2 with the same global t and z (usdm_tpu's step
    with its draws replaced by them; f32 compute): losses within 1e-4 rel,
    grad norms within 1e-4 rel, parameters within 1e-5 (the single-device
    test's bounds)."""
    b = _cfm_batch()
    tt, z = jnp.asarray(b.pop("t")), jnp.asarray(b.pop("z"))
    injected = types.SimpleNamespace(**{**vars(JVB),
                                        "cfm_loss": functools.partial(JVB.cfm_loss, t=tt, z=z)})
    tc = CfmTrainConfig()
    mesh = _mesh2()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(JC, "VB", injected)
        state, _ = JC.init_state(VB_CFG, tc, mesh, jax.random.PRNGKey(0))
        state = JC.CfmTrainState(jax.device_get(vb_params),
                                 JC.make_optimizer(tc).init(vb_params), state.step)
        step = JC.make_train_step(VB_CFG, tc, mesh, compute_dtype="float32")
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        metrics = []
        for _ in range(2):
            state, m = step(state, batch, jax.random.PRNGKey(0))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out, final = result()
    for got, (wl, wn) in zip(out["cfm"], metrics, strict=True):
        assert abs(got[0] / wl - 1) <= 1e-4
        assert abs(got[1] / wn - 1) <= 1e-4
    want = tree_leaves(bridge.voicebox_from_jax(jax.device_get(state.params)))
    assert _max_diff(final["cfm"], want) <= 1e-5


def test_lora_dp2_matches_usdm_tpu(lm_params, result):
    """Two LoRA steps at dp 2 (step 1 at lr 0): loss within 1e-5, grad norm
    within 1e-4 rel, the adapters within 1e-6 + 1e-4 of their peak."""
    jp, lw = lm_params
    with jax.default_matmul_precision("highest"):
        step, opt = JLO.make_lora_train_step(LM, LM_TC, _mesh2(), attn_impl="xla")
        st = opt.init(lw)
        batch = {k: jnp.asarray(v) for k, v in _lm_rows().items()}
        want = []
        for _ in range(2):
            lw, st, m = step(jp, lw, st, batch)
            want.append((float(m["loss"]), float(m["grad_norm"])))
    out, final = result()
    for got, (wl, wn) in zip(out["lora"], want, strict=True):
        assert abs(got[0] - wl) <= 1e-5
        assert abs(got[1] / wn - 1) <= 1e-4
    want = tree_leaves(bridge.lora_from_jax(jax.device_get(lw)))
    for g, w in zip(final["lora"], want, strict=True):
        assert float((g - w).abs().max()) <= 1e-6 + 1e-4 * float(w.abs().max())


def _metrics(path: str) -> list:
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [[r["train/loss"], r["train/grad_norm"], r["train/ntokens"]]
                for r in map(json.loads, f) if "train/loss" in r]


def _state(path: str, step: int) -> dict:
    return torch.load(os.path.join(path, "checkpoints", f"step_{step}", "state.pt"))


def test_cli_dp2_equals_in_process_dp2(runs, result):
    """Rank 0's metrics.jsonl of `cli.train_pt --tiny --dp 2` over two gloo
    processes: the in-process dp 2 trainer's losses, grad norms and token
    counts bit for bit; rank 1 writes no metrics."""
    out, _ = result()
    a = runs.wait("A")
    assert _metrics(a) == out["pt"]
    assert len(open(os.path.join(a, "metrics.jsonl")).read().splitlines()) == 4


def test_cli_dp2_resume_is_bit_exact_and_restores_at_dp1(runs):
    """B (2 steps, then --resume to 4) ends in A's step-4 state bit for bit
    (masters, moments, count); A's dp 2 step-2 checkpoint resumed by one
    process at dp 1 logs steps 3 and 4 within 2e-2 rel of A's (bf16
    compute over another reduction order)."""
    a = runs.wait("A")
    b, c = runs.resumed()
    sa, sb = _state(a, 4), _state(b, 4)
    ta = tree_leaves(sa["params"]) + sa["opt_state"]["m"] + sa["opt_state"]["v"]
    tb = tree_leaves(sb["params"]) + sb["opt_state"]["m"] + sb["opt_state"]["v"]
    assert sa["step"] == sb["step"] == 4 and sa["opt_state"]["count"] == 4
    assert all(torch.equal(x, y) for x, y in zip(ta, tb, strict=True))
    assert _metrics(b)[-2:] == _metrics(a)[-2:]
    got, want = _metrics(c), _metrics(a)[2:]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert abs(g[0] / w[0] - 1) <= 2e-2 and g[2] == w[2]
    assert _state(c, 4)["step"] == 4
