"""usdm_tpu_torch's core/mesh.py layouts and placements against usdm_tpu's
meshes and NamedShardings, on the CPU, and the refusals of the trainers'
multi-process flags.

The rank layouts are pure functions, held to the device order of usdm_tpu's
create_mesh / create_dcn_mesh over the 8 virtual devices of
tests/conftest.py, and to its errors.  Each rank's block of every Mistral
leaf (models/mistral.py param_shardings) and of a batch (shard_batch) is
held to the shard usdm_tpu's NamedSharding puts on that rank's device, bit
for bit; these need no process group (a Mesh with no groups runs no
collective).  memory_budget is held to usdm_tpu's at several dp x tp."""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from usdm_tpu.core import mesh as JMS
from usdm_tpu.core.config import MistralConfig
from usdm_tpu.models import mistral as JM
from usdm_tpu.train import lm as JT
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as PC
from usdm_tpu_torch.core import distributed as D
from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.engine import tp as TP
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train import lm as T

CFG = MistralConfig.tiny(vocab_size=128).replace(num_heads=8, num_kv_heads=4, head_dim=8)
MESHES = [((2, 2), None), ((1, 4), None), ((4, 2), None), ((8, 1), None), ((1, 2), 2),
          ((2, 2), 2), ((-1, 1), 4)]


def pcfg(c):
    return PC.MistralConfig.from_dict(dataclasses.asdict(c))


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _n(shape, slices) -> int:
    """The devices (ranks) a mesh spans: dp -1 takes all 8."""
    dp, tp = shape
    return 8 if dp == -1 else dp * tp * (slices or 1)


def _jax_mesh(shape, slices):
    dp, tp = shape
    devices = jax.devices()[:_n(shape, slices)]
    if slices is None:
        return JMS.create_mesh(dp=dp, tp=tp, devices=devices)
    return JMS.create_dcn_mesh(num_slices=slices, dp=dp, tp=tp, devices=devices)


def _port_layout(shape, slices):
    dp, tp = shape
    lay = MS.layout(_n(shape, slices), dp, tp, slices or 1)
    return lay[0] if slices is None else lay


def _port_mesh(shape, slices, rank) -> MS.Mesh:
    names = ((MS.DATA_AXIS, MS.MODEL_AXIS) if slices is None
             else (MS.REPLICA_AXIS, MS.DATA_AXIS, MS.MODEL_AXIS))
    return MS.Mesh(names, _port_layout(shape, slices), rank, {}, torch.device("cpu"))


@pytest.mark.parametrize("shape,slices", MESHES)
def test_layouts_are_usdm_tpu_device_orders(shape, slices):
    """Rank r sits where usdm_tpu puts device r: row-major (data, model),
    the process (slice) boundary on the outer axis of a DCN mesh."""
    np.testing.assert_array_equal(_port_layout(shape, slices), _ids(_jax_mesh(shape, slices)))


@pytest.mark.parametrize("n,dp,tp,slices", [(8, 3, 2, 1), (8, -1, 3, 1), (8, 2, 2, 3),
                                            (8, 4, 4, 1), (8, -1, 3, 2)])
def test_layout_errors_name_the_numbers(n, dp, tp, slices):
    """usdm_tpu's bare asserts become ValueErrors that name the numbers."""
    with pytest.raises(AssertionError):
        if slices == 1:
            JMS.create_mesh(dp=dp, tp=tp, devices=jax.devices()[:n])
        else:
            JMS.create_dcn_mesh(num_slices=slices, dp=dp, tp=tp, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as e:
        MS.layout(n, dp, tp, slices)
    assert f"{n} ranks" in str(e.value) or f"tp={tp}" in str(e.value) \
        or f"ranks({n})" in str(e.value)


@pytest.fixture(scope="module")
def jp():
    return JM.init_params(CFG, jax.random.PRNGKey(0), dtype="float32")


def _shard_on(x, mesh, spec, device_id):
    arr = jax.device_put(x, NamedSharding(mesh, spec))
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device.id == device_id)


@pytest.mark.parametrize("shape,slices", MESHES[:3] + MESHES[5:6])
def test_param_blocks_are_usdm_tpu_shards(jp, shape, slices):
    """Every rank's block of every leaf (param_shardings.shard) equals the
    shard usdm_tpu's param_specs put on that rank's device: layers [L, ...]
    take the layer's slice, lm_head compares transposed ([V, D] here, [D,
    V] there)."""
    jmesh = _jax_mesh(shape, slices)
    specs = JM.param_specs(CFG)
    full = bridge.mistral_from_jax(jax.device_get(jp))
    for rank in range(_n(shape, slices)):
        shs = M.param_shardings(pcfg(CFG), _port_mesh(shape, slices, rank))
        got = shs["embed"].shard(full["embed"]).numpy()
        np.testing.assert_array_equal(got, _shard_on(jp["embed"], jmesh, specs["embed"], rank))
        got = shs["lm_head"].shard(full["lm_head"]).numpy()
        want = _shard_on(jp["lm_head"], jmesh, specs["lm_head"], rank)
        np.testing.assert_array_equal(got, want.T)
        for name, spec in specs["layers"].items():
            want = _shard_on(jp["layers"][name], jmesh, spec, rank)
            for i, lp in enumerate(full["layers"]):
                np.testing.assert_array_equal(shs["layers"][i][name].shard(lp[name]).numpy(),
                                              want[i])


@pytest.mark.parametrize("shape,slices", [((2, 2), None), ((1, 2), 2), ((-1, 1), 4)])
def test_batch_rows_are_usdm_tpu_shards(shape, slices):
    """shard_batch's rows for each rank equal the rows usdm_tpu's batch_spec
    puts on its device (over data, or (replica, data))."""
    jmesh = _jax_mesh(shape, slices)
    x = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    for rank in range(_n(shape, slices)):
        got = MS.shard_batch(_port_mesh(shape, slices, rank), {"input_ids": x})["input_ids"]
        np.testing.assert_array_equal(
            got, _shard_on(x, jmesh, JT.batch_spec(jmesh)["input_ids"], rank))
    with pytest.raises(ValueError, match="does not divide"):
        MS.shard_batch(_port_mesh((8, 1), None, 0), {"input_ids": x[:6]})


def test_odd_vocab_pads_like_serving():
    """At an odd vocab each model rank's lm_head block is engine/tp.py
    shard_vocab's (zero rows pad the last), and the FSDP split of D follows."""
    cfg = pcfg(CFG).replace(vocab_size=131)
    w = torch.randn(131, cfg.hidden_size)
    for rank in range(4):
        mesh = _port_mesh((2, 2), None, rank)
        block = M.param_shardings(cfg, mesh)["lm_head"].shard(w)
        d = mesh.coord(MS.DATA_AXIS)
        want = TP.shard_vocab(w, 2, mesh.coord(MS.MODEL_AXIS))[:, d * 32:(d + 1) * 32]
        assert torch.equal(block, want) and block.shape == (66, 32)


def test_specs_cover_every_leaf():
    """param_specs and state_specs name a placement for every leaf (the
    moments' follow the params' leaf by leaf)."""
    cfg = pcfg(CFG)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    specs = T.state_specs(cfg)
    n = len(T.tree_leaves(params))
    assert len(specs.opt_state.m) == len(specs.opt_state.v) == n
    for t, spec in zip(T.tree_leaves(params), specs.opt_state.m):
        assert len(spec) == t.ndim
    assert T.batch_spec()["input_ids"] == ("data", None)


@pytest.mark.parametrize("dp,tp", [(1, 1), (8, 1), (4, 2), (2, 4), (1, 8)])
def test_memory_budget_matches_usdm_tpu_shard_factor(dp, tp):
    """memory_budget at dp x tp equals usdm_tpu's (its shard_factor over
    param_specs) on every key but streamed_gb and what follows from it."""
    full = MistralConfig()
    derived = {"streamed_gb", "update_peak_gb", "device_gb", "fits"}
    for offload in (False, True):
        got = T.memory_budget(pcfg(full), dp=dp, tp=tp, offload=offload)
        want = JT.memory_budget(full, dp=dp, tp=tp, offload=offload)
        for k in want.keys() - derived:
            assert got[k] == want[k], (k, dp, tp)


def _args(**kw):
    base = dict(dp=-1, tp=1, num_slices=1, coordinator=None, num_processes=None,
                process_id=None)
    return argparse.Namespace(**{**base, **kw})


def test_cli_mesh_refusals_name_what_is_missing(monkeypatch):
    """No flags: no group and no mesh (the single-device path).  A mesh of
    more ranks than the run has raises by name, on the CPU and for cards
    this host lacks; so do --num_processes without a rendezvous and a
    coordinator without a rank."""
    for k in ("WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert D.make_cli_mesh(_args(), "cpu") is None
    with pytest.raises(ValueError, match="needs 4 processes: start them with torchrun"):
        D.make_cli_mesh(_args(dp=2, tp=2), "cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        D.make_cli_mesh(_args(num_slices=2), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices for a mesh of 2 ranks, have 0"):
            D.make_cli_mesh(_args(tp=2), "cuda")
        with pytest.raises(ValueError, match="need 2 devices"):
            D.make_cli_mesh(_args(num_processes=2, coordinator="h:1", process_id=1), "cuda")
    with pytest.raises(ValueError, match="rendezvous"):
        D.make_cli_mesh(_args(num_processes=2), "cpu")
    with pytest.raises(ValueError, match="--process_id"):
        D.make_cli_mesh(_args(coordinator="h:1"), "cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialized 4-rank"):
        MS.create_mesh(dp=2, tp=2, device="cpu")


def test_guarded_training_writes_an_emergency_checkpoint(tmp_path):
    """usdm_tpu's guarded_training: a step that raises leaves a checkpoint
    of the state at that step (restorable) and the error propagates."""
    from usdm_tpu_torch.core import checkpoint as CK

    cfg, tc = pcfg(CFG), PC.TrainConfig(max_steps=4)
    state = T.init_state(cfg, tc, "cpu", torch.Generator().manual_seed(0))
    state.step = 3
    with pytest.raises(RuntimeError, match="step failed"):
        with D.guarded_training(str(tmp_path), lambda: state, lambda: state.step):
            raise RuntimeError("step failed")
    assert CK.latest_step(str(tmp_path)) == 3
    fresh = T.init_state(cfg, tc, "cpu", torch.Generator().manual_seed(1))
    CK.restore_train_state(str(tmp_path), fresh)
    assert fresh.step == 3 and all(torch.equal(a, b) for a, b in
                                   zip(T.tree_leaves(fresh.params), T.tree_leaves(state.params)))
