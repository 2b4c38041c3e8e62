"""The port's multipack FFD sampler (usdm_tpu_torch/data/packing.py) against
usdm_tpu's, on the CPU.

The port builds its own copy of the FFD source with g++ into
usdm_tpu_torch/_build/ and raises when it cannot; its batches and
efficiency equal its numpy twin's and usdm_tpu's numpy path's, over seeded
lengths, for one rank and for each of four.
"""

import numpy as np
import pytest

from usdm_tpu.data import packing as JP
from usdm_tpu_torch.data import packing as P


def _lengths(seed: int, n: int, c: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # mostly short rows with a long tail, as stage2's utterances are
    return np.minimum(rng.integers(20, c // 3, n) * rng.integers(1, 4, n), c).astype(np.int64)


def _batches(sampler, epochs=(0, 1)):
    out = []
    for e in epochs:
        sampler.set_epoch(e)
        out.append([b.tolist() for b in sampler.generate_batches(set_stats=True)])
    return out, sampler.efficiency()


@pytest.mark.parametrize("num_replicas", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_batches_match_numpy_twin_and_jax(num_replicas, seed):
    """Every rank's batches (two epochs) and the efficiency: the g++ core,
    the port's numpy twin and usdm_tpu's numpy path agree exactly; every
    batch fits its bin and no index repeats across the ranks."""
    c = 1024
    lengths = _lengths(seed, 300, c)
    seen = []
    for rank in range(num_replicas):
        kw = dict(num_replicas=num_replicas, rank=rank, seed=seed)
        native = _batches(P.MultipackSampler(c, lengths, **kw))
        twin = _batches(P.MultipackSampler(c, lengths, use_native=False, **kw))
        jax_np = _batches(JP.MultipackSampler(c, lengths, use_native=False, **kw))
        assert native == twin == jax_np
        assert native[0][0] and 0.5 < native[1] <= 1.0
        for b in native[0][0]:
            assert lengths[b].sum() <= c
        seen += [i for b in native[0][0] for i in b]
    assert len(seen) == len(set(seen))


def test_native_library_is_the_ports_own_build():
    """The library loads from usdm_tpu_torch/_build/ffd-<hash>/, built from
    usdm_tpu_torch/native/ffd.cpp, and is not native/libffd.so."""
    lib = P.library()
    assert "/_build/ffd-" in lib._name and lib._name.endswith("/libffd.so")
    assert P.FFD_SOURCE.exists() and P.FFD_SOURCE.parent.name == "native"
    assert P.FFD_SOURCE.parent.parent.name == "usdm_tpu_torch"


def test_build_failures_raise(tmp_path, monkeypatch):
    """No g++, or a source g++ refuses: the sampler raises with the cause
    (no silent numpy fallback); use_native=False still runs the twin."""
    monkeypatch.setattr(P, "_lib", None)
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(P.shutil, "which", lambda name: None)
    lengths = _lengths(0, 50, 512)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        P.MultipackSampler(512, lengths).generate_batches()
    monkeypatch.undo()
    bad = tmp_path / "native" / "ffd.cpp"
    bad.parent.mkdir()
    bad.write_text("int ffd_check(\n")
    monkeypatch.setattr(P, "_lib", None)
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(P, "FFD_SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        P.MultipackSampler(512, lengths).generate_batches()
    assert P.MultipackSampler(512, lengths, use_native=False).generate_batches()
    with pytest.raises(ValueError):
        P.MultipackSampler(100, lengths)


def test_no_lengths_give_no_batches():
    """Every row filtered out (stage3 with all rows past max_length): no
    batch and efficiency 0 from the g++ core, as from the numpy twin."""
    for native in (True, False):
        sampler = P.MultipackSampler(512, np.zeros(0, np.int64), use_native=native)
        assert sampler.generate_batches(set_stats=True) == []
        assert sampler.efficiency() == 0.0
