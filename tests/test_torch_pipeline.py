"""A whole tiny speech-to-speech turn: usdm_tpu_torch against usdm_tpu.

The port's pipeline gets usdm_tpu's tiny_random weights through the bridge;
the same wav must give an identical DialogResult (greedy tokens, texts,
units), and the port's synthesis, fed the initial noise the JAX synthesis
draws, must give the same waveform within 1e-3 of its peak.  Also: the port runs
without JAX and without usdm_tpu, and its entry points default to CUDA and
raise without a card.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.audio.units import expand_and_pool
from usdm_tpu.audio.wav import ceil_to, write_wav
from usdm_tpu.pipeline import UsdmPipeline as JaxPipeline
from usdm_tpu_torch.core import bridge
from usdm_tpu_torch.core import config as C
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine.synthesis import SpeechDecoder
from usdm_tpu_torch.pipeline import UsdmPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cfg(jcfg):
    """The port's config of the same fields as a usdm_tpu config."""
    return getattr(C, type(jcfg).__name__).from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def pipes():
    with jax.default_matmul_precision("highest"):
        jpipe = JaxPipeline.tiny_random(seed=0)
    host = jax.device_get
    d = jpipe.decoder
    decoder = SpeechDecoder(bridge.voicebox_from_jax(host(d.voicebox_params)),
                            port_cfg(d.voicebox_cfg),
                            bridge.bigvgan_from_jax(host(d.vocoder_params)),
                            port_cfg(d.vocoder_cfg), port_cfg(d.mel_cfg))
    tpipe = UsdmPipeline(UsdmTokenizer.build_test(num_units=32),
                         bridge.mistral_from_jax(host(jpipe.lm_params)), port_cfg(jpipe.lm_cfg),
                         bridge.xlsr_from_jax(host(jpipe.xlsr_params)), port_cfg(jpipe.xlsr_cfg),
                         decoder, device="cpu", max_new_tokens=jpipe.max_new_tokens)
    yield jpipe, tpipe
    jpipe.close()
    tpipe.close()


@pytest.fixture
def user_wav(tmp_path):
    path = str(tmp_path / "user.wav")
    wav = np.random.default_rng(5).standard_normal(16000) * 0.1
    write_wav(path, wav.astype(np.float32), 16000)
    return path


def test_tiny_turn_matches_jax(pipes, user_wav, tmp_path):
    jpipe, tpipe = pipes
    with jax.default_matmul_precision("highest"):
        want = jpipe.respond(user_wav, n_timesteps=4, seed=3)
    out = str(tmp_path / "agent.wav")
    got = tpipe.respond(user_wav, out, n_timesteps=4, seed=3)
    # texts, units and every stage's tokens (the two DialogResult classes differ)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.agent_units, "degenerate turn: no agent units"
    assert os.path.exists(out)


def test_tiny_synthesis_matches_jax(pipes, rng):
    """Same units, same initial noise: the JAX synthesis draws z from
    split(key)[0]; the port is handed that z."""
    jpipe, tpipe = pipes
    units = rng.integers(0, 32, size=60).tolist()
    key = jax.random.PRNGKey(11)
    n = len(expand_and_pool(np.asarray(units))[0])
    shape = (1, jpipe.decoder.mel_cfg.num_mels, ceil_to(n, jpipe.decoder.frame_bucket))
    z = np.asarray(jax.random.normal(jax.random.split(key)[0], shape, jnp.float32))
    with jax.default_matmul_precision("highest"):
        want = jpipe.decoder.synthesize(units, key, n_timesteps=6)
    got = tpipe.decoder.synthesize(units, z=torch.from_numpy(np.array(z)), n_timesteps=6)
    assert got.shape == want.shape and len(got) > 0
    peak = np.abs(want).max()  # the tiny random vocoder's output is ~1e-3
    assert peak > 0
    np.testing.assert_allclose(got, want, atol=1e-3 * peak, rtol=0)  # f32 both sides


def test_port_runs_without_jax(tmp_path):
    """With usdm_tpu (and safetensors, tokenizers, transformers, ml_dtypes)
    made unimportable, every usdm_tpu_torch module imports,
    chip_smoke.py and every port module it imports load, and a tiny turn
    (W8A8 LM and Voicebox) runs on the CPU; jax never enters sys.modules."""
    code = f"""
import ast, importlib, os, pkgutil, sys
for name in ("usdm_tpu", "optax", "safetensors", "tokenizers", "transformers", "ml_dtypes"):
    sys.modules[name] = None  # any import of these now fails
import numpy as np
import usdm_tpu_torch
for m in pkgutil.walk_packages(usdm_tpu_torch.__path__, "usdm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for node in ast.walk(ast.parse(open("chip_smoke.py").read())):
    if isinstance(node, ast.ImportFrom) and node.module.startswith("usdm_tpu_torch"):
        mod = importlib.import_module(node.module)
        for alias in node.names:
            getattr(mod, alias.name, None) or importlib.import_module(node.module + "." + alias.name)
from usdm_tpu_torch.audio.wav import write_wav
from usdm_tpu_torch.pipeline import UsdmPipeline
path = os.path.join({str(tmp_path)!r}, "u.wav")
write_wav(path, (np.random.default_rng(0).standard_normal(8000) * 0.1).astype(np.float32), 16000)
pipe = UsdmPipeline.tiny_random(device="cpu", lm_int8=True, vb_int8=True)
res = pipe.respond(path, os.path.join({str(tmp_path)!r}, "o.wav"), n_timesteps=2)
pipe.close()
assert isinstance(res.user_text, str)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_import_no_jax_package():
    """No .py under usdm_tpu_torch/ and not chip_smoke.py imports usdm_tpu or
    jax or optax, at any depth (imports inside functions included), nor the
    packages the card lacks and the port replaces: safetensors, tokenizers,
    transformers, ml_dtypes."""
    files = sorted(pathlib.Path(REPO, "usdm_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(REPO, "chip_smoke.py"))
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("usdm_tpu", "jax", "jaxlib", "optax", "safetensors",
                                           "tokenizers", "transformers", "ml_dtypes")]
    assert len(files) > 30 and not bad, bad


def test_cuda_request_without_card_raises(pipes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tpipe = pipes
    with pytest.raises(RuntimeError, match="CUDA"):
        UsdmPipeline(tpipe.tokenizer, tpipe.lm_params, tpipe.lm_cfg, tpipe.xlsr_params,
                     tpipe.xlsr_cfg, tpipe.decoder, device="cuda")
    with pytest.raises(RuntimeError):
        UsdmPipeline.tiny_random(device="cuda")


def test_entry_points_default_to_cuda(pipes):
    """Without a device argument the entry points ask for the card, so on a
    machine without CUDA they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tpipe = pipes
    with pytest.raises(RuntimeError, match="CUDA"):
        UsdmPipeline.tiny_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        UsdmPipeline.tiny_random(lm_int8=True, vb_int8=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        UsdmPipeline(tpipe.tokenizer, tpipe.lm_params, tpipe.lm_cfg, tpipe.xlsr_params,
                     tpipe.xlsr_cfg, tpipe.decoder)
    with pytest.raises(RuntimeError, match="CUDA"):
        UsdmPipeline.random_init(tpipe.tokenizer, tpipe.lm_cfg, tpipe.xlsr_cfg,
                                 tpipe.decoder.voicebox_cfg, tpipe.decoder.vocoder_cfg)


def test_unported_paths_raise(pipes):
    """Tensor-parallel serving is ported (tests/test_torch_tp.py), and
    make_server(tp=2) outside an initialized 2-rank group raises by name
    rather than serve on one device.  Speaker reference prompts and the
    dense dialog path run (tests/test_torch_reference.py,
    tests/test_torch_dense.py)."""
    _, tpipe = pipes
    with pytest.raises(RuntimeError, match="tp=2 needs an initialized 2-rank"):
        tpipe.make_server(tp=2)
