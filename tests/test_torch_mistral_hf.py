"""The port's Mistral forward against HF transformers' MistralForCausalLM.

A second oracle beside usdm_tpu (tests/test_torch_models.py): a random-init
HF model built from a small config (3 layers, GQA 4/2, head 16), its state
dict converted by usdm_tpu's `convert_hf_state_dict` and carried into the
port by `bridge.mistral_from_jax`.  Both sides run in f32 on the CPU; the
port imports neither HF nor JAX, only this test does.

The port's (and usdm_tpu's) window lets a query see keys with
q_pos - k_pos <= sliding_window; HF's mask keeps q_pos - k_pos <
sliding_window, so the HF model is built with the port's window + 1.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

# Imported here, while the module is collected and before any test runs: a
# stub module without __spec__ (librosa, torchaudio) that another test module
# leaves in sys.modules makes transformers' import-time package probe
# (importlib.util.find_spec) raise, and transformers keeps the probe's answer
# from its first import.
transformers = pytest.importorskip("transformers")

from usdm_tpu.core.config import MistralConfig  # noqa: E402
from usdm_tpu.models import mistral as JLM  # noqa: E402
from usdm_tpu_torch.core import bridge  # noqa: E402
from usdm_tpu_torch.core import config as C  # noqa: E402
from usdm_tpu_torch.models import mistral as LM  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # f32 logits of O(1) on both sides, other summation orders


def _cfg(window: int) -> MistralConfig:
    return MistralConfig.tiny(vocab_size=128).replace(num_layers=3, sliding_window=window)


def _models(cfg: MistralConfig):
    """(HF model, the port's params from its state dict, the port's config)."""
    hf_cfg = transformers.MistralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, max_position_embeddings=cfg.max_seq_len,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window + 1, attention_dropout=0.0,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.MistralForCausalLM(hf_cfg).eval()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jparams = JLM.convert_hf_state_dict(state, cfg, dtype="float32")
    params = bridge.mistral_from_jax(jax.device_get(jparams))
    return hf, params, C.MistralConfig.from_dict(dataclasses.asdict(cfg))


def _hf_logits(hf, ids: np.ndarray, mask: np.ndarray = None) -> np.ndarray:
    with torch.no_grad():
        return hf(torch.from_numpy(ids),
                  attention_mask=None if mask is None else torch.from_numpy(mask)).logits.numpy()


def test_port_forward_matches_hf_full_attention():
    """T 24 inside a 64-token window: every query sees every earlier key."""
    cfg = _cfg(64)
    hf, params, pcfg = _models(cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 24))
    got = LM.forward(params, pcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, ids), **TOL)


def test_port_forward_matches_hf_within_window():
    """T 40 against a window of 8: the late queries see only their last 9
    keys, on both sides; an early token changes the first logits and not
    the last ones."""
    cfg = _cfg(8)
    hf, params, pcfg = _models(cfg)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 40))
    got = LM.forward(params, pcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _hf_logits(hf, ids), **TOL)
    ids2 = ids.copy()
    ids2[:, 0] = (ids2[:, 0] + 1) % cfg.vocab_size
    moved = LM.forward(params, pcfg, torch.from_numpy(ids2)).numpy()
    assert np.abs(moved[:, 1] - got[:, 1]).max() > 1e-4
    # 3 layers of a window of 8 reach back 24 positions
    np.testing.assert_allclose(moved[:, 30:], got[:, 30:], rtol=1e-5, atol=1e-5)


def test_port_forward_matches_hf_right_padding():
    """Right-padded rows: HF takes an attention mask, the port segment id -1
    on the padding; the logits of the valid positions agree."""
    cfg = _cfg(16)
    hf, params, pcfg = _models(cfg)
    t, lens = 32, np.asarray([32, 19])
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, t))
    valid = np.arange(t)[None] < lens[:, None]
    seg = np.where(valid, 0, -1).astype(np.int32)
    got = LM.forward(params, pcfg, torch.from_numpy(ids), torch.from_numpy(seg)).numpy()
    want = _hf_logits(hf, ids, valid.astype(np.int64))
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    # the short row's valid logits are those of the row alone
    alone = _hf_logits(hf, ids[1:, :lens[1]])
    np.testing.assert_allclose(got[1, :lens[1]], alone[0], **TOL)
