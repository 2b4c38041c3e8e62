"""usdm_tpu_torch tokenizer, sampling and unit helpers against usdm_tpu.

The port's pure-Python tokenizer must give the HF-`tokenizers`-backed
UsdmTokenizer's ids and strings exactly, on the dialog templates and on the
Metaspace corner cases (prefix after a special token, newlines, leading
spaces).  Sampling is held to the JAX sampler with the JAX sampler's own
Gumbel noise injected.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usdm_tpu.audio import units as JU
from usdm_tpu.core.tokenizer import UsdmTokenizer as JaxTokenizer
from usdm_tpu.engine.dialog import default_template as jax_template
from usdm_tpu.ops import sampling as JS
from usdm_tpu_torch.audio import units as U
from usdm_tpu_torch.core.tokenizer import UsdmTokenizer
from usdm_tpu_torch.engine.dialog import default_template
from usdm_tpu_torch.ops import sampling as S

TEXTS = [
    "hello world", " leading", "  two spaces", "tail ", "a  b", "a\nb", "\n", "", " ",
    "é ü", "<pad>", "<|unit1|> x", "<|correspond|>  y ", "x<|correspond|>\n",
    "<|unit3|><|unit4|><|correspond|>hi there\n### Agent\n", "<|unit99999|>", "<s></s>",
    "<|continue|>a<|unit0|>", "~!@#$%^&*()_+{}|:\"<>?`-=[]\\;',./",
]


@pytest.fixture(scope="module", params=["test", "full"])
def tokenizers(request):
    if request.param == "test":
        return JaxTokenizer.build_test(num_units=32), UsdmTokenizer.build_test(num_units=32)
    return JaxTokenizer.build_synthetic_full(), UsdmTokenizer.build_synthetic_full()


def _dialog_prompts():
    units = "".join(f"<|unit{u}|>" for u in (3, 17, 0, 31, 5))
    return [jax_template(units), jax_template(units, user_text="hi there"),
            jax_template(units, user_text=" hi", agent_text="fine, thanks \n")]


def test_token_space_and_vocab(tokenizers):
    ref, tok = tokenizers
    # the same fields (the port keeps its own TokenSpace class)
    assert type(tok.ts).__module__.startswith("usdm_tpu_torch")
    assert dataclasses.asdict(tok.ts) == dataclasses.asdict(ref.ts)
    assert tok.vocab_size == ref.vocab_size
    for t in ("<unk>", "▁", "\n", "a", "<|correspond|>", "<|unit5|>", "<pad>"):
        assert tok.token_to_id(t) == ref.token_to_id(t)


@pytest.mark.parametrize("text", TEXTS + _dialog_prompts())
def test_encode_decode_match(tokenizers, text):
    ref, tok = tokenizers
    for add_bos in (True, False):
        ids = tok.encode(text, add_bos=add_bos)
        assert ids == ref.encode(text, add_bos=add_bos)
        assert tok.decode(ids) == ref.decode(ids)
        assert tok.decode(ids, skip_special=True) == ref.decode(ids, skip_special=True)


def test_decode_generated_ids_match(tokenizers, rng):
    """Arbitrary id streams, as a random LM emits them."""
    ref, tok = tokenizers
    for _ in range(20):
        ids = rng.integers(0, ref.vocab_size, size=int(rng.integers(1, 30))).tolist()
        assert tok.decode(ids) == ref.decode(ids)


def test_templates_match():
    units = "".join(f"<|unit{u}|>" for u in (1, 2))
    for kw in ({}, {"user_text": "a b"}, {"user_text": "a", "agent_text": "b c"}):
        assert default_template(units, **kw) == jax_template(units, **kw)


@pytest.mark.parametrize("stage", [S.STAGE_UNIT2TEXT, S.STAGE_TEXT2TEXT, S.STAGE_TEXT2UNIT])
def test_stage_masks_match(tokenizers, stage):
    ref, tok = tokenizers
    np.testing.assert_array_equal(S.stage_allow_mask(stage, tok.ts),
                                  JS.stage_allow_mask(stage, ref.ts))
    assert S.stage_eos(stage, tok.ts) == JS.stage_eos(stage, ref.ts)


@pytest.mark.parametrize("top_k,top_p,temp", [(1, 1.0, 1.0), (0, 0.9, 0.7), (5, 1.0, 1.3),
                                              (5, 0.5, 1.0), (0, 1.0, 1.0)])
def test_sample_batched_matches_jax(rng, top_k, top_p, temp):
    """jax.random.categorical(key, x) == argmax(x + gumbel(key)): feeding the
    port the same Gumbel noise must give the JAX sampler's tokens."""
    b, v = 4, 50
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    logits[:, 40:] = S.NEG_INF  # a stage mask
    keys = jax.random.split(jax.random.PRNGKey(int(rng.integers(1 << 30))), b)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (v,), jnp.float32)) for k in keys])
    tk = np.full(b, top_k, np.int32)
    tp = np.full(b, top_p, np.float32)
    tm = np.full(b, temp, np.float32)
    want = JS.sample_batched(jnp.asarray(logits), keys, jnp.asarray(tk), jnp.asarray(tp),
                             jnp.asarray(tm))
    got = S.sample_batched(torch.from_numpy(logits), torch.from_numpy(noise),
                           torch.from_numpy(tk), torch.from_numpy(tp), torch.from_numpy(tm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_units_helpers_match(rng):
    units = rng.integers(0, 10000, size=37).tolist()
    s = U.units_to_string(units)
    assert s == JU.units_to_string(units)
    assert U.parse_units("x" + s + " <|unit3|>") == JU.parse_units("x" + s + " <|unit3|>")
    rows = rng.integers(0, 4, size=(64, 9))  # many ties: smallest value wins
    np.testing.assert_array_equal(U.rowwise_mode(rows), np.asarray(JU.rowwise_mode(rows)))
    for n in (0, 1, 5, 60):
        u = rng.integers(0, 100, size=n)
        got, n_got = U.expand_and_pool(u)
        want, n_want = JU.expand_and_pool(u)
        np.testing.assert_array_equal(got, want)
        assert n_got == n_want
