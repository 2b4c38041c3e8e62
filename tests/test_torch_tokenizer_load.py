"""UsdmTokenizer.load (pure Python BPE) against usdm_tpu's, which runs HF
`tokenizers`, on tokenizer.json files the test writes.

Two Mistral layouts: the legacy one (normalizer Prepend("▁") + Replace(" "
-> "▁"), decoder Replace / ByteFallback / Fuse / Strip) and the Metaspace
one (pre-tokenizer prepend_scheme "first", Metaspace decoder); a BPE with
byte fallback, merges trained by `tokenizers` on a small corpus, fused
unknowns; the speech specials present or missing; normalized and raw added
tokens.  encode and decode must give `tokenizers`' ids and strings on every
`hypothesis` case; the TokenSpace must be equal; `save` must be read back by
`tokenizers` to the same ids.
"""

import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")

from usdm_tpu.core.tokenizer import UsdmTokenizer as JaxTokenizer  # noqa: E402
from usdm_tpu_torch.core.tokenizer import BpeTokenizer, UsdmTokenizer  # noqa: E402

MS = "▁"
CORPUS = ["hello world, how are you today?", "the quick brown fox jumps over the lazy dog",
          "i am fine thanks and you", "spoken dialog with speech units and text",
          "hello hello world world the the", "naïve café résumé"]
NUM_UNITS = 12
SPECIALS = (["<|continue|>", "<|correspond|>"] + [f"<|unit{i}|>" for i in range(NUM_UNITS)]
            + ["<pad>"])
# "hello" normalized (matched after normalization), "<extra>" raw and not special
ADDED = [("hello", True, False), ("<extra>", False, False)]


def _trained_bpe():
    """(vocab, merges) of a Mistral-shaped BPE: <unk>, <s>, </s>, the 256
    byte tokens, then what `tokenizers` trains on the "▁"-joined corpus."""
    from tokenizers import Tokenizer, models, trainers

    tok = Tokenizer(models.BPE())
    trainer = trainers.BpeTrainer(vocab_size=160, show_progress=False,
                                  initial_alphabet=list(MS + "abcdefghijklmnopqrstuvwxyz,?"))
    tok.train_from_iterator([MS + s.replace(" ", MS) for s in CORPUS], trainer)
    spec = json.loads(tok.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for t, _ in sorted(spec["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    return vocab, spec["merges"]


def _spec(layout: str, with_specials: bool) -> dict:
    vocab, merges = _trained_bpe()
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for c, i in
             (("<unk>", 0), ("<s>", 1), ("</s>", 2))]
    n = len(vocab)
    for c, normalized, special in ADDED:
        added.append({"id": n, "content": c, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": normalized, "special": special})
        n += 1
    if with_specials:
        for c in SPECIALS:
            added.append({"id": n, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True})
            n += 1
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": merges},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}}],
                               "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                        {"Sequence": {"id": "A", "type_id": 0}},
                                        {"Sequence": {"id": "B", "type_id": 1}}],
                               "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                                          "tokens": ["<s>"]}}}}
    if layout == "legacy":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": MS},
            {"type": "Replace", "pattern": {"String": " "}, "content": MS}]}
        spec["pre_tokenizer"] = None
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": MS}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    else:
        meta = {"type": "Metaspace", "replacement": MS, "prepend_scheme": "first",
                "split": True}
        spec["normalizer"] = None
        spec["pre_tokenizer"] = meta
        spec["decoder"] = dict(meta)
    return spec


CASES = [("legacy", True), ("legacy", False), ("metaspace", True), ("metaspace", False)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-{'specials' if b else 'missing'}"
                                                   for a, b in CASES])
def pair(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    (d / "tokenizer.json").write_text(json.dumps(_spec(*request.param), ensure_ascii=False))
    (d / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 4096}))
    return (JaxTokenizer.load(str(d), num_units=NUM_UNITS),
            UsdmTokenizer.load(str(d), num_units=NUM_UNITS), d)


TEXTS = ["hello world", "x<|unit5|>hello", "é", "naïve café\n", "\n", "", " ", "  a  b ",
         "<s>hi</s>", "<|unit3|><|unit11|><|correspond|>the dog\n### x", "hellohello",
         "<extra> hello<extra>", "\U0001F600 ok", "<|unit12|>", "a\tb\r\nc"]


def test_load_matches_tokenizers(pair):
    """Token space, sizes, model_max_length and the ids of fixed texts
    (specials, merges, byte fallback, normalized/raw added tokens)."""
    ref, tok, _ = pair
    assert tok.ts.__dict__ == ref.ts.__dict__
    assert tok.vocab_size == ref.vocab_size
    assert tok.model_max_length == ref.model_max_length == 4096
    for t in TEXTS:
        assert tok.encode(t) == ref.encode(t), t
        assert tok.encode(t, add_bos=False) == ref.encode(t, add_bos=False), t
    for c in SPECIALS + ["<unk>", "<s>", MS, "hello", "<extra>", "nope"]:
        assert tok.token_to_id(c) == ref.token_to_id(c), c


_ALPHABET = st.sampled_from(list("abcdefghilnorstuwy ,?!\n\t") + ["é", "ï", "한", "\U0001F600",
                                                                    MS, "<", ">", "|"])
_PIECES = st.one_of(st.text(_ALPHABET, max_size=12),
                    st.sampled_from(SPECIALS + ["<s>", "</s>", "<unk>", "hello", "<extra>",
                                                "<|unit99|>", "<|unit1"]))


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(pieces=st.lists(_PIECES, max_size=8))
def test_encode_decode_hypothesis(pair, pieces):
    """Random texts mixing specials, spaces, newlines and non-ASCII: the
    same ids; decode of those ids, with and without the specials, the same
    strings."""
    ref, tok, _ = pair
    text = "".join(pieces)
    ids = tok.encode(text, add_bos=False)
    assert ids == ref.encode(text, add_bos=False)
    for skip in (False, True):
        assert tok.decode(ids, skip_special=skip) == ref.decode(ids, skip_special=skip)


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(data=st.data())
def test_decode_any_ids(pair, data):
    """Any id sequence, byte tokens among them (invalid UTF-8 included) and
    ids past the vocab: the same strings as `tokenizers`."""
    ref, tok, _ = pair
    n = tok.vocab_size
    ids = data.draw(st.lists(st.one_of(st.integers(0, n + 2), st.integers(3, 3 + 255)),
                             max_size=16))
    for skip in (False, True):
        assert tok.decode(ids, skip_special=skip) == ref.decode(ids, skip_special=skip)


def test_save_read_back_by_tokenizers(pair, tmp_path):
    """save writes a tokenizer.json that `tokenizers` (and usdm_tpu's load)
    read to the same ids, and a token_space.json equal to usdm_tpu's."""
    from tokenizers import Tokenizer

    ref, tok, _ = pair
    tok.save(str(tmp_path / "ours"))
    ref.save(str(tmp_path / "theirs"))
    hf = Tokenizer.from_file(str(tmp_path / "ours" / "tokenizer.json"))
    for t in TEXTS:
        assert hf.encode(t, add_special_tokens=False).ids == tok.encode(t, add_bos=False), t
    assert hf.get_vocab_size() == tok.vocab_size
    assert (json.loads((tmp_path / "ours" / "token_space.json").read_text())
            == json.loads((tmp_path / "theirs" / "token_space.json").read_text()))
    back = JaxTokenizer.load(str(tmp_path / "ours"), num_units=NUM_UNITS)
    assert back.ts.__dict__ == tok.ts.__dict__


@pytest.mark.parametrize("builder", ["build_test", "build_synthetic_full"])
def test_char_level_builders_save(tmp_path, builder):
    """The char-level constructors write tokenizer.json files that
    `tokenizers` and the port's load read to the same ids."""
    from tokenizers import Tokenizer

    tok = getattr(UsdmTokenizer, builder)()
    ref = getattr(JaxTokenizer, builder)()
    tok.save(str(tmp_path))
    hf = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    back = UsdmTokenizer.load(str(tmp_path), num_units=tok.ts.num_units)
    assert back.ts.__dict__ == tok.ts.__dict__ == ref.ts.__dict__
    for t in TEXTS:
        ids = tok.encode(t, add_bos=False)
        assert ids == hf.encode(t, add_special_tokens=False).ids == back.encode(t, add_bos=False)
        assert back.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("edit,name", [
    (lambda s: s.update(normalizer={"type": "NFKC"}), "NFKC"),
    (lambda s: s.update(pre_tokenizer={"type": "ByteLevel"}), "ByteLevel"),
    (lambda s: s.update(decoder={"type": "WordPiece"}), "WordPiece"),
    (lambda s: s["model"].update(type="Unigram"), "Unigram"),
    (lambda s: s["model"].update(dropout=0.1), "dropout"),
    (lambda s: s["model"].update(continuing_subword_prefix="##"), "continuing_subword_prefix"),
    (lambda s: s["added_tokens"][3].update(lstrip=True), "lstrip"),
    (lambda s: s["added_tokens"][3].update(single_word=True), "single_word"),
    (lambda s: s.update(truncation={"max_length": 8}), "truncation"),
    (lambda s: s["normalizer"]["normalizers"][1].update(pattern={"Regex": " "}), "Regex"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_unsupported_raises_by_name(edit, name):
    spec = _spec("legacy", True)
    edit(spec)
    with pytest.raises(ValueError, match=name):
        BpeTokenizer(spec)
