"""USDM tokenizer in pure Python: a Mistral-style BPE with the 10,003-token
speech extension, with no `tokenizers` dependency.

Port of usdm_tpu/core/tokenizer.py, which runs HF `tokenizers`.  The
reference vocabulary: base Mistral (32,000), then `<|continue|>`,
`<|correspond|>`, `<|unit0|>`..`<|unit9999|>`, `<pad>`.

`BpeTokenizer` reads a `tokenizer.json` and gives `tokenizers`' ids and
strings for `encode(text, add_special_tokens=False)` and `decode`, for what
it implements; anything else raises with its name, never approximated:

  * added tokens split out of the raw text first, leftmost-longest, those
    with `normalized: false` on the raw text, then those with
    `normalized: true` on each normalized piece (their patterns normalized
    too); `special` decides what decode(skip_special=True) drops;
    `single_word`, `lstrip` and `rstrip` raise;
  * normalizers `Sequence`, `Prepend` and `Replace` (string patterns): the
    legacy Mistral layout, Prepend("▁") + Replace(" " -> "▁"), which
    prepends "▁" to every piece between added tokens;
  * pre-tokenizer `Metaspace` (prepend_scheme always / first / never,
    split on "▁" merged with the next piece) or none;
  * the BPE model: vocab, merges applied by rank exactly as `tokenizers`
    orders them (lowest rank, then leftmost), `unk_token`, `fuse_unk`,
    `byte_fallback` (`<0xNN>` tokens), a per-word cache; dropout,
    `continuing_subword_prefix`, `end_of_word_suffix` and `ignore_merges`
    raise;
  * decoders `Sequence`, `Replace`, `ByteFallback` (invalid UTF-8 gives one
    U+FFFD a byte), `Fuse`, `Strip` and `Metaspace`.

The post-processor is kept for `save` and never applied: usdm_tpu encodes
with add_special_tokens=False and prepends BOS itself.

`UsdmTokenizer` adds usdm_tpu's rules on top: the specials appended when
missing, the TokenSpace (bos / eos / space fallbacks 1 / 2 / 28705, the
newline id = the last id of encode("\\n")), model_max_length from
tokenizer_config.json.  `build_test` and `build_synthetic_full` are
loaded tokenizers with no merges, with usdm_tpu's ids.
"""

from __future__ import annotations

import heapq
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from usdm_tpu_torch.core.config import TokenSpace

_METASPACE = "▁"
_BYTE_RE = re.compile(r"\+?[0-9A-Fa-f]+")
_CACHE_WORDS = 10000


def _unsupported(kind: str, spec: dict) -> ValueError:
    return ValueError(f"tokenizer.json: {kind} {spec.get('type')!r} is not supported")


def _string_pattern(kind: str, spec: dict) -> str:
    pattern = spec["pattern"]
    if set(pattern) != {"String"}:
        raise ValueError(f"tokenizer.json: {kind} Replace with a {list(pattern)} pattern is "
                         f"not supported (String only)")
    return pattern["String"]


def _normalizer_ops(spec: Optional[dict]) -> List[Tuple[str, str, str]]:
    if spec is None:
        return []
    kind = spec["type"]
    if kind == "Sequence":
        return [op for sub in spec["normalizers"] for op in _normalizer_ops(sub)]
    if kind == "Prepend":
        return [("prepend", spec["prepend"], "")]
    if kind == "Replace":
        return [("replace", _string_pattern("normalizer", spec), spec["content"])]
    raise _unsupported("normalizer", spec)


def _decoder_ops(spec: Optional[dict]) -> list:
    if spec is None:
        return []
    kind = spec["type"]
    if kind == "Sequence":
        return [op for sub in spec["decoders"] for op in _decoder_ops(sub)]
    if kind == "Replace":
        return [("replace", _string_pattern("decoder", spec), spec["content"])]
    if kind in ("ByteFallback", "Fuse"):
        return [(kind, None, None)]
    if kind == "Strip":
        return [("Strip", spec["content"], (spec["start"], spec["stop"]))]
    if kind == "Metaspace":
        return [("Metaspace", spec["replacement"], spec.get("prepend_scheme", "always"))]
    raise _unsupported("decoder", spec)


def _byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending: List[int] = []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend(["�"] * len(pending))
            pending.clear()

    for tok in tokens:
        mid = tok[3:5]
        if (len(tok.encode()) == 6 and tok.startswith("<0x") and tok.endswith(">")
                and _BYTE_RE.fullmatch(mid)):
            pending.append(int(mid, 16))
            continue
        flush()
        out.append(tok)
    flush()
    return out


def _strip(tok: str, content: str, start: int, stop: int) -> str:
    a, b = 0, len(tok)
    for i in range(min(start, len(tok))):
        if tok[i] != content:
            break
        a = i + 1
    for i in range(stop):
        j = len(tok) - i - 1
        if j < 0 or tok[j] != content:
            break
        b = j
    return tok[a:b]


class _Trie:
    """Leftmost-longest matching of a set of strings (aho-corasick's
    MatchKind::LeftmostLongest, as `tokenizers` splits added tokens)."""

    def __init__(self, patterns: Dict[str, int]):
        self.root: dict = {}
        for pat, tid in patterns.items():
            if not pat:
                continue
            node = self.root
            for ch in pat:
                node = node.setdefault(ch, {})
            node[None] = tid
        self._starts = (re.compile("[" + "".join(re.escape(c) for c in self.root) + "]")
                        if self.root else None)

    def split(self, s: str) -> List[Tuple[int, int, Optional[int]]]:
        """[(start, end, id or None)] covering s; empty pieces dropped."""
        out: List[Tuple[int, int, Optional[int]]] = []
        pos = 0
        i = 0
        while self._starts is not None:
            m = self._starts.search(s, i)
            if m is None:
                break
            i = m.start()
            node, j, best = self.root, i, None
            while j < len(s) and s[j] in node:
                node = node[s[j]]
                j += 1
                if None in node:
                    best = (j, node[None])
            if best is None:
                i += 1
                continue
            if pos < i:
                out.append((pos, i, None))
            out.append((i, best[0], best[1]))
            pos = i = best[0]
        if pos < len(s):
            out.append((pos, len(s), None))
        return out


class BpeTokenizer:
    """A `tokenizer.json` (as a dict) with `tokenizers`' encode/decode."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"tokenizer.json: {key} is not supported")
        model = spec["model"]
        if model.get("type") != "BPE":
            raise _unsupported("model", model)
        if model.get("dropout") not in (None, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise ValueError(f"tokenizer.json: BPE {key} is not supported")
        if model.get("ignore_merges"):
            raise ValueError("tokenizer.json: BPE ignore_merges is not supported")
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre.get("type") != "Metaspace":
            raise _unsupported("pre_tokenizer", pre)
        self._spec = spec
        self._norm = _normalizer_ops(spec.get("normalizer"))
        self._pre = pre
        self._dec = _decoder_ops(spec.get("decoder"))
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self._model_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_token = model.get("unk_token")
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges", [])):
            parts = m.split(" ") if isinstance(m, str) else list(m)
            if len(parts) != 2:
                raise ValueError(f"tokenizer.json: merge {rank + 1} is not a pair: {m!r}")
            a, b = parts
            for t in (a, b, a + b):
                if t not in self.vocab:
                    raise ValueError(f"tokenizer.json: merge {m!r} names {t!r}, which is not "
                                     f"in the vocab")
            self._merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._merges_raw = model.get("merges", [])
        self.added: Dict[str, int] = {}
        self._top: Optional[int] = None  # the largest added id
        self._added_r: Dict[int, dict] = {}
        self.special: set = set()
        self._cache: Dict[str, List[int]] = {}
        self._tries = None
        for tok in spec.get("added_tokens", []):
            for flag in ("single_word", "lstrip", "rstrip"):
                if tok.get(flag):
                    raise ValueError(f"tokenizer.json: added token {tok['content']!r} sets "
                                     f"{flag}, which is not supported")
            self.add_token(tok["content"], special=tok.get("special", False),
                           normalized=tok.get("normalized", not tok.get("special", False)),
                           want_id=tok.get("id"))

    # ---------------------------------------------------------- vocabulary
    def add_token(self, content: str, special: bool = True, normalized: bool = False,
                  want_id: Optional[int] = None) -> None:
        """tokenizers' add_tokens / add_special_tokens for one token: an id
        of the vocab or of an earlier added token is kept, else the next one
        past both; `want_id` (the file's) must agree."""
        if not content:
            return
        tid = self.token_to_id(content)
        if tid is None:
            top, n = self._top, len(self.vocab)
            tid = n if top is None or (top < n and n) else top + 1
        if want_id is not None and want_id != tid:
            raise ValueError(f"tokenizer.json: added token {content!r} has id {want_id}, "
                             f"tokenizers would give it {tid}")
        self.added[content] = tid
        self._top = tid if self._top is None else max(self._top, tid)
        self._added_r[tid] = {"id": tid, "content": content, "single_word": False,
                              "lstrip": False, "rstrip": False, "normalized": normalized,
                              "special": special}
        if special:
            self.special.add(content)
        self._tries = None

    def get_vocab(self) -> Dict[str, int]:
        return {**self.vocab, **self.added}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab.keys() | self.added.keys())

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added.get(token, self.vocab.get(token))

    def id_to_token(self, tid: int) -> Optional[str]:
        a = self._added_r.get(tid)
        return a["content"] if a is not None else self._model_tokens.get(tid)

    # -------------------------------------------------------------- encode
    def _normalize(self, s: str) -> str:
        for op, a, b in self._norm:
            if op == "prepend":
                s = a + s if s else s
            else:
                s = s.replace(a, b)
        return s

    def _trie_pair(self):
        if self._tries is None:
            raw = {c: i for c, i in self.added.items() if not self._added_r[i]["normalized"]}
            norm = {self._normalize(c): i for c, i in self.added.items()
                    if self._added_r[i]["normalized"]}
            self._tries = (_Trie(raw), _Trie(norm))
        return self._tries

    def _pre_tokenize(self, s: str, at_start: bool) -> List[str]:
        if self._pre is None:
            return [s]
        rep = self._pre["replacement"]
        s = s.replace(" ", rep)
        scheme = self._pre.get("prepend_scheme", "always")
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"tokenizer.json: Metaspace prepend_scheme {scheme!r} is not "
                             f"supported")
        if not s.startswith(rep) and (scheme == "always" or (scheme == "first" and at_start)):
            s = rep + s
        if not self._pre.get("split", True):
            return [s]
        words, cur = [], ""
        for ch in s:  # split on rep, merged with the next piece
            if ch == rep and cur:
                words.append(cur)
                cur = ""
            cur += ch
        if cur:
            words.append(cur)
        return words

    def _bpe(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids: List[int] = []
        lens: List[int] = []
        unk: Optional[List[int]] = None  # [id, byte length]
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk[0])
                    lens.append(unk[1])
                    unk = None
                ids.append(tid)
                lens.append(len(ch.encode()))
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode()]
                if all(c is not None for c in codes):
                    ids += codes
                    lens += [1] * len(codes)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f"tokenizer.json: unk_token {self.unk_token!r} is not in "
                                     f"the vocab")
                if unk is not None and self.fuse_unk:
                    unk[1] += len(ch.encode())
                else:
                    if unk is not None:
                        ids.append(unk[0])
                        lens.append(unk[1])
                    unk = [unk_id, len(ch.encode())]
        if unk is not None:
            ids.append(unk[0])
            lens.append(unk[1])
        out = self._merge_all(ids, lens)
        if len(self._cache) < _CACHE_WORDS:
            self._cache[word] = out
        return out

    def _merge_all(self, ids: List[int], lens: List[int]) -> List[int]:
        """tokenizers' Word::merge_all without dropout: a heap of (rank,
        position) merges; an entry whose pair no longer yields its token is
        skipped."""
        n = len(ids)
        prev = list(range(-1, n - 1))
        nxt = [i + 1 if i + 1 < n else -1 for i in range(n)]
        merges = self._merges
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                for m in [merges.get((ids[i], ids[i + 1]))] if m is not None]
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if lens[pos] == 0 or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            lens[pos] += lens[right]
            lens[right] = 0
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((ids[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, ln in zip(ids, lens) if ln]

    def encode(self, text: str) -> List[int]:
        """tokenizers' encode(text, add_special_tokens=False).ids."""
        raw, norm = self._trie_pair()
        ids: List[int] = []
        for start, end, tid in raw.split(text):
            if tid is not None:
                ids.append(tid)
                continue
            piece = self._normalize(text[start:end])
            for s2, e2, tid2 in norm.split(piece):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                for word in self._pre_tokenize(piece[s2:e2], start == 0 and s2 == 0):
                    ids += self._bpe(word)
        return ids

    # -------------------------------------------------------------- decode
    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        tokens = [t for t in (self.id_to_token(int(i)) for i in ids)
                  if t is not None and not (skip_special and t in self.special)]
        if not self._dec:
            return " ".join(tokens)
        for op, a, b in self._dec:
            if op == "replace":
                tokens = [t.replace(a, b) for t in tokens]
            elif op == "ByteFallback":
                tokens = _byte_fallback(tokens)
            elif op == "Fuse":
                tokens = ["".join(tokens)]
            elif op == "Strip":
                tokens = [_strip(t, a, *b) for t in tokens]
            else:  # Metaspace: the first token's replacements vanish unless "never"
                tokens = [t.replace(a, "" if i == 0 and b != "never" else " ")
                          for i, t in enumerate(tokens)]
        return "".join(tokens)

    # ---------------------------------------------------------------- save
    def to_json(self) -> dict:
        """The tokenizer.json dict, in the layout `tokenizers` writes."""
        model = {**self._spec["model"], "vocab": dict(sorted(self.vocab.items(),
                                                             key=lambda kv: kv[1])),
                 "merges": self._merges_raw}
        return {"version": "1.0", "truncation": None, "padding": None,
                "added_tokens": [self._added_r[i] for i in sorted(self._added_r)],
                "normalizer": self._spec.get("normalizer"),
                "pre_tokenizer": self._spec.get("pre_tokenizer"),
                "post_processor": self._spec.get("post_processor"),
                "decoder": self._spec.get("decoder"), "model": model}


def _specials(num_units: int) -> List[str]:
    return (["<|continue|>", "<|correspond|>"] + [f"<|unit{i}|>" for i in range(num_units)]
            + ["<pad>"])


def _char_spec(vocab: Dict[str, int]) -> dict:
    """A char-level BPE with no merges under Metaspace (prepend "first"), as
    usdm_tpu's build_test builds it."""
    meta = {"type": "Metaspace", "replacement": _METASPACE, "prepend_scheme": "first",
            "split": True}
    return {"added_tokens": [], "normalizer": None, "pre_tokenizer": meta,
            "post_processor": None, "decoder": dict(meta),
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": []}}


def _base_vocab() -> Dict[str, int]:
    chars = [chr(c) for c in range(32, 127)] + ["\n"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, _METASPACE: 3}
    for ch in chars:
        if ch not in vocab and ch != " ":
            vocab[ch] = len(vocab)
    return vocab


class UsdmTokenizer:
    def __init__(self, tok: BpeTokenizer, ts: TokenSpace, add_bos: bool = True,
                 model_max_length: int = 8192):
        self._tok = tok
        self.ts = ts
        self.add_bos = add_bos
        # per-stage decode budget for serving (the reference's
        # tokenizer.model_max_length)
        self.model_max_length = model_max_length

    @classmethod
    def load(cls, path: str, num_units: int = 10000) -> "UsdmTokenizer":
        """Load tokenizer.json from a directory or file and extend the vocab
        with the specials it lacks (usdm_tpu's UsdmTokenizer.load)."""
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        model_max_length = 8192
        cfg_path = os.path.join(os.path.dirname(path), "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                mml = json.load(f).get("model_max_length")
            if isinstance(mml, (int, float)) and 0 < mml < 1e9:  # HF's sentinel is ~1e30
                model_max_length = int(mml)
        with open(path, encoding="utf-8") as f:
            tok = BpeTokenizer(json.load(f))
        base = tok.vocab_size
        specials = _specials(num_units)
        vocab = tok.get_vocab()
        missing = [s for s in specials if s not in vocab]
        for s in missing:
            tok.add_token(s, special=True, normalized=False)
        base_vocab = base if missing else base - len(specials)
        space_id = tok.token_to_id(_METASPACE)
        bos, eos = tok.token_to_id("<s>"), tok.token_to_id("</s>")
        ts = TokenSpace(
            base_vocab_size=base_vocab,
            num_units=num_units,
            bos_id=bos if bos is not None else 1,
            eos_id=eos if eos is not None else 2,
            space_id=space_id if space_id is not None else 28705,
            newline_id=tok.encode("\n")[-1],
        )
        return cls(tok, ts, model_max_length=model_max_length)

    @classmethod
    def _char_level(cls, vocab: Dict[str, int], num_units: int) -> "UsdmTokenizer":
        tok = BpeTokenizer(_char_spec(vocab))
        for s in _specials(num_units):
            tok.add_token(s, special=True, normalized=False)
        ts = TokenSpace(base_vocab_size=len(vocab), num_units=num_units, bos_id=1, eos_id=2,
                        space_id=vocab[_METASPACE], newline_id=vocab["\n"])
        return cls(tok, ts)

    @classmethod
    def build_test(cls, num_units: int = 32) -> "UsdmTokenizer":
        """Same ids as usdm_tpu's build_test: a char-level BPE with no
        merges, <unk>/<s>/</s> at 0/1/2, a bare "▁", then the specials."""
        return cls._char_level(_base_vocab(), num_units)

    @classmethod
    def build_synthetic_full(cls, base_vocab_size: int = 32000,
                             num_units: int = 10000) -> "UsdmTokenizer":
        """Same ids as usdm_tpu's build_synthetic_full: the real 42,003-id
        geometry, the char-level base padded with filler tokens."""
        vocab = _base_vocab()
        i = 0
        while len(vocab) < base_vocab_size:
            vocab[f"<fill{i}>"] = len(vocab)
            i += 1
        return cls._char_level(vocab, num_units)

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        ids = self._tok.encode(text)
        add_bos = self.add_bos if add_bos is None else add_bos
        return ([self.ts.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        return self._tok.decode(ids, skip_special=skip_special)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def save(self, path: str) -> None:
        """tokenizer.json (read by `tokenizers` to the same ids) and
        token_space.json, as usdm_tpu writes them."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(self._tok.to_json(), f, ensure_ascii=False, indent=2)
        with open(os.path.join(path, "token_space.json"), "w") as f:
            json.dump(self.ts.__dict__, f, indent=2)
