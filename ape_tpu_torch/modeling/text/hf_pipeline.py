"""The ``tokenizer.json`` pipeline as ``tokenizers`` runs it and a
``transformers`` fast tokenizer wraps it, shared by the BPE model (``bpe``,
Llama-2) and the Unigram model (``unigram``, T5 and mT5):

1. the added tokens split out of the raw text (``AddedVocabulary``): those
   with ``normalized`` false first, leftmost-longest; each other piece
   normalized, then the ``normalized`` ones split out of it, their content
   normalized as a piece is;
2. the normalizers: ``Sequence``, ``Prepend``, ``Replace`` (a string, or a
   ``{"Regex": ...}`` of literal characters each with a greedy quantifier
   of at least one), ``Strip`` and ``Precompiled`` (``charsmap``);
3. the pre-tokenizers: ``Sequence``, ``WhitespaceSplit`` and ``Metaspace``
   (``prepend_scheme`` always, first or never, and ``split``; the older
   ``add_prefix_space`` form reads as always);
4. the model on each piece the pre-tokenizers leave (``tokenize_word``);
5. the ``TemplateProcessing`` post-processor, single and pair (the Llama
   classes rebuild it from ``add_bos_token``/``add_eos_token``);
6. padding on the tokenizer's side with its pad token.

``Metaspace``'s "first" scheme prepends only to a piece that starts at
offset 0 of the original text, so each piece carries, for every character,
the offset of the original character it aligns to, moved through every
normalizer as ``NormalizedString::transform_range`` moves it.

``tokenizer_config.json`` (and, without an ``added_tokens_decoder`` there,
``special_tokens_map.json``) adds what ``transformers`` adds on top: the
class's default special tokens (T5's ``</s>``, ``<unk>``, ``<pad>`` and its
``extra_ids`` ``<extra_id_*>``; Llama's ``<unk>``, ``<s>``, ``</s>``), the
named and additional special tokens, and the tokens of its
``added_tokens_decoder``: a token that ``tokenizer.json`` lacks is added at
its vocabulary id or else at the next free id, as ``AddedVocabulary``
numbers it (the ids written in ``tokenizer.json`` are not read, as
``tokenizers`` does not read them). Any other type, flag or option raises
``NotImplementedError`` naming it; nothing is approximated.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ape_tpu_torch.modeling.text.charsmap import Charsmap
from ape_tpu_torch.modeling.text.hf_files import (
    pad_batch,
    read_config,
    read_json,
    read_tokenizer_config,
)

# Rust's char::is_whitespace (Unicode White_Space): WhitespaceSplit and Strip
WHITESPACE = frozenset(map(chr, [*range(9, 14), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                                  0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
# the tokenizer class a directory's model_type selects where
# tokenizer_config.json names none (AutoTokenizer's table)
CLASS_OF_MODEL_TYPE = {"llama": "LlamaTokenizer", "t5": "T5Tokenizer", "mt5": "MT5Tokenizer"}
# the classes whose padding_side defaults to "left" and that rebuild the
# post-processor from add_bos_token/add_eos_token (transformers 4.57)
LLAMA_CLASSES = {"LlamaTokenizer", "CodeLlamaTokenizer"}
T5_CLASSES = {"T5Tokenizer", "MT5Tokenizer"}
# each class's default special tokens (its __init__'s defaults)
_CLASS_SPECIAL = {"LlamaTokenizer": {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"},
                  "T5Tokenizer": {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}}
_CLASS_SPECIAL["CodeLlamaTokenizer"] = _CLASS_SPECIAL["LlamaTokenizer"]
_CLASS_SPECIAL["MT5Tokenizer"] = _CLASS_SPECIAL["T5Tokenizer"]
# CodeLlama's infilling tokens, appended to its additional special tokens
_CODE_LLAMA_TOKENS = (("prefix_token", "▁<PRE>"), ("middle_token", "▁<MID>"),
                      ("suffix_token", "▁<SUF>"), ("eot_token", "▁<EOT>"))
SPECIAL_ATTRIBUTES = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                      "mask_token")
_FLAGS = ("single_word", "lstrip", "rstrip", "normalized", "special")
_UNREAD_FLAGS = ("single_word", "lstrip", "rstrip")


def refuse(what: str, value) -> None:
    raise NotImplementedError(f"tokenizer.json: {what} {value!r} is not supported (the port reads "
                              "the BPE and Unigram models with the normalizers, pre-tokenizers "
                              "and post-processor its hf_pipeline module names)")


# ----------------------------------------------------------------------
# A piece of text with its alignment to the original
# ----------------------------------------------------------------------

class Piece:
    """A piece of normalized text: ``starts[i]``, the offset in the
    original text of the character that character ``i`` aligns to, and
    ``shift``, the offset the piece was cut at (``original_shift``)."""

    __slots__ = ("text", "starts", "shift")

    def __init__(self, text: str, starts: List[int], shift: int):
        self.text, self.starts, self.shift = text, starts, shift

    @classmethod
    def of(cls, text: str, shift: int = 0) -> "Piece":
        return cls(text, list(range(shift, shift + len(text))), shift)

    def slice(self, i: int, j: int) -> "Piece":
        return Piece(self.text[i:j], self.starts[i:j], self.starts[i])

    def transform(self, dest: Sequence[Tuple[str, int]]) -> "Piece":
        """``transform_range`` over the whole piece: each (character,
        change) of ``dest`` takes the alignment of the character it replaces
        (change <= 0, ``-change`` more removed after it) or of the one before
        (change > 0, inserted)."""
        old, pos = self.starts, 0
        starts = []
        for _, change in dest:
            if change > 0:
                starts.append(old[pos - 1] if pos >= 1 else self.shift)
            else:
                starts.append(old[pos])
                pos += 1 - change
        return Piece("".join(c for c, _ in dest), starts, self.shift)

    def replace(self, spans: Sequence[Tuple[int, int]], content: str) -> "Piece":
        """Each (start, end) span replaced by ``content``, whose characters
        take the alignment of the span's last one (``NormalizedString::
        replace``)."""
        if not spans:
            return self
        text, starts, last = [], [], 0
        for s, e in spans:
            text.append(self.text[last:s] + content)
            starts += self.starts[last:s] + [self.starts[e - 1]] * len(content)
            last = e
        text.append(self.text[last:])
        starts += self.starts[last:]
        return Piece("".join(text), starts, self.shift)

    def prepend(self, s: str) -> "Piece":
        if not self.text:
            return self
        return Piece(s + self.text, [self.starts[0]] * len(s) + self.starts, self.shift)


# ----------------------------------------------------------------------
# Normalizers
# ----------------------------------------------------------------------

_QUANTIFIED = re.compile(r"(?:[^\\^$.|?*+()\[\]{}]|\\[^0-9A-Za-z])"  # a literal or \punctuation
                         r"(?:\+|\{[1-9][0-9]*(?:,[0-9]*)?\})?")  # +, {m}, {m,} or {m,n}, m >= 1


def _regex(pattern: str) -> "re.Pattern":
    """A ``Replace`` regex the port reads: literal characters (or escaped
    punctuation), each with at most a greedy quantifier whose minimum is at
    least 1, so that Oniguruma and ``re`` find the same matches and none is
    empty (``Regex(" {2,}")``, T5Converter's, among them)."""
    if not pattern or _QUANTIFIED.sub("", pattern):
        refuse("Replace pattern Regex", pattern)
    for lo, hi in re.findall(r"\{([0-9]+),([0-9]*)\}", pattern):
        if hi and int(hi) < int(lo):
            refuse("Replace pattern Regex", pattern)
    return re.compile(pattern)


def _spans(pattern, text: str) -> List[Tuple[int, int]]:
    if isinstance(pattern, str):  # a string: its non-overlapping occurrences
        out, i = [], text.find(pattern) if pattern else -1
        while i >= 0:
            out.append((i, i + len(pattern)))
            i = text.find(pattern, i + len(pattern))
        return out
    return [m.span() for m in pattern.finditer(text)]


def _strip(piece: Piece, left: bool, right: bool) -> Piece:
    text = piece.text
    i, j = 0, len(text)
    while left and i < j and text[i] in WHITESPACE:
        i += 1
    while right and j > i and text[j - 1] in WHITESPACE:
        j -= 1
    if i == 0 and j == len(text):
        return piece
    return Piece(text[i:j], piece.starts[i:j], piece.shift)


def normalizers(spec) -> List[Callable[[Piece], Piece]]:
    """The steps of a ``normalizer`` spec, in order."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for sub in spec["normalizers"] for step in normalizers(sub)]
    if kind == "Prepend":
        return [lambda p, s=spec["prepend"]: p.prepend(s)]
    if kind == "Replace":
        pat = spec["pattern"]
        if set(pat) == {"String"}:
            pattern = pat["String"]
        elif set(pat) == {"Regex"}:
            pattern = _regex(pat["Regex"])
        else:
            refuse("normalizer", f"Replace {pat}")
        return [lambda p, pt=pattern, c=spec["content"]: p.replace(_spans(pt, p.text), c)]
    if kind == "Strip":
        return [lambda p, lr=(bool(spec["strip_left"]), bool(spec["strip_right"])): _strip(p, *lr)]
    if kind == "Precompiled":
        cmap = Charsmap.from_base64(spec["precompiled_charsmap"])

        def precompiled(p: Piece) -> Piece:
            dest = cmap.transformations(p.text)
            return p if dest is None else p.transform(dest)

        return [precompiled]
    refuse("normalizer", kind)


def normalize(steps, piece: Piece) -> Piece:
    for step in steps:
        piece = step(piece)
    return piece


# ----------------------------------------------------------------------
# Pre-tokenizers
# ----------------------------------------------------------------------

def _whitespace_split(piece: Piece) -> List[Piece]:
    out, start = [], None
    for i, c in enumerate(piece.text):
        if c in WHITESPACE:
            if start is not None:
                out.append(piece.slice(start, i))
                start = None
        elif start is None:
            start = i
    if start is not None:
        out.append(piece.slice(start, len(piece.text)))
    return out


def _metaspace(spec) -> Callable[[Piece], List[Piece]]:
    rep = spec["replacement"]
    if len(rep) != 1:
        refuse("Metaspace replacement", rep)
    scheme = spec.get("prepend_scheme", "always")
    if scheme not in ("always", "first", "never"):
        refuse("Metaspace prepend_scheme", scheme)
    if "add_prefix_space" in spec and spec["add_prefix_space"] != (scheme != "never"):
        raise ValueError("tokenizer.json: Metaspace add_prefix_space does not match its "
                         f"prepend_scheme {scheme!r}")
    split = spec.get("split", True)

    def metaspace(piece: Piece) -> List[Piece]:
        piece = piece.replace(_spans(" ", piece.text), rep)
        if not piece.text.startswith(rep) and (
                scheme == "always" or (scheme == "first" and piece.shift == 0)):
            piece = piece.prepend(rep)
        if not split:
            return [piece]
        cuts = [i for i, c in enumerate(piece.text) if c == rep and i] + [len(piece.text)]
        return [piece.slice(a, b) for a, b in zip([0] + cuts, cuts) if a < b]

    return metaspace


def pre_tokenizers(spec) -> List[Callable[[Piece], List[Piece]]]:
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for sub in spec["pretokenizers"] for step in pre_tokenizers(sub)]
    if kind == "WhitespaceSplit":
        return [_whitespace_split]
    if kind == "Metaspace":
        return [_metaspace(spec)]
    refuse("pre-tokenizer", kind)


# ----------------------------------------------------------------------
# The tokenizer
# ----------------------------------------------------------------------

def _content(token) -> str:
    return token["content"] if isinstance(token, dict) else token


def _flags(token: dict) -> tuple:
    """The ``_FLAGS`` of an ``AddedToken`` dict, with ``AddedToken``'s
    defaults (``normalized`` is ``not special``)."""
    special = bool(token.get("special", False))
    return tuple(bool(token.get(f, not special if f == "normalized" else False))
                 for f in _FLAGS[:-1]) + (special,)


def _template(spec, which: str, ids_of: Dict[str, List[int]]) -> List:
    """A template (``single`` or ``pair``): a list of token ids and "A" or
    "B" (the texts' ids)."""
    out = []
    for item in spec[which]:
        if "Sequence" in item:
            out.append(item["Sequence"]["id"])
        else:
            out.extend(ids_of[item["SpecialToken"]["id"]])
    return out


def read_dir(path) -> tuple:
    """(``tokenizer.json``, the tokenizer config with its special tokens
    as the files give them, ``config.json``'s model_type or None) of the
    directory ``path``."""
    d = Path(path)
    model_type = read_config(d).get("model_type") if (d / "config.json").is_file() else None
    return read_json(d / "tokenizer.json"), read_tokenizer_config(d, flatten=False), model_type


class HFTokenizer:
    """The pipeline of a ``tokenizer.json`` spec under its directory's
    ``tokenizer_config.json`` (``config``; special tokens as strings or as
    ``AddedToken`` dicts) and ``config.json``'s ``model_type``. A subclass
    reads the model: ``MODEL`` names its type, ``read_model`` sets
    ``vocab`` (token -> id), ``vocab_size`` and ``unk_token``, and
    ``tokenize_word`` gives the ids of one piece."""

    MODEL = ""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 model_type: Optional[str] = None):
        config = dict(config or {})
        model = spec["model"]
        if model.get("type") != self.MODEL:
            refuse("model", model.get("type"))
        self.vocab: Dict[str, int] = {}
        self.vocab_size = 0
        self.unk_token: Optional[str] = None
        self.read_model(model)
        self.normalizers = normalizers(spec.get("normalizer"))
        self.pre_tokenizers = pre_tokenizers(spec.get("pre_tokenizer"))
        if config.get("split_special_tokens"):
            refuse("tokenizer_config.json split_special_tokens", True)
        if config.get("extra_special_tokens"):
            refuse("tokenizer_config.json extra_special_tokens", config["extra_special_tokens"])
        if config.get("add_prefix_space") is not None or config.get("from_slow"):
            refuse("add_prefix_space or from_slow (a conversion from the slow tokenizer)",
                   config.get("add_prefix_space", config.get("from_slow")))

        # the added vocabulary: tokenizer.json's, then transformers' additions
        self.added: Dict[str, int] = {}
        self.added_flags: Dict[str, tuple] = {}
        for tok in spec.get("added_tokens", []):
            self._add(tok["content"], _flags(tok))
        cls = config.get("tokenizer_class") or CLASS_OF_MODEL_TYPE.get(model_type or "", "")
        cls = cls[: -len("Fast")] if cls.endswith("Fast") else cls
        named, additional = self._special_tokens(cls, config, spec.get("padding"))
        self._add_config_tokens(config, named, additional)
        special = {k: None if v is None else _content(v) for k, v in named.items()}
        self._split_raw = self._matcher(False)
        self._split_normalized = self._matcher(True)

        if cls in LLAMA_CLASSES:
            bos, eos = special.get("bos_token"), special.get("eos_token")
            add_bos, add_eos = config.get("add_bos_token", True), config.get("add_eos_token", False)
            if (add_bos and bos is None) or (add_eos and eos is None):
                raise ValueError("add_bos_token/add_eos_token set without the token")
            single = (([self.token_id(bos)] if add_bos else []) + ["A"]
                      + ([self.token_id(eos)] if add_eos else []))
            self.template = {"single": single,
                             "pair": single + [x if x != "A" else "B" for x in single]}
        else:
            post = spec.get("post_processor")
            if post is None:
                self.template = {"single": ["A"], "pair": ["A", "B"]}
            elif post.get("type") != "TemplateProcessing":
                refuse("post-processor", post.get("type"))
            else:
                ids_of = {k: v["ids"] for k, v in post["special_tokens"].items()}
                self.template = {w: _template(post, w, ids_of) for w in ("single", "pair")}
        padding = spec.get("padding") or {}
        self.padding_side = (config.get("padding_side") or padding.get("direction", "").lower()
                             or ("left" if cls in LLAMA_CLASSES else "right"))
        pad = special.get("pad_token")
        self.pad_id = None if pad is None else self.token_id(pad)

    @classmethod
    def from_dir(cls, path) -> "HFTokenizer":
        """The tokenizer of the directory ``path`` (``read_dir``)."""
        return cls(*read_dir(path))

    # -- the model (a subclass's) ---------------------------------------
    def read_model(self, model: dict) -> None:
        raise NotImplementedError

    def tokenize_word(self, word: str) -> List[int]:
        raise NotImplementedError

    # -- the added vocabulary -------------------------------------------
    def _add(self, content: str, flags: tuple) -> None:
        """``AddedVocabulary::add_tokens`` for one token: its flags must be
        ones the port reads; its id is the one it already has, else its
        vocabulary id, else the next free one."""
        for name, on in zip(_FLAGS, flags):
            if on and name in _UNREAD_FLAGS:
                refuse(f"added token {content!r} with {name}", True)
        if not content:
            return
        if content in self.added:  # added again: only its special flag may change
            if self.added_flags[content][:-1] != flags[:-1]:
                refuse(f"added token {content!r} added again with other flags", flags)
            self.added_flags[content] = flags
            return
        if content in self.vocab:
            self.added[content] = self.vocab[content]
        else:
            top = max(self.added.values(), default=None)
            self.added[content] = (self.vocab_size if top is None
                                   else top + 1 if top >= self.vocab_size or not self.vocab_size
                                   else self.vocab_size)
        self.added_flags[content] = flags

    def _special_tokens(self, cls: str, config: dict, padding: Optional[dict]) -> tuple:
        """(named, additional): the named special tokens ({attribute:
        token}) and the additional ones, strings or ``AddedToken`` dicts,
        as the class's ``__init__`` sets them: the config's, else the
        class's defaults, else ``tokenizer.json``'s pad token."""
        defaults = dict(_CLASS_SPECIAL.get(cls, {}))
        if padding and "pad_token" not in defaults:
            defaults["pad_token"] = padding.get("pad_token")
        named = {k: (config[k] if k in config else defaults.get(k)) for k in SPECIAL_ATTRIBUTES}
        additional = list(config.get("additional_special_tokens") or [])
        if cls in T5_CLASSES:
            extra_ids = config.get("extra_ids", 100)
            if config.get("additional_special_tokens") is None:
                additional = [f"<extra_id_{i}>" for i in range(extra_ids)]
            else:
                extra = [t for t in additional if "<extra_id_" in _content(t)]
                if not extra:
                    additional += [f"<extra_id_{i}>" for i in range(extra_ids)]
                elif extra_ids > 0 and extra_ids != len(extra):
                    raise ValueError(f"extra_ids ({extra_ids}) and additional_special_tokens "
                                     f"({len(extra)} <extra_id_*>) disagree, as T5Tokenizer "
                                     "refuses them")
        elif cls == "CodeLlamaTokenizer":
            additional += [config.get(k, v) for k, v in _CODE_LLAMA_TOKENS
                           if config.get(k, v) is not None]
        return named, additional

    def _add_config_tokens(self, config: dict, named: dict, additional: list) -> None:
        """``PreTrainedTokenizerFast.__init__``'s additions: the config's
        ``added_tokens_decoder`` entries that ``tokenizer.json`` does not
        hold as they are, then every special token it does not hold (one
        given as an ``AddedToken`` dict is added again as it stands)."""
        values = [v for v in named.values() if v is not None] + additional
        names = {_content(v) for v in values}
        for _, tok in sorted((config.get("added_tokens_decoder") or {}).items(),
                             key=lambda kv: int(kv[0])):
            flags = _flags(tok)
            if self.added_flags.get(tok["content"]) != flags:
                self._add(tok["content"], flags[:-1] + (flags[-1] or tok["content"] in names,))
        seen = set()
        for value in values:
            name = _content(value)
            if name in seen:
                continue
            seen.add(name)
            if isinstance(value, dict):
                self._add(name, _flags(value)[:-1] + (True,))
            elif name not in self.added:
                self._add(name, (False, False, False, False, True))

    def _matcher(self, normalized: bool) -> tuple:
        """(the leftmost-longest alternation, {match: id}) of the added
        tokens whose ``normalized`` flag is ``normalized``, their content
        normalized where it is."""
        ids_of: Dict[str, int] = {}
        for t, flags in self.added_flags.items():
            if flags[3] == normalized:
                key = normalize(self.normalizers, Piece.of(t)).text if normalized else t
                if key:
                    ids_of.setdefault(key, self.added[t])
        if not ids_of:
            return None, ids_of
        return re.compile("|".join(re.escape(t) for t in sorted(ids_of, key=len, reverse=True))
                          ), ids_of

    def token_id(self, token: str) -> int:
        """``convert_tokens_to_ids``: the added vocabulary, the model's,
        else the unknown token's id."""
        if token in self.added:
            return self.added[token]
        if token in self.vocab:
            return self.vocab[token]
        if self.unk_token is None:
            raise KeyError(f"token {token!r} is not in the vocabulary and there is no unk token")
        return self.token_id(self.unk_token)

    # -- encoding -------------------------------------------------------
    @staticmethod
    def _split(piece: Piece, matcher: tuple) -> list:
        """``split_with_indices``: the piece cut around each match, a match
        as its token id, the rest as pieces (no empty one)."""
        pattern, ids_of = matcher
        if pattern is None:
            return [piece] if piece.text else []
        out, last = [], 0
        for m in pattern.finditer(piece.text):
            if last < m.start():
                out.append(piece.slice(last, m.start()))
            out.append(ids_of[m.group()])
            last = m.end()
        if last < len(piece.text):
            out.append(piece.slice(last, len(piece.text)))
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        """The text's ids before the template."""
        ids: List[int] = []
        for part in self._split(Piece.of(text), self._split_raw):
            if isinstance(part, int):
                ids.append(part)
                continue
            part = normalize(self.normalizers, part)
            if not part.text:
                continue
            for sub in self._split(part, self._split_normalized):
                if isinstance(sub, int):
                    ids.append(sub)
                    continue
                pieces = [sub]
                for pre in self.pre_tokenizers:
                    pieces = [q for p in pieces for q in pre(p) if q.text]
                for p in pieces:
                    ids.extend(self.tokenize_word(p.text))
        return ids

    def encode(self, text: str, pair: Optional[str] = None) -> List[int]:
        seqs = {"A": self.tokenize_ids(text)}
        if pair is not None:
            seqs["B"] = self.tokenize_ids(pair)
        out: List[int] = []
        for item in self.template["single" if pair is None else "pair"]:
            if isinstance(item, str):
                out.extend(seqs[item])
            else:
                out.append(item)
        return out

    def __call__(self, texts: Sequence[str], pairs: Optional[Sequence[str]] = None,
                 padding: str = "longest", max_length: Optional[int] = None,
                 truncation: bool = False) -> Dict[str, np.ndarray]:
        """The batch of ``tokenizer(texts[, pairs], padding=...)``:
        ``input_ids`` and ``attention_mask``, int64, padded on
        ``padding_side``. Without a pad token it raises ``ValueError``, as
        ``transformers`` does."""
        if truncation:
            raise NotImplementedError(f"{type(self).__name__}: truncation (no caller asks for it)")
        if pairs is not None and len(pairs) != len(texts):
            raise ValueError(f"{len(texts)} texts and {len(pairs)} pairs")
        seqs = [self.encode(t, None if pairs is None else pairs[i]) for i, t in enumerate(texts)]
        return pad_batch(seqs, self.pad_id, padding, max_length, self.padding_side)
