"""CLIP byte-BPE tokenizer: the port's own copy of
``diff_pruning_tpu/data/clip_tokenizer.py`` (OpenAI ``clip.tokenize``,
clip/simple_tokenizer.py, which FrozenCLIPTextEmbedder calls), with the same
ids and without the third-party ``regex`` module.

Reads the standard ``bpe_simple_vocab_16e6.txt.gz`` (or an uncompressed
merges file in the same format: a version header line, then one merge pair a
line) from a local path. The vocabulary is built as OpenAI builds it: 256
byte symbols, their '</w>' word-final forms, one token per merge, then the
two special tokens (49,408 for the full file). As in the JAX package,
``basic_clean`` skips ftfy.fix_text and unescapes HTML twice.

The pre-tokenizer pattern (OpenAI's, compiled there with ``regex`` and
IGNORECASE)::

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

is matched here by a scanner over ``unicodedata.category``: ``\\p{L}`` is
the categories L*, ``\\p{N}`` the categories N* (Python's ``\\w`` and
``\\d`` are other classes: '²' is N but not ``\\d``), ``\\s`` is the Unicode
White_Space set that ``regex`` uses (without the separators U+001C-U+001F,
which Python's ``\\s`` and ``str.isspace`` add), and IGNORECASE lets 'ſ'
(U+017F) stand for 's' in the literal alternatives and leaves U+0345 (a
combining mark whose case variants are letters) in no class. Code points
that are unassigned in Python's Unicode tables but assigned in a newer
``regex`` build are classified as neither letter nor number here.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from typing import Iterable, List, Sequence, Union

import numpy as np

# the Unicode White_Space property: what the regex module's \s matches
_WHITE_SPACE = frozenset(map(chr, (0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680,
                                   *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                   0x3000)))
# the literal alternatives of the pattern, in its order
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# characters that IGNORECASE matches to an ASCII letter beyond its two cases
_CASE_FOLD = {"\u017f": "s", "\u212a": "k", "\u0130": "i"}
# the one assigned character that no alternative matches under IGNORECASE (a
# mark whose case variants are letters): findall skips it as it skips spaces
_NO_CLASS = "\u0345"


@lru_cache()
def bytes_to_unicode():
    """GPT-2/CLIP byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    """Runs of White_Space -> one space, then ``str.strip``."""
    out, in_run = [], False
    for ch in text:
        if ch in _WHITE_SPACE:
            if not in_run:
                out.append(" ")
            in_run = True
        else:
            out.append(ch)
            in_run = False
    return "".join(out).strip()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _literal_at(text: str, i: int, lit: str) -> bool:
    if len(text) - i < len(lit):
        return False
    for ch, want in zip(text[i:i + len(lit)], lit):
        if ch != want and _CASE_FOLD.get(ch, ch.lower()) != want:
            return False
    return True


def pre_tokenize(text: str) -> List[str]:
    """``regex.findall`` of OpenAI's pattern (module docstring) on ``text``."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((lit for lit in _LITERALS if _literal_at(text, i, lit)), None)
        if lit is not None:
            j = i + len(lit)
        elif _is_letter(text[i]):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(text[i]):
            j = i + 1
        elif text[i] not in _WHITE_SPACE and text[i] != _NO_CLASS:
            j = i + 1
            while j < n and not (text[j] in _WHITE_SPACE or text[j] == _NO_CLASS
                                 or _is_letter(text[j]) or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """clip.simple_tokenizer.SimpleTokenizer + clip.tokenize."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                raw = f.read()
        else:
            with open(bpe_path, encoding="utf-8") as f:
                raw = f.read()
        merges = raw.split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]  # simple_tokenizer.py:65
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in pre_tokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        return bytearray(byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts: Union[str, Sequence[str]], context_length: int = 77,
                 truncate: bool = True) -> np.ndarray:
        """clip.tokenize: (B, context_length) int32, <sot> ids <eot>,
        zero-padded; on overflow truncate and force a final <eot>."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"input {text!r} too long for context {context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out
