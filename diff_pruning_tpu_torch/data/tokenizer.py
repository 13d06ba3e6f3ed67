"""BERT WordPiece tokenizer for a local ``vocab.txt``: the port's own copy of
``diff_pruning_tpu/data/tokenizer.py`` (pure Python, the same ids).

The reference's BERTTokenizer (ldm_exp/ldm/modules/encoders/modules.py:53-77)
is huggingface's bert-base-uncased tokenizer. This is the same algorithm
(BasicTokenizer + WordPiece, as transformers' slow BertTokenizer): lowercase,
accent strip, punctuation split and CJK isolation, then greedy longest-match
WordPiece with '##' continuations, [CLS]/[SEP] wrapping, truncation to
``max_length`` and [PAD] padding (padding='max_length', truncation=True,
max_length=77). It needs only the vocab file (bert-base-uncased's has 30,522
lines) and ``unicodedata``.
"""

from __future__ import annotations

import unicodedata
from typing import List

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-letter/digit ranges count as punctuation (BERT convention)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch) in ("Cc", "Cf")


class BERTTokenizer:
    """bert-base-uncased-compatible tokenizer from a local vocab.txt."""

    def __init__(self, vocab_file: str, *, max_length: int = 77, do_lower_case: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = [line.rstrip("\n") for line in f]
        self.ids = {tok: i for i, tok in enumerate(self.vocab)}
        self.max_length = max_length
        self.do_lower_case = do_lower_case
        for special in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if special not in self.ids:
                raise ValueError(f"vocab missing {special}")
        self.vocab_size = len(self.vocab)
        self.pad_id = self.ids["[PAD]"]
        self.unk_id = self.ids["[UNK]"]
        self.cls_id = self.ids["[CLS]"]
        self.sep_id = self.ids["[SEP]"]

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if unicodedata.category(ch) == "Zs" or ch.isspace() else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.ids:
                    cur = self.ids[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts) -> np.ndarray:
        """A string or list of strings -> (B, max_length) int32 ids,
        [CLS] ... [SEP] [PAD]*."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenize_ids(t)[: self.max_length - 2]
            row = [self.cls_id] + ids + [self.sep_id]
            out[i, : len(row)] = row
        return out
