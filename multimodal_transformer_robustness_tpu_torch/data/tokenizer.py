"""BERT tokenization for the text path (pure Python).

Counterpart of ``multimodal_transformer_robustness_tpu/data/tokenizer.py``:
  * :class:`WordPieceTokenizer` matches HF's uncased BertTokenizer (basic
    tokenize: lowercase, strip accents, split punctuation; greedy
    longest-match wordpiece; CLS/SEP; pad/truncate to max_length).  Needs only
    a ``vocab.txt``.
  * :class:`HashTokenizer` is the deterministic fallback when no vocabulary
    exists: whitespace tokens hashed into a fixed id space.  Not parity with
    the reference; it keeps the pipelines runnable.
"""

from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, List, Optional


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _basic_tokenize(text: str, lower: bool = True) -> List[str]:
    if lower:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
    out: List[str] = []
    word: List[str] = []
    for ch in text:
        if ch.isspace() or _is_punct(ch):
            if word:
                out.append("".join(word))
                word = []
            if not ch.isspace():
                out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


def _pad(ids: List[int], max_length: int, cls_id: int, sep_id: int,
         pad_id: int) -> Dict[str, List[int]]:
    """add_special_tokens=True, pad_to_max_length=True: the collate's call."""
    ids = [cls_id] + ids[: max_length - 2] + [sep_id]
    attn = [1] * len(ids) + [0] * (max_length - len(ids))
    ids = ids + [pad_id] * (max_length - len(ids))
    return {"input_ids": ids, "token_type_ids": [0] * max_length,
            "attention_mask": attn}


class WordPieceTokenizer:
    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 unk: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.lower = do_lower_case
        self.unk = unk
        self.max_chars = max_chars_per_word
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab.get("[PAD]", 0)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.vocab[self.unk]]
            ids.append(cur)
            start = end
        return ids

    def encode_plus(self, text: str, max_length: int) -> Dict[str, List[int]]:
        ids: List[int] = []
        for w in _basic_tokenize(text, self.lower):
            ids.extend(self._wordpiece(w))
        return _pad(ids, max_length, self.cls_id, self.sep_id, self.pad_id)


class HashTokenizer:
    """Deterministic whitespace + hash fallback (documented non-parity)."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id, self.pad_id = 101, 102, 0

    def encode_plus(self, text: str, max_length: int) -> Dict[str, List[int]]:
        ids = []
        for w in text.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids.append(1000 + (h % (self.vocab_size - 1003)))
        return _pad(ids, max_length, self.cls_id, self.sep_id, self.pad_id)


def load_tokenizer(bert_dir: Optional[str], vocab_size: int = 30522):
    """WordPiece from ``<bert_dir>/vocab.txt`` when it exists, else the hash
    fallback.  (The JAX package can also take a native tokenizer; the port
    has only the pure-Python one.)"""
    if bert_dir:
        vocab = os.path.join(bert_dir, "vocab.txt")
        if os.path.exists(vocab):
            return WordPieceTokenizer(vocab)
    return HashTokenizer(vocab_size)
