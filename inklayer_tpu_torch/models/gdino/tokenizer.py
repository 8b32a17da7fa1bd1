"""Offline WordPiece tokenizer (bert-base-uncased compatible).

A copy of :mod:`inklayer_tpu.models.gdino.tokenizer`: that package's
``__init__`` imports jax, which the port must not.

The reference uses HF ``AutoTokenizer.from_pretrained("bert-base-uncased")``
(downloads vocab at first use).  This environment has no network, so we ship
a full WordPiece implementation plus a small embedded vocab fragment whose
ids are exact bert-base-uncased ids — enough for the pipeline's constant
caption "object" (detector/gdino.py:18) and common open-vocabulary prompts.
For exact parity on arbitrary captions, point ``vocab_path`` at a real
bert-base-uncased ``vocab.txt``; ids then match HF tokenization exactly.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional

# exact bert-base-uncased ids for the embedded fragment
_EMBEDDED_VOCAB: Dict[str, int] = {
    "[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103,
    "!": 999, '"': 1000, "#": 1001, "$": 1002, "%": 1003, "&": 1004,
    "'": 1005, "(": 1006, ")": 1007, "*": 1008, "+": 1009, ",": 1010,
    "-": 1011, ".": 1012, "/": 1013, ":": 1024, ";": 1025, "?": 1029,
    "a": 1037, "b": 1038, "c": 1039, "d": 1040, "e": 1041, "f": 1042,
    "g": 1043, "h": 1044, "i": 1045, "j": 1046, "k": 1047, "l": 1048,
    "m": 1049, "n": 1050, "o": 1051, "p": 1052, "q": 1053, "r": 1054,
    "s": 1055, "t": 1056, "u": 1057, "v": 1058, "w": 1059, "x": 1060,
    "y": 1061, "z": 1062,
    "the": 1996, "of": 1997, "and": 1998, "in": 1999, "to": 2000,
    "was": 2001, "he": 2002, "is": 2003, "as": 2004, "for": 2005,
    "on": 2006, "with": 2007, "that": 2008, "it": 2009, "his": 2010,
    "by": 2011, "at": 2012, "from": 2014, "her": 2016, "##s": 2015,
    "an": 2019, "person": 2711, "people": 2111, "man": 2158, "woman": 2450,
    "house": 2160, "water": 2300, "dog": 3899, "cat": 4937, "object": 4874,
    "objects": 5200, "tree": 3392, "table": 2795, "chair": 3242,
    "car": 2482, "book": 2338, "bird": 4743, "fish": 3869, "horse": 3586,
    "flower": 6546, "plant": 3269, "lamp": 10022, "clock": 5119,
    "window": 3332, "door": 2341, "bed": 2793, "cup": 2452, "hat": 6045,
    "sun": 3103, "moon": 4231, "star": 2732, "cloud": 6112, "sketch": 22165,
    "drawing": 5059, "line": 2240, "rabbit": 10442, "bunny": 16291,
}


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    """BERT basic+wordpiece tokenization (lowercase, accent-strip,
    punctuation split, greedy longest-match-first subwords)."""

    def __init__(self, vocab_path: Optional[str] = None,
                 max_input_chars_per_word: int = 100):
        self.full_vocab = bool(vocab_path and os.path.exists(vocab_path))
        if self.full_vocab:
            self.vocab = {}
            with open(vocab_path, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    self.vocab[line.rstrip("\n")] = i
        else:
            self.vocab = dict(_EMBEDDED_VOCAB)
        self._warned_fallback = False
        self.unk_id = self.vocab.get("[UNK]", 100)
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.max_chars = max_input_chars_per_word
        self._inv = None

    # -- basic tokenizer ---------------------------------------------------
    # exact HF BertTokenizer BasicTokenizer semantics (do_lower_case=True,
    # tokenize_chinese_chars=True): clean control chars, space out CJK,
    # lowercase + strip accents (NFD, drop Mn), split on punctuation.
    def _basic(self, text: str) -> List[str]:
        cleaned = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                cleaned.append(f" {ch} ")
            elif ch.isspace():
                cleaned.append(" ")
            else:
                cleaned.append(ch)
        text = unicodedata.normalize("NFD", "".join(cleaned).lower())
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = ""
        for ch in text:
            if ch == " ":
                if word:
                    out.append(word)
                    word = ""
            elif _is_punct(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    # -- wordpiece ---------------------------------------------------------
    def _wordpiece(self, token: str) -> List[int]:
        if len(token) > self.max_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int = 256,
               add_special: bool = True) -> List[int]:
        ids: List[int] = []
        fallback_miss = False
        for tok in self._basic(text):
            piece_ids = self._wordpiece(tok)
            if (not self.full_vocab and tok not in self.vocab
                    and not (len(tok) == 1 and _is_punct(tok))):
                fallback_miss = True
            ids.extend(piece_ids)
        if fallback_miss and not self._warned_fallback:
            self._warned_fallback = True
            print("[tokenizer] WARNING: caption contains words outside the "
                  "embedded vocab fragment and no bert-base-uncased vocab.txt "
                  "was provided — token ids will NOT match HF for this "
                  "caption.  Fetch vocab.txt (scripts/download_checkpoints.sh)"
                  " and pass vocab_path/models_dir.")
        if add_special:
            ids = [self.cls_id] + ids[: max_len - 2] + [self.sep_id]
        return ids

    def decode_token(self, token_id: int) -> str:
        if self._inv is None:
            self._inv = {v: k for k, v in self.vocab.items()}
        return self._inv.get(token_id, "[UNK]")

    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            t = self.decode_token(int(i))
            if t.startswith("##"):
                parts.append(t[2:])
            elif t in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            else:
                # HF-style cleanup: no space before punctuation
                if parts and not (len(t) == 1 and _is_punct(t)):
                    parts.append(" ")
                parts.append(t)
        return "".join(parts)
