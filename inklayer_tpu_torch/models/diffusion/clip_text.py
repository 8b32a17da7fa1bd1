"""CLIP ViT-L/14 text encoder (SD1.5's conditioning model) and its BPE
tokenizer (port of :mod:`inklayer_tpu.models.diffusion.clip_text`).

Encoder: vocab 49408, hidden 768, 12 layers / 12 heads, quick-GELU, causal
attention, final LayerNorm (eps 1e-5); SD uses the last hidden state (77
tokens).  ``act="gelu"`` (exact erf) is the OpenCLIP-bigG tower's MLP
activation (SDXL's second text encoder, :mod:`.sdxl`).  Parameters carry
the transformers ``CLIPTextModel`` names
(``text_model.encoder.layers.{i}.self_attn.q_proj`` ...), so the JAX
package's ``CLIP_TEXT_RULES`` bridge its params.

Tokenizer: byte-level BPE, copied from the JAX package without jax.  It
loads the public ``vocab.json`` / ``merges.txt`` when given; without them
every BPE piece gets the JAX package's deterministic crc32 id, fine for
placeholder weights only.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import zlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.ops.attention import sdpa


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape

        def heads(t):
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        out = sdpa(heads(self.q_proj(x)), heads(self.k_proj(x)),
                   heads(self.v_proj(x)), mask=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, act: str = "quick_gelu"):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.fc1 = nn.Linear(hidden, hidden * 4)
        self.fc2 = nn.Linear(hidden * 4, hidden)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPTextLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, act: str = "quick_gelu"):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, eps=1e-5)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = LayerNorm(hidden, eps=1e-5)
        self.mlp = CLIPMLP(hidden, act)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_len: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden)
        self.position_embedding = nn.Embedding(max_len, hidden)


class _Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, act: str):
        super().__init__()
        self.layers = nn.ModuleList(CLIPTextLayer(hidden, heads, act)
                                    for _ in range(layers))


class _TextModel(nn.Module):
    def __init__(self, vocab_size, hidden, layers, heads, max_len, act):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden, max_len)
        self.encoder = _Encoder(hidden, layers, heads, act)
        self.final_layer_norm = LayerNorm(hidden, eps=1e-5)

    def hidden_states(self, input_ids: torch.Tensor):
        """(B, n) int -> (the last layer's input, the last layer's output)
        of the causal stack (the final LayerNorm not applied)."""
        n = input_ids.shape[1]
        x = self.embeddings.token_embedding(input_ids) \
            + self.embeddings.position_embedding.weight[:n]
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=input_ids.device).tril()
        penultimate = x
        for layer in self.encoder.layers:
            penultimate = x
            x = layer(x, causal)
        return penultimate, x


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, hidden: int = 768,
                 layers: int = 12, heads: int = 12, max_len: int = 77,
                 act: str = "quick_gelu"):
        super().__init__()
        self.text_model = _TextModel(vocab_size, hidden, layers, heads,
                                     max_len, act)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, n) int -> (B, n, hidden) last hidden state."""
        tm = self.text_model
        return tm.final_layer_norm(tm.hidden_states(input_ids)[1])


# ---------------------------------------------------------------------------
# BPE tokenizer
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _bytes_to_unicode():
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


_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|"
    r"[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


class CLIPTokenizer:
    BOS = 49406
    EOS = 49407

    def __init__(self, vocab_path: Optional[str] = None,
                 merges_path: Optional[str] = None):
        self.byte_encoder = _bytes_to_unicode()
        self.vocab = None
        self.bpe_ranks = {}
        self.bos, self.eos = self.BOS, self.EOS
        if vocab_path and os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.vocab = json.load(f)
            self.bos = self.vocab.get("<|startoftext|>", self.BOS)
            self.eos = self.vocab.get("<|endoftext|>", self.EOS)
        if merges_path and os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                merges = [m for m in f.read().split("\n")
                          if m and not m.startswith("#")]
            self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self._cache = {}
        self._warned_fallback = False

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str, max_len: int = 77) -> np.ndarray:
        """(1, max_len) int32: BOS, the pieces' ids, EOS, EOS padding."""
        if self.vocab is None and text and not self._warned_fallback:
            self._warned_fallback = True
            print("[tokenizer] WARNING: no CLIP vocab.json/merges.txt "
                  "provided — prompt ids are deterministic hashes, NOT real "
                  "CLIP ids (fine for placeholder weights only).",
                  file=sys.stderr)
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok):
                if self.vocab is not None:
                    ids.append(self.vocab.get(piece, 0))
                else:  # crc32 is stable across processes (str hash is not)
                    ids.append(zlib.crc32(piece.encode()) % 49000 + 300)
        ids = [self.bos] + ids[: max_len - 2] + [self.eos]
        ids = ids + [self.eos] * (max_len - len(ids))
        return np.asarray([ids], np.int32)
