"""BERT-base text encoder with GroundingDINO's sub-sentence masking (port
of :mod:`inklayer_tpu.models.gdino.bert`).  Module names follow the
HuggingFace ``BertModel`` checkpoint (``embeddings.*``,
``encoder.layer.i.attention.self.query`` ...).

Tensor parallelism (:meth:`BertLayer.shard_tp`, ``parallel/tp.py``): each
rank keeps its heads of ``query`` / ``key`` / ``value`` and the matching
columns of ``attention.output.dense``, and its hidden units of
``intermediate.dense`` / ``output.dense``; each LayerNorm runs after the
sum.  (The JAX rules leave q / k / v replicated; the head plan needs them
split.)"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.config import BertConfig
from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.ops.attention import sdpa
from inklayer_tpu_torch.parallel.tp import (copy_to_tp, ffn, prefixed,
                                            row_linear, shard_column,
                                            shard_ffn, shard_row, splits)


class _Dense(nn.Module):
    """A ``dense`` Linear, optionally followed by a ``LayerNorm``
    (HF BertSelfOutput / BertIntermediate / BertOutput)."""

    def __init__(self, d_in: int, d_out: int, eps: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if eps:
            self.LayerNorm = LayerNorm(d_out, eps=eps)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor):
        """x: the (B, N, C) hidden states, copied to the tp ranks."""
        b, n, _ = x.shape

        def heads(y):
            return y.reshape(b, n, self.num_heads, -1).transpose(1, 2)

        out = sdpa(heads(self.query(x)), heads(self.key(x)),
                   heads(self.value(x)), mask=attn_mask)
        return out.transpose(1, 2).reshape(b, n, -1)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        # the checkpoint calls this submodule 'self'
        setattr(self, "self", BertSelfAttention(cfg))
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size,
                             cfg.layer_norm_eps)
        self.tp = None  # set where the heads split


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size,
                             cfg.layer_norm_eps)
        self.tp = None

    def shard_tp(self, tp) -> dict:
        """Keep this rank's heads (if tp divides them) and hidden units;
        returns the tp-sharded parameters' layouts."""
        self.tp = tp
        att = self.attention
        sa = getattr(att, "self")
        layout = shard_ffn(self.intermediate.dense, self.output.dense, tp,
                           ("intermediate.dense", "output.dense"))
        if not splits(sa.num_heads, tp):
            return layout
        sa.num_heads //= tp.size
        for name in ("query", "key", "value"):
            layout.update(prefixed(f"attention.self.{name}",
                                   shard_column(getattr(sa, name), tp)))
        att.tp = tp
        return {**layout, **prefixed("attention.output.dense",
                                     shard_row(att.output.dense, tp))}

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor):
        att = self.attention
        a = row_linear(getattr(att, "self")(copy_to_tp(x, att.tp),
                                            attn_mask),
                       att.output.dense, att.tp)
        x = att.output.LayerNorm(x + a)
        return self.output.LayerNorm(x + ffn(
            x, self.intermediate.dense, self.output.dense, self.tp, F.gelu))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertEncoderLayers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoderLayers(cfg)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        """input_ids, position_ids (B, N) int; attn_mask (B, N, N) bool ->
        last hidden state (B, N, H)."""
        e = self.embeddings
        x = (e.word_embeddings(input_ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings(torch.zeros_like(input_ids)))
        x = e.LayerNorm(x)
        mask4 = attn_mask[:, None]
        for layer in self.encoder.layer:
            x = layer(x, mask4)
        return x


# ---------------------------------------------------------------------------
# Sub-sentence mask bookkeeping (host-side numpy)
# ---------------------------------------------------------------------------

CLS_ID, SEP_ID, PAD_ID, DOT_ID, QMARK_ID = 101, 102, 0, 1012, 1029
SPLIT_IDS = (CLS_ID, SEP_ID, DOT_ID, QMARK_ID)


def subsentence_masks(input_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, N) token ids -> (attention_mask (B, N, N) bool, position_ids
    (B, N) int64).  Special tokens attend to themselves; the tokens between
    two special tokens (and the closing one) form a self-attending span
    whose position ids restart at 0."""
    b, n = input_ids.shape
    special = np.isin(input_ids, SPLIT_IDS)
    attn = np.tile(np.eye(n, dtype=bool), (b, 1, 1))
    pos = np.zeros((b, n), np.int64)
    for bi in range(b):
        prev = 0
        for col in np.nonzero(special[bi])[0]:
            if col in (0, n - 1):
                attn[bi, col, col] = True
                pos[bi, col] = 0
            else:
                attn[bi, prev + 1: col + 1, prev + 1: col + 1] = True
                pos[bi, prev + 1: col + 1] = np.arange(0, col - prev)
            prev = int(col)
    return attn, pos
