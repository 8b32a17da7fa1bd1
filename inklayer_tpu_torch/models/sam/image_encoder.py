"""SAM ViT image encoder (port of
:mod:`inklayer_tpu.models.sam.image_encoder`).

Semantics of segment-anything ``ImageEncoderViT``: windowed blocks zero-pad
the LN output to a window multiple (64 -> 70 for ViT-H), partition, run the
qkv dense (pad tokens carry qkv = bias), attend, unpartition and crop;
global blocks attend over all 4096 tokens.  Both call the same rel-pos
attention op, which launches the ``relpos_attention`` kernel on the card.
The residual stream stays token-major (B, N, C) with the JAX package's
pending-residual pairs: block i's MLP output is added inside block i+1's
first LayerNorm.

Tensor parallelism (:meth:`Block.shard_tp`, ``parallel/tp.py``): each
rank keeps its heads of ``qkv`` / ``proj`` and its hidden units of the
MLP.  The attention output is summed over the ranks before ``norm2`` and
the MLP output before it becomes the next block's pending residual, so no
partial sum reaches a LayerNorm.  ``rel_pos_h`` / ``rel_pos_w`` (per head
dim) stay whole on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.nn.layers import (MLP, LayerNorm, PatchEmbed,
                                          window_partition, window_unpartition)
from inklayer_tpu_torch.ops.attention import rel_terms, relpos_attention
from inklayer_tpu_torch.parallel.tp import (copy_to_tp, prefixed,
                                            row_linear, shard_column,
                                            shard_row, splits)


class Attention(nn.Module):
    """Multi-head attention over a (B, H, W, C) map with the decomposed
    relative-position bias (reference image_encoder.py Attention)."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.tp = None
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def shard_heads(self, tp) -> dict:
        """Keep this rank's heads (``num_heads`` becomes the local count);
        whole where tp does not divide them."""
        if not splits(self.num_heads, tp):
            return {}
        self.tp = tp
        self.num_heads //= tp.size
        return {**prefixed("qkv", shard_column(self.qkv, tp, groups=3)),
                **prefixed("proj", shard_row(self.proj, tp))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads, hd = self.num_heads, self.head_dim
        n = h * w
        qkv = self.qkv(copy_to_tp(x, self.tp)).reshape(
            b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (b, heads, n, hd)
        # bias terms from UNSCALED q (the reference scales q @ k only)
        rel_h, rel_w = rel_terms(q.reshape(b, heads, h, w, hd),
                                 copy_to_tp(self.rel_pos_h, self.tp),
                                 copy_to_tp(self.rel_pos_w, self.tp))
        fold = lambda t, d: t.reshape(b * heads, n, d).contiguous()
        out = relpos_attention(fold(q, hd), fold(k, hd), fold(v, hd),
                               fold(rel_h, h), fold(rel_w, w), self.scale)
        out = out.reshape(b, heads, h, w, hd).permute(0, 2, 3, 1, 4)
        return row_linear(out.reshape(b, h, w, heads * hd), self.proj,
                          self.tp)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, input_size: Tuple[int, int]):
        super().__init__()
        self.window_size = window_size
        self.input_size = input_size
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(
            dim, num_heads,
            (window_size, window_size) if window_size > 0 else input_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, fused=True)

    def shard_tp(self, tp) -> dict:
        """The block's tp plan: heads of ``attn``, hidden units of ``mlp``;
        returns the tp-sharded parameters' layouts."""
        return {**prefixed("attn", self.attn.shard_heads(tp)),
                **prefixed("mlp", self.mlp.shard_hidden(tp))}

    def forward(self, x: torch.Tensor, delta: torch.Tensor):
        """Pending-residual pair: returns (x + delta + attn, mlp_out) with
        the last add left to the next block's first LayerNorm."""
        h, w = self.input_size
        b, n, c = x.shape
        shortcut, y = self.norm1(x, delta)
        y = y.reshape(b, h, w, c)
        if self.window_size > 0:
            y, padded_hw = window_partition(y, self.window_size)
            y = self.attn(y)
            y = window_unpartition(y, self.window_size, padded_hw, (h, w))
        else:
            y = self.attn(y)
        x, y = self.norm2(shortcut, y.reshape(b, n, c))
        return x, self.mlp(y)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)):
        super().__init__()
        self.grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid, self.grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size,
                  (self.grid, self.grid))
            for i in range(depth))
        # neck: 1x1 conv -> LN -> 3x3 conv -> LN (checkpoint keys neck.0-3)
        self.neck = nn.ModuleList([
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm(out_chans),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) preprocessed pixels -> (B, S/16, S/16, out_chans)."""
        x = self.patch_embed(x)
        b, g, _, c = x.shape
        n = g * g
        x = x.reshape(b, n, c)
        delta = self.pos_embed.to(x.dtype).reshape(1, n, c).expand(b, n, c)
        for blk in self.blocks:
            x, delta = blk(x, delta)
        x = x + delta
        conv1, ln1, conv2, ln2 = self.neck
        x = F.linear(x, conv1.weight.reshape(conv1.out_channels, c))
        x = ln1(x).reshape(b, g, g, -1)
        x = F.conv2d(x.permute(0, 3, 1, 2), conv2.weight, padding=1)
        return ln2(x.permute(0, 2, 3, 1))
