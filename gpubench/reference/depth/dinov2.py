"""Plain fp32 copy of ``inklayer_tpu_torch.models.depth.dinov2`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from gpubench.reference.config import DepthConfig
from gpubench.reference.layers import MLP, LayerNorm, PatchEmbed
from gpubench.reference.ops import (attention, copy_to_tp, row_linear)
from gpubench.reference.image import resize


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, layerscale_init: float = 1.0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.tp = None
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim)
        self.ls1 = LayerScale(dim, layerscale_init)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, names=("fc1", "fc2"))
        self.ls2 = LayerScale(dim, layerscale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        heads, hd = self.num_heads, self.head_dim
        qkv = self.attn.qkv(copy_to_tp(self.norm1(x), self.tp)).reshape(
            b, n, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (b, heads, n, hd)
        out = attention(q, k, v).transpose(1, 2).reshape(b, n, heads * hd)
        x = x + self.ls1.gamma * row_linear(out, self.attn.proj, self.tp)
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: DepthConfig = DepthConfig()):
        super().__init__()
        self.cfg = cfg
        grid = cfg.input_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid,
                                                  cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, cfg.layerscale_init)
            for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.embed_dim)

    def _interpolate_pos(self, grid_hw: Tuple[int, int]) -> torch.Tensor:
        """Bicubic resample of the patch-grid position embedding to the
        input's grid (jax.image.resize semantics); cls position kept."""
        pos = self.pos_embed
        gs = int(round(math.sqrt(pos.shape[1] - 1)))
        if tuple(grid_hw) == (gs, gs):
            return pos
        grid = pos[0, 1:].reshape(gs, gs, -1).float()
        grid = resize(grid, grid_hw, "bicubic").reshape(1, -1, pos.shape[-1])
        return torch.cat([pos[:, :1], grid.to(pos.dtype)], dim=1)

    def forward(self, x: torch.Tensor, taps: Sequence[int]
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(B, H, W, 3), H and W multiples of the patch -> for each tapped
        block ((B, N, C) patch tokens, (B, C) cls), final norm applied."""
        c = self.cfg
        b, h, w, _ = x.shape
        ph, pw = h // c.patch_size, w // c.patch_size
        x = self.patch_embed(x).reshape(b, ph * pw, c.embed_dim)
        cls = self.cls_token.expand(b, 1, c.embed_dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self._interpolate_pos((ph, pw)).to(
            x.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in taps:
                y = self.norm(x)
                outs.append((y[:, 1:], y[:, 0]))
        return outs
