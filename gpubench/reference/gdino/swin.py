"""Plain fp32 copy of ``inklayer_tpu_torch.models.gdino.swin`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.config import SwinConfig
from gpubench.reference.layers import MLP, LayerNorm, PatchEmbed, \
    resize_pad_mask
from gpubench.reference.ops import (copy_to_tp, row_linear, sdpa)


@functools.lru_cache(maxsize=64)
def _relative_position_index(window: int) -> np.ndarray:
    """(win^2, win^2) index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, win^2, win^2) additive SW-MSA mask: 0 within one
    original region, -100 across."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hsl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for wsl in (slice(0, -window), slice(-window, -shift),
                    slice(-shift, None)):
            img[hsl, wsl] = cnt
            cnt += 1
    wins = img.reshape(hp // window, window, wp // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return ((wins[:, :, None] != wins[:, None, :]) * -100.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.tp = None
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x: (nW*B, win^2, C); mask: (nW, win^2, win^2) additive."""
        bw, n, _ = x.shape
        hd = self.head_dim
        idx = torch.from_numpy(_relative_position_index(self.window)).to(
            x.device)
        bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(
            n, n, self.num_heads).permute(2, 0, 1)[None]  # (1, heads, n, n)
        qkv = self.qkv(copy_to_tp(x, self.tp)).reshape(bw, n, 3,
                                                       self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        if mask is not None:
            nw = mask.shape[0]
            fb = bias.float()[:, None] + mask[None, :, None]
            bias = fb.expand(bw // nw, nw, self.num_heads, n, n).reshape(
                bw, self.num_heads, n, n)
        out = sdpa(q, k, v, bias=bias, scale=hd ** -0.5)
        return row_linear(out.transpose(1, 2).reshape(
            bw, n, self.num_heads * hd), self.proj, self.tp)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, names=("fc1", "fc2"))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, n, c = x.shape
        win, shift = self.window, self.shift
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        pad_b, pad_r = (win - h % win) % win, (win - w % win) % win
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(_shift_attn_mask(hp, wp, win, shift)).to(
                x.device)
        x = x.reshape(b, hp // win, win, wp // win, win, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        x = self.attn(x, mask)
        x = x.reshape(b, hp // win, wp // win, win, win, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, n, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]):
        h, w = hw
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        hh, ww = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.reshape(b, hh * ww, 4 * c))), (hh, ww)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 mlp_ratio: float, qkv_bias: bool, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                      mlp_ratio, qkv_bias) for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinPatchEmbed(PatchEmbed):
    def __init__(self, patch_size: int, in_ch: int, embed_dim: int):
        super().__init__(patch_size, in_ch, embed_dim)
        self.norm = LayerNorm(embed_dim)


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig = SwinConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = SwinPatchEmbed(cfg.patch_size, cfg.in_chans,
                                          cfg.embed_dim)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            BasicLayer(cfg.embed_dim * 2 ** i, cfg.depths[i], cfg.num_heads[i],
                       cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                       downsample=i < n - 1)
            for i in range(n))
        for i in cfg.out_indices:
            setattr(self, f"norm{i}", LayerNorm(cfg.embed_dim * 2 ** i))

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        """x: (B, H, W, 3); mask: (B, H, W) bool, True = padding.  Returns
        [(feature (B, Hs, Ws, C_s), pad mask (B, Hs, Ws))] per out index."""
        c = self.cfg
        p = c.patch_size
        b, h0, w0, _ = x.shape
        pad_b, pad_r = (p - h0 % p) % p, (p - w0 % p) % p
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        x = self.patch_embed(x)
        hw = (x.shape[1], x.shape[2])
        x = self.patch_embed.norm(x.reshape(b, hw[0] * hw[1], -1))
        outs = []
        for stage, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, hw)
            if stage in c.out_indices:
                feat = getattr(self, f"norm{stage}")(x)
                outs.append((feat.reshape(b, hw[0], hw[1], -1),
                             resize_pad_mask(mask, hw)))
            if layer.downsample is not None:
                x, hw = layer.downsample(x, hw)
        return outs
