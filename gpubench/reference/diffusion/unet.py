"""Plain fp32 SD1.5 inpainting UNet (runwayml/stable-diffusion-inpainting
``unet/config.json``): 9 input channels (the latent, the mask, the masked
image's latent), blocks 320/640/1280/1280 of 2 resnets, 8 heads,
cross-attention to 768-wide text, GEGLU feed-forward, 3 cross-attention
down blocks and a plain one, mid resnet / transformer / resnet, the up
blocks mirrored with skip concatenations; the ControlNet's residuals added
to the skips and the mid block.  Parameters carry the diffusers names.

Departures from the published model, as the program runs it: GroupNorm's
epsilon is 1e-6 in the resnets too (:data:`~.nn.GN_EPS`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.diffusion.nn import (attention, group_norm,
                                             timestep_embedding)


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int):
        super().__init__()
        self.norm1 = group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        kv = context_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv, dim, bias=False)
        self.to_v = nn.Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, c = x.shape

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, -1).transpose(1, 2)

        out = attention(split(self.to_q(x)), split(self.to_k(context)),
                        split(self.to_v(context)))
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * hidden)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, y, context):
        y = y + self.attn1(self.norm1(y))
        y = y + self.attn2(self.norm2(y), context)
        return y + self.ff(self.norm3(y))


class Transformer2D(nn.Module):
    """GroupNorm, 1x1 proj_in, one basic block over the H*W tokens, 1x1
    proj_out, residual."""

    def __init__(self, channels: int, heads: int, context_dim: int):
        super().__init__()
        self.norm = group_norm(channels)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(y)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Block(nn.Module):
    def __init__(self, resnets, attentions=(), sampler=None,
                 sampler_name: str = "downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class MidBlock(nn.Module):
    def __init__(self, ch: int, temb_dim: int, heads: int, context_dim: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, temb_dim),
                                      ResnetBlock(ch, ch, temb_dim)])
        self.attentions = nn.ModuleList(
            [Transformer2D(ch, heads, context_dim)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


def encoder_blocks(ch: Sequence[int], layers: int, temb: int, heads: int,
                   context_dim: int) -> nn.ModuleList:
    """The down blocks: a transformer after each resnet on every level but
    the last, a strided convolution after every level but the last."""
    blocks, prev = [], ch[0]
    for i, c in enumerate(ch):
        last = i == len(ch) - 1
        res = [ResnetBlock(prev if j == 0 else c, c, temb)
               for j in range(layers)]
        att = [] if last else [Transformer2D(c, heads, context_dim)
                               for _ in range(layers)]
        blocks.append(Block(res, att, None if last else Downsample(c)))
        prev = c
    return nn.ModuleList(blocks)


def skip_channels(ch: Sequence[int], layers: int) -> list:
    """The channels of the down pass's features: conv_in's output, then
    each resnet's (with its transformer) and each downsample's."""
    out = [ch[0]]
    for i, c in enumerate(ch):
        out += [c] * (layers + (i < len(ch) - 1))
    return out


def run_encoder(blocks, x, temb, context):
    """The down pass: (its output, every feature the skips take)."""
    feats = [x]
    for blk in blocks:
        for j, res in enumerate(blk.resnets):
            x = res(x, temb)
            if hasattr(blk, "attentions"):
                x = blk.attentions[j](x, context)
            feats.append(x)
        if hasattr(blk, "downsamplers"):
            x = blk.downsamplers[0](x)
            feats.append(x)
    return x, feats


class UNet(nn.Module):
    def __init__(self, in_channels: int = 9, out_channels: int = 4,
                 block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, num_heads: int = 8,
                 context_dim: int = 768):
        super().__init__()
        ch = tuple(block_channels)
        temb = 4 * ch[0]
        self.block_channels = ch
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(ch[0], temb)
        self.down_blocks = encoder_blocks(ch, layers_per_block, temb,
                                          num_heads, context_dim)
        self.mid_block = MidBlock(ch[-1], temb, num_heads, context_dim)
        skips = skip_channels(ch, layers_per_block)
        ups, prev = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            first = i == 0  # the plain level
            res, att = [], []
            for _ in range(layers_per_block + 1):
                res.append(ResnetBlock(prev + skips.pop(), c, temb))
                if not first:
                    att.append(Transformer2D(c, num_heads, context_dim))
                prev = c
            last = i == len(ch) - 1
            ups.append(Block(res, att, None if last else Upsample(c),
                             "upsamplers"))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = group_norm(ch[0])
        self.conv_out = nn.Conv2d(ch[0], out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, down_residuals=None,
                mid_residual=None):
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.block_channels[0]))
        x = self.conv_in(sample)
        x, skips = run_encoder(self.down_blocks, x, temb, context)
        x = self.mid_block(x, temb, context)
        if mid_residual is not None:
            x = x + mid_residual
        if down_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_residuals)]
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
