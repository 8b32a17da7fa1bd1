"""SD1.5 conditional UNet, inpaint variant (9 input channels), with the
ControlNet residual inputs (port of :mod:`inklayer_tpu.models.diffusion.unet`).

Published architecture (runwayml/stable-diffusion-inpainting): block
channels (320, 640, 1280, 1280); down = 3 cross-attention down blocks + 1
plain down block, mid = resnet / transformer / resnet, up mirrored with
skip concatenations; each transformer = self-attention + cross-attention
(text 768) + GEGLU feed-forward; sinusoidal timestep embedding (cos half
first) -> 2-layer MLP.

Tensors are NCHW (channels-last in memory, as ``build_diffusion_models``
sets the weights); the transformer blocks work on (B, H*W, C) tokens.
Parameters carry the diffusers checkpoint names, so the JAX package's
``UNET_RULES`` bridge its params.  Self-attention goes through the port's
:func:`~inklayer_tpu_torch.ops.attention.attention` dispatcher: at least
1024 keys take the flash kernel (K7; at 768^2 the 96^2 = 9216 tokens of
level 0 at head_dim 40 and the 48^2 = 2304 of level 1 at head_dim 80),
fewer (and the 77-key cross-attention) the matmul + softmax ``sdpa``.

The SDXL options of the JAX module: ``transformer_layers`` deeper than 1
(diffusers' ``attentions.{j}.transformer_blocks.{d}``; the mid block takes
the deepest level's depth), ``linear_proj`` (``nn.Linear`` proj_in /
proj_out on the (B, H*W, C) tokens), ``head_dim`` (heads = C // head_dim)
and the text_time embedding (``add_embedding``: the pooled text, then the
sinusoid of each of the 6 float time-ids, into a 2-layer MLP added to the
time embedding).  SDXL's (320, 640, 1280) levels with depths (0, 2, 10) at
a 1024^2 image run the flash kernel at head_dim 64 over 64^2 = 4096 tokens
(level 1) and 32^2 = 1024 (level 2).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.nn.layers import LayerNorm
from inklayer_tpu_torch.ops.attention import attention

GN_EPS = 1e-6  # flax GroupNorm's default


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) fp32: cos half, then sin half."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=GN_EPS)


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlockT(nn.Module):
    """GroupNorm-SiLU-conv twice, the time embedding added in between."""

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


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        kv_dim = context_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv_dim, dim, bias=False)
        self.to_v = nn.Linear(kv_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, c = x.shape
        m = context.shape[1]
        hd = c // self.heads

        def heads(t, length):
            return t.reshape(b, length, self.heads, hd).transpose(1, 2)

        out = attention(heads(self.to_q(x), n), heads(self.to_k(context), m),
                        heads(self.to_v(context), m))
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, hidden * 2)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class GEGLUFeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU(dim -> 8 dim), net.2 = Linear
    (4 dim -> dim); net.1 is the (parameterless) dropout."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LayerNorm (eps 1e-5) before self-attention, cross-attention and the
    feed-forward, each with a residual."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, y, context):
        y = y + self.attn1(self.norm1(y))
        y = y + self.attn2(self.norm2(y), context)
        return y + self.ff(self.norm3(y))


class TransformerBlock2D(nn.Module):
    """GroupNorm, proj_in, ``depth`` basic blocks over the H*W tokens,
    proj_out, residual (diffusers' Transformer2DModel).  The projections
    are 1x1 convolutions (SD1.5) or, with ``linear_proj``, linear layers
    on the tokens (SDXL)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1, linear_proj: bool = False):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = group_norm(channels)
        proj = (lambda: nn.Linear(channels, channels)) if linear_proj else \
            (lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, context_dim)
            for _ in range(depth))
        self.proj_out = proj()

    def forward(self, x, context):
        b, c, h, w = x.shape
        tokens = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, c)
        image = lambda t: t.reshape(b, h, w, c).permute(0, 3, 1, 2)
        y = self.norm(x)
        y = self.proj_in(tokens(y)) if self.linear_proj \
            else tokens(self.proj_in(y))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return x + (image(self.proj_out(y)) if self.linear_proj
                    else self.proj_out(image(y)))


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


class _Block(nn.Module):
    """A diffusers down / up block: ``resnets``, optional ``attentions``,
    optional ``downsamplers`` / ``upsamplers``."""

    def __init__(self, resnets, attentions=None, sampler=None,
                 sampler_name: str = "downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _MidBlock(nn.Module):
    def __init__(self, ch: int, temb_dim: int, heads: int, context_dim: int,
                 depth: int = 1, linear_proj: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlockT(ch, ch, temb_dim),
                                      ResnetBlockT(ch, ch, temb_dim)])
        self.attentions = nn.ModuleList(
            [TransformerBlock2D(ch, heads, context_dim, depth, linear_proj)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


def down_blocks(in_ch: int, block_channels: Sequence[int],
                layers_per_block: int, depths: Sequence[int], temb_dim: int,
                heads: Sequence[int], context_dim: int,
                linear_proj: bool = False) -> nn.ModuleList:
    """The UNet's (and the ControlNet's) encoder blocks; level i has
    ``depths[i]`` basic blocks per transformer (0: none) of ``heads[i]``
    heads."""
    blocks, prev = [], in_ch
    for i, c in enumerate(block_channels):
        res, att = [], []
        for j in range(layers_per_block):
            res.append(ResnetBlockT(prev if j == 0 else c, c, temb_dim))
            if depths[i]:
                att.append(TransformerBlock2D(c, heads[i], context_dim,
                                              depths[i], linear_proj))
        last = i == len(block_channels) - 1
        blocks.append(_Block(res, att, None if last else Downsample(c)))
        prev = c
    return nn.ModuleList(blocks)


def skip_channels(block_channels: Sequence[int],
                  layers_per_block: int) -> list:
    """Channels of the encoder's skip features, as run_down_blocks
    returns them: conv_in's output, then each resnet's and downsample's."""
    last = len(block_channels) - 1
    return [block_channels[0]] + [
        c for i, c in enumerate(block_channels)
        for _ in range(layers_per_block + (i < last))]


def run_down_blocks(blocks: nn.ModuleList, x, temb, context):
    """Encoder pass; returns (x, the skip features incl. the input)."""
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


class UNet2DCondition(nn.Module):
    def __init__(self, in_channels: int = 9, out_channels: int = 4,
                 block_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, num_heads: int = 8,
                 context_dim: int = 768,
                 transformer_layers: Tuple[int, ...] = (1, 1, 1, 0),
                 linear_proj: bool = False, head_dim: int = 0,
                 addition_embed_dim: int = 0, addition_proj_dim: int = 0):
        """``transformer_layers``: basic blocks per transformer of each
        down level (0: a plain level; the up levels mirror it, the mid
        block takes the largest); ``head_dim`` > 0: heads = C // head_dim,
        else ``num_heads``; ``addition_embed_dim`` > 0: the text_time
        embedding, an MLP from ``addition_proj_dim`` = pooled text + 6 *
        ``addition_embed_dim`` inputs."""
        super().__init__()
        if addition_embed_dim and not addition_proj_dim:
            raise ValueError("addition_embed_dim needs addition_proj_dim "
                             "(the pooled text width + 6 * "
                             "addition_embed_dim)")
        ch = block_channels
        temb = ch[0] * 4
        depths = tuple(transformer_layers)
        heads = [c // head_dim if head_dim else num_heads for c in ch]
        self.block_channels = tuple(ch)
        self.addition_embed_dim = addition_embed_dim
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(ch[0], temb)
        if addition_embed_dim:
            self.add_embedding = TimeEmbedding(addition_proj_dim, temb)
        self.down_blocks = down_blocks(ch[0], ch, layers_per_block, depths,
                                       temb, heads, context_dim, linear_proj)
        self.mid_block = _MidBlock(ch[-1], temb, heads[-1], context_dim,
                                   max(depths), linear_proj)
        # up: mirrored, layers_per_block + 1 resnets each taking a skip
        skip_ch = skip_channels(ch, layers_per_block)
        ups, prev = [], ch[-1]
        rev = list(reversed(ch))
        for i, c in enumerate(rev):
            depth = depths[len(ch) - 1 - i]
            res, att = [], []
            for _ in range(layers_per_block + 1):
                res.append(ResnetBlockT(prev + skip_ch.pop(), c, temb))
                if depth:
                    att.append(TransformerBlock2D(
                        c, heads[len(ch) - 1 - i], context_dim, depth,
                        linear_proj))
                prev = c
            last = i == len(ch) - 1
            ups.append(_Block(res, att, None if last else Upsample(c),
                              "upsamplers"))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = group_norm(ch[0])
        self.conv_out = nn.Conv2d(ch[0], out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context,
                down_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None):
        """sample (B, in_ch, H, W) latents; timesteps (B,); context (B, T,
        context_dim); down/mid_residual: the ControlNet's additions;
        pooled_text (B, D) and time_ids (B, 6) floats: SDXL's text_time
        conditioning (used when the UNet has ``add_embedding`` and
        ``pooled_text`` is given).  Returns (B, out_ch, H, W) in the
        weights' dtype."""
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.block_channels[0]).to(dtype))
        if self.addition_embed_dim and pooled_text is not None:
            b = pooled_text.shape[0]
            tid = timestep_embedding(time_ids.reshape(-1),
                                     self.addition_embed_dim).reshape(b, -1)
            temb = temb + self.add_embedding(
                torch.cat([pooled_text.float(), tid], dim=-1).to(dtype))
        x = self.conv_in(sample.to(dtype))
        x, skips = run_down_blocks(self.down_blocks, x, temb, context)
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
