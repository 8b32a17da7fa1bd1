"""AutoencoderKL, the SD1.5 VAE (port of
:mod:`inklayer_tpu.models.diffusion.vae`).

Encoder: conv_in, 4 down stages of 2 resnets + a strided-conv downsample
(padded (0, 1) bottom-right, not symmetric), mid resnet-attention-resnet,
GroupNorm/SiLU head, 2 * latent channels, quant_conv; decoder mirrored
with 3 resnets per stage and nearest 2x upsampling; latent scaling factor
0.18215.  The mid-block attention is one head over all H*W tokens through
``sdpa`` (matmul + softmax), as in the JAX package, which uses no Pallas
kernel there.  NCHW; parameters carry the diffusers names
(``VAE_RULES``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.models.diffusion.unet import group_norm
from inklayer_tpu_torch.ops.attention import sdpa

SCALING_FACTOR = 0.18215


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = group_norm(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        out = sdpa(self.to_q(y), self.to_k(y), self.to_v(y))[:, 0]
        out = self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + out


class _Sampler(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride,
                              padding=1 if stride == 1 else 0)

    def forward(self, x):
        if self.stride == 2:  # downsample: pad bottom and right only
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Stage(nn.Module):
    def __init__(self, resnets, sampler=None, sampler_name="downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, channels: Tuple[int, ...], latent_channels: int):
        super().__init__()
        ch = channels
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        stages, prev = [], ch[0]
        for i, c in enumerate(ch):
            stages.append(_Stage(
                [ResnetBlock(prev, c), ResnetBlock(c, c)],
                _Sampler(c, 2) if i < len(ch) - 1 else None))
            prev = c
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = _Mid(ch[-1])
        self.conv_norm_out = group_norm(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "downsamplers"):
                x = stage.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, channels: Tuple[int, ...], latent_channels: int):
        super().__init__()
        ch = channels
        self.conv_in = nn.Conv2d(latent_channels, ch[-1], 3, padding=1)
        self.mid_block = _Mid(ch[-1])
        stages, prev = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            stages.append(_Stage(
                [ResnetBlock(prev, c), ResnetBlock(c, c), ResnetBlock(c, c)],
                _Sampler(c, 1) if i < len(ch) - 1 else None, "upsamplers"))
            prev = c
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = group_norm(ch[0])
        self.conv_out = nn.Conv2d(ch[0], 3, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            for res in stage.resnets:
                x = res(x)
            if hasattr(stage, "upsamplers"):
                x = stage.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, channels: Tuple[int, ...] = (128, 256, 512, 512),
                 latent_channels: int = 4):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder = Encoder(channels, latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.decoder = Decoder(channels, latent_channels)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x in [-1, 1], (B, 3, H, W) -> the latent mean (B, C_lat, H/8,
        W/8), scaled by 0.18215."""
        x = x.to(self.quant_conv.weight.dtype)
        moments = self.quant_conv(self.encoder(x))
        return moments[:, :self.latent_channels] * SCALING_FACTOR

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, C_lat, h, w) scaled latents -> (B, 3, 8h, 8w) in ~[-1, 1]."""
        z = (z / SCALING_FACTOR).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
