"""Plain fp32 SD1.5 VAE, AutoencoderKL (runwayml/stable-diffusion-inpainting
``vae/config.json``): channels 128/256/512/512 with 2 resnets a level down
and 3 up, a strided convolution padded bottom-right to halve, nearest 2x
upsampling, a mid block of resnet / single-head attention over every pixel
/ resnet, 4 latent channels, the latent scaled by 0.18215.  The encoder
gives the latent mean (the sampler draws no latent noise).  Parameters
carry the diffusers names.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from gpubench.reference.diffusion.nn import attention, group_norm


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
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y))
        out = self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + out


class Sampler(nn.Module):
    def __init__(self, ch: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(ch, ch, 3, stride=2 if down else 1,
                              padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Stage(nn.Module):
    def __init__(self, resnets, sampler=None, name: str = "downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, name, nn.ModuleList([sampler]))


class Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch),
                                      ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, ch: Sequence[int], latent: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        stages, prev = [], ch[0]
        for i, c in enumerate(ch):
            stages.append(Stage([ResnetBlock(prev, c), ResnetBlock(c, c)],
                                Sampler(c, True) if i < len(ch) - 1
                                else None))
            prev = c
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = Mid(ch[-1])
        self.conv_norm_out = group_norm(ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent, 3, padding=1)

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
    def __init__(self, ch: Sequence[int], latent: int):
        super().__init__()
        self.conv_in = nn.Conv2d(latent, ch[-1], 3, padding=1)
        self.mid_block = Mid(ch[-1])
        stages, prev = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            stages.append(Stage(
                [ResnetBlock(prev, c), ResnetBlock(c, c), ResnetBlock(c, c)],
                Sampler(c, False) if i < len(ch) - 1 else None,
                "upsamplers"))
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
    def __init__(self, channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4, scaling_factor: float = 0.18215):
        super().__init__()
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(channels, latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                    1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.decoder = Decoder(channels, latent_channels)

    def encode(self, x):
        """(B, 3, H, W) in [-1, 1] -> the scaled latent mean."""
        moments = self.quant_conv(self.encoder(x))
        return moments[:, :self.latent_channels] * self.scaling_factor

    def decode(self, z):
        """Scaled latents -> (B, 3, 8h, 8w) in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z / self.scaling_factor))
