"""Plain fp32 ControlNet v1.1 inpaint (lllyasviel/control_v11p_sd15_inpaint
``config.json``): the UNet's encoder copied (4 latent input channels),
the conditioning-image embedding (16, 32, 96, 256 channels, SiLU, three
stride-2 convolutions to the latent size) added after conv_in, and a 1x1
convolution on every skip feature and on the mid block, each output scaled
by the conditioning scale.  Parameters carry the diffusers names.

Departures from the published model, as the program runs it: GroupNorm's
epsilon is 1e-6 in the resnets too (:data:`~.nn.GN_EPS`).
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from gpubench.reference.diffusion.nn import timestep_embedding
from gpubench.reference.diffusion.unet import (MidBlock, TimeEmbedding,
                                               encoder_blocks, run_encoder,
                                               skip_channels)


class ConditioningEmbedding(nn.Module):
    def __init__(self, out_ch: int, channels: Sequence[int]):
        super().__init__()
        self.conv_in = nn.Conv2d(3, channels[0], 3, padding=1)
        blocks = []
        for a, b in zip(channels[:-1], channels[1:]):
            blocks += [nn.Conv2d(a, a, 3, padding=1),
                       nn.Conv2d(a, b, 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_ch, 3, padding=1)

    def forward(self, image):
        x = F.silu(self.conv_in(image))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    def __init__(self, in_channels: int = 4,
                 block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, num_heads: int = 8,
                 context_dim: int = 768,
                 conditioning_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        ch = tuple(block_channels)
        temb = 4 * ch[0]
        self.block_channels = ch
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(ch[0], temb)
        self.controlnet_cond_embedding = ConditioningEmbedding(
            ch[0], conditioning_channels)
        self.down_blocks = encoder_blocks(ch, layers_per_block, temb,
                                          num_heads, context_dim)
        self.mid_block = MidBlock(ch[-1], temb, num_heads, context_dim)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in skip_channels(ch, layers_per_block))
        self.controlnet_mid_block = nn.Conv2d(ch[-1], ch[-1], 1)

    def forward(self, sample, timesteps, context, image, scale: float):
        """(the residuals of the UNet's skips, of its mid block)."""
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.block_channels[0]))
        x = self.conv_in(sample) + self.controlnet_cond_embedding(image)
        x, feats = run_encoder(self.down_blocks, x, temb, context)
        x = self.mid_block(x, temb, context)
        down = [conv(f) * scale
                for conv, f in zip(self.controlnet_down_blocks, feats)]
        return down, self.controlnet_mid_block(x) * scale
