"""ControlNet (lllyasviel/control_v11p_sd15_inpaint architecture): a copy
of the UNet encoder, the conditioning-image embedder and the 1x1 output
convs (port of :mod:`inklayer_tpu.models.diffusion.controlnet`).

Returns one residual per UNet skip feature and one for the mid block, each
scaled by the conditioning scale; the UNet adds them
(:class:`~inklayer_tpu_torch.models.diffusion.unet.UNet2DCondition`).
NCHW; parameters carry the diffusers names (``CONTROLNET_RULES``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.models.diffusion.unet import (TimeEmbedding,
                                                       _MidBlock, down_blocks,
                                                       run_down_blocks,
                                                       skip_channels,
                                                       timestep_embedding)


class ControlNetConditioningEmbedding(nn.Module):
    """control image (B, 3, H, W) -> (B, out_ch, H/8, W/8)."""

    def __init__(self, out_ch: int = 320,
                 block_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        bc = block_channels
        self.conv_in = nn.Conv2d(3, bc[0], 3, padding=1)
        blocks = []
        for i in range(len(bc) - 1):
            blocks.append(nn.Conv2d(bc[i], bc[i], 3, padding=1))
            blocks.append(nn.Conv2d(bc[i], bc[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(bc[-1], out_ch, 3, padding=1)

    def forward(self, cond):
        x = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    def __init__(self, in_channels: int = 4,
                 block_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, num_heads: int = 8,
                 context_dim: int = 768):
        super().__init__()
        ch = block_channels
        temb = ch[0] * 4
        self.block_channels = tuple(ch)
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(ch[0], temb)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch[0])
        depths = [int(i < len(ch) - 1) for i in range(len(ch))]
        self.down_blocks = down_blocks(ch[0], ch, layers_per_block, depths,
                                       temb, [num_heads] * len(ch),
                                       context_dim)
        self.mid_block = _MidBlock(ch[-1], temb, num_heads, context_dim)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in skip_channels(ch, layers_per_block))
        self.controlnet_mid_block = nn.Conv2d(ch[-1], ch[-1], 1)

    def forward(self, sample, timesteps, context, cond_image,
                conditioning_scale: float = 1.0):
        """sample (B, in_ch, h, w); cond_image (B, 3, 8h, 8w).  Returns
        (down residuals, mid residual)."""
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.block_channels[0]).to(dtype))
        x = self.conv_in(sample.to(dtype)) + \
            self.controlnet_cond_embedding(cond_image.to(dtype))
        x, feats = run_down_blocks(self.down_blocks, x, temb, context)
        x = self.mid_block(x, temb, context)
        down = [conv(f) * conditioning_scale
                for conv, f in zip(self.controlnet_down_blocks, feats)]
        return down, self.controlnet_mid_block(x) * conditioning_scale
