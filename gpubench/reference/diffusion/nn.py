"""Plain fp32 building blocks of the diffusion reference: attention by
matmul and softmax, GroupNorm, the sinusoidal timestep embedding."""

from __future__ import annotations

import math

import torch
from torch import nn

# query rows per block of the plain attention: bounds the (rows, keys)
# scores held at once (SD1.5's level 0 at 768^2 has 9216 keys)
QUERY_BLOCK = 1024

# GroupNorm's epsilon in every diffusion model of the program (flax's
# default); the published UNet and ControlNet resnets use 1e-5, their
# transformers' GroupNorm and the VAE 1e-6
GN_EPS = 1e-6


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (..., N, D), in fp32 by query
    blocks; ``mask`` (Nq, Nk) bool, True = attend."""
    scale = q.shape[-1] ** -0.5
    out = []
    for s in range(0, q.shape[-2], QUERY_BLOCK):
        qb = q[..., s:s + QUERY_BLOCK, :].float()
        logits = torch.matmul(qb, k.float().transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask[s:s + QUERY_BLOCK], -1e30)
        out.append(torch.matmul(torch.softmax(logits, dim=-1), v.float()))
    return torch.cat(out, dim=-2).to(q.dtype)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=GN_EPS)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) timesteps -> (B, dim): cos of the half, then sin (SD1.5's
    ``flip_sin_to_cos``, frequency shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
