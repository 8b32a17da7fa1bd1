"""Plain fp32 copy of ``inklayer_tpu_torch.nn.layers`` for the benchmark's
reference: the same module tree and parameter names, with no kernel
and no tensor parallelism."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.ops import (layernorm_2d, layernorm_2d_plain,
                                    layernorm_residual_2d,
                                    layernorm_residual_2d_plain)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics.

    ``ln(x)`` returns LN(x); ``ln(x, residual)`` returns ``(x + residual,
    LN(x + residual))``.  Rows >= 512 with C % 8 == 0 go through the
    kernel op (the JAX package's gate, nn/layers.py:116,139); smaller
    shapes take the plain version on any device."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None):
        shape = x.shape
        c = shape[-1]
        x2 = x.reshape(-1, c)
        gate = c % 8 == 0 and x2.shape[0] >= 512
        if residual is not None:
            r2 = residual.reshape(-1, c)
            fn = layernorm_residual_2d if gate else layernorm_residual_2d_plain
            s, o = fn(x2.contiguous(), r2.contiguous(), self.weight, self.bias,
                      eps=self.eps)
            return s.reshape(shape), o.reshape(shape)
        fn = layernorm_2d if gate else layernorm_2d_plain
        return fn(x2.contiguous(), self.weight, self.bias,
                  eps=self.eps).reshape(shape)


def group_norm_nhwc(x: torch.Tensor, groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """flax nn.GroupNorm on NHWC (fp32 statistics over H, W and the
    group's channels)."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * weight.float() + bias.float()).to(x.dtype)


class MLP(nn.Module):
    """Linear -> act -> Linear with checkpoint names (``lin1``/``lin2`` for
    SAM, ``fc1``/``fc2`` for Swin); ``fused`` is taken and ignored."""

    def __init__(self, dim: int, hidden: int, out: int, act: str = "gelu",
                 names: Tuple[str, str] = ("lin1", "lin2"),
                 fused: bool = False):
        super().__init__()
        self.names = names
        self.act = act
        setattr(self, names[0], nn.Linear(dim, hidden))
        setattr(self, names[1], nn.Linear(hidden, out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1 = getattr(self, self.names[0])
        fc2 = getattr(self, self.names[1])
        h = fc1(x)
        h = F.gelu(h) if self.act == "gelu" else F.relu(h)
        return fc2(h)


class MLPBlock(nn.Module):
    """num_layers Linear layers with ReLU between (detection / SAM heads);
    checkpoint keys ``layers.{i}``."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], hidden if i < num_layers - 1 else out)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding applied as space-to-depth + matmul (the
    JAX package's ``_PatchProj``).  NHWC in, NHWC out; the parameter is the
    checkpoint's ``proj`` Conv2d."""

    def __init__(self, patch_size: int, in_ch: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, hh, ww, c = x.shape
        h, w = hh // p, ww // p
        # (b, h, w, c, p, p): the conv weight's (in, kh, kw) order
        xp = x.reshape(b, h, p, w, p, c).permute(0, 1, 3, 5, 2, 4).reshape(
            b, h, w, c * p * p)
        wt = self.proj.weight.reshape(self.proj.out_channels, c * p * p)
        return F.linear(xp.to(wt.dtype), wt, self.proj.bias)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B*nWh*nWw, window, window, C), zero-padding H/W up to
    a multiple of ``window`` (bottom-right)."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, padded_hw,
                       orig_hw) -> torch.Tensor:
    """Inverse of :func:`window_partition`, cropped back to ``orig_hw``."""
    hp, wp = padded_hw
    h, w = orig_hw
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def resize_pad_mask(mask: torch.Tensor, hw) -> torch.Tensor:
    """Downsample a top-left-anchored rectangular pad mask (B, H, W) bool to
    ``hw`` analytically (ceil keeps >= 1 valid row/col)."""
    b, big_h, big_w = mask.shape
    h, w = hw
    vh = (~mask[:, :, 0]).sum(1)
    vw = (~mask[:, 0, :]).sum(1)
    vh_l = torch.clamp(torch.ceil(vh.float() * h / big_h).long(), 1, h)
    vw_l = torch.clamp(torch.ceil(vw.float() * w / big_w).long(), 1, w)
    rows = torch.arange(h, device=mask.device)[None, :, None]
    cols = torch.arange(w, device=mask.device)[None, None, :]
    return (rows >= vh_l[:, None, None]) | (cols >= vw_l[:, None, None])
