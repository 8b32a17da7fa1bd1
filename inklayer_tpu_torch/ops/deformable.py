"""Multi-scale deformable attention sampling (GroundingDINO).

Port of :mod:`inklayer_tpu.ops.deformable`.  Semantics of
``F.grid_sample(align_corners=False, padding_mode='zeros')``: pixel
coordinate = loc * size - 0.5, out-of-range corners contribute zero.

On a CUDA tensor :func:`ms_deform_attn` launches the direct-gather kernel of
``csrc/ms_deform_attn.cu`` (ports the Pallas tiled and fused-v3 kernels);
on a CPU tensor it runs :func:`ms_deform_attn_plain`, the corner-gather
formulation of the JAX package's ``_ms_deform_attn_gather``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel

_MAX_LEVELS = 8
# the kernel's value types -> its is_bf16 flag
_VALUE_TYPES = {torch.bfloat16: 1, torch.float32: 0}


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, heads, D); sampling_locations (B, Lq, heads, L, P, 2) in
    [0, 1]; attention_weights (B, Lq, heads, L, P).  -> (B, Lq, heads*D)
    in value's dtype, accumulated in fp32."""
    b, _, n_heads, head_dim = value.shape
    lq, n_points = sampling_locations.shape[1], sampling_locations.shape[4]
    out = torch.zeros((b, n_heads, lq, head_dim), dtype=torch.float32,
                      device=value.device)
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, offset: offset + h * w].permute(0, 2, 1, 3).float()
        offset += h * w
        loc = sampling_locations[:, :, :, lvl].float()  # (B, Lq, H, P, 2)
        wts = attention_weights[:, :, :, lvl].float()   # (B, Lq, H, P)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        acc = torch.zeros((b, n_heads, lq * n_points, head_dim),
                          dtype=torch.float32, device=value.device)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            xi, yi = x0i + dx, y0i + dy
            wx = fx if dx else 1.0 - fx
            wy = fy if dy else 1.0 - fy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            cw = wx * wy * valid
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            idx = idx.permute(0, 2, 1, 3).reshape(b, n_heads, lq * n_points)
            g = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, head_dim))
            acc = acc + g * cw.permute(0, 2, 1, 3).reshape(
                b, n_heads, lq * n_points, 1)
        acc = acc * wts.permute(0, 2, 1, 3).reshape(b, n_heads, lq * n_points, 1)
        out = out + acc.reshape(b, n_heads, lq, n_points, head_dim).sum(3)
    out = out.permute(0, 2, 1, 3).reshape(b, lq, n_heads * head_dim)
    return out.to(value.dtype)


@functools.lru_cache(maxsize=64)
def level_table(spatial_shapes: Tuple[Tuple[int, int], ...]) -> tuple:
    """The kernel's level table for ``spatial_shapes`` (a tuple of (h, w)
    tuples): (S, then 8 heights, 8 widths and 8 token offsets, unused
    entries 0), built once per shape set."""
    n = len(spatial_shapes)
    if not 1 <= n <= _MAX_LEVELS:
        raise ValueError(f"ms_deform_attn kernel takes 1 to {_MAX_LEVELS} "
                         f"levels, got {n}")
    pad = (0,) * (_MAX_LEVELS - n)
    hs = tuple(int(h) for h, _ in spatial_shapes)
    ws = tuple(int(w) for _, w in spatial_shapes)
    starts, s = [], 0
    for h, w in zip(hs, ws):
        starts.append(s)
        s += h * w
    return (s,) + hs + pad + ws + pad + tuple(starts) + pad


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """See :func:`ms_deform_attn_plain`.  The kernel takes head_dim 32 (the
    GDINO width), fp32 locations and weights, bf16 or fp32 values, at most
    8 levels."""
    if not use_kernel(value, sampling_locations, attention_weights):
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if type(spatial_shapes) is not tuple:
        spatial_shapes = tuple(map(tuple, spatial_shapes))
    s_tot, *levels = level_table(spatial_shapes)
    b, s, heads, d = value.shape
    _, lq, _, n_levels, n_points, _ = sampling_locations.shape
    if d != 32:
        raise ValueError(f"ms_deform_attn kernel takes head_dim 32, got {d}")
    if s_tot != s or len(spatial_shapes) != n_levels:
        raise ValueError("ms_deform_attn kernel: spatial_shapes do not match "
                         "the value / location tensors")
    if sampling_locations.shape != (b, lq, heads, n_levels, n_points, 2) or \
            attention_weights.shape != (b, lq, heads, n_levels, n_points):
        raise ValueError("ms_deform_attn kernel: location / weight shapes")
    if value.dtype not in _VALUE_TYPES or \
            sampling_locations.dtype != torch.float32 or \
            attention_weights.dtype != torch.float32:
        raise TypeError("ms_deform_attn kernel takes bf16 or fp32 values and "
                        "fp32 locations and weights")
    if not (value.is_contiguous() and sampling_locations.is_contiguous()
            and attention_weights.is_contiguous()):
        raise ValueError("ms_deform_attn kernel takes contiguous tensors")
    # the kernel reads value 16 bytes and a location 8 bytes at a time
    if value.data_ptr() % 16 or sampling_locations.data_ptr() % 8:
        raise ValueError("ms_deform_attn kernel takes value aligned to 16 "
                         "bytes and locations aligned to 8")
    out =torch.empty((b, lq, heads * d), dtype=value.dtype,
                      device=value.device)
    status = _kernels.lib().ik_ms_deform_attn(
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), b, s, lq, heads,
        n_levels, n_points, _VALUE_TYPES[value.dtype], *levels,
        _kernels.stream(value.get_device()))
    _kernels.check(status, "ms_deform_attn")
    _kernels.count_launch("ms_deform_attn")
    return out
