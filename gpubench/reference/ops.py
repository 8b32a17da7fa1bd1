"""The plain versions of the port's kernel ops (``inklayer_tpu_torch.ops``
``attention``, ``norm``, ``mlp``, ``deformable``), copied, and the
identity forms of its tensor-parallel helpers: the reference runs every
op in plain PyTorch on one device."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.image import resize_matrix

_NEG_INF = -1e30


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         mask: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Nq, D), k/v: (..., Nk, D).  bias: additive, broadcastable
    to (..., Nq, Nk); mask: bool, True = attend.  Logits and softmax in
    fp32, probabilities rounded to v's dtype before the PV product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention(q, k, v, scale: Optional[float] = None):
    return sdpa(q, k, v, scale=scale)


def attention(q, k, v, bias=None, mask=None, scale=None,
              min_flash_len: int = 1024):
    return sdpa(q, k, v, bias=bias, mask=mask, scale=scale)


def relpos_attention(q, k, v, rel_h, rel_w, scale: float):
    """logits[t, u] = scale * q_t . k_u + rel_h[t, u // kw] + rel_w[t, u % kw]
    with q, k, v (BH, N, D), rel_h (BH, N, kh), rel_w (BH, N, kw)."""
    bh, n, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
            ).reshape(bh, n, kh * kw)
    return sdpa(q, k, v, bias=bias, scale=scale)


def resize_rel_table(rel_pos: torch.Tensor, q_size: int,
                     k_size: int) -> torch.Tensor:
    """Linear-resample a (L, C) rel-pos table to 2*max(q, k)-1 rows when it
    was trained for another size (jax.image.resize 'linear' semantics)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] == max_rel_dist:
        return rel_pos
    m = torch.from_numpy(resize_matrix(rel_pos.shape[0], max_rel_dist)).to(
        rel_pos.device)
    return m @ rel_pos.float()


def gather_rel_pos(rel_pos: torch.Tensor, q_size: int,
                   k_size: int) -> torch.Tensor:
    """(q_size, k_size, C) table with entry [i, j] = rel_pos[i - j + k - 1]
    (segment-anything get_rel_pos, q_size == k_size on the encoder)."""
    rel_pos = resize_rel_table(rel_pos, q_size, k_size)
    qi = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    ki = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    idx = (qi - ki + (k_size - 1) * max(q_size / k_size, 1.0)).astype(np.int64)
    return rel_pos[torch.from_numpy(idx).to(rel_pos.device)]


def rel_terms(q: torch.Tensor, rel_pos_h: torch.Tensor,
              rel_pos_w: torch.Tensor):
    """Decomposed rel-pos q-terms from UNSCALED q of shape (B, H, W, C)
    (any leading batch dims): rel_h (..., H, W, H), rel_w (..., H, W, W)."""
    h, w = q.shape[-3], q.shape[-2]
    rh = gather_rel_pos(rel_pos_h, h, h).to(q.dtype)
    rw = gather_rel_pos(rel_pos_w, w, w).to(q.dtype)
    rel_h = torch.einsum("...hwc,hkc->...hwk", q, rh)
    rel_w = torch.einsum("...hwc,wkc->...hwk", q, rw)
    return rel_h, rel_w


def layernorm_2d_plain(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def layernorm_residual_2d_plain(x: torch.Tensor, y: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor,
                                eps: float = 1e-6):
    s = x.float() + y.float()
    mean = s.mean(-1, keepdim=True)
    sc = s - mean
    var = (sc * sc).mean(-1, keepdim=True)
    out = sc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return s.to(x.dtype), out.to(x.dtype)


layernorm_2d = layernorm_2d_plain
layernorm_residual_2d = layernorm_residual_2d_plain


def mlp_gelu(x, w1, b1, w2, b2):
    h = F.gelu(F.linear(x, w1, b1))
    return F.linear(h, w2, b2)


def ms_deform_attn(value: torch.Tensor,
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


# the tensor-parallel helpers with no tp group: identities and the whole
# layers (``inklayer_tpu_torch.parallel.tp`` with ``tp`` None)
def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    return x


def all_reduce_max(x: torch.Tensor, tp) -> torch.Tensor:
    return x.detach()


def row_linear(x: torch.Tensor, linear, tp) -> torch.Tensor:
    return linear(x)


def ffn(x: torch.Tensor, first, second, tp, act=F.relu) -> torch.Tensor:
    return second(act(first(x)))
