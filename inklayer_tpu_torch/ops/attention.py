"""Attention ops: explicit matmul + softmax, and SAM's rel-pos attention.

Port of :mod:`inklayer_tpu.ops.attention`:

* :func:`sdpa` — reference attention (short sequences: Swin and SAM-decoder
  windows, BERT, GDINO decoder queries), matmul + fp32 softmax + matmul;
* :func:`relpos_attention` — SAM encoder attention with the decomposed
  relative-position bias.  On a CUDA tensor it launches the kernel of
  ``csrc/relpos_attention.cu`` (ports the Pallas window kernel
  ``sam_window_block_attention`` and the global kernel
  ``sam_global_attention2``); on a CPU tensor it runs the plain version;
* :func:`flash_attention` — attention with no bias over long sequences
  (DINOv2's 1370 tokens at head_dim 64; the SD1.5 UNet's and ControlNet's
  self-attention, 9216 tokens at head_dim 40 and 2304 at head_dim 80 for
  a 768^2 image).  On a CUDA tensor it launches the kernel of
  ``csrc/flash_attention.cu`` (ports the Pallas ``flash_attention``); on a
  CPU tensor it runs the plain version;
* :func:`attention` — the JAX package's dispatcher: 4-D input with no bias
  and no mask and at least ``min_flash_len`` keys goes to
  :func:`flash_attention`, everything else to :func:`sdpa`;
* the rel-term helpers (:func:`gather_rel_pos`, :func:`rel_terms`), which
  are XLA in the JAX package and plain PyTorch here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel

_NEG_INF = -1e30
FLASH_HEAD_DIMS = (40, 64, 80)  # the instances of csrc/flash_attention.cu


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


# ---------------------------------------------------------------------------
# Flash attention (no bias)
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """(BH, Nq, D) attention over (BH, Nk, D) keys and values (the port
    pads no keys, so there is no tail to mask)."""
    return sdpa(q, k, v, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale * q k^T) v over (BH, N, D); scale defaults to
    D ** -0.5.  Returns (BH, N, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    bh, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash kernel: q, k, v must have one shape")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head_dim "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("flash kernel takes contiguous, 16-byte aligned "
                             "bf16 tensors")
    out = torch.empty_like(q)
    status = _kernels.lib().ik_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, n, d,
        float(scale), _kernels.stream(q.get_device()))
    _kernels.check(status, "flash_attention")
    _kernels.count_launch("flash_attention", f"d{d}")
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              min_flash_len: int = 1024) -> torch.Tensor:
    """(B, H, N, D) attention: long unbiased, unmasked sequences go to
    :func:`flash_attention`, everything else to :func:`sdpa`."""
    if not (bias is None and mask is None and k.shape[-2] >= min_flash_len
            and q.dim() == 4):
        return sdpa(q, k, v, bias=bias, mask=mask, scale=scale)
    b, h, nq, d = q.shape
    fold = lambda t: t.reshape(b * h, t.shape[-2], d).contiguous()
    return flash_attention(fold(q), fold(k), fold(v), scale).reshape(
        b, h, nq, d)


# ---------------------------------------------------------------------------
# SAM rel-pos attention
# ---------------------------------------------------------------------------


def relpos_attention_plain(q, k, v, rel_h, rel_w, scale: float):
    """logits[t, u] = scale * q_t . k_u + rel_h[t, u // kw] + rel_w[t, u % kw]
    with q, k, v (BH, N, D), rel_h (BH, N, kh), rel_w (BH, N, kw)."""
    bh, n, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
            ).reshape(bh, n, kh * kw)
    return sdpa(q, k, v, bias=bias, scale=scale)


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """SAM attention with the decomposed rel-pos bias; see
    :func:`relpos_attention_plain`.  Returns (BH, N, D) in q's dtype."""
    if not use_kernel(q, k, v, rel_h, rel_w):
        return relpos_attention_plain(q, k, v, rel_h, rel_w, scale)
    bh, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("relpos kernel: q, k, v must have one shape")
    if rel_h.shape != (bh, n, kh) or rel_w.shape != (bh, n, kw) \
            or kh * kw != n or max(kh, kw) > 64:
        raise ValueError(f"relpos kernel: rel_h {tuple(rel_h.shape)} / rel_w "
                         f"{tuple(rel_w.shape)} do not tile N={n} (kh, kw<=64)")
    if d not in (64, 80):
        raise ValueError(f"relpos kernel is built for head_dim 64 and 80, "
                         f"got {d}")
    for t in (q, k, v, rel_h, rel_w):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("relpos kernel takes contiguous, 16-byte "
                             "aligned bf16 tensors")
    out = torch.empty_like(q)
    status = _kernels.lib().ik_relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), bh, n, d, kh, kw, float(scale),
        _kernels.stream(q.get_device()))
    _kernels.check(status, "relpos_attention")
    _kernels.count_launch("relpos_attention")
    return out


def resize_rel_table(rel_pos: torch.Tensor, q_size: int,
                     k_size: int) -> torch.Tensor:
    """Linear-resample a (L, C) rel-pos table to 2*max(q, k)-1 rows when it
    was trained for another size (jax.image.resize 'linear' semantics)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] == max_rel_dist:
        return rel_pos
    from inklayer_tpu_torch.ops.image import resize_matrix

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
