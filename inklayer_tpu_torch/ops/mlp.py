"""Transformer MLP fc1 -> exact GELU -> fc2 (SAM ViT blocks).

Port of :mod:`inklayer_tpu.ops.mlp` ``mlp_gelu``.  On a CUDA tensor it runs
the hand-written bf16 GEMM kernel of ``csrc/linear_bias_act.cu`` twice:
fc1 with the bias + erf-GELU epilogue, then fc2 with the bias epilogue.
The hidden activation is rounded to bf16 between the two, where the TPU
kernel rounds it too.  :func:`gemm_config` is the kernel's launch
configuration.

Weights take PyTorch's ``nn.Linear`` layout: ``w1`` is (H, C) and ``w2`` is
(C_out, H) — the transposes of the JAX function's (C, H) and (H, C).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel

GEMM_BLOCK_M = 128
GEMM_BLOCK_N = (256, 160, 128)  # the instances of csrc/linear_bias_act.cu


def mlp_gelu_plain(x, w1, b1, w2, b2):
    h = F.gelu(F.linear(x, w1, b1))
    return F.linear(h, w2, b2)


@functools.lru_cache(maxsize=None)
def gemm_config(m: int, n: int, k: int, n_sm: int = 132):
    """(block tile N, output tiles, grid) of the persistent GEMM for an
    (m, k) x (n, k)^T product on ``n_sm`` SMs.

    Takes the shapes of the kernel's gate: m and n multiples of 128, k of
    32.  Of the tile widths in :data:`GEMM_BLOCK_N` that divide n, the one
    with the least work per SM, ceil(tiles / n_sm) * width, wins; on a tie
    the wider one (fewer bytes from L2 per operation).  The grid is one
    block per SM, or one per tile where there are fewer tiles."""
    if m <= 0 or n <= 0 or k <= 0 or m % GEMM_BLOCK_M or n % 128 or k % 32:
        raise ValueError(f"linear kernel needs M, N % 128 == 0 and K % 32 == 0"
                         f", got M={m} N={n} K={k}")
    best = None
    for bn in GEMM_BLOCK_N:
        if n % bn:
            continue
        tiles = (m // GEMM_BLOCK_M) * (n // bn)
        work = -(-tiles // n_sm) * bn
        if best is None or work < best[0]:
            best = (work, bn, tiles)
    _, bn, tiles = best
    return bn, tiles, min(tiles, n_sm)


def _linear_bias_act(a, w, b, gelu: bool):
    if a.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"linear kernel: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k or b.shape[0] != n:
        raise ValueError(f"linear kernel: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    dev = a.get_device()
    bn, _, grid = gemm_config(m, n, k, _kernels.sm_count(dev))
    for t in (a, w, b):  # one pass: type, device, layout
        if t.dtype != torch.bfloat16 or t.get_device() != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("linear kernel takes contiguous, 16-byte "
                             "aligned bf16 tensors on one device")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    status = _kernels.lib().ik_linear_bias_act(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        gelu, bn, grid, _kernels.stream(dev))
    _kernels.check(status, "mlp_gelu")
    return out


def mlp_gelu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (T, C), w1 (H, C), b1 (H,), w2 (C_out, H), b2 (C_out,) -> (T, C_out).
    """
    if not use_kernel(x, w1, b1, w2, b2):
        return mlp_gelu_plain(x, w1, b1, w2, b2)
    h = _linear_bias_act(x, w1, b1, gelu=True)
    out = _linear_bias_act(h, w2, b2, gelu=False)
    _kernels.count_launch("mlp_gelu")
    return out
