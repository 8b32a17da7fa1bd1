"""Transformer MLP fc1 -> exact GELU -> fc2 (SAM ViT blocks).

Port of :mod:`inklayer_tpu.ops.mlp` ``mlp_gelu``.  On a CUDA tensor it runs
the hand-written bf16 GEMM kernel of ``csrc/linear_bias_act.cu`` twice:
fc1 with the bias + erf-GELU epilogue, then fc2 with the bias epilogue.
The hidden activation is rounded to bf16 between the two, where the TPU
kernel rounds it too.

Weights take PyTorch's ``nn.Linear`` layout: ``w1`` is (H, C) and ``w2`` is
(C_out, H) — the transposes of the JAX function's (C, H) and (H, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel


def mlp_gelu_plain(x, w1, b1, w2, b2):
    h = F.gelu(F.linear(x, w1, b1))
    return F.linear(h, w2, b2)


def _linear_bias_act(a, w, b, gelu: bool):
    m, k = a.shape
    n = w.shape[0]
    if w.shape != (n, k) or b.shape != (n,):
        raise ValueError(f"linear kernel: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if m % 128 or n % 128 or k % 32:
        raise ValueError(f"linear kernel needs M, N % 128 == 0 and K % 32 == 0"
                         f", got M={m} N={n} K={k}")
    for t in (a, w, b):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("linear kernel takes contiguous, 16-byte "
                             "aligned bf16 tensors")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    status = _kernels.lib().ik_linear_bias_act(
        _kernels.ptr(a), _kernels.ptr(w), _kernels.ptr(b), _kernels.ptr(out),
        m, n, k, int(gelu), _kernels.stream_handle(a.device))
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
