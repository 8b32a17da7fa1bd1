"""Row LayerNorm with fp32 statistics, plain and fused with a residual add.

Port of :mod:`inklayer_tpu.ops.norm` (Pallas ``layernorm_2d`` and
``layernorm_residual_2d``).  On a CUDA tensor both launch the hand-written
kernel in ``csrc/layernorm.cu``; on a CPU tensor they run the plain
version below, which is also the reference the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel


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


def _launch(x, y, scale, bias, eps):
    if x.dim() != 2:
        raise ValueError(f"layernorm kernel takes (rows, C), got {tuple(x.shape)}")
    rows, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layernorm kernel takes bf16 or fp32, got {x.dtype}")
    per_vec = 16 // x.element_size()
    if c % per_vec or c // per_vec > 16 * 32:
        raise ValueError(f"layernorm kernel: C={c} must be a multiple of "
                         f"{per_vec} and at most {16 * 32 * per_vec}")
    for name, t in (("scale", scale), ("bias", bias)) + (
            (("y", y),) if y is not None else ()):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"layernorm kernel: {name} must match x "
                            f"({x.dtype}, {x.device})")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("layernorm kernel: scale/bias must be (C,)")
    if y is not None and y.shape != x.shape:
        raise ValueError("layernorm kernel: residual must match x's shape")
    tensors = [x, scale, bias] + ([y] if y is not None else [])
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("layernorm kernel needs contiguous 16-byte "
                             "aligned tensors")
    out = torch.empty_like(x)
    sum_out = torch.empty_like(x) if y is not None else None
    lib = _kernels.lib()
    status = lib.ik_layernorm(
        _kernels.ptr(x), _kernels.ptr(y) if y is not None else None,
        _kernels.ptr(scale), _kernels.ptr(bias),
        _kernels.ptr(sum_out) if sum_out is not None else None,
        _kernels.ptr(out), rows, c, ctypes.c_float(eps),
        int(x.dtype == torch.bfloat16), _kernels.stream_handle(x.device))
    _kernels.check(status, "layernorm")
    _kernels.count_launch("layernorm")
    return sum_out, out


def layernorm_2d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (N, C); scale, bias: (C,).  LN(x) in x.dtype, fp32 statistics."""
    if not use_kernel(x, scale, bias):
        return layernorm_2d_plain(x, scale, bias, eps)
    return _launch(x, None, scale, bias, eps)[1]


def layernorm_residual_2d(x: torch.Tensor, y: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-6):
    """Returns (x + y, LN(x + y)); the sum is taken and normalised in fp32."""
    if not use_kernel(x, y, scale, bias):
        return layernorm_residual_2d_plain(x, y, scale, bias, eps)
    return _launch(x, y, scale, bias, eps)
