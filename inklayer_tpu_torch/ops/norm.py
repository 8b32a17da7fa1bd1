"""Row LayerNorm with fp32 statistics, plain and fused with a residual add.

Port of :mod:`inklayer_tpu.ops.norm` (Pallas ``layernorm_2d`` and
``layernorm_residual_2d``).  On a CUDA tensor both launch the hand-written
kernel in ``csrc/layernorm.cu``; on a CPU tensor they run the plain
version below, which is also the reference the kernel is held against.
:func:`layernorm_config` is the kernel's launch configuration.

A ctypes launch cannot be traced, so under ``torch.export`` (or
``torch.compile``) a CUDA tensor's launch is recorded as the custom op
``inklayer::layernorm_2d`` / ``inklayer::layernorm_residual_2d``: the
program then launches the kernel on the card, as a JAX program exported on
a TPU holds the Pallas call, and runs the plain version on the CPU.
Loading such a program needs this module imported (it registers the ops).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel

# the instances of csrc/layernorm.cu: 16-byte vectors per lane (the powers
# of two take any C, guarded; 3 and 5 split the model's widths evenly)
LN_VECTORS = (1, 2, 3, 4, 5, 8, 16)


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


@functools.lru_cache(maxsize=None)
def layernorm_config(rows: int, c: int, element_size: int,
                     n_sm: int = 132):
    """(lanes per row, 16-byte vectors per lane, threads per block) of the
    kernel for ``rows`` rows of ``c`` elements of ``element_size`` bytes.

    A row takes the largest power of two of lanes, up to a warp, that
    divides its vector count into at most 16 per lane, so that every lane
    holds the same number and none idles; where none does, the whole warp
    with the last vectors guarded.  The instance is the smallest one of
    :data:`LN_VECTORS` that holds a lane's share.  Blocks shrink from 8
    warps towards 1 until the grid has at least two blocks per SM."""
    per_vec = 16 // element_size
    if c <= 0 or c % per_vec:
        raise ValueError(f"layernorm kernel: C={c} must be a positive "
                         f"multiple of {per_vec}")
    nvec = c // per_vec
    lanes = 32
    while nvec % lanes:
        lanes //= 2
    per_lane = nvec // lanes
    if per_lane > LN_VECTORS[-1]:
        lanes, per_lane = 32, -(-nvec // 32)
    if per_lane > LN_VECTORS[-1]:
        raise ValueError(f"layernorm kernel: C={c} is wider than "
                         f"{32 * LN_VECTORS[-1] * per_vec}")
    vpl = next(v for v in LN_VECTORS if v >= per_lane)
    warps = 8
    while warps > 1 and -(-rows * lanes // (32 * warps)) < 2 * n_sm:
        warps //= 2
    return lanes, vpl, 32 * warps


def _launch(x, y, scale, bias, eps):
    dt = x.dtype
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise TypeError(f"layernorm kernel takes bf16 or fp32, got {dt}")
    if x.dim() != 2:
        raise ValueError(f"layernorm kernel takes (rows, C), got {tuple(x.shape)}")
    rows, c = x.shape
    dev = x.get_device()
    lanes, vpl, threads = layernorm_config(rows, c, x.element_size(),
                                           _kernels.sm_count(dev))
    for t in (x, scale, bias) if y is None else (x, y, scale, bias):
        # one pass: type, device, layout
        if t.dtype is not dt or t.get_device() != dev:
            raise TypeError(f"layernorm kernel: scale, bias and the residual "
                            f"must match x ({dt}, cuda:{dev})")
        if not t.is_contiguous() or t.data_ptr() & 15:
            raise ValueError("layernorm kernel needs contiguous 16-byte "
                             "aligned tensors")
    if scale.shape != bias.shape or bias.shape != (c,):
        raise ValueError("layernorm kernel: scale/bias must be (C,)")
    out = torch.empty_like(x)
    if y is None:
        sum_out, ys = None, 0
    else:
        if y.shape != x.shape:
            raise ValueError("layernorm kernel: residual must match x's shape")
        sum_out = torch.empty_like(x)
        ys = sum_out.data_ptr()
    status = _kernels.lib().ik_layernorm(
        x.data_ptr(), 0 if y is None else y.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), ys, out.data_ptr(), rows, c, lanes, vpl, threads,
        eps, dt is torch.bfloat16, _kernels.stream(dev))
    _kernels.check(status, "layernorm")
    _kernels.count_launch("layernorm")
    return sum_out, out


@torch.library.custom_op("inklayer::layernorm_2d", mutates_args=(),
                         device_types="cuda")
def _layernorm_2d_op(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    return _launch(x, None, scale, bias, eps)[1]


@torch.library.custom_op("inklayer::layernorm_residual_2d", mutates_args=(),
                         device_types="cuda")
def _layernorm_residual_2d_op(x: torch.Tensor, y: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(x, y, scale, bias, eps)


_layernorm_2d_op.register_kernel("cpu")(layernorm_2d_plain)
_layernorm_residual_2d_op.register_kernel("cpu")(layernorm_residual_2d_plain)


@_layernorm_2d_op.register_fake
def _(x, scale, bias, eps):
    return torch.empty_like(x)


@_layernorm_residual_2d_op.register_fake
def _(x, y, scale, bias, eps):
    return torch.empty_like(x), torch.empty_like(x)


def layernorm_2d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (N, C); scale, bias: (C,).  LN(x) in x.dtype, fp32 statistics."""
    if not use_kernel(x, scale, bias):
        return layernorm_2d_plain(x, scale, bias, eps)
    if torch.compiler.is_compiling():  # traced: the launch as one op
        return _layernorm_2d_op(x, scale, bias, eps)
    return _launch(x, None, scale, bias, eps)[1]


def layernorm_residual_2d(x: torch.Tensor, y: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-6):
    """Returns (x + y, LN(x + y)); the sum is taken and normalised in fp32."""
    if not use_kernel(x, y, scale, bias):
        return layernorm_residual_2d_plain(x, y, scale, bias, eps)
    if torch.compiler.is_compiling():
        return _layernorm_residual_2d_op(x, y, scale, bias, eps)
    return _launch(x, y, scale, bias, eps)
