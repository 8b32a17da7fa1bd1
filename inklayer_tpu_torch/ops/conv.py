"""3x3 convolution, stride 1, same padding, NHWC, no bias (port of the
measurement prototype ``scripts/ablate_pallas_conv.py``, whose Pallas
kernels ``make_pallas_conv`` and ``make_pallas_conv_concat`` compute it).

The layouts are the JAX ones at the interface: input (B, H, W, C) and
weights (3, 3, C, Cout), HWIO, as the prototype's ``run(x, w)`` takes them.
On a CUDA tensor :func:`conv3x3_nhwc` launches the implicit-GEMM kernel of
``csrc/conv3x3.cu`` (bf16 in, fp32 sums, bf16 out); on a CPU tensor it runs
:func:`conv3x3_nhwc_plain`, the prototype's shift-9 formulation.  No model
of the port calls it: the JAX package's UNet, ControlNet and VAE convolve
with XLA, so the port's keep ``F.conv2d``.  Its entry point is
``scripts/torch_conv_ab.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from inklayer_tpu_torch import _kernels
from inklayer_tpu_torch.runtime import use_kernel


def conv3x3_nhwc_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w (3, 3, C, Cout) -> (B, H, W, Cout) in x's dtype:
    nine shifted (B*H*W, C) @ (C, Cout) products of the zero-padded input,
    summed in fp32."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b * h * wd, cout), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c)
            acc += tap.float() @ w[dy, dx].float()
    return acc.reshape(b, h, wd, cout).to(x.dtype)


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """See :func:`conv3x3_nhwc_plain`.  The kernel takes contiguous bf16
    tensors on one card with C and Cout multiples of 8, aligned to 16
    bytes."""
    if not use_kernel(x, w):
        return conv3x3_nhwc_plain(x, w)
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 kernel takes x (B, H, W, C) and w "
                         f"(3, 3, C, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 kernel takes bf16, got {x.dtype} and "
                        f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"conv3x3 kernel: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 kernel takes contiguous tensors")
    b, h, wd, c = x.shape
    cout = w.shape[3]
    if c % 8 or cout % 8:
        raise ValueError(f"conv3x3 kernel takes C and Cout multiples of 8, "
                         f"got {c} and {cout}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3 kernel takes x and w aligned to 16 bytes")
    if b * h * wd * max(c, cout) >= 2 ** 31 or \
            -(-b * h * wd // 128) > 65535:
        raise ValueError(f"conv3x3 kernel: {tuple(x.shape)} is too large")
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    status = _kernels.lib().ik_conv3x3(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, cout,
        _kernels.stream(x.get_device()))
    _kernels.check(status, "conv3x3")
    _kernels.count_launch("conv3x3")
    return out
