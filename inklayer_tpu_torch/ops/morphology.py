"""Binary morphology on (..., H, W) bool masks (port of
:mod:`inklayer_tpu.ops.morphology`).

cv2 semantics, as in the JAX package: dilation assumes 0 outside the image,
erosion 1 (so borders are not eaten).  Rectangular structuring elements are
separable window maxima (``max_pool2d`` along one axis, then the other):
dilate(m) = any over the window, erode(m) = not dilate(not m).  Other
elements (ellipse, disk, the neighbour count) are counts of a ``conv2d``
with the 0/1 element.  The counts are small integers, exact in fp32 and in
TF32 (cuDNN convolves fp32 in TF32 by default; 0/1 operands lose nothing),
so no precision switch is needed.  The JAX package's channel-packed path
(``_rect_chan_path``) is a TPU layout trick and has no counterpart here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def rect_kernel(k: int) -> np.ndarray:
    return np.ones((k, k), np.float32)


@functools.lru_cache(maxsize=32)
def ellipse_kernel(k: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (k, k)) semantics."""
    se = np.zeros((k, k), np.float32)
    r = k // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    for i in range(k):
        dy = abs(i - r)
        dx = int(round(r * np.sqrt(max(0.0, 1.0 - (dy * dy) * inv_r2)))) \
            if r > 0 else 0
        se[i, max(0, r - dx): min(k, r + dx + 1)] = 1.0
    return se


@functools.lru_cache(maxsize=32)
def disk_kernel(radius: int) -> np.ndarray:
    """skimage.morphology.disk(radius) semantics: x^2 + y^2 <= r^2."""
    yy, xx = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return ((yy * yy + xx * xx) <= radius * radius).astype(np.float32)


def _is_rect(se: np.ndarray) -> bool:
    return bool((se == 1.0).all())


def _check_odd(se: np.ndarray) -> None:
    if se.shape[0] % 2 == 0 or se.shape[1] % 2 == 0:
        raise ValueError(f"structuring element {se.shape} must be odd-sized")


def _window_any(mask: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Any-True over a centred kh x kw window, 0 outside the image."""
    shape = mask.shape
    dtype = torch.float16 if mask.is_cuda else torch.float32
    x = mask.reshape(-1, 1, *shape[-2:]).to(dtype)
    if kh > 1:
        x = F.max_pool2d(x, (kh, 1), stride=1, padding=(kh // 2, 0))
    if kw > 1:
        x = F.max_pool2d(x, (1, kw), stride=1, padding=(0, kw // 2))
    return (x > 0.5).reshape(shape)


def conv_counts(mask: torch.Tensor, se: np.ndarray,
                border: float = 0.0) -> torch.Tensor:
    """(..., H, W) bool -> fp32 count of True pixels under ``se`` centred on
    each pixel; ``border`` is the value assumed outside the image."""
    _check_odd(se)
    shape = mask.shape
    kh, kw = se.shape
    x = mask.reshape(-1, 1, *shape[-2:]).float()
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), value=border)
    w = torch.from_numpy(np.ascontiguousarray(se, np.float32)).to(x.device)
    return F.conv2d(x, w[None, None]).reshape(shape)


def binary_dilate(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    _check_odd(se)
    if _is_rect(se):
        return _window_any(mask, *se.shape)
    return conv_counts(mask, se, border=0.0) > 0.5


def binary_erode(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    _check_odd(se)
    if _is_rect(se):
        return ~_window_any(~mask, *se.shape)
    return conv_counts(mask, se, border=1.0) > float(se.sum()) - 0.5


def morph_close(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return binary_erode(binary_dilate(mask, se), se)


def morph_open(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return binary_dilate(binary_erode(mask, se), se)


def neighbor_count(mask: torch.Tensor, window: int = 3) -> torch.Tensor:
    """True neighbours in a window, the centre pixel excluded."""
    se = np.ones((window, window), np.float32)
    se[window // 2, window // 2] = 0.0
    return conv_counts(mask, se)
