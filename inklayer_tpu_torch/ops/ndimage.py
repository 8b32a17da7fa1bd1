"""The few ``scipy.ndimage`` filters the train-time augmentation uses, in
numpy (the port imports no scipy).

Each mirrors scipy's C arithmetic so that the results are bit-exact:

* :func:`minimum_filter` / :func:`maximum_filter`: a square window, mode
  ``reflect`` (half-sample symmetric), one axis after the other;
* :func:`gaussian_filter`: float64, one axis after the other, scipy's 1-D
  kernel (``exp(-x^2 / (2 sigma^2))`` over radius ``int(truncate * sigma +
  0.5)``, normalised by its sum) and its summation for a symmetric kernel
  (the centre tap, then each pair of mirrored taps from the outside in,
  added before the product), mode ``reflect``;
* :func:`map_coordinates`: orders 0 and 1, mode ``nearest`` (each tap's
  index clamped to the grid, the coordinate itself not), order-1 weights
  ``1 - t`` and ``1 - (1 - t)``, the (order + 1)^2 taps added in C order,
  integer outputs rounded half away from zero and clipped to the type's
  range.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np


def _window_filter(image: np.ndarray, size: int, reduce) -> np.ndarray:
    if size < 1:
        raise ValueError(f"filter size must be >= 1, got {size}")
    lo = size // 2
    hi = size - lo - 1
    out = np.asarray(image)
    for axis in range(out.ndim):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (lo, hi)
        padded = np.pad(out, pad, mode="symmetric")
        n = out.shape[axis]
        acc = np.take(padded, np.arange(n), axis=axis)
        for k in range(1, size):
            acc = reduce(acc, np.take(padded, np.arange(k, k + n), axis=axis))
        out = acc
    return out.astype(image.dtype, copy=False)


def minimum_filter(image: np.ndarray, size: int) -> np.ndarray:
    """``scipy.ndimage.minimum_filter(image, size=size)``."""
    return _window_filter(image, size, np.minimum)


def maximum_filter(image: np.ndarray, size: int) -> np.ndarray:
    """``scipy.ndimage.maximum_filter(image, size=size)``."""
    return _window_filter(image, size, np.maximum)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy's ``_gaussian_kernel1d`` at order 0."""
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def gaussian_filter(image: np.ndarray, sigma: float,
                    truncate: float = 4.0) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter(image, sigma)`` of a float64 array
    (mode ``reflect``)."""
    out = np.asarray(image, dtype=np.float64)
    radius = int(truncate * float(sigma) + 0.5)
    w = gaussian_kernel1d(float(sigma), radius)[::-1]
    for axis in range(out.ndim):
        x = np.moveaxis(out, axis, -1)
        n = x.shape[-1]
        xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(radius, radius)],
                    mode="symmetric")
        acc = xp[..., radius:radius + n] * w[radius]
        for j in range(radius, 0, -1):
            acc = acc + (xp[..., radius - j:radius - j + n]
                         + xp[..., radius + j:radius + j + n]) * w[radius - j]
        out = np.moveaxis(acc, -1, axis)
    return np.ascontiguousarray(out)


def _cast(values: np.ndarray, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    if dtype.kind in "ui":
        info = np.iinfo(dtype)
        values = np.where(values > 0, values + 0.5, values - 0.5)
        values = np.clip(np.trunc(values), info.min, info.max)
    return values.astype(dtype)


def map_coordinates(image: np.ndarray, coordinates: Sequence[np.ndarray],
                    order: int = 1) -> np.ndarray:
    """``scipy.ndimage.map_coordinates(image, coordinates, order=order,
    mode="nearest")`` for orders 0 and 1; the output has the image's
    dtype, as scipy's does."""
    if order not in (0, 1):
        raise ValueError(f"map_coordinates: order {order} is not ported "
                         f"(0 and 1 are)")
    image = np.asarray(image)
    coords = np.asarray(coordinates, dtype=np.float64)
    if coords.shape[0] != image.ndim:
        raise ValueError("map_coordinates: one coordinate array per axis")
    taps = []  # per axis: [(index, weight)] for the order + 1 taps
    for axis, c in enumerate(coords):
        n = image.shape[axis]
        edge = lambda i: np.clip(i, 0, n - 1).astype(np.intp)
        if order == 0:
            taps.append([(edge(np.floor(c + 0.5)), None)])
            continue
        start = np.floor(c)
        w0 = 1.0 - (c - start)
        w1 = 1.0 - w0
        taps.append([(edge(start), w0), (edge(start + 1), w1)])
    values = image.astype(np.float64)
    total = np.zeros(coords.shape[1:], np.float64)
    for tap in itertools.product(*taps):  # C order, the last axis fastest
        coeff = values[tuple(idx for idx, _ in tap)]
        for _, w in tap:
            if w is not None:
                coeff = coeff * w
        total = total + coeff
    return _cast(total, image.dtype)
