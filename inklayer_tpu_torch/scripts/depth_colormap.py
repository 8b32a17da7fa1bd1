"""The depth scripts' colouring: matplotlib's ``Spectral_r`` as the port's
own 256-entry float64 table (matplotlib is not a dependency of the port),
and the two ways the JAX package's depth scripts apply it.

The table is built as matplotlib builds its ``Spectral`` colormap (the 11
ColorBrewer colours at equal steps, ``LinearSegmentedColormap.from_list``
then ``reversed()``, a lookup table of 256 entries), so its entries are
the same float64 values.  :func:`spectral_r` indexes it as a matplotlib
colormap does: integers are indices, floats in [0, 1] take index
``int(x * 256)`` with 1.0 at 255.
"""

from __future__ import annotations

import numpy as np

LUT_SIZE = 256
# ColorBrewer "Spectral", 11 classes (matplotlib's _Spectral_data), as
# 8-bit RGB
_SPECTRAL_8BIT = (
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97),
    (254, 224, 139), (255, 255, 191), (230, 245, 152), (171, 221, 164),
    (102, 194, 165), (50, 136, 189), (94, 79, 162))


def _spectral_r_table(n: int = LUT_SIZE) -> np.ndarray:
    """(n, 3) float64: matplotlib's ``_create_lookup_table`` over the
    reversed segments of the 11 colours."""
    colors = np.asarray(_SPECTRAL_8BIT, np.float64) / 255.0
    vals = np.linspace(0, 1, len(colors))
    # reversed(): x -> 1 - x, in reverse order
    x = np.asarray([1.0 - v for v in vals[::-1]]) * (n - 1)
    y = colors[::-1]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([y[:1], distance[:, None] * (y[ind] - y[ind - 1])
                          + y[ind - 1], y[-1:]])
    return np.clip(lut, 0.0, 1.0)


SPECTRAL_R = _spectral_r_table()


def spectral_r(x: np.ndarray) -> np.ndarray:
    """``matplotlib.colormaps["Spectral_r"](x)[..., :3]``: (..., 3)
    float64 RGB in [0, 1]."""
    n = LUT_SIZE
    xa = np.array(x, copy=True)
    bad = np.zeros(xa.shape, bool)
    if xa.dtype.kind == "f":
        bad = np.isnan(xa)
        xa *= n
        xa[xa == n] = n - 1
        with np.errstate(invalid="ignore"):
            xa = xa.astype(int)
    rgb = SPECTRAL_R[np.clip(xa, 0, n - 1)]
    rgb[bad] = 0.0  # the colormap's "bad" colour is transparent black
    return rgb


def colorize_u8(depth: np.ndarray, grayscale: bool = False) -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 RGB through uint8 indices, the range
    floored at 1e-8 (the JAX ``scripts/depth_demo.py`` ``colorize``)."""
    lo, hi = float(depth.min()), float(depth.max())
    d8 = ((depth - lo) / max(hi - lo, 1e-8) * 255.0).astype(np.uint8)
    if grayscale:
        return np.repeat(d8[..., None], 3, axis=-1)
    return (spectral_r(d8) * 255).astype(np.uint8)


def colorize_unit(depth: np.ndarray, grayscale: bool) -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 RGB through the [0, 1] range, zeros
    for a constant map (the JAX ``scripts/run_depth.py`` ``colorize``)."""
    lo, hi = float(depth.min()), float(depth.max())
    norm = (depth - lo) / (hi - lo) if hi > lo else np.zeros_like(depth)
    if grayscale:
        return np.repeat((norm * 255).astype(np.uint8)[..., None], 3, -1)
    return (spectral_r(norm) * 255).astype(np.uint8)
