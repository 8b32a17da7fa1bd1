"""Raster brush augmentation for dataset synthesis / fine-tuning.

The reference ships an Illustrator ExtendScript (InkScenes/
brush_augmentation.jsx) that re-renders vector sketches with varied brushes
to synthesize training diversity.  This is the raster-domain equivalent:
stroke-width jitter (morphological), elastic warps, opacity/texture
variation, and background tinting — usable to augment InkScenes-style
sketches when fine-tuning the detector (parallel/detection_loss.py).

The port's copy of :mod:`inklayer_tpu.pipeline.augment`, on the numpy
filters of :mod:`inklayer_tpu_torch.ops.ndimage` (bit-exact to scipy's)
instead of ``scipy.ndimage``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from inklayer_tpu_torch.ops import ndimage


def _rng(seed):
    return np.random.default_rng(seed)


def stroke_width_jitter(gray: np.ndarray, amount: int, ink_threshold: int = 250
                        ) -> np.ndarray:
    """amount > 0: thicken strokes by dilation; < 0: thin by erosion.
    Operates on ink (dark) pixels, preserving grayscale values by min/max
    filtering."""
    if amount == 0:
        return gray.copy()
    size = 2 * abs(amount) + 1
    if amount > 0:
        return ndimage.minimum_filter(gray, size)
    return np.where(
        ndimage.maximum_filter(gray, size) > ink_threshold, 255, gray
    ).astype(np.uint8)


def elastic_warp(gray: np.ndarray, alpha: float = 8.0, sigma: float = 6.0,
                 seed: int = 0) -> np.ndarray:
    """Smooth random displacement field (brush-hand wobble)."""
    r = _rng(seed)
    h, w = gray.shape
    dx = ndimage.gaussian_filter(r.standard_normal((h, w)), sigma) * alpha
    dy = ndimage.gaussian_filter(r.standard_normal((h, w)), sigma) * alpha
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    coords = np.stack([yy + dy, xx + dx])
    return ndimage.map_coordinates(gray, coords, order=1).astype(np.uint8)


def opacity_texture(gray: np.ndarray, strength: float = 0.3,
                    scale: float = 12.0, seed: int = 0,
                    ink_threshold: int = 250) -> np.ndarray:
    """Per-stroke opacity variation (dry-brush look): lighten ink pixels by a
    smooth noise field."""
    r = _rng(seed)
    h, w = gray.shape
    noise = ndimage.gaussian_filter(r.random((h, w)), scale)
    noise = (noise - noise.min()) / max(float(np.ptp(noise)), 1e-9)
    ink = gray < ink_threshold
    lightened = gray.astype(np.float64) + strength * 255.0 * noise
    out = np.where(ink, np.clip(lightened, 0, 245), gray)
    return out.astype(np.uint8)


def background_tint(gray: np.ndarray, tint: float = 0.05, seed: int = 0
                    ) -> np.ndarray:
    """Paper-like background shade (reference sketches are scans/exports
    with off-white paper)."""
    r = _rng(seed)
    h, w = gray.shape
    shade = 255.0 * (1.0 - tint * r.random())
    out = gray.astype(np.float64)
    return np.where(gray >= 250, shade, out).astype(np.uint8)


def augment_sketch(
    gray: np.ndarray,
    labels: Optional[np.ndarray] = None,
    seed: int = 0,
    width_range: Tuple[int, int] = (-1, 2),
    warp_alpha: float = 6.0,
    opacity_strength: float = 0.25,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One randomized brush augmentation; the GT label matrix (if given)
    is warped with the same displacement so instance masks stay aligned."""
    r = _rng(seed)
    out = gray.copy()
    amount = int(r.integers(width_range[0], width_range[1] + 1))
    out = stroke_width_jitter(out, amount)
    alpha = float(r.uniform(0, warp_alpha))
    sub = int(r.integers(0, 2 ** 31))
    out = elastic_warp(out, alpha=alpha, seed=sub)
    out = opacity_texture(out, strength=float(r.uniform(0, opacity_strength)),
                          seed=sub + 1)
    out = background_tint(out, seed=sub + 2)
    warped_labels = None
    if labels is not None:
        h, w = labels.shape
        rr = _rng(sub)
        dx = ndimage.gaussian_filter(rr.standard_normal((h, w)), 6.0) * alpha
        dy = ndimage.gaussian_filter(rr.standard_normal((h, w)), 6.0) * alpha
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        warped_labels = ndimage.map_coordinates(
            labels, np.stack([yy + dy, xx + dx]), order=0)
    return out, warped_labels
