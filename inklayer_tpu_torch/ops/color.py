"""Pastel palette and mask colouring of a sketch (copied from
:mod:`inklayer_tpu.ops.color`, whose package ``__init__`` imports jax).

Vectorised form of the reference's utils/visualization.py.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def generate_pastel_colors(n_colors: int) -> List[Tuple[int, int, int]]:
    """Evenly spaced hues, interleaved for contrast, S=0.7 V=0.88
    (visualization.py:30-60)."""
    hues = [x / n_colors for x in range(n_colors)]
    result: List[float] = []
    queue = [hues]
    while queue:
        current = queue.pop(0)
        if len(current) <= 1:
            result += current
        else:
            queue.append(current[::2])
            queue.append(current[1::2])
    colors = [colorsys.hsv_to_rgb(h, 0.7, 0.88) for h in result]
    return [(int(r * 255), int(g * 255), int(b * 255)) for r, g, b in colors]


def mask_label_map(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (H, W) int32 label map: i + 1 for the LAST mask
    covering a pixel, 0 where none does.  That is the overlap rule of the
    JAX package's ``color_sketch_by_masks``, where each mask paints over the
    ones before it.  Computed where the masks lie (on the card in the
    slice)."""
    n, h, w = masks.shape
    if n == 0:
        return torch.zeros((h, w), dtype=torch.int32, device=masks.device)
    ids = torch.arange(1, n + 1, dtype=torch.int32, device=masks.device)
    return (masks * ids[:, None, None]).amax(0)


def color_sketch_by_label_map(
    sketch_rgb: np.ndarray,  # (H, W, 3) uint8 (or (H, W) gray)
    label_map: np.ndarray,  # (H, W) integer; 0 = no mask, i+1 = masks[i]
    n_masks: int,
    colors: Optional[Sequence[Tuple[int, int, int]]] = None,
    enhance_factor: float = 1.5,
    min_opacity: float = 0.2,
) -> np.ndarray:
    """Stroke pixels take their mask's pastel colour weighted by enhanced
    stroke opacity; strokes in no mask stay black-on-white (the exact math
    of the reference's visualization.py:63-167).

    Every per-pixel quantity depends only on the 8-bit gray value and the
    label, so the image is one lookup in an (n_masks+1, 256, 3) table.
    With the labels of :func:`mask_label_map` the result equals the JAX
    package's per-mask ``color_sketch_by_masks`` bit for bit, at a fraction
    of its host time when many large masks overlap."""
    if colors is None:
        colors = generate_pastel_colors(n_masks)
    if sketch_rgb.ndim != 3:
        gray = sketch_rgb
    else:
        gray = np.asarray(
            0.299 * sketch_rgb[..., 0] + 0.587 * sketch_rgb[..., 1]
            + 0.114 * sketch_rgb[..., 2]).round().astype(np.uint8)
    g = np.arange(256, dtype=np.float64)
    raw = (255.0 - g) / 255.0
    stroke_g = g < 250

    # the enhancement branch looks at the image's stroke pixels: max stroke
    # opacity > 0.1  <=>  min stroke gray value < 229.5
    smask = gray < 250
    if smask.any():
        if (255.0 - float(gray[smask].min())) / 255.0 > 0.1:
            enh = np.power(raw, 1.0 / enhance_factor)
            enh = np.where(stroke_g & (raw > 0.02),
                           np.maximum(enh, min_opacity), enh)
        else:
            enh = np.where(stroke_g, np.maximum(raw * 3, min_opacity), raw)
    else:
        enh = raw

    pal = np.zeros((n_masks + 1, 3), np.float32)  # label 0: black strokes
    for i in range(n_masks):
        pal[i + 1] = np.asarray(colors[i], np.float32)
    a = enh[None, :, None]
    # float64 blend -> float32 store -> uint8 truncation, as the per-mask
    # version's out[m] = ... / out.astype(uint8)
    table = (pal[:, None, :] * a + 255.0 * (1 - a)).astype(np.float32)
    tab_u8 = table.astype(np.uint8)
    tab_u8[:, ~stroke_g, :] = 255  # non-stroke pixels stay white
    return tab_u8[np.asarray(label_map), gray]
