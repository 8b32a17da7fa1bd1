"""Object / background silhouette masks and RGBA layer creation (port of
:mod:`inklayer_tpu.pipeline.inpaint.masks`, which uses scipy.ndimage).

get_mask: Otsu strokes -> dilate; if the strokes touch a border band:
strokes + the fully enclosed holes of >= 50 px; else: flood from the
corner -> silhouette -> largest component -> shrink by the distance
transform so that every stroke stays covered -> fill enclosed holes.
create_rgba_layer(s_on_dir): ink keeps its gray value, the silhouette is
white, the rest transparent.

Host code in numpy (a handful of calls per image), with the port's own
exact versions of what scipy did:

* :func:`label4` — 4-connected labelling (``ndimage.label``'s default
  structure, components numbered in raster order of their first pixel),
  by union-find over row runs.  The port's connected-components kernel
  (K6b) is 8-connected and is not used here;
* :func:`distance_transform_edt` — the exact Euclidean distance of each
  True pixel to the nearest False pixel (``ndimage.distance_transform_edt``),
  not the chamfer approximation of ``ops/distance.py``;
* dilation by the port's ``ops/morphology.py`` (ellipse element).
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch.ops.morphology import binary_dilate, ellipse_kernel


def _otsu_threshold(gray: np.ndarray) -> int:
    """Otsu's method on a uint8 image (cv2.THRESH_OTSU equivalent)."""
    hist = np.bincount(gray.reshape(-1), minlength=256).astype(np.float64)
    total = gray.size
    sum_all = (np.arange(256) * hist).sum()
    sum_b = 0.0
    w_b = 0.0
    best, best_t = -1.0, 0
    for t in range(256):
        w_b += hist[t]
        if w_b == 0:
            continue
        w_f = total - w_b
        if w_f == 0:
            break
        sum_b += t * hist[t]
        m_b = sum_b / w_b
        m_f = (sum_all - sum_b) / w_f
        between = w_b * w_f * (m_b - m_f) ** 2
        if between > best:
            best, best_t = between, t
    return best_t


def label4(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected components of a (H, W) bool mask: (int32 labels, 0 for
    False and 1..n in raster order of each component's first pixel, n)."""
    h, w = mask.shape
    edges = np.diff(np.pad(mask.astype(np.int8), ((0, 0), (1, 1))), axis=1)
    row, start = np.nonzero(edges == 1)  # runs [start, end) in raster order
    end = np.nonzero(edges == -1)[1]
    n_runs = len(row)
    labels = np.zeros((h, w), np.int32)
    if n_runs == 0:
        return labels, 0
    # run b of row r + 1 touches the runs a of row r with end_a > start_b
    # and start_a < end_b: a contiguous range of run indices
    stride = w + 1
    start_key, end_key = row * stride + start, row * stride + end
    below = row > 0
    lo = np.searchsorted(end_key, (row - 1) * stride + start, side="right")
    hi = np.searchsorted(start_key, (row - 1) * stride + end, side="left")
    cnt = np.where(below, np.maximum(hi - lo, 0), 0)
    b_idx = np.repeat(np.arange(n_runs), cnt)
    a_idx = np.repeat(lo, cnt) + (np.arange(cnt.sum())
                                  - np.repeat(np.cumsum(cnt) - cnt, cnt))
    parent = list(range(n_runs))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in zip(a_idx.tolist(), b_idx.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:  # the smaller run index (the earlier pixel) is the root
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.asarray([find(i) for i in range(n_runs)])
    uniq, comp = np.unique(roots, return_inverse=True)  # sorted: raster order
    lengths = end - start
    flat = (np.repeat(row * w + start, lengths)
            + np.arange(lengths.sum())
            - np.repeat(np.cumsum(lengths) - lengths, lengths))
    labels.reshape(-1)[flat] = np.repeat(comp + 1, lengths)
    return labels, len(uniq)


def distance_transform_edt(mask: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (float64) of every True pixel to the
    nearest False pixel; 0 on False pixels.  Column distances first, then
    the row pass min_d (d^2 + g[j + d]^2), stopped once d^2 exceeds every
    distance found so far."""
    h, w = mask.shape
    if mask.all():
        raise ValueError("distance transform of a mask with no False pixel")
    big = h + w
    rows = np.arange(h)[:, None]
    up = np.maximum.accumulate(np.where(mask, -big, rows), axis=0)
    down = np.minimum.accumulate(np.where(mask, 2 * big, rows)[::-1],
                                 axis=0)[::-1]
    g = np.minimum(rows - up, down - rows).astype(np.int64)
    g2 = g * g
    best = g2.copy()
    d = 1
    while d < w and d * d < best.max():
        np.minimum(best[:, d:], g2[:, :-d] + d * d, out=best[:, d:])
        np.minimum(best[:, :-d], g2[:, d:] + d * d, out=best[:, :-d])
        d += 1
    return np.sqrt(best.astype(np.float64))


def _dilate(mask: np.ndarray, k: int, iterations: int = 1) -> np.ndarray:
    se = ellipse_kernel(k)
    out = torch.from_numpy(np.ascontiguousarray(mask))
    for _ in range(iterations):
        out = binary_dilate(out, se)
    return out.numpy()


def _fill_holes(mask: np.ndarray, min_area: int = 0) -> np.ndarray:
    """Fill the background components fully enclosed by the mask (not
    touching the border) of at least ``min_area`` pixels."""
    labels, n = label4(~mask)
    if n == 0:
        return mask
    border = np.zeros(n + 1, bool)
    border[np.concatenate([labels[0], labels[-1], labels[:, 0],
                           labels[:, -1]])] = True
    fill = (np.bincount(labels.reshape(-1), minlength=n + 1) >= min_area) \
        & ~border
    fill[0] = False
    return mask | fill[labels]


def get_mask(
    sketch_gray: np.ndarray,  # (H, W) uint8, black strokes on white
    dilate_iter: int = 5,
    kernel_size: int = 3,
    safety_margin: int = 0,
    stroke_thick: int = 1,
    border_band: int = 2,
) -> Tuple[np.ndarray, str]:
    """Returns (bool silhouette mask, mask_type string)."""
    inv = 255 - sketch_gray
    strokes = inv > _otsu_threshold(inv)

    thick = _dilate(strokes, kernel_size, dilate_iter)
    touches = (thick[:border_band].any() or thick[-border_band:].any()
               or thick[:, :border_band].any() or thick[:, -border_band:].any())
    if touches:
        mask = _fill_holes(_dilate(strokes, kernel_size, stroke_thick),
                           min_area=50)
        return mask, "open-curve"

    # flood from the corner: outside = the background component of (0, 0)
    labels, _ = label4(~thick)
    silhouette = labels != labels[0, 0]

    # largest connected component of the silhouette
    sl, n = label4(silhouette)
    if n > 1:
        areas = np.bincount(sl.reshape(-1))
        areas[0] = 0
        silhouette = sl == int(np.argmax(areas))

    # shrink so that every stroke pixel stays covered
    dist = distance_transform_edt(silhouette)
    stroke_dists = dist[strokes]
    shrink_by = 0
    if stroke_dists.size:
        shrink_by = max(0, int(np.floor(stroke_dists.min())) - safety_margin)
        if shrink_by > 0:
            silhouette = dist >= shrink_by
    silhouette = _fill_holes(silhouette)
    return silhouette, f"closed-silhouette (shrunk by {shrink_by}px)"


def create_rgba_layer(layer_rgb: np.ndarray, **mask_params
                      ) -> Tuple[np.ndarray, str]:
    """One complete_layers image -> RGBA: ink keeps its gray value, the
    silhouette is white, the rest transparent."""
    gray = np.asarray(Image.fromarray(layer_rgb).convert("L"))
    h, w = gray.shape
    sketch_pixels = gray < 240
    bg_mask, mask_type = get_mask(gray, **mask_params)
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[..., 3] = (sketch_pixels | bg_mask).astype(np.uint8) * 255
    rgba[bg_mask, :3] = 255
    rgba[sketch_pixels, :3] = gray[sketch_pixels, None]
    return rgba, mask_type


def create_rgba_layers_on_dir(input_dir: str, output_dir: str) -> str:
    os.makedirs(output_dir, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(input_dir, "*.png"))):
        rgb = np.asarray(Image.open(path).convert("RGB"))
        rgba, _ = create_rgba_layer(rgb)
        Image.fromarray(rgba).save(
            os.path.join(output_dir, os.path.basename(path)))
    return output_dir
