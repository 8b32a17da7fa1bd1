"""Depth-based mask ordering (port of
:mod:`inklayer_tpu.pipeline.refine.depth_sort`).

refinement/depth_sort.py with the JAX package's redesign: grid-stratified
stroke sampling (one stroke pixel per radius-sized cell, first in raster
order), a per-mask binned-mode depth score as a one-hot histogram matmul,
the strict bbox containment graph, the ink-restricted major-overlap
matrix, and the argsort + 3 bubble passes on the host.

Exactness: ``torch.round`` and ``jnp.round`` both round half to even; a
bool argmax is taken on uint8 (first maximum, as jnp); divisions by a
constant divide by a 0-dim tensor, because CUDA turns division by a Python
scalar into a multiplication by its reciprocal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from inklayer_tpu_torch.config import RefineConfig
from inklayer_tpu_torch.ops import morphology as M

_N_BINS = 512


def sample_stroke_points(ink: torch.Tensor, cell: int):
    """ink: (H, W) bool -> ((S, 2) int64 yx points, (S,) bool validity),
    S = number of cells; one stroke pixel per cell (first in raster
    order, (0, 0) of the cell when it holds none)."""
    h, w = ink.shape
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    x = F.pad(ink.to(torch.uint8), (0, pw, 0, ph))
    ncy, ncx = x.shape[0] // cell, x.shape[1] // cell
    cells = x.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell)
    first = torch.argmax(cells, dim=1)
    valid = cells.any(dim=1).bool()
    c = torch.arange(ncy * ncx, device=ink.device)
    yy = (c // ncx * cell + first // cell).clamp(0, h - 1)
    xx = (c % ncx * cell + first % cell).clamp(0, w - 1)
    return torch.stack([yy, xx], dim=1), valid


def mask_depth_scores(masks: torch.Tensor, points: torch.Tensor,
                      valid: torch.Tensor, depth: torch.Tensor,
                      bin_width: float = 0.1) -> torch.Tensor:
    """Mode of the bin-rounded depths at the sampled stroke points inside
    each mask (get_binned_frequent); +inf for a mask with no point."""
    bw = torch.tensor(bin_width, dtype=torch.float32, device=depth.device)
    d = depth.float()[points[:, 0], points[:, 1]]
    bins = torch.round(d / bw).long()
    bmin = torch.where(valid, bins, 0).min()
    bins = (bins - bmin).clamp(0, _N_BINS - 1)
    onehot = F.one_hot(bins, _N_BINS).float() * valid[:, None]
    member = masks[:, points[:, 0], points[:, 1]].float()
    counts = member @ onehot
    mode_bin = torch.argmax(counts, dim=1)
    score = (mode_bin + bmin).float() * bw
    return torch.where(counts.sum(dim=1) > 0, score, torch.inf)


def containment_graph(boxes: np.ndarray, image_hw: Tuple[int, int],
                      cfg: RefineConfig = RefineConfig()) -> np.ndarray:
    """graph[i, j] = True iff box_i strictly contains box_j
    (build_containment_graph_fast)."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 0), bool)
    h, w = image_hw
    b = np.asarray(boxes, float).copy()
    if b.max() <= 1.0 + 1e-6:
        b[:, [0, 2]] *= w
        b[:, [1, 3]] *= h
    x1 = np.minimum(b[:, 0], b[:, 2])
    x2 = np.maximum(b[:, 0], b[:, 2])
    y1 = np.minimum(b[:, 1], b[:, 3])
    y2 = np.maximum(b[:, 1], b[:, 3])
    b = np.stack([x1, y1, x2, y2], 1)
    eps = float(max(1.0, cfg.containment_eps_frac * max(h, w)))
    areas = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    cx = (b[:, 0] + b[:, 2]) * 0.5
    cy = (b[:, 1] + b[:, 3]) * 0.5
    b1, b2 = b[:, None], b[None, :]
    contained = ((b1[..., 0] - eps <= b2[..., 0])
                 & (b1[..., 1] - eps <= b2[..., 1])
                 & (b1[..., 2] + eps >= b2[..., 2])
                 & (b1[..., 3] + eps >= b2[..., 3]))
    contained &= (areas[:, None] * (1.0 - cfg.containment_area_gap)) \
        > areas[None, :]
    cx_in = (b1[..., 0] - eps <= cx[None, :]) & (cx[None, :] <= b1[..., 2] + eps)
    cy_in = (b1[..., 1] - eps <= cy[None, :]) & (cy[None, :] <= b1[..., 3] + eps)
    contained &= cx_in & cy_in
    np.fill_diagonal(contained, False)
    return contained


def major_overlap_matrix(masks: torch.Tensor, thr: float = 0.6
                         ) -> torch.Tensor:
    """major[i, j] = inter / min(area_i, area_j) >= thr on 1 px-dilated
    masks (compute_major_overlap_matrix)."""
    n = masks.shape[0]
    flat = M.binary_dilate(masks, M.ellipse_kernel(3)).reshape(n, -1).float()
    inter = flat @ flat.T
    areas = flat.sum(dim=1)
    denom = torch.minimum(areas[:, None], areas[None, :])
    ratio = torch.where(denom > 0,
                        inter / torch.where(denom > 0, denom, 1.0), 0.0)
    eye = torch.eye(n, dtype=torch.bool, device=masks.device)
    return (ratio >= thr) & (inter > 0) & ~eye


def sort_order(depth_scores: np.ndarray, containment: np.ndarray,
               overlap: np.ndarray) -> List[int]:
    """Descending depth, then 3 bubble passes moving containers earlier
    when they overlap (sort_sketch_masks)."""
    order = list(np.argsort(depth_scores)[::-1])
    for _ in range(3):
        for i in range(len(order)):
            for j in range(i + 1, len(order)):
                a, b = order[i], order[j]
                if not overlap[a, b]:
                    continue
                if containment[a, b]:
                    order[i], order[j] = order[j], order[i]
    return order
