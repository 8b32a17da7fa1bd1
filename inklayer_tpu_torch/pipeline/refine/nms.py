"""Sketch-aware NMS (port of :mod:`inklayer_tpu.pipeline.refine.nms`).

refinement/nms_sketch.py: greedy score-ordered NMS where the overlap metric
is the IoU of masks restricted to stroke pixels (< 250), gated by bbox
containment within a dynamic epsilon (8 px * diag / 1000) AND a shared
corner within the same epsilon; plain bbox IoU > 0.7 also suppresses.  A
prefilter drops boxes covering >= 90% of the image, boxes without sketch
content and boxes containing more than 5 others.

The host half (prefilter and box gates) is the JAX package's numpy code,
kept call for call (``np.argsort(-fs)``) so ties break identically.  The
ink-IoU matrix is computed where the masks lie; the greedy scan over the
tiny (K, K) matrices runs wherever its inputs are (the NMS front reads the
matrix back with the depth stats and scans on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from inklayer_tpu_torch.config import RefineConfig


def integral_nonzero(gray: np.ndarray) -> np.ndarray:
    """Padded (H+1, W+1) int32 integral image of (gray > 0): the
    prefilter's per-box ink-count table.  int32 throughout (``cumsum`` of
    int32 widens to int64 unless told otherwise)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    return np.pad((gray > 0).astype(np.int32), ((1, 0), (1, 0))).cumsum(
        0, dtype=np.int32).cumsum(1, dtype=np.int32)


def ink_mask_iou_matrix(masks: torch.Tensor, ink: torch.Tensor
                        ) -> torch.Tensor:
    """masks: (N, H, W) bool, ink: (H, W) bool -> (N, N) fp32 IoU of the
    ink-restricted masks (content_iou).  Counts are exact integers in fp32
    (< 2^24 pixels)."""
    n = masks.shape[0]
    flat = (masks & ink[None]).reshape(n, -1).float()
    inter = flat @ flat.T
    areas = flat.sum(dim=1)
    union = areas[:, None] + areas[None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       0.0)


def bbox_iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """(N, 4) xyxy -> (N, N) IoU (refinement/utils.py compute_bbox_iou)."""
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.where((x2 >= x1) & (y2 >= y1), (x2 - x1) * (y2 - y1), 0.0)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = areas[:, None] + areas[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _is_contained(small: np.ndarray, big: np.ndarray, eps: float
                  ) -> np.ndarray:
    """contained[i, j] = small_j inside big_i with slack."""
    return ((big[:, None, 0] - eps <= small[None, :, 0])
            & (big[:, None, 1] - eps <= small[None, :, 1])
            & (big[:, None, 2] + eps >= small[None, :, 2])
            & (big[:, None, 3] + eps >= small[None, :, 3]))


def _share_corner(boxes: np.ndarray, eps: float) -> np.ndarray:
    """share[i, j] = boxes i and j have a pair of corners within eps."""
    corners = np.stack([
        boxes[:, [0, 1]], boxes[:, [0, 3]], boxes[:, [2, 1]], boxes[:, [2, 3]],
    ], axis=1)  # (N, 4, 2)
    d = np.linalg.norm(
        corners[:, None, :, None, :] - corners[None, :, None, :, :], axis=-1)
    return (d <= eps).any(axis=(2, 3))


def _strict_contains(boxes: np.ndarray) -> np.ndarray:
    """contains[i, j] = box_i contains box_j (no epsilon), i != j."""
    return ((boxes[:, None, 0] <= boxes[None, :, 0])
            & (boxes[:, None, 1] <= boxes[None, :, 1])
            & (boxes[:, None, 2] >= boxes[None, :, 2])
            & (boxes[:, None, 3] >= boxes[None, :, 3])
            & ~np.eye(len(boxes), dtype=bool))


def nms_host_prefilter(boxes: np.ndarray, scores: np.ndarray,
                       sketch_gray: np.ndarray,
                       cfg: RefineConfig = RefineConfig()):
    """Host half: the filter_full_or_empty_bbox prefilter plus the box-only
    pairwise gates.  Returns (kept0, order, gate, iou_bbox); gate and
    iou_bbox are (K, K) over the kept0 rows."""
    h, w = sketch_gray.shape
    img_area = h * w
    boxes = boxes.astype(np.float64)

    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    valid_area = areas / img_area < cfg.nms_max_area_frac
    integral = integral_nonzero(sketch_gray)
    xs1 = np.clip(boxes[:, 0], 0, w - 1).astype(int)
    ys1 = np.clip(boxes[:, 1], 0, h - 1).astype(int)
    xs2 = np.clip(boxes[:, 2], 0, w - 1).astype(int) + 1
    ys2 = np.clip(boxes[:, 3], 0, h - 1).astype(int) + 1
    nz = (integral[ys2, xs2] - integral[ys1, xs2]
          - integral[ys2, xs1] + integral[ys1, xs1])
    has_content = nz > 0
    contains = _strict_contains(boxes)
    few_contained = contains.sum(axis=1) <= cfg.nms_max_contained
    kept0 = np.nonzero(valid_area & has_content & few_contained)[0]
    if len(kept0) == 0:
        z = np.zeros((0, 0))
        return kept0, np.zeros((0,), int), z.astype(bool), z

    fb = boxes[kept0]
    fs = scores[kept0]
    order = np.argsort(-fs)

    iou_bbox = bbox_iou_matrix(fb)
    eps = cfg.nms_eps_px_per_kdiag * (np.hypot(h, w) / 1000.0)
    areas_f = (fb[:, 2] - fb[:, 0]) * (fb[:, 3] - fb[:, 1])
    larger_is_i = areas_f[:, None] > areas_f[None, :]
    cont = _is_contained(fb, fb, eps)
    gate = np.where(larger_is_i, cont, cont.T) & _share_corner(fb, eps)
    return kept0, order, gate, iou_bbox


def greedy_nms(sketch_iou: torch.Tensor, gate: torch.Tensor,
               bbox_ov: torch.Tensor, order: torch.Tensor, thr_s: float,
               thr_b: float) -> torch.Tensor:
    """Greedy score-ordered suppression (nms_sketch.py's double loop).

    Iteration follows non-increasing score order, so the reference's
    'suppress the higher-scored a' branch never fires and each surviving a
    kills every later overlapping b.  Returns keep flags in ``order``
    space; ``bbox_ov`` is the gated bbox IoU, fp32 as in the JAX
    package."""
    k = order.shape[0]
    s_ov = torch.where(gate, sketch_iou, 0.0)[order][:, order]
    b_ov = bbox_ov.float()[order][:, order]
    idx = torch.arange(k, device=order.device)
    # sup[pi] & (idx > pi), for every pi at once: 3 launches per step left
    later = ((s_ov > thr_s) | (b_ov > thr_b)) & (idx[None, :] > idx[:, None])
    keep = torch.ones(k, dtype=torch.bool, device=order.device)
    for pi in range(k):
        keep = keep & ~(later[pi] & keep[pi])
    return keep
