"""NMS + depth-stat front (port of
:mod:`inklayer_tpu.pipeline.refine.front`).

Everything between mask cleaning and the host's sort: the kept-mask
gather, the ink thresholds, the ink-IoU matrix, stroke sampling, per-mask
depth scores and the major-overlap matrix, computed where the masks lie.

* :func:`nms_depth_front` (the default) takes the host prefilter's
  survivors and gates, reads the matrices back and runs the greedy NMS
  scan on the host.  The JAX package pads every array to the cleaned-mask
  capacity to keep its compiled shapes; padded rows are all-False masks
  that change no real row, so the port works on the K prefilter survivors
  directly.
* :func:`nms_depth_front_device` (``PipelineConfig.device_front``) needs
  no detect read-back: :func:`device_prefilter_gates` runs the prefilter
  and the box gates over the whole top-K capacity from the device boxes
  and scores, and the greedy scan runs where the masks lie (K steps of a
  few launches each).  Everything stays in top-K index space; the caller
  reads (valid, order, keep, depth scores, overlap) back in one go, and
  the kept rows are ``order[keep & valid[order]]``.  As in the JAX
  package, the box corners are fp32 products truncated to pixels where
  the host path truncates fp64 products, so a product that lands exactly
  on a pixel boundary can flip a 1-px truncation.
"""

from __future__ import annotations

import numpy as np
import torch

from inklayer_tpu_torch.config import RefineConfig
from inklayer_tpu_torch.pipeline.refine.depth_sort import (
    major_overlap_matrix, mask_depth_scores, sample_stroke_points)
from inklayer_tpu_torch.pipeline.refine.nms import (greedy_nms,
                                                    ink_mask_iou_matrix)
from inklayer_tpu_torch.spans import span


def device_prefilter_gates(boxes_cxcywh: torch.Tensor, scores: torch.Tensor,
                           gray: torch.Tensor, hw, max_area_frac: float,
                           max_contained: int, eps_per_kdiag: float,
                           thresh: float):
    """The host prefilter (:func:`nms.nms_host_prefilter`) over the fixed
    top-K capacity, where the boxes lie: score threshold (the detections
    are a score-sorted prefix of top-K), area, ink content and strict
    containment, then the box-only pairwise gates.  (K, 4) normalised
    cxcywh boxes, (K,) scores, (H, W) uint8 gray -> (valid (K,), gate
    (K, K), gated bbox IoU (K, K) fp32, order (K,)), the JAX package's
    ``_device_prefilter_gates`` (front.py:53-124) op for op."""
    h, w = hw
    dev = boxes_cxcywh.device
    bx = boxes_cxcywh.float()
    cx, cy, hw_, hh = bx[:, 0], bx[:, 1], bx[:, 2] / 2, bx[:, 3] / 2
    # host parity: astype(int) truncates (of fp64 products there); the
    # fp32 products by the width and height of the JAX package
    b = torch.trunc(torch.stack([(cx - hw_) * w, (cy - hh) * h,
                                 (cx + hw_) * w, (cy + hh) * h], dim=1))
    k = b.shape[0]
    valid_t = scores.float() > thresh

    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    valid_area = areas / (h * w) < max_area_frac
    ii = torch.nn.functional.pad((gray > 0).to(torch.int32), (1, 0, 1, 0)
                                 ).cumsum(0, dtype=torch.int32).cumsum(
        1, dtype=torch.int32)
    xs1 = b[:, 0].clamp(0, w - 1).long()
    ys1 = b[:, 1].clamp(0, h - 1).long()
    xs2 = b[:, 2].clamp(0, w - 1).long() + 1
    ys2 = b[:, 3].clamp(0, h - 1).long() + 1
    nz = ii[ys2, xs2] - ii[ys1, xs2] - ii[ys2, xs1] + ii[ys1, xs1]
    has_content = nz > 0

    # strict containment: only thresholded boxes count as targets, the host
    # path's universe of n boxes
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    contains = ((b[:, None, 0] <= b[None, :, 0])
                & (b[:, None, 1] <= b[None, :, 1])
                & (b[:, None, 2] >= b[None, :, 2])
                & (b[:, None, 3] >= b[None, :, 3])
                & ~eye) & valid_t[None, :]
    few_contained = contains.sum(dim=1) <= max_contained
    valid = valid_t & valid_area & has_content & few_contained

    x1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = torch.where((x2 >= x1) & (y2 >= y1), (x2 - x1) * (y2 - y1), 0.0)
    union = areas[:, None] + areas[None, :] - inter
    iou_bbox = torch.where(union > 0,
                           inter / torch.where(union > 0, union, 1.0), 0.0)
    # fp32 scalars, as jnp.float32 computes them
    f32 = np.float32
    eps = float(f32(eps_per_kdiag) * (np.sqrt(f32(h) ** 2 + f32(w) ** 2)
                                      / f32(1000.0)))
    larger_is_i = areas[:, None] > areas[None, :]
    cont = ((b[:, None, 0] - eps <= b[None, :, 0])
            & (b[:, None, 1] - eps <= b[None, :, 1])
            & (b[:, None, 2] + eps >= b[None, :, 2])
            & (b[:, None, 3] + eps >= b[None, :, 3]))
    corners = torch.stack([b[:, [0, 1]], b[:, [0, 3]], b[:, [2, 1]],
                           b[:, [2, 3]]], dim=1)  # (K, 4, 2)
    # the norm over the last axis as jnp.linalg.norm takes it
    diff = corners[:, None, :, None, :] - corners[None, :, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))
    share = (d <= eps).flatten(2).any(dim=2)
    gate = torch.where(larger_is_i, cont, cont.T) & share
    gate = gate & valid[:, None] & valid[None, :]
    key = torch.where(valid, scores.float(), -torch.inf)
    # jnp.argsort is stable; torch.argsort is only when asked
    order = torch.argsort(-key, stable=True)
    return valid, gate, torch.where(gate, iou_bbox, 0.0), order


def nms_depth_front_device(boxes: torch.Tensor, scores: torch.Tensor,
                           cleaned: torch.Tensor, gray: torch.Tensor,
                           depth: torch.Tensor, hw,
                           cfg: RefineConfig = RefineConfig(),
                           box_threshold: float = 0.2):
    """The front without a detect read-back: the prefilter, the gates, the
    greedy NMS scan and the depth stats, all from the device top-K boxes
    and scores and the (K, H, W) cleaned masks.  Returns device (valid
    (K,), order (K,), keep (K,) in ``order`` space, depth scores (K,),
    major overlap (K, K)); the kept rows are ``order[keep &
    valid[order]]``."""
    valid, gate, bb_gated, order = device_prefilter_gates(
        boxes, scores, gray, hw, cfg.nms_max_area_frac,
        cfg.nms_max_contained, cfg.nms_eps_px_per_kdiag, box_threshold)
    # rows that are not valid become all-False masks: they suppress
    # nothing, and their depth score is +inf
    iou_s, dscores, overlap = depth_front(cleaned & valid[:, None, None],
                                          gray, depth, cfg)
    keep = greedy_nms(iou_s, gate, bb_gated, order, cfg.nms_iou,
                      cfg.nms_bbox_iou_kill)
    return valid, order, keep, dscores, overlap


def depth_front(masks: torch.Tensor, gray: torch.Tensor, depth: torch.Tensor,
                cfg: RefineConfig = RefineConfig()):
    """(K, H, W) masks -> device (ink-IoU (K, K), depth scores (K,),
    major overlap (K, K))."""
    h = gray.shape[0]
    iou_s = ink_mask_iou_matrix(masks, gray < cfg.ink_threshold)
    # sketch_to_01binary threshold (refinement/utils.py): max / 2, fp32
    g = gray.float()
    ink2 = g <= g.max() / 2
    cell = max(1, int(round(h * cfg.sample_radius_frac)))
    pts, pvalid = sample_stroke_points(ink2, cell)
    dscores = mask_depth_scores(masks, pts, pvalid, depth, cfg.depth_bin)
    overlap = major_overlap_matrix(masks & ink2[None],
                                   thr=cfg.overlap_major_frac)
    return iou_s, dscores, overlap


def nms_depth_front(kept0: np.ndarray, gate: np.ndarray,
                    iou_bbox: np.ndarray, order: np.ndarray,
                    masks: torch.Tensor, gray: torch.Tensor,
                    depth: torch.Tensor, cfg: RefineConfig = RefineConfig()):
    """The NMS keep flags (in ``order`` space) and the depth stats of the
    prefilter survivors ``kept0``, as host arrays: (keep (K,), depth
    scores (K,), major overlap (K, K))."""
    sel = torch.from_numpy(np.asarray(kept0, np.int64)).to(masks.device)
    iou_s, dscores, overlap = depth_front(masks[sel], gray, depth, cfg)
    with span("wait"):
        iou_s, dscores, overlap = (t.cpu() for t in (iou_s, dscores,
                                                     overlap))
    bb = torch.from_numpy(np.where(gate, iou_bbox, 0.0).astype(np.float32))
    keep = greedy_nms(iou_s, torch.from_numpy(np.asarray(gate, bool)), bb,
                      torch.from_numpy(np.asarray(order, np.int64)),
                      cfg.nms_iou, cfg.nms_bbox_iou_kill)
    return keep.numpy(), dscores.numpy(), overlap.numpy()
