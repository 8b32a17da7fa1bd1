"""NMS + depth-stat front (port of
:mod:`inklayer_tpu.pipeline.refine.front`, the ``device_front=False``
entry).

Everything between mask cleaning and the host's sort: the kept-mask
gather, the ink thresholds, the ink-IoU matrix, stroke sampling, per-mask
depth scores and the major-overlap matrix, computed where the masks lie
and read back; the greedy NMS scan then runs on the host
over the (K, K) matrices.  The JAX package pads every array to the
cleaned-mask capacity to keep its compiled shapes; padded rows are
all-False masks that change no real row, so the port works on the K
prefilter survivors directly.
"""

from __future__ import annotations

import numpy as np
import torch

from inklayer_tpu_torch.config import RefineConfig
from inklayer_tpu_torch.pipeline.refine.depth_sort import (
    major_overlap_matrix, mask_depth_scores, sample_stroke_points)
from inklayer_tpu_torch.pipeline.refine.nms import (greedy_nms,
                                                    ink_mask_iou_matrix)


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
    iou_s, dscores, overlap = (t.cpu() for t in (iou_s, dscores, overlap))
    bb = torch.from_numpy(np.where(gate, iou_bbox, 0.0).astype(np.float32))
    keep = greedy_nms(iou_s, torch.from_numpy(np.asarray(gate, bool)), bb,
                      torch.from_numpy(np.asarray(order, np.int64)),
                      cfg.nms_iou, cfg.nms_bbox_iou_kill)
    return keep.numpy(), dscores.numpy(), overlap.numpy()
