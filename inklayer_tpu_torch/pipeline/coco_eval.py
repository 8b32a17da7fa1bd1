"""COCO-style average-precision evaluation, dependency-free numpy (the
port's own copy of :mod:`inklayer_tpu.pipeline.coco_eval`).

Parity target: the reference's COCO AP evaluation path
(GroundingDINO demo/test_ap_on_coco.py:1-233 + util/get_tokenlizer-based
CocoGroundingEvaluator, which defer to pycocotools COCOeval).  This is the
same metric definition — 101-point interpolated AP averaged over IoU
thresholds .50:.95:.05 — implemented directly so no pycocotools/mmdet
dependency is needed.

Boxes are xyxy absolute pixels.  Masks (optional) are bool (H, W) arrays;
mask IoU replaces box IoU when given (segm AP).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-9)


def mask_iou_matrix(a: Sequence[np.ndarray], b: Sequence[np.ndarray]
                    ) -> np.ndarray:
    out = np.zeros((len(a), len(b)))
    for i, ma in enumerate(a):
        for j, mb in enumerate(b):
            inter = np.logical_and(ma, mb).sum()
            union = np.logical_or(ma, mb).sum()
            out[i, j] = inter / max(union, 1)
    return out


def _match_image(iou: np.ndarray, scores: np.ndarray, thresh: float):
    """Greedy COCO matching: predictions in score order claim the
    highest-IoU unclaimed GT above `thresh`.  Returns (tp bool per pred,
    n_gt)."""
    n_pred, n_gt = iou.shape
    order = np.argsort(-scores, kind="stable")
    claimed = np.zeros(n_gt, bool)
    tp = np.zeros(n_pred, bool)
    for i in order:
        if n_gt == 0:
            break
        cand = np.where(~claimed, iou[i], -1.0)
        j = int(np.argmax(cand))
        if cand[j] >= thresh:
            claimed[j] = True
            tp[i] = True
    return tp, n_gt


def _average_precision(tp: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP (pycocotools definition)."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope (monotone non-increasing from the right)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    pr = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(pr.mean())


def evaluate_detections(
    predictions: List[Dict],
    ground_truths: List[Dict],
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
    use_masks: bool = False,
) -> Dict[str, float]:
    """predictions[i]: {'boxes': (N,4) xyxy, 'scores': (N,), 'masks': opt};
    ground_truths[i]: {'boxes': (M,4), 'masks': opt}.  Single-category
    (InkLayer detects the one open-vocabulary prompt 'object').

    Returns {'mAP', 'AP50', 'AP75', 'AR100'} — the headline COCO numbers.
    """
    assert len(predictions) == len(ground_truths)
    ious, all_scores = [], []
    total_gt = 0
    for pred, gt in zip(predictions, ground_truths):
        if use_masks:
            iou = mask_iou_matrix(pred.get("masks", []), gt.get("masks", []))
        else:
            iou = box_iou_matrix(np.asarray(pred["boxes"], float).reshape(-1, 4),
                                 np.asarray(gt["boxes"], float).reshape(-1, 4))
        ious.append(iou)
        all_scores.append(np.asarray(pred["scores"], float).reshape(-1))
        total_gt += iou.shape[1]

    aps = {}
    recalls = []
    for t in iou_thresholds:
        tps, scores = [], []
        for iou, sc in zip(ious, all_scores):
            tp, _ = _match_image(iou, sc, t)
            tps.append(tp)
            scores.append(sc)
        tp_cat = np.concatenate(tps) if tps else np.zeros(0, bool)
        sc_cat = np.concatenate(scores) if scores else np.zeros(0)
        aps[round(float(t), 2)] = _average_precision(tp_cat, sc_cat, total_gt)
        recalls.append(tp_cat.sum() / max(total_gt, 1))
    ap_values = [v for v in aps.values() if not np.isnan(v)]
    return {
        "mAP": float(np.mean(ap_values)) if ap_values else float("nan"),
        "AP50": aps.get(0.5, float("nan")),
        "AP75": aps.get(0.75, float("nan")),
        "AR100": float(np.mean(recalls)) if recalls else float("nan"),
        "per_iou": aps,
    }
