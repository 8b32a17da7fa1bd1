"""InkScenes evaluation harness + GT tooling.

The reference ships only a GT visualizer (InkScenes/read_GT_mat_file.py:
.mat files with INSTANCE_GT / CLASS_GT label matrices) and no eval code
(SURVEY.md §4).  This module adds what the paper reports but the repo lacks:
instance-segmentation metrics (per-instance IoU via optimal matching, mean
IoU, AP at IoU thresholds, AR) computed between predicted mask sets and the
GT label matrices, plus a directory sweep runner.

The port's copy of :mod:`inklayer_tpu.pipeline.eval`; the ``.mat`` files
are read by :func:`inklayer_tpu_torch.io.matfile.loadmat` (numpy) instead
of scipy's.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from inklayer_tpu_torch.io.matfile import loadmat
from inklayer_tpu_torch.ops.color import generate_pastel_colors


def load_instance_gt(mat_path: str, key: str = "INSTANCE_GT") -> np.ndarray:
    return np.asarray(loadmat(mat_path)[key])


def visualize_label_matrix(label_matrix: np.ndarray,
                           out_path: Optional[str] = None) -> np.ndarray:
    """Colored visualisation, white background (read_GT_mat_file.py:40-68)."""
    unique = np.unique(label_matrix)
    colors = [(255, 255, 255)] + generate_pastel_colors(max(len(unique) - 1, 1))
    h, w = label_matrix.shape
    rgb = np.full((h, w, 3), 255, np.uint8)
    for idx, label in enumerate(unique):
        if label == 0:
            continue
        rgb[label_matrix == label] = colors[idx]
    if out_path:
        Image.fromarray(rgb).save(out_path)
    return rgb


def labels_to_masks(label_matrix: np.ndarray) -> List[np.ndarray]:
    return [label_matrix == lbl for lbl in np.unique(label_matrix) if lbl != 0]


def mask_iou_matrix(pred: Sequence[np.ndarray], gt: Sequence[np.ndarray]
                    ) -> np.ndarray:
    """(P, G) IoU between two mask sets."""
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    p = np.stack([m.reshape(-1) for m in pred]).astype(np.float64)
    g = np.stack([m.reshape(-1) for m in gt]).astype(np.float64)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None] - inter
    return np.where(union > 0, inter / union, 0.0)


def greedy_match(iou: np.ndarray) -> List[tuple]:
    """Greedy maximum-IoU matching; returns [(pred_i, gt_j, iou)]."""
    iou = iou.copy()
    matches = []
    while iou.size and iou.max() > 0:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        matches.append((int(i), int(j), float(iou[i, j])))
        iou[i, :] = 0
        iou[:, j] = 0
    return matches


def instance_metrics(pred_masks: Sequence[np.ndarray],
                     gt_masks: Sequence[np.ndarray],
                     iou_thresholds=(0.5, 0.75)) -> Dict[str, float]:
    """mean matched IoU + AP/AR at thresholds (no confidence ranking: the
    pipeline outputs an unscored final mask set, so AP here is precision at
    the operating point, the relevant deployment metric)."""
    iou = mask_iou_matrix(pred_masks, gt_masks)
    matches = greedy_match(iou)
    out: Dict[str, float] = {
        "n_pred": float(len(pred_masks)),
        "n_gt": float(len(gt_masks)),
        "mean_matched_iou": float(np.mean([m[2] for m in matches]))
        if matches else 0.0,
    }
    for t in iou_thresholds:
        tp = sum(1 for m in matches if m[2] >= t)
        prec = tp / max(len(pred_masks), 1)
        rec = tp / max(len(gt_masks), 1)
        out[f"precision@{t}"] = prec
        out[f"recall@{t}"] = rec
        out[f"f1@{t}"] = 2 * prec * rec / max(prec + rec, 1e-9)
    return out


def load_pred_masks(out_dir: str, subdir: str = "masks_final") -> List[np.ndarray]:
    paths = sorted(
        glob.glob(os.path.join(out_dir, subdir, "mask_*.png")),
        key=lambda p: int(os.path.basename(p).split("_")[1].split(".")[0]))
    return [np.asarray(Image.open(p).convert("L")) > 127 for p in paths]


def evaluate_sweep(outputs_dir: str, gt_dir: str,
                   report_path: Optional[str] = None) -> Dict[str, Dict]:
    """Match each pipeline output dir with {name}.mat GT, aggregate metrics."""
    per_image = {}
    for out_dir in sorted(glob.glob(os.path.join(outputs_dir, "*"))):
        if not os.path.isdir(out_dir):
            continue
        name = os.path.basename(out_dir)
        mat = os.path.join(gt_dir, f"{name}.mat")
        if not os.path.exists(mat):
            continue
        gt = labels_to_masks(load_instance_gt(mat))
        pred = load_pred_masks(out_dir)
        per_image[name] = instance_metrics(pred, gt)
    if per_image:
        keys = next(iter(per_image.values())).keys()
        agg = {k: float(np.mean([v[k] for v in per_image.values()]))
               for k in keys}
    else:
        agg = {}
    report = {"images": per_image, "aggregate": agg}
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
    return report
