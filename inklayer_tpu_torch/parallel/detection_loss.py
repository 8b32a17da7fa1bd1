"""Detection fine-tuning losses (DETR/DINO recipe) for GroundingDINO
(port of :mod:`inklayer_tpu.parallel.detection_loss`).

The set-prediction loss: greedy matching on (focal class cost + L1 +
GIoU), then focal classification + L1 + GIoU box losses over the matched
pairs.  Matching stays on the device (a loop of ``argmin`` over the
ground truths, no host read-back), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / torch.clamp(union, min=1e-9)
    # smallest enclosing box
    lt_c = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb_c = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh_c = torch.clamp(rb_c - lt_c, min=0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / torch.clamp(area_c, min=1e-9)


@torch.no_grad()
def greedy_assignment(cost: torch.Tensor, gt_valid: torch.Tensor
                      ) -> torch.Tensor:
    """For each GT in order, the cheapest query not yet taken.  Returns
    (M,) int64 query index per GT, -1 for an invalid GT.  ``torch.argmin``
    returns the first minimum, as ``jnp.argmin`` does."""
    nq, m = cost.shape
    dev = cost.device
    big = torch.tensor(1e9, dtype=cost.dtype, device=dev)
    taken = torch.zeros(nq, dtype=torch.bool, device=dev)
    assign = torch.full((m,), -1, dtype=torch.int64, device=dev)
    queries = torch.arange(nq, device=dev)
    for j in range(m):
        qi = torch.argmin(torch.where(taken, big, cost[:, j]))
        valid = gt_valid[j]
        assign[j] = torch.where(valid, qi, -1)
        taken = taken | ((queries == qi) & valid)
    return assign


def _per_image(probs_i, boxes, gts, posmaps, valid, focal_alpha,
               focal_gamma, cost_class, cost_bbox, cost_giou):
    # alignment score of each query with each GT's positive tokens
    pm = posmaps.float()
    pm_norm = pm / torch.clamp(pm.sum(-1, keepdim=True), min=1.0)
    # clipped away from {0, 1}, as in the JAX package
    cls_score = torch.clamp(probs_i @ pm_norm.T, 1e-7, 1 - 1e-7)  # (nq, M)
    # focal-style class cost (up-weight confident wrong matches)
    pos_cost = focal_alpha * ((1 - cls_score) ** focal_gamma) * (
        -torch.log(cls_score))
    neg_cost = (1 - focal_alpha) * (cls_score ** focal_gamma) * (
        -torch.log1p(-cls_score))
    c_class = pos_cost - neg_cost
    l1 = torch.abs(boxes[:, None] - gts[None]).sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(boxes),
                               box_cxcywh_to_xyxy(gts))
    cost = cost_class * c_class + cost_bbox * l1 - cost_giou * giou
    assign = greedy_assignment(cost.detach(), valid)  # (M,)

    safe = torch.clamp(assign, min=0)
    matched_boxes = boxes[safe]
    vf = valid.float()
    n = torch.clamp(vf.sum(), min=1.0)
    loss_l1 = (torch.abs(matched_boxes - gts).sum(-1) * vf).sum() / n
    g = generalized_box_iou(box_cxcywh_to_xyxy(matched_boxes),
                            box_cxcywh_to_xyxy(gts))
    loss_giou = ((1 - torch.diagonal(g)) * vf).sum() / n

    # focal classification over all query-token pairs: targets are the
    # positive maps at matched queries.  Invalid GTs all map to query 0
    # with zero rows, so the scatter takes the maximum (the JAX
    # ``.at[].max``), never the last write.
    upd = (pm * vf[:, None]).to(probs_i.dtype)
    tgt = torch.zeros_like(probs_i).scatter_reduce_(
        0, safe[:, None].expand_as(upd), upd, "amax", include_self=True)
    pc = torch.clamp(probs_i, 1e-7, 1 - 1e-7)
    p_t = pc * tgt + (1 - pc) * (1 - tgt)
    a_t = focal_alpha * tgt + (1 - focal_alpha) * (1 - tgt)
    ce = -(tgt * torch.log(pc) + (1 - tgt) * torch.log1p(-pc))
    loss_cls = (a_t * ((1 - p_t) ** focal_gamma) * ce).sum() / n
    return loss_cls, loss_l1, loss_giou


def detection_loss(
    pred_logits: torch.Tensor,  # (B, nq, T) token-alignment logits
    pred_boxes: torch.Tensor,  # (B, nq, 4) cxcywh in [0, 1]
    gt_boxes: torch.Tensor,  # (B, M, 4) cxcywh, zero-padded
    gt_pos_maps: torch.Tensor,  # (B, M, T) positive token maps
    gt_valid: torch.Tensor,  # (B, M) bool
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total loss, metric dict). Weights follow the DINO recipe."""
    finite_logits = torch.where(torch.isfinite(pred_logits), pred_logits,
                                torch.full_like(pred_logits, -30.0))
    probs = torch.sigmoid(finite_logits)
    parts = [_per_image(probs[b], pred_boxes[b], gt_boxes[b], gt_pos_maps[b],
                        gt_valid[b].bool(), focal_alpha, focal_gamma,
                        cost_class, cost_bbox, cost_giou)
             for b in range(probs.shape[0])]
    loss_cls, loss_l1, loss_giou = (torch.stack(x) for x in zip(*parts))
    metrics = {
        "loss_cls": loss_cls.mean(),
        "loss_l1": loss_l1.mean(),
        "loss_giou": loss_giou.mean(),
    }
    # DINO loss weights: cls 1.0 (focal), L1 5.0, GIoU 2.0
    total = (metrics["loss_cls"] + 5.0 * metrics["loss_l1"]
             + 2.0 * metrics["loss_giou"])
    return total, metrics
