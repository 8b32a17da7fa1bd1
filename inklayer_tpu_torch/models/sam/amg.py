"""Automatic mask generation: a point grid through SAM (port of
:mod:`inklayer_tpu.models.sam.amg`).

segment-anything ``automatic_mask_generator.py`` + ``utils/amg.py``: a
regular point grid per crop -> multimask decode in fixed batches -> the
predicted-IoU filter -> the stability-score filter (the IoU of the logits
thresholded at +/- the offset, on the 256^2 low-res logits, as the JAX
package computes it) -> upsampling, boxes and the crop-edge filter -> box
NMS per crop, then across crops -> the records (``segmentation``,
``rle``, ``area``, XYWH ``bbox``, ``bbox_xyxy``, ``crop_box``,
``predicted_iou``, ``stability_score``, ``point_coords``).

The JAX package reads every batch's (64, 3, 256, 256) logits back to the
host, keeps the survivors there and uploads them again.  Here the logits
stay on the device: each batch reads back only its IoU predictions and
stability scores, picks its survivors with one device index, and the
survivors are upsampled, thresholded and boxed where they lie, in the same
chunks of ``points_per_batch``; only the boxes, and then the bit-packed
masks that survive the crop's NMS, come back.  It is the same arithmetic
in the same order, so the records are the same (held by
``tests/test_torch_amg.py``).  Every crop is one image encode
(:meth:`SamPredictor.set_image`): ``crop_n_layers = 1`` encodes 5 times.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Dict, List

import numpy as np
import torch

from inklayer_tpu_torch.models.sam.sam import SamPredictor
from inklayer_tpu_torch.ops.bits import pack_bits, readback, unpack_bits_host


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) normalised xy points at cell centres."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    gx, gy = np.meshgrid(coords, coords)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """Layer i's grid has n_per_side / scale^i points per side."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float):
    """Crop pyramid: layer 0 is the whole image, layer i has (2^i)^2
    overlapping xyxy crops (utils/amg.py generate_crop_boxes)."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes, layer_idxs = [[0, 0, im_w, im_h]], [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        cw = crop_len(im_w, n_side, overlap)
        ch = crop_len(im_h, n_side, overlap)
        xs = [int((cw - overlap) * i) for i in range(n_side)]
        ys = [int((ch - overlap) * i) for i in range(n_side)]
        for x0, y0 in product(xs, ys):
            crop_boxes.append([x0, y0, min(x0 + cw, im_w),
                               min(y0 + ch, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def is_box_near_crop_edge(boxes: np.ndarray, crop_box, orig_box,
                          atol: float = 20.0) -> np.ndarray:
    """True for boxes (in the crop's frame) near their crop's edge but not
    the image's (utils/amg.py:78-88)."""
    crop = np.asarray(crop_box, np.float64)
    orig = np.asarray(orig_box, np.float64)
    b = boxes.astype(np.float64) + np.asarray(
        [crop_box[0], crop_box[1], crop_box[0], crop_box[1]], np.float64)
    near_crop = np.isclose(b, crop[None, :], atol=atol, rtol=0)
    near_image = np.isclose(b, orig[None, :], atol=atol, rtol=0)
    return np.any(near_crop & ~near_image, axis=1)


def stability_score(logits: torch.Tensor, mask_threshold: float = 0.0,
                    offset: float = 1.0) -> torch.Tensor:
    """(..., H, W) logits -> |logits > t + o| / |logits > t - o| (fp32)."""
    hi = (logits > mask_threshold + offset).sum(dim=(-2, -1))
    lo = (logits > mask_threshold - offset).sum(dim=(-2, -1))
    return hi.float() / lo.clamp(min=1).float()


def mask_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, 4) int32 xyxy boxes (exclusive max; zeros for
    an empty mask)."""
    n, h, w = masks.shape
    rows, cols = masks.any(dim=2), masks.any(dim=1)
    ys = torch.arange(h, dtype=torch.int32, device=masks.device)
    xs = torch.arange(w, dtype=torch.int32, device=masks.device)
    big = 1 << 30
    x1 = torch.where(cols, xs, big).amin(dim=1)
    y1 = torch.where(rows, ys, big).amin(dim=1)
    x2 = torch.where(cols, xs, -1).amax(dim=1) + 1
    y2 = torch.where(rows, ys, -1).amax(dim=1) + 1
    box = torch.stack([x1, y1, x2, y2], dim=-1)
    return torch.where(rows.any(dim=1)[:, None], box, 0)


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float
            ) -> np.ndarray:
    """Greedy box NMS; the kept indices, best score first."""
    order = np.argsort(-scores)
    keep = []
    areas = ((boxes[:, 2] - boxes[:, 0]).clip(0)
             * (boxes[:, 3] - boxes[:, 1]).clip(0))
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = (x2 - x1).clip(0) * (y2 - y1).clip(0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep)


def mask_to_rle(mask: np.ndarray) -> Dict:
    """Uncompressed column-major RLE (utils/amg.py mask_to_rle_pytorch)."""
    h, w = mask.shape
    flat = mask.T.reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        flat[pos: pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T


class SamAutomaticMaskGenerator:
    """Masks for everything in an image from a grid of point prompts; the
    reference's defaults."""

    def __init__(self, predictor: SamPredictor, points_per_side: int = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, min_mask_region_area: int = 0,
                 crop_n_layers: int = 0, crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1):
        self.predictor = predictor
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        # survivors of the IoU and stability filters over the last
        # generate call, before any box NMS
        self.last_survivors = 0

    @torch.inference_mode()
    def _decode_points(self, embedding: torch.Tensor, points: np.ndarray):
        """(B, 2) model-space xy -> multimask low-res logits (B, 3, 4G, 4G)
        fp32, iou (B, 3) and stability (B, 3), on the device.  Each point
        gets the reference's (0, 0) / -1 pad point, since there is no box
        (prompt_encoder.py:81-85)."""
        dev = embedding.device
        bp = points.shape[0]
        pts = torch.from_numpy(np.concatenate(
            [points[:, None, :], np.zeros((bp, 1, 2))], 1).astype(
            np.float32)).to(dev)
        labels = torch.tensor([[1, -1]], device=dev).expand(bp, 2)
        logits, iou = self.predictor.model.decode(
            embedding, points=(pts, labels), multimask_output=True)
        stab = stability_score(logits.float(),
                               offset=self.stability_score_offset)
        return logits, iou, stab

    @torch.inference_mode()
    def _process_crop(self, image: np.ndarray, crop_box, grid: np.ndarray,
                      orig_size) -> Dict:
        """One crop: encode it, decode its point grid at low res, filter,
        upsample the survivors, drop boxes on the crop's edge, NMS within
        the crop, and return to the image's frame."""
        pred = self.predictor
        oh, ow = orig_size
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1]
        pred.set_image(cropped)
        state = pred.state
        ch, cw = cropped.shape[:2]
        pts_model = grid * np.asarray([[cw, ch]]) * state["scale"]
        ppb = self.points_per_batch

        survivors: List[Dict] = []
        lowres: List[torch.Tensor] = []
        for start in range(0, len(pts_model), ppb):
            batch = pts_model[start: start + ppb]
            pts = np.pad(batch, ((0, ppb - len(batch)), (0, 0)))
            logits, iou, stab = self._decode_points(state["embedding"], pts)
            iou_h, stab_h = readback([iou.float(), stab])()
            iou_h, stab_h = iou_h[:len(batch)], stab_h[:len(batch)]
            # the JAX loops' tests, NaN included: skip below a threshold
            pi, mi = np.nonzero(~(iou_h < self.pred_iou_thresh)
                                & ~(stab_h < self.stability_score_thresh))
            if not len(pi):
                continue
            m = logits.shape[1]
            rows = torch.from_numpy(pi * m + mi).to(logits.device)
            lowres.append(logits.reshape(-1, *logits.shape[2:])[rows])
            for p, k in zip(pi, mi):
                survivors.append({
                    "predicted_iou": float(iou_h[p, k]),
                    "stability_score": float(stab_h[p, k]),
                    # in the image's frame (uncrop_points)
                    "point_coords": [
                        (grid[start + p] * [cw, ch] + [x0, y0]).tolist()],
                })
        self.last_survivors += len(survivors)
        empty = dict(masks=np.zeros((0, oh, ow), bool),
                     boxes=np.zeros((0, 4), np.float64),
                     iou=np.zeros((0,)), recs=[])
        if not survivors:
            return empty

        # upsample to the crop's size, threshold and box, in chunks of a
        # batch; the masks stay packed on the device
        low = torch.cat(lowres)
        boxes_d, packed = [], []
        for start in range(0, len(low), ppb):
            full = pred._postprocess_device_state(
                state, low[start: start + ppb]) > 0  # (n, ch, cw) bool
            boxes_d.append(mask_boxes(full))
            packed.append(pack_bits(full))
        boxes = readback([torch.cat(boxes_d)])()[0].astype(np.float64)
        idx = np.arange(len(survivors))

        # drop masks touching the crop's edge (but not the image's)
        keep = ~is_box_near_crop_edge(boxes, crop_box, [0, 0, ow, oh])
        idx, boxes = idx[keep], boxes[keep]
        survivors = [r for r, k in zip(survivors, keep) if k]
        if not survivors:
            return empty

        # dedup within the crop (automatic_mask_generator.py:270-276)
        iou_preds = np.asarray([r["predicted_iou"] for r in survivors])
        keep_idx = box_nms(boxes, iou_preds, self.box_nms_thresh)
        idx, boxes = idx[keep_idx], boxes[keep_idx]
        survivors = [survivors[i] for i in keep_idx]
        rows = torch.from_numpy(idx).to(low.device)
        masks_c = unpack_bits_host(readback([torch.cat(packed)[rows]])()[0],
                                   cw)

        # return to the image's frame
        if (x0, y0, x1, y1) != (0, 0, ow, oh):
            full = np.zeros((len(masks_c), oh, ow), bool)
            full[:, y0:y1, x0:x1] = masks_c
            masks_c = full
            boxes = boxes + np.asarray([x0, y0, x0, y0], np.float64)
        return dict(masks=masks_c, boxes=boxes,
                    iou=np.asarray([r["predicted_iou"] for r in survivors]),
                    recs=survivors)

    def generate(self, image: np.ndarray) -> List[Dict]:
        """(H, W, 3) uint8 RGB host image -> the mask records."""
        h, w = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            (h, w), self.crop_n_layers, self.crop_overlap_ratio)
        grids = build_all_layer_point_grids(
            self.points_per_side, self.crop_n_layers,
            self.crop_n_points_downscale_factor)

        self.last_survivors = 0
        parts = [self._process_crop(image, cb, grids[li], (h, w))
                 for cb, li in zip(crop_boxes, layer_idxs)]
        masks = np.concatenate([p["masks"] for p in parts])
        boxes = np.concatenate([p["boxes"] for p in parts])
        recs = [r for p in parts for r in p["recs"]]
        if not recs:
            return []
        crop_of = np.concatenate([
            np.repeat([cb], len(p["recs"]), axis=0)
            for cb, p in zip(crop_boxes, parts)])

        if len(crop_boxes) > 1:
            # across crops, masks from smaller crops win
            # (automatic_mask_generator.py:210-220: scores = 1 / crop area)
            areas = ((crop_of[:, 2] - crop_of[:, 0])
                     * (crop_of[:, 3] - crop_of[:, 1])).astype(np.float64)
            keep = box_nms(boxes, 1.0 / areas, self.crop_nms_thresh)
            masks, boxes = masks[keep], boxes[keep]
            recs = [recs[i] for i in keep]
            crop_of = crop_of[keep]

        out = []
        for i, rec in enumerate(recs):
            m = masks[i]
            if (self.min_mask_region_area
                    and m.sum() < self.min_mask_region_area):
                continue
            cb = crop_of[i]
            out.append({
                "segmentation": m,
                "rle": mask_to_rle(m),
                "area": int(m.sum()),
                # XYWH as the reference's records; xyxy beside it
                "bbox": [boxes[i][0], boxes[i][1],
                         boxes[i][2] - boxes[i][0],
                         boxes[i][3] - boxes[i][1]],
                "bbox_xyxy": boxes[i].tolist(),
                "crop_box": [float(cb[0]), float(cb[1]),
                             float(cb[2] - cb[0]), float(cb[3] - cb[1])],
                "predicted_iou": rec["predicted_iou"],
                "stability_score": rec["stability_score"],
                "point_coords": rec["point_coords"],
            })
        return out
