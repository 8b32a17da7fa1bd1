"""Pipeline orchestrator, detect + segment half (port of the first half of
:meth:`inklayer_tpu.pipeline.runner.InkLayerPipeline.run`,
runner.py:389-621).

``run`` stops after segmentation: GroundingDINO detect -> the top-K boxes
chained into SAM's box-prompted decode -> full-resolution masks, writing
``input.png``, ``bboxes.json``, ``bboxes.png``, ``masks/`` and
``segmented_sketch.png``.  Mask cleaning, sketch NMS, depth, refinement
and inpainting are not ported yet, so their outputs are not written.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.io import outputs as io_out
from inklayer_tpu_torch.ops.color import (color_sketch_by_label_map,
                                          mask_label_map)


def boxes_cxcywh_to_sam_space(boxes: torch.Tensor, hw, scale_xy
                              ) -> torch.Tensor:
    """(K, 4) normalised cxcywh -> (K, 4) xyxy in SAM model space: scale to
    pixels, truncate like the host path's astype(int), then scale per axis
    into the model's resized frame."""
    h, w = hw
    b = boxes.float()
    wh = torch.tensor([float(w), float(h)], device=b.device)
    half = b[:, 2:4] / 2
    xyxy = torch.cat([(b[:, 0:2] - half) * wh, (b[:, 0:2] + half) * wh], 1)
    sc = torch.as_tensor(np.asarray(scale_xy, np.float32), device=b.device)
    return torch.trunc(xyxy) * torch.cat([sc, sc])


class InkLayerPipeline:
    """Detect + segment over models built once (see
    :func:`inklayer_tpu_torch.build.build_pipeline`)."""

    def __init__(self, detector, sam_predictor,
                 cfg: PipelineConfig = PipelineConfig()):
        self.detector = detector
        self.sam = sam_predictor
        self.cfg = cfg
        self.device = sam_predictor.device
        # seconds per stage of the last run(): detect, segment (device work
        # included) and write (the output files)
        self.stage_times: dict = {}

    def _stage(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_times[name] = self.stage_times.get(name, 0.0) + (t1 - t0)
        return t1

    def run(self, input_path: str, out_base_dir: str) -> str:
        """Detect + segment one image; returns its output directory.

        Writes input.png, bboxes.json, bboxes.png, masks/mask_{i}.png and
        segmented_sketch.png — the half of the reference's output contract
        that precedes mask cleaning."""
        self.stage_times = {}
        input_name = os.path.basename(input_path).split(".")[0]
        image_pil = Image.open(input_path).convert("RGB")
        image = np.array(image_pil)
        h, w = image.shape[:2]
        out_dir = io_out.prepare_out_dir(out_base_dir, input_name)
        io_out.save_input_png(os.path.join(out_dir, "input.png"), input_path,
                              image)
        image_dev = torch.from_numpy(image).to(self.device)

        # detect; the top-K boxes stay on the device and chain into the SAM
        # decode (the surviving detections are a score-sorted prefix)
        t0 = time.perf_counter()
        det_fin, _scores, boxes_dev = self.detector.detect_device(image_dev)
        t0 = self._stage("detect", t0)
        state = self.sam.compute_image_state(image_dev)
        boxes_model = boxes_cxcywh_to_sam_space(boxes_dev, (h, w),
                                                state["scale"])
        lowres, _iou = self.sam.decode_lowres_state(state, boxes_model)
        t0 = self._stage("segment", t0)
        det = det_fin()
        t0 = self._stage("detect", t0)

        boxes_cxcywh, scores = det["boxes"], det["scores"]
        # cxcywh -> xyxy normalised -> absolute int (utils/processing.py)
        xyxy_norm = np.stack([
            boxes_cxcywh[:, 0] - boxes_cxcywh[:, 2] / 2,
            boxes_cxcywh[:, 1] - boxes_cxcywh[:, 3] / 2,
            boxes_cxcywh[:, 0] + boxes_cxcywh[:, 2] / 2,
            boxes_cxcywh[:, 1] + boxes_cxcywh[:, 3] / 2,
        ], axis=-1) if len(boxes_cxcywh) else np.zeros((0, 4))
        boxes_abs = (xyxy_norm * np.asarray([w, h, w, h])).astype(int) \
            .astype(float)
        n_det = len(boxes_abs)
        if n_det:
            masks_dev = self.sam.masks_from_lowres(state, lowres, n_det)
        else:
            masks_dev = torch.zeros((0, h, w), dtype=torch.bool,
                                    device=self.device)
        masks = masks_dev.cpu().numpy()
        labels = mask_label_map(masks_dev).cpu().numpy()
        t0 = self._stage("segment", t0)
        io_out.save_norm_bboxes(boxes_abs, scores, image_pil.size,
                                os.path.join(out_dir, "bboxes.json"))
        io_out.save_png(os.path.join(out_dir, "bboxes.png"), np.asarray(
            io_out.draw_boxes_image(image_pil, xyxy_norm.tolist(), scores,
                                    labels=det.get("labels"))))
        io_out.save_masks_dir(masks, os.path.join(out_dir, "masks"))
        io_out.save_png(os.path.join(out_dir, "segmented_sketch.png"),
                        color_sketch_by_label_map(image, labels, n_det))
        self._stage("write", t0)
        return out_dir
