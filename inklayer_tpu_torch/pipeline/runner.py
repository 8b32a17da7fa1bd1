"""Pipeline orchestrator: the default run and the inpainting stage (port
of :meth:`inklayer_tpu.pipeline.runner.InkLayerPipeline.run`,
runner.py:389-856, with ``device_front=False``).

GroundingDINO detect -> the top-K boxes chained into SAM's box-prompted
decode -> full-resolution masks -> mask cleaning -> the host NMS prefilter
and the NMS + depth-stat front -> Depth-Anything-V2 depth -> depth sort,
disjoint compositing, watershed and box refinement -> the reference's
output contract: ``input.png``, ``bboxes.json``, ``bboxes.png``,
``masks/``, ``segmented_sketch.png``, ``masks_cleaned/``,
``bboxes_final.json``, ``bboxes_final.png``, ``masks_disjoint/``,
``depth_map.png``, ``masks_final/``, ``segmented_sketch_final.png``;
with ``inpaint``, the inpainter then completes the occluded layers from
``masks_final/`` (``complete_layers/``, ``complete_layers_process/``,
``complete_layers_rgba/``).  ``no_intermediate`` leaves only the items of
``KEEP_LIST``.

Masks, depth and the refine stack stay on the model's device; the host
reads back the detections, the NMS/depth-stat matrices, the small refine
statistics and the stacks it writes.  The JAX package's transport
machinery (survivor-subset bucketing, bit-packed and label-map readbacks,
sync counting, the device front, the run_dir lookahead) has no
counterpart here.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.io import outputs as io_out
from inklayer_tpu_torch.models.depth.dpt import quantize_depth
from inklayer_tpu_torch.ops.color import (color_sketch_by_label_map,
                                          mask_label_map)
from inklayer_tpu_torch.pipeline.refine.depth_sort import (containment_graph,
                                                           sort_order)
from inklayer_tpu_torch.pipeline.refine.front import nms_depth_front
from inklayer_tpu_torch.pipeline.refine.mask_cleaner import clean_masks_device
from inklayer_tpu_torch.pipeline.refine.nms import nms_host_prefilter
from inklayer_tpu_torch.pipeline.refine.refiner import (
    improve_masks_deferred, parse_masks_to_disjoint)

STAGES = ("detect", "segment", "depth", "clean", "nms", "refine", "write")


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


def _save_sketch(path: str, image: np.ndarray, masks: torch.Tensor) -> None:
    """The reference's per-mask colouring (each mask paints over the ones
    before it), through the label map of the last covering mask."""
    labels = mask_label_map(masks).cpu().numpy()
    io_out.save_png(path, color_sketch_by_label_map(image, labels,
                                                    masks.shape[0]))


class InkLayerPipeline:
    """The default run over models built once (see
    :func:`inklayer_tpu_torch.build.build_pipeline`).  Several threads may
    call :meth:`run` at once (the web app serves requests concurrently):
    each keeps its own stage times, and the inpainting stage runs one call
    at a time under :attr:`inpaint_lock`."""

    def __init__(self, detector, sam_predictor, depth_estimator,
                 cfg: PipelineConfig = PipelineConfig(), inpainter=None):
        self.detector = detector
        self.sam = sam_predictor
        self.depth = depth_estimator
        self.inpainter = inpainter
        self.cfg = cfg
        self.device = sam_predictor.device
        # one diffusion call on the device at a time: bounds device memory
        # to one in-flight 768^2 sample when requests run concurrently
        self.inpaint_lock = threading.Lock()
        self._local = threading.local()
        self._batched_encoder = None

    @property
    def stage_times(self) -> dict:
        """Seconds per stage of this thread's last :meth:`run` (STAGES, and
        "inpaint" when it ran; device work included: each stage ends with
        a synchronise of the device, so concurrent runs count each
        other's device work)."""
        return getattr(self._local, "stage_times", {})

    def enable_batched_encoder(self):
        """Route SAM's image encoding through a micro-batcher, so that
        concurrent runs share one batched ViT launch; returns the
        :class:`inklayer_tpu_torch.serve.batcher.BatchedSamEncoder`."""
        if self._batched_encoder is None:
            from inklayer_tpu_torch.serve.batcher import BatchedSamEncoder

            self._batched_encoder = BatchedSamEncoder(self.sam.model)
            self.sam.encode_fn = self._batched_encoder.encode
        return self._batched_encoder

    def _stage(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        times = self._local.stage_times
        times[name] = times.get(name, 0.0) + (t1 - t0)
        return t1

    def run(self, input_path: str, out_base_dir: str,
            no_intermediate: bool = False, inpaint: bool = False) -> str:
        """The default run on one image, then the inpainting stage when
        ``inpaint``; returns its output directory."""
        cfg = self.cfg
        rcfg = cfg.refine
        self._local.stage_times = {}
        t0 = time.perf_counter()
        input_name = os.path.basename(input_path).split(".")[0]
        image_pil = Image.open(input_path).convert("RGB")
        image = np.array(image_pil)
        gray = np.array(image_pil.convert("L"))
        h, w = image.shape[:2]
        out_dir = io_out.prepare_out_dir(out_base_dir, input_name)
        io_out.save_input_png(os.path.join(out_dir, "input.png"), input_path,
                              image)
        image_dev = torch.from_numpy(image).to(self.device)
        gray_dev = torch.from_numpy(gray).to(self.device)
        t0 = self._stage("write", t0)

        # detect; the top-K boxes stay on the device and chain into the SAM
        # decode (the surviving detections are a score-sorted prefix)
        det_fin, _scores, boxes_dev = self.detector.detect_device(image_dev)
        t0 = self._stage("detect", t0)
        state = self.sam.compute_image_state(image_dev)
        boxes_model = boxes_cxcywh_to_sam_space(boxes_dev, (h, w),
                                                state["scale"])
        lowres, _iou = self.sam.decode_lowres_state(state, boxes_model)
        t0 = self._stage("segment", t0)
        depth = self.depth.infer_image_device(image_dev)
        depth_u8 = quantize_depth(depth)
        t0 = self._stage("depth", t0)
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
        t0 = self._stage("segment", t0)
        if not no_intermediate:
            io_out.save_norm_bboxes(boxes_abs, scores, image_pil.size,
                                    os.path.join(out_dir, "bboxes.json"))
            io_out.save_png(os.path.join(out_dir, "bboxes.png"), np.asarray(
                io_out.draw_boxes_image(image_pil, xyxy_norm.tolist(), scores,
                                        labels=det.get("labels"))))
            io_out.save_masks_dir(masks_dev.cpu().numpy(),
                                  os.path.join(out_dir, "masks"))
            _save_sketch(os.path.join(out_dir, "segmented_sketch.png"), image,
                         masks_dev)
            t0 = self._stage("write", t0)

        cleaned, _capped = clean_masks_device(masks_dev, rcfg)
        t0 = self._stage("clean", t0)
        if not no_intermediate:
            io_out.save_masks_dir(cleaned.cpu().numpy(),
                                  os.path.join(out_dir, "masks_cleaned"))
            t0 = self._stage("write", t0)

        # sketch NMS: host prefilter + gates, then the NMS + depth-stat front
        kept0, order0, gate, iou_bbox = nms_host_prefilter(
            boxes_abs, scores, gray, rcfg)
        if len(kept0):
            keep, dscores, doverlap = nms_depth_front(
                kept0, gate, iou_bbox, order0, cleaned, gray_dev, depth, rcfg)
            kept = kept0[order0[keep]]
            pos = {int(o): i for i, o in enumerate(kept0)}
            rows = np.asarray([pos[int(i)] for i in kept])
        else:
            kept = np.zeros((0,), np.int64)
        t0 = self._stage("nms", t0)
        final_norm = [xyxy_norm[i].tolist() for i in kept]
        final_data = {"bboxes": final_norm,
                      "scores": [float(scores[i]) for i in kept],
                      "kept_indices": [int(i) for i in kept],
                      "threshold": rcfg.nms_iou}
        with open(os.path.join(out_dir, "bboxes_final.json"), "w") as f:
            json.dump(final_data, f, indent=4)
        io_out.save_png(os.path.join(out_dir, "bboxes_final.png"), np.asarray(
            io_out.draw_boxes_image(image_pil, final_norm,
                                    final_data["scores"])))
        t0 = self._stage("write", t0)

        # refinement: depth sort from the front's stats, disjoint layers,
        # watershed + box completion, the candidate extra mask
        sort_result = None
        if len(kept):
            kept_masks = cleaned[torch.from_numpy(kept).to(self.device)]
            kept_boxes = np.asarray(
                [[int(xyxy_norm[i][0] * w), int(xyxy_norm[i][1] * h),
                  int(xyxy_norm[i][2] * w), int(xyxy_norm[i][3] * h)]
                 for i in kept], float)
            cont = containment_graph(kept_boxes, (h, w), rcfg)
            sort_result = sort_order(dscores[rows], cont,
                                     doverlap[np.ix_(rows, rows)])
        else:
            kept_masks = torch.zeros((0, h, w), dtype=torch.bool,
                                     device=self.device)
            kept_boxes = np.zeros((0, 4))
        disjoint, sorted_boxes, _info = parse_masks_to_disjoint(
            kept_masks, kept_boxes, gray_dev, rcfg, sort_result=sort_result)
        final, has_extra = improve_masks_deferred(
            disjoint,
            np.asarray(sorted_boxes) if len(sorted_boxes) else np.zeros((0, 4)),
            gray_dev, rcfg)
        if not bool(has_extra):  # the candidate extra mask is empty
            final = final[:-1]
        t0 = self._stage("refine", t0)

        if not no_intermediate or inpaint:  # the layer editors read it
            io_out.save_masks_dir(disjoint.cpu().numpy(),
                                  os.path.join(out_dir, "masks_disjoint"))
        io_out.save_masks_dir(final.cpu().numpy(),
                              os.path.join(out_dir, "masks_final"))
        io_out.save_png(os.path.join(out_dir, "depth_map.png"),
                        np.repeat(depth_u8.cpu().numpy()[:, :, None], 3,
                                  axis=2))
        _save_sketch(os.path.join(out_dir, "segmented_sketch_final.png"),
                     image, final)
        t0 = self._stage("write", t0)
        if inpaint:  # reads masks_final/ and input.png from disk
            if self.inpainter is None:
                print("Inpainting requested but no inpainter is configured; "
                      "skipping (provide diffusion weights to enable).")
            else:
                with self.inpaint_lock:
                    self.inpainter.run_on_sketch_dir(out_dir)
                t0 = self._stage("inpaint", t0)
        if no_intermediate:
            io_out.cleanup_intermediate(out_dir)
            self._stage("write", t0)
        return out_dir
