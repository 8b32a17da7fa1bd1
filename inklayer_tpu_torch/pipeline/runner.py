"""Pipeline orchestrator: the default run, the inpainting stage and the
directory sweep (port of :mod:`inklayer_tpu.pipeline.runner`,
``InkLayerPipeline.run`` and ``run_dir``).

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
``KEEP_LIST``, and makes and cleans masks only for the NMS prefilter's
survivors, padded to a power-of-two bucket.  When the output directory
holds ``mmdet_out/*.json`` (the mmdetection alt route's boxes, written
after the directory is prepared), its boxes and scores replace
GroundingDINO's before NMS, while the masks still come from
GroundingDINO's boxes, as in the JAX runner.

With ``PipelineConfig.device_front`` the masks are made and cleaned over
the whole top-K capacity and the NMS + depth-stat front runs from the
device boxes and scores
(:func:`inklayer_tpu_torch.pipeline.refine.front.nms_depth_front_device`),
all queued before the detection is read back; the detection and the front
then come back in one read-back, and no subset masks are made.  The
mmdetection route and the batched prefill's host boxes turn it off for
that run.

Masks, depth and the refine stack stay on the model's device.  The host
writes on two writer threads: each stack is read back by a non-blocking
copy into pinned memory that the run enqueues behind the work that made
it (:mod:`inklayer_tpu_torch.ops.bits`), and the writer waits on that
copy's event alone.  Each thread drains the writes it submitted
(:meth:`InkLayerPipeline.drain`); a run on its own drains before it
returns.

:meth:`InkLayerPipeline.run_dir` sweeps a list of images.  With one
worker, a decode thread reads image i+1 while image i runs, and once image
i's device work and read-backs are queued a lookahead queues image i+1's
upload, detection, SAM encode and depth behind them on the same stream.
With several workers, a thread pool runs the images, each run on its own
CUDA stream.  With ``batch_size`` > 1, GroundingDINO and SAM's encoder
first run batched over the images; a run then has host boxes, not device
ones, and takes its masks from ``SamPredictor.predict_device_state``, as
the JAX package does.  No stage synchronises the whole device: a stage
ends with a synchronise of the calling thread's current stream.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.io import outputs as io_out
from inklayer_tpu_torch.models.depth.dpt import quantize_depth
from inklayer_tpu_torch.ops.bits import (final_readback, masks_readback,
                                         pack_bits, readback,
                                         unpack_bits_host)
from inklayer_tpu_torch.ops.color import (color_sketch_by_label_map,
                                          mask_label_map)
from inklayer_tpu_torch.pipeline.refine.depth_sort import (containment_graph,
                                                           sort_order)
from inklayer_tpu_torch.pipeline.refine.front import (nms_depth_front,
                                                      nms_depth_front_device)
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


def decode_image(path: str):
    """(RGB (H, W, 3) uint8, gray (H, W) uint8) of an image file."""
    pil = Image.open(path).convert("RGB")
    return np.array(pil), np.array(pil.convert("L"))


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory and a
    non-blocking copy, so that the host does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _label_map_host(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (H, W) label of the last mask covering each pixel
    (:func:`inklayer_tpu_torch.ops.color.mask_label_map` on the host)."""
    lab = np.zeros(masks.shape[1:], np.int32)
    for i, m in enumerate(masks):
        lab[m] = i + 1
    return lab


class InkLayerPipeline:
    """The default run over models built once (see
    :func:`inklayer_tpu_torch.build.build_pipeline`).  Several threads may
    call :meth:`run` at once (the web app serves requests concurrently,
    ``run_dir`` runs workers): each keeps its own stage times and pending
    writes, and the inpainting stage runs one call at a time under
    :attr:`inpaint_lock`."""

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
        # PNG encodes and the waits on read-backs run here, so the run
        # goes on to its next device work
        self._writer = ThreadPoolExecutor(max_workers=2)
        # host waits on device results (detections, the NMS front, each
        # written stack), counted for attribution
        self.sync_count = 0
        self._sync_guard = threading.Lock()
        # run_dir's results computed ahead of a run, by input path
        self._det_cache: dict = {}
        self._sam_state_cache: dict = {}
        self._img_cache: dict = {}
        self._depth_cache: dict = {}
        self._host_cache: dict = {}  # path -> (RGB, gray) host arrays

    @property
    def stage_times(self) -> dict:
        """Seconds per stage of this thread's last :meth:`run` (STAGES, and
        "inpaint" when it ran), or their sums over its last
        :meth:`run_dir`.  A stage ends with a synchronise of the thread's
        current stream, so its device work is in it; "write" is the run's
        own host time around the writes and its wait for them."""
        return getattr(self._local, "stage_times", {})

    @property
    def _pending(self) -> list:
        lst = getattr(self._local, "pending", None)
        if lst is None:
            lst = self._local.pending = []
        return lst

    @property
    def async_io(self) -> bool:
        # per thread, like _pending: concurrent runs must not restore each
        # other's flag (a stale True makes a run skip its final drain)
        return getattr(self._local, "async_io", False)

    @async_io.setter
    def async_io(self, value: bool):
        self._local.async_io = value

    def _count_sync(self, n: int = 1):
        with self._sync_guard:
            self.sync_count += n

    def _submit(self, fn, *args):
        if self.async_io:
            self._pending.append(self._writer.submit(fn, *args))
        else:
            fn(*args)

    def drain(self):
        """Wait for all host writes submitted BY THIS THREAD."""
        pending = self._pending
        for f in pending:
            f.result()
        pending.clear()

    def enable_batched_encoder(self):
        """Route SAM's image encoding through a micro-batcher, so that
        concurrent runs share one batched ViT launch; returns the
        :class:`inklayer_tpu_torch.serve.batcher.BatchedSamEncoder`."""
        if self._batched_encoder is None:
            from inklayer_tpu_torch.serve.batcher import BatchedSamEncoder

            self._batched_encoder = BatchedSamEncoder(self.sam.model)
            self.sam.encode_fn = self._batched_encoder.encode
        return self._batched_encoder

    def _stage(self, name: str, t0: float, sync: bool = True) -> float:
        if sync and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()
        times = self._local.stage_times
        times[name] = times.get(name, 0.0) + (t1 - t0)
        return t1

    def _stream_after(self, main):
        """A new CUDA stream, ordered after ``main``'s work so far, as this
        thread's current stream (nothing on the CPU)."""
        if main is None:
            return contextlib.nullcontext()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(main)
        return torch.cuda.stream(stream)

    # ------------------------------------------------------------------
    def run_dir(self, paths, out_base_dir: str, no_intermediate: bool = False,
                inpaint: bool = False, batch_size: int = 1, workers=None):
        """Run every image of ``paths``; returns their output directories.

        ``workers`` (default ``cfg.sweep_workers``) > 1 runs the images on
        a thread pool, each run on its own CUDA stream.  One worker runs
        them in turn on the calling thread, with a decode thread and the
        lookahead: once image i's device work and read-backs are queued,
        image i+1's upload, detection, SAM encode and depth are queued
        behind them, so the card computes them while the host finishes
        image i.  ``batch_size`` > 1 first runs detection and SAM's
        encoder over groups of that many images (one forward each); the
        runs then read those results.  ``inpaint`` forces one worker (the
        diffusion stage runs one call at a time anyway)."""
        if workers is None:
            workers = max(1, int(self.cfg.sweep_workers))
        totals, guard = {}, threading.Lock()

        def add(times):
            with guard:
                for k, v in times.items():
                    totals[k] = totals.get(k, 0.0) + v

        self.async_io = True
        self._det_cache, self._sam_state_cache = {}, {}
        try:
            if batch_size > 1:
                self._local.stage_times = {}
                self._prefill_batches(paths, batch_size)
                add(self._local.stage_times)
            self._img_cache, self._depth_cache = {}, {}
            if inpaint:
                workers = 1
            if workers > 1 and len(paths) > 1:
                # the prefill's results lie on this thread's stream
                main = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

                def _run_and_drain(p):
                    with self._stream_after(main):
                        out = self.run(p, out_base_dir, no_intermediate,
                                       inpaint)
                        self.drain()  # this worker's own writes
                    add(self.stage_times)
                    return out

                with ThreadPoolExecutor(max_workers=workers) as ex:
                    return list(ex.map(_run_and_drain, paths))
            outs = []
            with ThreadPoolExecutor(max_workers=1) as decode_pool:
                dec_futs = {}
                if paths:
                    dec_futs[paths[0]] = decode_pool.submit(decode_image,
                                                            paths[0])
                for i, p in enumerate(paths):
                    nxt = paths[i + 1] if i + 1 < len(paths) else None
                    if nxt is not None and nxt not in dec_futs:
                        dec_futs[nxt] = decode_pool.submit(decode_image, nxt)

                    def _prefetch(nxt=nxt):
                        if nxt is None or nxt in self._det_cache:
                            return
                        fut = dec_futs.pop(nxt, None)
                        host = (fut.result() if fut is not None
                                else decode_image(nxt))
                        dev_next = upload(host[0], self.device)
                        # JAX runner.py:341-346: the parts, for the fused
                        # read-back of the device front
                        detect = (self.detector.detect_device_parts
                                  if self.cfg.device_front
                                  else self.detector.detect_device)
                        self._det_cache[nxt] = detect(dev_next)
                        self._sam_state_cache[nxt] = \
                            self.sam.compute_image_state(dev_next)
                        self._depth_cache[nxt] = \
                            self.depth.infer_image_device(dev_next)
                        self._img_cache[nxt] = dev_next
                        self._host_cache[nxt] = host

                    fut = dec_futs.pop(p, None)
                    if fut is not None and p not in self._host_cache:
                        self._host_cache[p] = fut.result()
                    outs.append(self.run(p, out_base_dir, no_intermediate,
                                         inpaint, _prefetch_hook=_prefetch))
                    add(self.stage_times)
            return outs
        finally:
            self.drain()
            self.async_io = False
            self._det_cache, self._sam_state_cache = {}, {}
            self._img_cache, self._depth_cache = {}, {}
            self._host_cache = {}
            self._local.stage_times = totals

    def _prefill_batches(self, paths, batch_size: int):
        """Detection and SAM's encoder over groups of ``batch_size`` images,
        one forward each, into the caches the runs read."""
        for s in range(0, len(paths), batch_size):
            chunk = paths[s: s + batch_size]
            images = [upload(decode_image(p)[0], self.device) for p in chunk]
            t0 = time.perf_counter()
            dets = self.detector.detect_batch(images)
            t0 = self._stage("detect", t0)
            states = self.sam.precompute_image_states(images)
            self._stage("segment", t0)
            for p, d, st in zip(chunk, dets, states):
                self._det_cache[p] = d
                self._sam_state_cache[p] = st

    # ------------------------------------------------------------------
    def run(self, input_path: str, out_base_dir: str,
            no_intermediate: bool = False, inpaint: bool = False,
            _prefetch_hook=None) -> str:
        """The default run on one image, then the inpainting stage when
        ``inpaint``; returns its output directory.  ``_prefetch_hook`` (the
        sweep's lookahead) is called once all of this image's device work
        and read-backs are queued."""
        cfg, rcfg, dev = self.cfg, self.cfg.refine, self.device
        self._local.stage_times = {}
        t0 = time.perf_counter()
        input_name = os.path.basename(input_path).split(".")[0]
        host = self._host_cache.pop(input_path, None)
        image, gray = host if host is not None else decode_image(input_path)
        image_pil = Image.fromarray(image)
        h, w = image.shape[:2]
        out_dir = io_out.prepare_out_dir(out_base_dir, input_name)
        # host writes go to the writer threads even in a run on its own, so
        # that PNG encodes overlap device work; drained before returning
        was_async = self.async_io
        self.async_io = True
        self._submit(io_out.save_input_png, os.path.join(out_dir, "input.png"),
                     input_path, image)
        image_dev = self._img_cache.pop(input_path, None)
        if image_dev is None:
            image_dev = upload(image, dev)
        gray_dev = upload(gray, dev)
        t0 = self._stage("write", t0)

        # the mmdetection alt route (refinement/bbox_filter.py:40-45): when
        # <out_dir>/mmdet_out/*.json exists its boxes replace GDINO's before
        # NMS, so the detect -> decode chain and the survivor-subset masks
        # are off.  Globbed after prepare_out_dir, which empties a non-empty
        # out_dir, as the JAX runner does: only a file written after that
        # is read.
        mmdet_json = glob.glob(os.path.join(out_dir, "mmdet_out", "*.json"))

        # detect; the top-K boxes stay on the device and chain into the SAM
        # decode (the surviving detections are a score-sorted prefix).  The
        # sweep may have run it: the lookahead leaves the device triple (or
        # the parts, with the device front), the batched prefill a host
        # dict (then there are no device boxes).  With the device front the
        # read-back waits to join the front's (JAX runner.py:450-470).
        det = self._det_cache.pop(input_path, None)
        boxes_dev = scores_dev = det_parts = det_finalize = None
        if det is None and cfg.device_front:
            det = self.detector.detect_device_parts(image_dev)
        elif det is None:
            det = self.detector.detect_device(image_dev)
        if isinstance(det, tuple) and len(det) == 4:
            det_parts, det_finalize, scores_dev, boxes_dev = det
        elif isinstance(det, tuple):
            det, scores_dev, boxes_dev = det
        t0 = self._stage("detect", t0)
        state = self._sam_state_cache.pop(input_path, None)
        if state is None:
            state = self.sam.compute_image_state(image_dev)
        elif dev.type == "cuda":  # encoded on another stream, maybe
            with torch.inference_mode():
                state["embedding"].record_stream(
                    torch.cuda.current_stream(dev))
        lowres = None
        if boxes_dev is not None and not mmdet_json:
            lowres, _iou = self.sam.decode_lowres_state(
                state, boxes_cxcywh_to_sam_space(boxes_dev, (h, w),
                                                 state["scale"]))
        t0 = self._stage("segment", t0)
        depth = self._depth_cache.pop(input_path, None)
        if depth is None:
            depth = self.depth.infer_image_device(image_dev)
        depth_u8 = quantize_depth(depth)
        t0 = self._stage("depth", t0)

        # the device front (JAX runner.py:510-530): masks over the whole
        # top-K capacity, cleaned, then the prefilter, gates, NMS scan and
        # depth stats from the device boxes, all queued before the
        # detection is read back; rows stay in top-K index space
        front = front_host = cleaned = None
        if lowres is not None and cfg.device_front:
            masks_dev = self.sam.masks_from_lowres(state, lowres,
                                                   int(lowres.shape[0]))
            t0 = self._stage("segment", t0)
            cleaned, _capped = clean_masks_device(masks_dev, rcfg)
            t0 = self._stage("clean", t0)
            front = nms_depth_front_device(
                boxes_dev, scores_dev, cleaned, gray_dev, depth, (h, w),
                rcfg, box_threshold=self.detector.cfg.box_threshold)
            t0 = self._stage("nms", t0)
        if det_parts is not None:
            # one read-back for the detection and the front together
            # (JAX runner.py:534-545)
            self._count_sync()
            host = readback(list(det_parts) + list(front or ()))()
            det, front_host = det_finalize(host[:4]), host[4:]
        elif callable(det):
            self._count_sync()
            det = det()
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

        def write_bbox_outputs():
            io_out.save_norm_bboxes(boxes_abs, scores, image_pil.size,
                                    os.path.join(out_dir, "bboxes.json"))
            io_out.save_png(os.path.join(out_dir, "bboxes.png"), np.asarray(
                io_out.draw_boxes_image(image_pil, xyxy_norm.tolist(), scores,
                                        labels=det.get("labels"))))

        if not no_intermediate:
            self._submit(write_bbox_outputs)

        # --no_intermediate with the chained decode: masks/ and
        # masks_cleaned/ are never written and NMS and refine read only the
        # prefilter survivors, so their masks are made after the prefilter;
        # not with the device front, whose masks are made (JAX
        # runner.py:589-593)
        n_det = len(boxes_abs)
        subset = (no_intermediate and lowres is not None and n_det > 0
                  and front is None)
        if front is not None:
            pass  # the top-K capacity's masks, made above
        elif lowres is not None and n_det and not subset:
            masks_dev = self.sam.masks_from_lowres(state, lowres, n_det)
        elif lowres is None and n_det:  # host boxes (batched prefill, mmdet)
            masks_dev, _iou = self.sam.predict_device_state(state, boxes_abs)
        else:
            masks_dev = torch.zeros((0, h, w), dtype=torch.bool, device=dev)
        t0 = self._stage("segment", t0)

        def write_sam_outputs(wait):
            self._count_sync()
            packed, labels = wait()
            masks = unpack_bits_host(packed, w)
            io_out.save_masks_dir(masks, os.path.join(out_dir, "masks"))
            io_out.save_png(os.path.join(out_dir, "segmented_sketch.png"),
                            color_sketch_by_label_map(image, labels,
                                                      len(masks)))

        if not no_intermediate:
            # the capacity's stack is cut to the detections (a prefix)
            shown = masks_dev[:n_det]
            self._submit(write_sam_outputs, readback(
                [pack_bits(shown), mask_label_map(shown)]))

        if cleaned is None and not subset:
            cleaned, _capped = clean_masks_device(masks_dev, rcfg)
        t0 = self._stage("clean", t0)

        def write_cleaned(wait):
            self._count_sync()
            io_out.save_masks_dir(wait(),
                                  os.path.join(out_dir, "masks_cleaned"))

        if not no_intermediate:
            self._submit(write_cleaned, masks_readback(cleaned[:n_det]))

        if mmdet_json:  # the alt route's boxes; the masks stay GDINO's
            with open(mmdet_json[0]) as f:
                alt = json.load(f)
            alt_norm = np.asarray(alt["bboxes"], float)
            boxes_abs = alt_norm * np.asarray([w, h, w, h]) \
                if alt_norm.size and alt_norm.max() <= 1.0 else alt_norm
            scores = np.asarray(alt["scores"], float)
            xyxy_norm = boxes_abs / np.asarray([w, h, w, h]) \
                if boxes_abs.size else boxes_abs

        if front_host is not None:
            # the device front's rows are in top-K index space, which is
            # the detections' (JAX runner.py:662-670).  The JAX package
            # then cuts the cleaning's cap flags to the detections
            # (:823-827); the port's connected components have no cap.
            valid, order, keep, dscores, doverlap = front_host
            kept = rows_of_kept = order[keep & valid[order]].astype(np.int64)
        else:
            # host prefilter + gates, then the NMS + depth-stat front
            kept0, order0, gate, iou_bbox = nms_host_prefilter(
                boxes_abs, scores, gray, rcfg)
            k = len(kept0)
            t0 = self._stage("nms", t0)
            front_rows = kept0
            if subset and k:
                # masks and cleaning for the survivors only, padded to a
                # pow2 bucket; the cleaned rows are then in kept0-position
                # space
                bucket = 1
                while bucket < k:
                    bucket *= 2
                bucket = min(bucket, int(lowres.shape[0]))
                sel = np.zeros((bucket,), np.int64)
                sel[:k] = kept0
                masks_dev = self.sam.masks_from_lowres(
                    state, lowres[upload(sel, dev)], bucket)
                t0 = self._stage("segment", t0)
                cleaned, _capped = clean_masks_device(masks_dev, rcfg)
                t0 = self._stage("clean", t0)
                front_rows = np.arange(k)
            if k:
                self._count_sync()
                keep, dscores, doverlap = nms_depth_front(
                    front_rows, gate, iou_bbox, order0, cleaned, gray_dev,
                    depth, rcfg)
                kept = kept0[order0[keep]]
                pos = {int(o): i for i, o in enumerate(kept0)}
                rows_of_kept = np.asarray([pos[int(i)] for i in kept],
                                          np.int64)
            else:
                kept = rows_of_kept = np.zeros((0,), np.int64)
        t0 = self._stage("nms", t0)
        final_norm = [xyxy_norm[i].tolist() for i in kept]
        final_data = {"bboxes": final_norm,
                      "scores": [float(scores[i]) for i in kept],
                      "kept_indices": [int(i) for i in kept],
                      "threshold": rcfg.nms_iou}

        def write_final_bbox_outputs():
            with open(os.path.join(out_dir, "bboxes_final.json"), "w") as f:
                json.dump(final_data, f, indent=4)
            io_out.save_png(
                os.path.join(out_dir, "bboxes_final.png"),
                np.asarray(io_out.draw_boxes_image(image_pil, final_norm,
                                                   final_data["scores"])))

        self._submit(write_final_bbox_outputs)

        # refinement: depth sort from the front's stats, disjoint layers,
        # watershed + box completion, the candidate extra mask
        sort_result = None
        if len(kept):
            rows = rows_of_kept if subset else kept
            kept_masks = cleaned[upload(rows, dev)]
            kept_boxes = np.asarray(
                [[int(xyxy_norm[i][0] * w), int(xyxy_norm[i][1] * h),
                  int(xyxy_norm[i][2] * w), int(xyxy_norm[i][3] * h)]
                 for i in kept], float)
            cont = containment_graph(kept_boxes, (h, w), rcfg)
            sort_result = sort_order(
                dscores[rows_of_kept], cont,
                doverlap[np.ix_(rows_of_kept, rows_of_kept)])
        else:
            kept_masks = torch.zeros((0, h, w), dtype=torch.bool, device=dev)
            kept_boxes = np.zeros((0, 4))
        disjoint, sorted_boxes, _info = parse_masks_to_disjoint(
            kept_masks, kept_boxes, gray_dev, rcfg, sort_result=sort_result)
        final, has_extra = improve_masks_deferred(
            disjoint,
            np.asarray(sorted_boxes) if len(sorted_boxes) else np.zeros((0, 4)),
            gray_dev, rcfg)
        t0 = self._stage("refine", t0)

        # both stacks are disjoint: uint8 label maps, read back with the
        # depth map and the extra-mask flag in one read-back
        need_disjoint = not no_intermediate or inpaint

        def write_final_outputs(wait):
            self._count_sync()
            stacks, (depth_host, extra), labels = wait()
            if need_disjoint:
                io_out.save_masks_dir(stacks[0],
                                      os.path.join(out_dir, "masks_disjoint"))
            final_masks, lab = stacks[-1], labels[-1]
            if not bool(extra):  # the candidate extra mask is empty
                n_full = len(final_masks)
                final_masks = final_masks[:-1]
                if lab is not None:
                    lab = np.where(lab == n_full, 0, lab)
            io_out.save_masks_dir(final_masks,
                                  os.path.join(out_dir, "masks_final"))
            io_out.save_png(os.path.join(out_dir, "depth_map.png"),
                            np.repeat(depth_host[:, :, None], 3, axis=2))
            if lab is None:
                lab = _label_map_host(final_masks)
            io_out.save_png(
                os.path.join(out_dir, "segmented_sketch_final.png"),
                color_sketch_by_label_map(image, lab, len(final_masks)))

        self._submit(write_final_outputs, final_readback(
            [disjoint, final] if need_disjoint else [final],
            [depth_u8, has_extra], with_labels=True))

        if _prefetch_hook is not None:
            # all of this image's device work and read-backs are queued:
            # the next image's front goes behind them
            _prefetch_hook()
        t0 = time.perf_counter()
        if inpaint:  # reads masks_final/ and input.png from disk
            self.drain()
            t0 = self._stage("write", t0, sync=False)
            if self.inpainter is None:
                print("Inpainting requested but no inpainter is configured; "
                      "skipping (provide diffusion weights to enable).")
            else:
                with self.inpaint_lock:
                    self.inpainter.run_on_sketch_dir(out_dir)
                t0 = self._stage("inpaint", t0, sync=False)
        if no_intermediate:
            self.drain()  # every write to this directory lands first
            io_out.cleanup_intermediate(out_dir)
        self.async_io = was_async
        if not was_async:
            self.drain()  # a run on its own: all outputs on disk on return
        self._stage("write", t0, sync=False)
        return out_dir
