"""Occluded-stroke inpainting orchestration (port of
:mod:`inklayer_tpu.pipeline.inpaint.orchestrate`).

For each depth-ordered disjoint mask: the white-background layer image;
the earlier (in-front) masks whose bounding box overlaps it; their
background-silhouette masks; the edit mask = their union inside this
mask's box, minus the mask itself.  The layers that need it are inpainted
(batched when more than one does), the original ink is composited back,
and ``complete_layers/``, ``complete_layers_process/mask_i/`` and
``complete_layers_rgba/`` are written.
"""

from __future__ import annotations

import glob
import os
import shutil
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
from PIL import Image

from inklayer_tpu_torch.pipeline.inpaint.masks import (
    create_rgba_layers_on_dir, get_mask)


def mask_to_bbox(mask: np.ndarray) -> Optional[List[int]]:
    ys, xs = np.nonzero(mask > 127 if mask.dtype == np.uint8 else mask)
    if len(ys) == 0:
        return None
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


def mask_within_bbox(mask: np.ndarray, bbox) -> np.ndarray:
    """The mask with everything outside [x1, x2) x [y1, y2) cleared."""
    x1, y1, x2, y2 = bbox
    out = mask.copy()
    out[:y1, :] = False
    out[y2:, :] = False
    out[:, :x1] = False
    out[:, x2:] = False
    return out


def assemble_inpaint_input(
    masks: List[np.ndarray],  # depth-ordered bool masks (index 0 = front)
    index: int,
    sketch_rgb: np.ndarray,  # (H, W, 3) original sketch
) -> Tuple[Optional[np.ndarray], np.ndarray, Optional[np.ndarray], bool,
           Optional[np.ndarray]]:
    """Returns (edit_mask, sketch_layer_rgb, debug_vis, need_inpaint,
    original_sketch_mask)."""
    mask = masks[index].astype(bool)
    layer = sketch_rgb.copy()
    layer[~mask] = 255  # only this layer's ink, white elsewhere
    if index == 0:  # the front-most layer: nothing occludes it
        return None, layer, None, False, None
    bbox = mask_to_bbox(mask)
    if bbox is None:
        return None, layer, None, False, None

    overlap = [i for i in range(index)
               if (obox := mask_to_bbox(masks[i])) is not None
               and mask_within_bbox(mask, obox).any()]
    if not overlap:
        return mask, layer, mask.astype(np.uint8) * 255, False, None

    # background-silhouette masks of the occluders
    bg_masks = [get_mask(np.where(masks[i], 0, 255).astype(np.uint8),
                         dilate_iter=10, kernel_size=5, safety_margin=1,
                         stroke_thick=2, border_band=3)[0] for i in overlap]
    edit_mask = mask_within_bbox(np.logical_or.reduce(bg_masks), bbox)
    edit_mask[mask] = False  # never edit this layer's own ink

    original_sketch_mask = (layer < 255).any(axis=-1)
    # debug vis: the layer's mask white, the edit region red
    debug = np.zeros(mask.shape + (3,), np.uint8)
    debug[mask] = 255
    debug[edit_mask] = [255, 0, 0]
    return edit_mask, layer, debug, True, original_sketch_mask


def composite_original_onto_inpainted(
        inpainted: Image.Image, layer_rgb: np.ndarray,
        original_sketch_mask: np.ndarray) -> Image.Image:
    out = np.asarray(inpainted).copy()
    out[original_sketch_mask] = layer_rgb[original_sketch_mask]
    return Image.fromarray(out)


class Inpainter:
    """The inpainting stage.  ``inpaint_func(image, mask) -> PIL`` is the
    diffusion backend; ``inpaint_batch_func([(image, mask), ...])`` its
    batched form (independent layers share one UNet launch per solver
    step); ``single_layer_func(image, mask, prompt)`` the text-guided
    web-edit backend (cfg 7.0, cond 0.6, one pass, no sketch
    post-processing).

    ``stage_times`` holds the seconds of the last ``run_on_sketch_dir``:
    ``assemble`` (layers, silhouettes, edit masks, their PNGs),
    ``inpaint`` (the diffusion backend), ``composite`` and ``rgba``."""

    def __init__(self, inpaint_func: Callable,
                 single_layer_func: Optional[Callable] = None,
                 inpaint_batch_func: Optional[Callable] = None):
        self.inpaint_func = inpaint_func
        self.single_layer_func = single_layer_func
        self.inpaint_batch_func = inpaint_batch_func
        self.stage_times: dict = {}

    def inpaint_single_layer(self, image: Image.Image, mask: Image.Image,
                             prompt: str) -> Image.Image:
        if self.single_layer_func is not None:
            return self.single_layer_func(image, mask, prompt)
        return self.inpaint_func(image, mask)

    def run_on_sketch_dir(self, sketch_dir: str) -> str:
        t0 = time.perf_counter()
        masks_dir = os.path.join(sketch_dir, "masks_final")
        if not os.path.exists(masks_dir):
            raise FileNotFoundError(
                f"{masks_dir} missing — run segmentation first")
        mask_paths = sorted(
            glob.glob(os.path.join(masks_dir, "mask_*.png")),
            key=lambda p: int(os.path.basename(p).split("_")[1].split(".")[0]))
        masks = [np.asarray(Image.open(p).convert("L")) > 127
                 for p in mask_paths]
        sketch_rgb = np.asarray(
            Image.open(os.path.join(sketch_dir, "input.png")).convert("RGB"))

        layers_dir = os.path.join(sketch_dir, "complete_layers")
        debug_dir = os.path.join(sketch_dir, "complete_layers_process")
        for d in (layers_dir, debug_dir):
            if os.path.exists(d) and os.listdir(d):
                shutil.rmtree(d)
            os.makedirs(d, exist_ok=True)

        # a layer's assembly reads only the masks and the sketch, never
        # another layer's result: assemble all, then batch the diffusion
        todo = []  # (i, layer, edit_mask, orig_mask)
        for i in range(len(masks)):
            edit_mask, layer, debug, need_inpaint, orig_mask = \
                assemble_inpaint_input(masks, i, sketch_rgb)
            cur_debug = os.path.join(debug_dir, f"mask_{i}")
            os.makedirs(cur_debug, exist_ok=True)
            Image.fromarray(layer).save(
                os.path.join(cur_debug, "sketch_layer.png"))
            Image.fromarray(layer).save(
                os.path.join(layers_dir, f"layer_{i}.png"))
            if debug is not None:
                Image.fromarray(debug).save(
                    os.path.join(cur_debug, "debug_vis.png"))
            if need_inpaint:
                Image.fromarray(edit_mask.astype(np.uint8) * 255).save(
                    os.path.join(cur_debug, "edit_mask.png"))
                todo.append((i, layer, edit_mask, orig_mask))
        t1 = time.perf_counter()
        self.stage_times = {"assemble": t1 - t0}

        results = []
        if todo:
            pairs = [(Image.fromarray(layer),
                      Image.fromarray(edit_mask.astype(np.uint8) * 255))
                     for _, layer, edit_mask, _ in todo]
            if self.inpaint_batch_func is not None and len(pairs) > 1:
                results = self.inpaint_batch_func(pairs)
            else:
                results = [self.inpaint_func(im, mk) for im, mk in pairs]
        t2 = time.perf_counter()
        for (i, layer, _edit, orig_mask), inpainted in zip(todo, results):
            cur_debug = os.path.join(debug_dir, f"mask_{i}")
            inpainted.save(os.path.join(cur_debug, "inpainted_image.png"))
            final = composite_original_onto_inpainted(inpainted, layer,
                                                      orig_mask)
            final.save(os.path.join(cur_debug, "final_composited.png"))
            final.save(os.path.join(layers_dir, f"layer_{i}.png"))
        t3 = time.perf_counter()

        # complete_layers -> complete_layers_rgba (the basename only: a
        # parent directory whose name holds "layers" stays as it is)
        rgba_dir = os.path.join(
            os.path.dirname(layers_dir),
            os.path.basename(layers_dir).replace("layers", "layers_rgba"))
        create_rgba_layers_on_dir(layers_dir, rgba_dir)
        self.stage_times.update(inpaint=t2 - t1, composite=t3 - t2,
                                rgba=time.perf_counter() - t3)
        return layers_dir


def expand_mask_to_rect(mask: np.ndarray, pad: int = 10) -> np.ndarray:
    """Single-layer web edit: the mask's box grown by ``pad`` px, filled."""
    bbox = mask_to_bbox(mask)
    if bbox is None:
        return mask.astype(bool)
    h, w = mask.shape
    x1, y1, x2, y2 = bbox
    out = np.zeros_like(mask, dtype=bool)
    out[max(0, y1 - pad): min(h, y2 + pad),
        max(0, x1 - pad): min(w, x2 + pad)] = True
    return out
