"""Occluded-stroke inpainting orchestration (port of
:mod:`inklayer_tpu.pipeline.inpaint.orchestrate`).

For each depth-ordered disjoint mask: the white-background layer image;
the earlier (in-front) masks whose bounding box overlaps it; their
background-silhouette masks; the edit mask = their union inside this
mask's box, minus the mask itself.  The layers that need it are inpainted
(batched when more than one does) and the original ink is composited back
(:meth:`Inpainter.complete`, in memory); ``run_on_sketch_dir`` reads a
sketch directory's masks, completes them and writes
``complete_layers/``, ``complete_layers_process/mask_i/`` and
``complete_layers_rgba/``.
"""

from __future__ import annotations

import glob
import os
import shutil
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
from PIL import Image

from inklayer_tpu_torch.pipeline.inpaint.masks import (
    create_rgba_layers_on_dir, get_mask)
from inklayer_tpu_torch.spans import timed


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
    silhouettes: Optional[dict] = None,
) -> Tuple[Optional[np.ndarray], np.ndarray, Optional[np.ndarray], bool,
           Optional[np.ndarray]]:
    """Returns (edit_mask, sketch_layer_rgb, debug_vis, need_inpaint,
    original_sketch_mask).  ``silhouettes``, where given, keeps each
    occluder's background silhouette by its index, so that the layers of
    one sketch compute each one once."""
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
    silhouettes = {} if silhouettes is None else silhouettes
    for i in overlap:
        if i not in silhouettes:
            silhouettes[i] = get_mask(
                np.where(masks[i], 0, 255).astype(np.uint8), dilate_iter=10,
                kernel_size=5, safety_margin=1, stroke_thick=2,
                border_band=3)[0]
    bg_masks = [silhouettes[i] for i in overlap]
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


@dataclass
class LayerResult:
    """One layer of :meth:`Inpainter.complete`: what
    :func:`assemble_inpaint_input` returns, and for a layer that needed
    inpainting the backend's image (``inpainted``, PIL) and the layer with
    its original ink composited back (``final``, (H, W, 3) uint8)."""

    edit_mask: Optional[np.ndarray]
    layer: np.ndarray
    debug: Optional[np.ndarray]
    need_inpaint: bool
    original_sketch_mask: Optional[np.ndarray]
    inpainted: Optional[Image.Image] = None
    final: Optional[np.ndarray] = None


class Inpainter:
    """The inpainting stage.  ``inpaint_func(image, mask) -> PIL`` is the
    diffusion backend; ``inpaint_batch_func([(image, mask), ...])`` its
    batched form (independent layers share one UNet launch per solver
    step); ``single_layer_func(image, mask, prompt)`` the text-guided
    web-edit backend (cfg 7.0, cond 0.6, one pass, no sketch
    post-processing).

    ``stage_times`` holds the seconds of the last ``complete``:
    ``assemble`` (layers, silhouettes, edit masks), ``inpaint`` (the
    diffusion backend) and ``composite``; ``run_on_sketch_dir`` adds
    ``write`` (the PNGs) and ``rgba``."""

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

    def complete(self, masks: List[np.ndarray], sketch_rgb: np.ndarray
                 ) -> List[LayerResult]:
        """The layers of one sketch completed in memory: each depth-ordered
        mask's layer assembled, the occluded ones inpainted (batched when
        more than one is), the original ink composited back.  Returns one
        :class:`LayerResult` per mask, in order."""
        self.stage_times = {}
        with timed("inpaint.assemble", self.stage_times):
            # a layer's assembly reads only the masks and the sketch, never
            # another layer's result: assemble all (each occluder's
            # silhouette once), then batch the diffusion
            silhouettes = {}
            out = [LayerResult(*assemble_inpaint_input(masks, i, sketch_rgb,
                                                       silhouettes))
                   for i in range(len(masks))]
            todo = [r for r in out if r.need_inpaint]
        results = []
        with timed("inpaint.inpaint", self.stage_times, layers=len(todo)):
            if todo:
                pairs = [(Image.fromarray(r.layer),
                          Image.fromarray(r.edit_mask.astype(np.uint8) * 255))
                         for r in todo]
                if self.inpaint_batch_func is not None and len(pairs) > 1:
                    results = self.inpaint_batch_func(pairs)
                else:
                    results = [self.inpaint_func(im, mk) for im, mk in pairs]
        with timed("inpaint.composite", self.stage_times):
            for r, inpainted in zip(todo, results):
                r.inpainted = inpainted
                r.final = np.asarray(composite_original_onto_inpainted(
                    inpainted, r.layer, r.original_sketch_mask))
        return out

    def run_on_sketch_dir(self, sketch_dir: str) -> str:
        """:meth:`complete` on ``sketch_dir``'s ``masks_final/`` and
        ``input.png``, with ``complete_layers/``,
        ``complete_layers_process/mask_i/`` and ``complete_layers_rgba/``
        written."""
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
        layers = self.complete(masks, sketch_rgb)

        with timed("inpaint.write", self.stage_times):
            layers_dir = os.path.join(sketch_dir, "complete_layers")
            debug_dir = os.path.join(sketch_dir, "complete_layers_process")
            for d in (layers_dir, debug_dir):
                if os.path.exists(d) and os.listdir(d):
                    shutil.rmtree(d)
                os.makedirs(d, exist_ok=True)
            for i, r in enumerate(layers):
                cur_debug = os.path.join(debug_dir, f"mask_{i}")
                os.makedirs(cur_debug, exist_ok=True)
                Image.fromarray(r.layer).save(
                    os.path.join(cur_debug, "sketch_layer.png"))
                if r.debug is not None:
                    Image.fromarray(r.debug).save(
                        os.path.join(cur_debug, "debug_vis.png"))
                if r.need_inpaint:
                    Image.fromarray(r.edit_mask.astype(np.uint8) * 255).save(
                        os.path.join(cur_debug, "edit_mask.png"))
                    r.inpainted.save(
                        os.path.join(cur_debug, "inpainted_image.png"))
                    final = Image.fromarray(r.final)
                    final.save(os.path.join(cur_debug,
                                            "final_composited.png"))
                else:
                    final = Image.fromarray(r.layer)
                final.save(os.path.join(layers_dir, f"layer_{i}.png"))

        # complete_layers -> complete_layers_rgba (the basename only: a
        # parent directory whose name holds "layers" stays as it is)
        with timed("inpaint.rgba", self.stage_times):
            rgba_dir = os.path.join(
                os.path.dirname(layers_dir),
                os.path.basename(layers_dir).replace("layers",
                                                     "layers_rgba"))
            create_rgba_layers_on_dir(layers_dir, rgba_dir)
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
