"""Output-directory writers for the reference's per-image layout (copied
from :mod:`inklayer_tpu.io.outputs`, which imports jax through
``inklayer_tpu.ops``): ``input.png``, ``bboxes.json``, ``bboxes.png``,
``masks/``, ``segmented_sketch.png``, ``masks_cleaned/``,
``bboxes_final.json``, ``bboxes_final.png``, ``masks_disjoint/``,
``depth_map.png``, ``masks_final/``, ``segmented_sketch_final.png``, and
the ``--no_intermediate`` keep-list cleanup.

PNGs are written filter-None + zlib level 1 (as the JAX package's native
encoder does): PIL spends most of its PNG time on the adaptive filter
search.  Masks are 1-bit grayscale."""

from __future__ import annotations

import json
import os
import shutil
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from inklayer_tpu_torch.ops.color import generate_pastel_colors

KEEP_LIST = [
    "masks_final", "complete_layers", "complete_layers_rgba",
    "bboxes_final.json", "bboxes_final.png", "segmented_sketch_final.png",
    "depth_map.png", "input.png",
]


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def png_encode(arr: np.ndarray, bilevel: bool = False, level: int = 1
               ) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes, every row filter None.
    ``bilevel`` packs a 0/nonzero (H, W) mask to 1-bit grayscale."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    if bilevel:
        rows, depth, color = np.packbits(arr != 0, axis=1), 1, 0
    else:
        rows, depth = arr.reshape(h, -1), 8
        color = 2 if arr.ndim == 3 else 0
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, arr, level: int = 1) -> None:
    """(H, W) or (H, W, 3) uint8 through :func:`png_encode`; other arrays
    through PIL."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8 and (arr.ndim == 2 or
                                  (arr.ndim == 3 and arr.shape[2] == 3)):
        with open(path, "wb") as f:
            f.write(png_encode(arr, level=level))
        return
    Image.fromarray(arr).save(path, compress_level=level)


def save_input_png(dst: str, src_path: str, image: np.ndarray) -> None:
    """input.png: a byte copy when the source is a PNG (as in the JAX
    package, whatever its mode), else the decoded pixels re-encoded."""
    if src_path.lower().endswith(".png") and os.path.isfile(src_path):
        shutil.copyfile(src_path, dst)
        return
    save_png(dst, image)


def prepare_out_dir(out_base_dir: str, input_name: str) -> str:
    out_dir = os.path.join(out_base_dir, input_name)
    if os.path.exists(out_dir) and len(os.listdir(out_dir)) > 0:
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def save_norm_bboxes(bboxes_abs: Sequence[Sequence[float]],
                     scores: Sequence[float], image_size, out_path: str,
                     labels: Optional[Sequence[str]] = None) -> None:
    """xyxy pixel boxes stored normalised (utils/processing.py)."""
    w, h = image_size
    norm = [[b[0] / w, b[1] / h, b[2] / w, b[3] / h] for b in bboxes_abs]
    obj = {"bboxes": norm, "scores": [float(s) for s in scores]}
    if labels is not None:
        obj["labels"] = list(labels)
    with open(out_path, "w") as f:
        json.dump(obj, f, indent=4)


def save_masks_dir(masks: np.ndarray, out_dir: str) -> None:
    """(N, H, W) bool -> out_dir/mask_{i}.png, 1-bit grayscale (read
    with convert('L'))."""
    os.makedirs(out_dir, exist_ok=True)
    for i, mask in enumerate(masks):
        with open(os.path.join(out_dir, f"mask_{i}.png"), "wb") as f:
            f.write(png_encode(mask, bilevel=True))


def draw_boxes_image(image: Image.Image, norm_boxes, scores=None,
                     labels=None, line_width: int = 3) -> Image.Image:
    """Pastel-coloured normalised-box overlay (visualization.py)."""
    img = image.copy()
    draw = ImageDraw.Draw(img)
    w, h = img.size
    colors = generate_pastel_colors(max(len(norm_boxes), 1))
    for i, box in enumerate(norm_boxes):
        x1, y1, x2, y2 = box
        if max(box) <= 1.0:
            x1, y1, x2, y2 = x1 * w, y1 * h, x2 * w, y2 * h
        draw.rectangle([x1, y1, x2, y2], outline=colors[i], width=line_width)
        parts = []
        if labels is not None and i < len(labels):
            parts.append(str(labels[i]))
        if scores is not None and i < len(scores):
            parts.append(f"{scores[i]:.2f}")
        if parts:
            draw.text((x1, max(0, y1 - 12)), " : ".join(parts), fill=colors[i])
    return img


def cleanup_intermediate(out_dir: str) -> None:
    """--no_intermediate: delete every item not in KEEP_LIST
    (runner.py:91-101)."""
    for item in os.listdir(out_dir):
        if item in KEEP_LIST:
            continue
        path = os.path.join(out_dir, item)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
