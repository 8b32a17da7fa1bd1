"""Detection train-time augmentations, numpy host-side (the port's own
copy of :mod:`inklayer_tpu.pipeline.det_transforms`, which imports no JAX
but lives in a package that does).

Parity target: GroundingDINO ``datasets/transforms.py`` (RandomHorizontalFlip
:156, RandomSizeCrop :179-??, RandomResize :226-246, RandomSelect :247) and
the DETR-style train recipe they compose (flip -> RandomSelect(multi-scale
resize | resize+crop+resize) -> normalize, boxes to normalized cxcywh).

These run on the host (the data pipeline), before any tensor reaches the
card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

DETR_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)


def hflip(image: np.ndarray, boxes: np.ndarray
          ) -> Tuple[np.ndarray, np.ndarray]:
    """image (H, W, 3); boxes (N, 4) xyxy pixels."""
    w = image.shape[1]
    image = image[:, ::-1]
    boxes = boxes.copy()
    boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return image, boxes


def resize_shorter(image: np.ndarray, boxes: np.ndarray, size: int,
                   max_size: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Shorter-side resize with longer-side cap (transforms.py get_size)."""
    from PIL import Image

    h, w = image.shape[:2]
    short, long = min(h, w), max(h, w)
    target = size
    if max_size is not None and long / short * size > max_size:
        target = int(round(max_size * short / long))
    if short == h:
        nh, nw = target, int(round(target * w / h))
    else:
        nh, nw = int(round(target * h / w)), target
    out = np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))
    sx, sy = nw / w, nh / h
    boxes = boxes * np.asarray([sx, sy, sx, sy])
    return out, boxes


def crop(image: np.ndarray, boxes: np.ndarray,
         region: Tuple[int, int, int, int]
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """region (y, x, h, w). Returns (image, boxes, keep mask) — boxes are
    clipped; degenerate boxes are flagged for dropping (transforms.py crop
    removes empty targets)."""
    y, x, h, w = region
    image = image[y: y + h, x: x + w]
    boxes = boxes - np.asarray([x, y, x, y], float)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return image, boxes, keep


def random_size_crop(rng: np.random.Generator, image: np.ndarray,
                     boxes: np.ndarray, min_size: int = 384,
                     max_size: int = 600):
    h, w = image.shape[:2]
    cw = int(rng.integers(min(w, min_size), min(w, max_size) + 1))
    ch = int(rng.integers(min(h, min_size), min(h, max_size) + 1))
    x = int(rng.integers(0, w - cw + 1))
    y = int(rng.integers(0, h - ch + 1))
    return crop(image, boxes, (y, x, ch, cw))


def boxes_to_cxcywh_norm(boxes: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """xyxy pixels -> normalized cxcywh (transforms.py Normalize)."""
    h, w = hw
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / w
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / h
    bw = (boxes[:, 2] - boxes[:, 0]) / w
    bh = (boxes[:, 3] - boxes[:, 1]) / h
    return np.stack([cx, cy, bw, bh], axis=-1)


def detr_train_transform(
    rng: np.random.Generator,
    image: np.ndarray,
    boxes: np.ndarray,
    scales: Sequence[int] = DETR_SCALES,
    max_size: int = 1333,
) -> Tuple[np.ndarray, np.ndarray]:
    """The standard DETR/GDINO train augmentation chain.  Returns the
    augmented image (uint8) and normalized cxcywh boxes."""
    if rng.random() < 0.5:
        image, boxes = hflip(image, boxes)
    if rng.random() < 0.5:
        image, boxes = resize_shorter(
            image, boxes, int(rng.choice(scales)), max_size)
    else:
        image, boxes = resize_shorter(
            image, boxes, int(rng.choice([400, 500, 600])))
        image, boxes, keep = random_size_crop(rng, image, boxes)
        boxes = boxes[keep]
        image, boxes = resize_shorter(
            image, boxes, int(rng.choice(scales)), max_size)
    return image, boxes_to_cxcywh_norm(boxes, image.shape[:2])
