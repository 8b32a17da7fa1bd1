"""The mmdetection route's producer (port of
:mod:`inklayer_tpu.pipeline.mmdet_route`).

InkLayer/detector/gdino_mmdetection.py run_ft_dino_inference_on_image: a
multi-noun prompt ("a . b . c") through the fine-tuned GroundingDINO, a
noun label per box, and normalised-xyxy boxes written to
``mmdet_out/<name>.json``, which the runner prefers over GroundingDINO's
own boxes when it is there (refinement/bbox_filter.py:40-45).  The port's
:class:`inklayer_tpu_torch.models.gdino.GDinoDetector` stands in for
mmdet's ``DetInferencer``, as in the JAX package: each box's label is its
token posmap decoded against the prompt and matched back to a noun.

    python -m inklayer_tpu_torch.pipeline.mmdet_route --img <path>
        [--nouns cat dog] [--out_dir <img_dir>/mmdet_out]
        [--score_threshold 0.2] [--models_dir DIR] [--device cuda] [--cpu]

It runs on the card unless ``--device cpu`` or ``--cpu`` is given.  The
file's ``model_info`` names the port: ``model_config`` is
``inklayer_tpu_torch.GDinoConfig`` and ``device`` the detector's device.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch.io.outputs import draw_boxes_image

DEF_SCORE_THRESHOLD = 0.2


def _match_noun(phrase: str, nouns: Sequence[str]) -> str:
    """The prompt noun a decoded posmap phrase came from (mmdet's
    label_idx -> nouns[idx]); 'unknown' when none matches
    (gdino_mmdetection.py:91-96)."""
    phrase = phrase.lower().strip()
    if not phrase:
        return "unknown"
    best, best_score = "unknown", 0
    for noun in nouns:
        nl = noun.lower().strip()
        if not nl:
            continue
        if nl == phrase:
            return noun
        # token overlap: a posmap may span several prompt words
        overlap = len(set(nl.split()) & set(phrase.split()))
        if nl in phrase or phrase in nl:
            overlap = max(overlap, 1)
        if overlap > best_score:
            best, best_score = noun, overlap
    return best


def run_ft_dino_inference_on_image(
    detector,
    image_path: str,
    nouns: Sequence[str],
    mmdet_out_base_dir: str,
    out_dir: Optional[str] = None,
    score_threshold: float = DEF_SCORE_THRESHOLD,
) -> dict:
    """Detect ``nouns`` in the image and write the mmdet-contract files
    into ``out_dir`` (default ``mmdet_out_base_dir``): ``<name>.json``
    (normalised xyxy boxes, noun labels, scores, model_info),
    ``input_image.png`` and ``pred.png`` (gdino_mmdetection.py:82-117).
    ``detector`` is a GDinoDetector; returns the JSON's dict."""
    out_dir = out_dir or mmdet_out_base_dir
    image_pil = Image.open(image_path).convert("RGB")
    image = torch.from_numpy(np.array(image_pil)).to(detector.device)
    image_name = os.path.basename(image_path).split(".")[0]

    prompt = " . ".join(nouns)
    det = detector.detect(image, caption=prompt,
                          box_threshold=score_threshold)

    out_dict: dict = {"bboxes": [], "labels": [], "scores": []}
    boxes_norm_xyxy: List[List[float]] = []
    for box, score, label in zip(det["boxes"], det["scores"],
                                 det.get("labels", [])):
        cx, cy, bw, bh = [float(v) for v in box]
        xyxy = [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2]
        out_dict["bboxes"].append(xyxy)
        out_dict["labels"].append(_match_noun(label, nouns))
        out_dict["scores"].append(float(score))
        boxes_norm_xyxy.append(xyxy)

    os.makedirs(out_dir, exist_ok=True)
    image_pil.save(os.path.join(out_dir, "input_image.png"))
    draw_boxes_image(image_pil, boxes_norm_xyxy, out_dict["scores"],
                     labels=out_dict["labels"]).save(
        os.path.join(out_dir, "pred.png"))

    out_dict["model_info"] = {
        "model_config": "inklayer_tpu_torch.GDinoConfig",
        "weights": "inklayer_gdino (converted)",
        "device": str(detector.device),
        "score_threshold": score_threshold,
        "time": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
    }
    with open(os.path.join(out_dir, f"{image_name}.json"), "w") as f:
        json.dump(out_dict, f, indent=4)
    return out_dict


def main(argv=None):
    """The reference script's usage: writes ``mmdet_out/`` for an image,
    so that the pipeline's next run there prefers its boxes."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--img", required=True)
    ap.add_argument("--nouns", nargs="+", default=["object"])
    ap.add_argument("--out_dir", default=None,
                    help="defaults to <img_dir>/mmdet_out")
    ap.add_argument("--score_threshold", type=float,
                    default=DEF_SCORE_THRESHOLD)
    ap.add_argument("--models_dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU; overrides --device")
    args = ap.parse_args(argv)

    from inklayer_tpu_torch.build import build_detector
    from inklayer_tpu_torch.config import PipelineConfig

    device = "cpu" if args.cpu else args.device
    dtype = torch.bfloat16 if device.startswith("cuda") else torch.float32
    detector = build_detector(PipelineConfig(), device, dtype,
                              models_dir=args.models_dir)
    out_dir = args.out_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.img)), "mmdet_out")
    return run_ft_dino_inference_on_image(
        detector, args.img, list(args.nouns), out_dir,
        score_threshold=args.score_threshold)


if __name__ == "__main__":  # pragma: no cover
    main()
