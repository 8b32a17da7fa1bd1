"""Entry ``models``: the model work of ``main.py --dir --batch B`` on a
group of B sketches, in the runner's order (``InkLayerPipeline``'s batched
prefill, then each run's depth and masks).

A request:

1. uploads the B sketches (``pipeline.runner.upload``);
2. ``GDinoDetector.detect_batch``: one GroundingDINO forward over the
   group, the top ``max_boxes`` detections read back and thresholded;
3. ``SamPredictor.precompute_image_states``: one batched ViT encode;
4. per sketch, ``DepthEstimator.infer_image_device`` and
   ``SamPredictor.predict_device_state`` at the detections' boxes (xyxy
   pixels truncated to integers, as the runner makes them);
5. reads back each sketch's masks (bit-packed, ``ops.bits``) and depth map.

Spans (``gpubench/<layer>``) wrap the calls into each layer for the traced
sub-window.  The check (:func:`judge`) runs the plain fp32 reference
(``gpubench/reference``) on a sample of the window's sketches: detection
decoded from the proposals the program's two-stage top-K chose (recorded
by :func:`follow` after the window, not in it), SAM's mask logits and IoU
for the program's own boxes, and the depth map.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from gpubench import weights

# per-model offsets of the weight seed
SEED_OFFSETS = {"gdino": 0, "sam": 1, "depth": 2}


def _seed(seed: int, model: str) -> int:
    return (seed * 4 + SEED_OFFSETS[model]) % (1 << 63)


def make_config(cls, data: dict, nested: Optional[dict] = None):
    """``cls(**data)`` with lists as tuples and the fields named in
    ``nested`` ({field: dataclass}) built the same way."""
    nested = nested or {}
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if f.name in nested:
            v = make_config(nested[f.name], v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[f.name] = v
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    return cls(**kw)


def configs(config: dict, module) -> dict:
    """The three model configurations from a configuration file, as the
    classes of ``module`` (the program's ``config`` or the reference's)."""
    m = config["models"]
    return {
        "gdino": make_config(module.GDinoConfig, m["gdino"],
                             {"swin": module.SwinConfig,
                              "bert": module.BertConfig}),
        "sam": make_config(module.SamConfig, m["sam"]),
        "depth": make_config(module.DepthConfig, m["depth"]),
    }


def reference_makers(config: dict) -> dict:
    """{model: constructor} of the reference's modules at the
    configuration's widths (the weights' schema)."""
    from gpubench.reference import config as rc
    from gpubench.reference.depth.dpt import DepthAnythingV2
    from gpubench.reference.gdino.gdino import GroundingDINO
    from gpubench.reference.sam.sam import Sam

    c = configs(config, rc)
    return {"gdino": lambda: GroundingDINO(c["gdino"]),
            "sam": lambda: Sam(c["sam"]),
            "depth": lambda: DepthAnythingV2(c["depth"])}


def serving_dtype(config: dict, device: torch.device) -> torch.dtype:
    """The configuration's precision on the card; fp32 on the CPU (the
    port's plain versions, for tests)."""
    if device.type != "cuda":
        return torch.float32
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[
        config["precision"]]


def seeded_state(config: dict, model: str, seed: int, device, dtype):
    """``model``'s weights from ``seed``; its normalisation scales are the
    configuration's ``norm_scale`` for it (1 where not given)."""
    makers = reference_makers(config)
    scale = config.get("norm_scale", {}).get(model, 1.0)
    return weights.seeded_state_dict(weights.schema(makers[model], scale),
                                     _seed(seed, model), device, dtype)


@dataclasses.dataclass
class System:
    device: torch.device
    detector: object
    sam: object
    depth: object


def build(cell, seed: int, device: torch.device, traffic=None) -> System:
    """The port's three models through their classes, with seeded weights
    made on ``device`` and loaded by ``load_state_dict``."""
    from inklayer_tpu_torch import config as pc
    from inklayer_tpu_torch.models.depth import (DepthAnythingV2,
                                                 DepthEstimator)
    from inklayer_tpu_torch.models.gdino import (GDinoDetector,
                                                 GroundingDINO)
    from inklayer_tpu_torch.models.sam import Sam, SamPredictor

    c = configs(cell.config, pc)
    dtype = serving_dtype(cell.config, device)
    makers = {"gdino": lambda: GroundingDINO(c["gdino"]),
              "sam": lambda: Sam(c["sam"]),
              "depth": lambda: DepthAnythingV2(c["depth"])}
    models = {}
    for name, make in makers.items():
        state = seeded_state(cell.config, name, seed, device, dtype)
        models[name] = weights.build(make, state, device, dtype)
        del state
    return System(device=device,
                  detector=GDinoDetector(models["gdino"]),
                  sam=SamPredictor(models["sam"],
                                   box_capacity=c["gdino"].max_boxes),
                  depth=DepthEstimator(models["depth"]))


def boxes_abs(boxes_cxcywh: np.ndarray, h: int, w: int) -> np.ndarray:
    """Normalised cxcywh -> absolute xyxy pixels truncated to integers (the
    runner's conversion)."""
    if not len(boxes_cxcywh):
        return np.zeros((0, 4))
    b = boxes_cxcywh
    xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=-1)
    return (xyxy * np.asarray([w, h, w, h])).astype(int).astype(float)


class SelectionRecorder:
    """Stands in for ``torch`` in the program's GroundingDINO transformer
    module while :func:`follow` re-runs a sampled request, and keeps the
    indices of its two-stage top-K (the proposals it decodes): the check
    follows the program's selection, which rounding reorders among
    near-tied proposals."""

    def __init__(self, k: int):
        self.k = k
        self.indices = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, x, k, *args, **kwargs):
        got = torch.topk(x, k, *args, **kwargs)
        if k == self.k:
            self.indices.append(got.indices)
        return got


class recording_selection:
    """``with recording_selection(k) as rec:`` installs a
    :class:`SelectionRecorder` in the program's transformer module."""

    def __init__(self, k: int):
        self.rec = SelectionRecorder(k)

    def __enter__(self) -> SelectionRecorder:
        from inklayer_tpu_torch.models.gdino import transformer

        self.module = transformer
        transformer.torch = self.rec
        return self.rec

    def __exit__(self, *exc):
        self.module.torch = torch


def call(system: System, sketches: List[np.ndarray]) -> List[dict]:
    """One request; returns per sketch its detection (``boxes`` cxcywh,
    ``scores``, ``token_probs``), ``boxes_abs``, ``iou``, bit-packed
    ``masks`` and ``depth``, all on the host."""
    from inklayer_tpu_torch.ops.bits import pack_bits, readback
    from inklayer_tpu_torch.pipeline.runner import upload

    dev = system.device
    with record_function("gpubench/request"):
        with record_function("gpubench/upload"):
            images = [upload(s, dev) for s in sketches]
        with record_function("gpubench/detect"):
            dets = system.detector.detect_batch(images)
        with record_function("gpubench/segment"):
            states = system.sam.precompute_image_states(images)
        pending = []
        for image, det, state in zip(images, dets, states):
            h, w = image.shape[:2]
            with record_function("gpubench/depth"):
                depth = system.depth.infer_image_device(image)
            b_abs = boxes_abs(det["boxes"], h, w)
            with record_function("gpubench/segment"):
                if len(b_abs):
                    masks, iou = system.sam.predict_device_state(state, b_abs)
                else:
                    masks = torch.zeros((0, h, w), dtype=torch.bool,
                                        device=dev)
                    iou = np.zeros((0,), np.float32)
            with record_function("gpubench/readback"):
                pending.append((det, b_abs, iou, w,
                                readback([pack_bits(masks), depth])))
        out = []
        with record_function("gpubench/readback"):
            for det, b_abs, iou, w, wait in pending:
                packed, depth = wait()
                out.append({"boxes": det["boxes"], "scores": det["scores"],
                            "token_probs": det["token_logits"],
                            "boxes_abs": b_abs, "iou": iou,
                            "masks": packed, "width": w, "depth": depth})
    return out


def follow(system: System, samples, traffic) -> None:
    """After the window, on the same system: each sampled request's group
    detected again with the two-stage selection recorded, and the proposals
    chosen kept in its outputs (``select``; None where no selection of
    ``num_queries`` was seen, and then the reference decodes its own).
    ``rerun_gap`` is how far the re-run's detections lie from the
    window's (0 where the program is deterministic)."""
    from inklayer_tpu_torch.pipeline.runner import upload

    nq = system.detector.cfg.num_queries
    lost = False
    for r, outs in samples:
        images = [upload(s, system.device) for s in traffic.request(r)]
        with recording_selection(nq) as rec:
            dets = system.detector.detect_batch(images)
        select = torch.cat(rec.indices).cpu().numpy() if rec.indices \
            else []
        lost |= len(select) != len(outs)
        for j, (out, det) in enumerate(zip(outs, dets)):
            out["select"] = select[j] if len(select) == len(outs) else None
            same = det["boxes"].shape == np.shape(out["boxes"])
            out["rerun_gap"] = float(max(
                np.abs(det["boxes"] - out["boxes"]).max(initial=0.0),
                np.abs(det["scores"] - out["scores"]).max(initial=0.0))) \
                if same else 1.0
    if lost:
        print("gpubench: the program's two-stage top-K was not recorded "
              "(models/gdino/transformer.py's torch.topk of num_queries); "
              "the reference decodes its own selection", file=sys.stderr)


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def unpack(packed: np.ndarray, width: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1)[..., :width].astype(bool)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_models(config: dict, seed: int, device, quantize=None,
                     names=("gdino", "sam", "depth")):
    """Yields (name, fp32 reference model) one at a time, each freed before
    the next is built, with fp32 products in fp32 (TF32 off, the flags put
    back after).  ``quantize(model)`` (the control) rounds the model in
    place."""
    makers = reference_makers(config)
    serve = serving_dtype(config, device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name in names:
            state = seeded_state(config, name, seed, device, serve)
            state = {k: v.float() for k, v in state.items()}
            model = weights.build(makers[name], state, device, torch.float32)
            del state
            if quantize is not None:
                quantize(model)
            yield name, model
            del model
            _free(device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@torch.no_grad()
def reference_outputs(config: dict, seed: int, items, device,
                      quantize=None,
                      names=("gdino", "sam", "depth")) -> List[dict]:
    """The reference's outputs for each (sketch, program output) item: every
    query's probabilities and boxes decoded from the program's selection
    (its own where the item holds none), the mask logits and IoU for the
    program's boxes (``prompts_from`` the program's output, or the
    reference's own detection where the item holds no program output), and
    the depth map.  Of the masks it keeps the thresholded mask and each
    pixel's confidence: its logit's distance from the threshold over the
    mask's median distance."""
    from gpubench.reference.depth import dpt as rdpt
    from gpubench.reference.gdino import gdino as rg
    from gpubench.reference.sam import sam as rs

    gcfg = config["models"]["gdino"]
    sam_thr = config["models"]["sam"].get("mask_threshold", 0.0)
    res = [dict() for _ in items]
    for name, model in reference_models(config, seed, device, quantize,
                                        names):
        for (sketch, prog), r in zip(items, res):
            image = torch.from_numpy(np.ascontiguousarray(sketch)).to(device)
            if name == "gdino":
                select = None if prog is None else prog.get("select")
                probs, boxes, scores, select = rg.detect(
                    model, image, config["caption_ids"], select)
                r["probs"] = probs.cpu().numpy()
                r["boxes"] = boxes.cpu().numpy()
                r["enc_scores"] = scores.cpu().numpy()
                r["select"] = select.cpu().numpy()
            elif name == "sam":
                prompts = prog["boxes_abs"] if prog is not None else \
                    _own_boxes(r, gcfg, image.shape[:2])
                r["boxes_abs"] = prompts
                state = rs.encode(model, image)
                h, w = image.shape[:2]
                if len(prompts):
                    logits, iou = rs.masks_for_boxes(model, state, prompts,
                                                     gcfg["max_boxes"])
                    r["masks"] = (logits > sam_thr).cpu().numpy()
                    dist = (logits - sam_thr).abs().flatten(1)
                    med = dist.median(-1, keepdim=True).values
                    r["mask_conf"] = (dist / med.clamp(min=1e-30)).clamp(
                        max=6e4).half().view(logits.shape).cpu().numpy()
                    r["iou"] = iou.cpu().numpy()
                else:
                    r["masks"] = np.zeros((0, h, w), bool)
                    r["mask_conf"] = np.zeros((0, h, w), np.float16)
                    r["iou"] = np.zeros((0,), np.float32)
            else:
                est = rdpt.DepthEstimator(model)
                r["depth"] = est.infer_image_device(image).float().cpu().numpy()
    return res


def top_k(probs: np.ndarray, boxes: np.ndarray, k: int, threshold: float):
    """The top-k queries by their best token's probability, kept above the
    threshold: (scores, boxes, probs), score-descending."""
    scores = probs.max(-1)
    order = np.argsort(-scores, kind="stable")[:k]
    keep = order[scores[order] > threshold]
    return scores[keep], boxes[keep], probs[keep]


def _own_boxes(r: dict, gcfg: dict, hw) -> np.ndarray:
    _, boxes, _ = top_k(r["probs"], r["boxes"], gcfg["max_boxes"],
                        gcfg["box_threshold"])
    return boxes_abs(boxes, *hw)


def as_outputs(config: dict, refs: List[dict]) -> List[dict]:
    """Reference outputs in the program's output form (the control put in
    the program's place)."""
    gcfg = config["models"]["gdino"]
    outs = []
    for r in refs:
        scores, boxes, probs = top_k(r["probs"], r["boxes"],
                                     gcfg["max_boxes"],
                                     gcfg["box_threshold"])
        masks = r["masks"]
        outs.append({"boxes": boxes, "scores": scores, "token_probs": probs,
                     "select": r["select"],
                     "boxes_abs": r["boxes_abs"], "iou": r["iou"],
                     "masks": np.packbits(masks, axis=-1),
                     "width": masks.shape[-1], "depth": r["depth"]})
    return outs


def mask_sure_share(outs: List[dict], refs: List[dict],
                    margin: float) -> float:
    """The share of the sample's sure mask pixels on which the program's
    mask and the reference's (for the same box) differ.  A pixel is sure
    where the reference's logit lies farther from SAM's threshold than
    ``margin`` times the mask's median distance: rounding flips pixels near
    the threshold, a wrong mask head or resampling flips sure ones."""
    differ, sure = 0, 0
    for out, r in zip(outs, refs):
        masks = unpack(out["masks"], out["width"])
        if masks.shape != r["masks"].shape:
            return 1.0
        keep = r["mask_conf"] > margin
        differ += int((keep & (masks != r["masks"])).sum())
        sure += int(keep.sum())
    return differ / max(sure, 1)


def readings(cell, outs: List[dict], refs: List[dict]) -> dict:
    """The numbers compared, over the sample:

    * ``det_match_p90``: the 90th percentile over the program's detections
      of the distance to the nearest of the reference's queries (decoded
      from the program's proposals), as the largest of the box
      coordinates' (normalised cxcywh), the score's and the token
      probabilities' differences;
    * ``mask_sure_share``: :func:`mask_sure_share` at the traffic's
      ``check.mask_margin``;
    * ``iou_gap``: the largest difference of predicted IoU;
    * ``depth_rel_l1``: the depth maps' relative L1 error over the whole
      sample (the maps of all its sketches as one vector: a map that is
      nearly 0 after the head's ReLU does not set it alone).
    """
    nearest = []  # every detection's distance to its nearest query
    iou_gap = 0.0
    depth_l1 = [0.0, 0.0]  # absolute error, absolute reference
    for out, r in zip(outs, refs):
        k = len(out["scores"])
        pb = np.asarray(out["boxes"], np.float64)
        ps = np.asarray(out["scores"], np.float64)
        pp = np.asarray(out["token_probs"], np.float64)
        nearest += [float(np.maximum.reduce([
            np.abs(r["boxes"] - pb[i]).max(-1),
            np.abs(r["probs"].max(-1) - ps[i]),
            np.abs(r["probs"] - pp[i]).max(-1)]).min()) for i in range(k)]
        iou = np.asarray(out["iou"], np.float64)
        if iou.shape != r["iou"].shape:
            iou_gap = 1.0
        elif len(iou):
            iou_gap = max(iou_gap, float(np.abs(iou - r["iou"]).max()))
        d, dr = np.asarray(out["depth"], np.float64), r["depth"]
        depth_l1[0] += float(np.abs(d - dr).sum())
        depth_l1[1] += float(np.abs(dr).sum())
    return {
        "det_match_p90": float(np.percentile(nearest, 90)) if nearest
        else 1.0,
        "mask_sure_share": mask_sure_share(
            outs, refs, float(cell.traffic["check"]["mask_margin"])),
        "iou_gap": iou_gap,
        "depth_rel_l1": depth_l1[0] / max(depth_l1[1], 1e-24),
    }


def compare(cell, seed: int, samples, traffic, device):
    """(the program's outputs, the reference's) for the sampled requests
    [(request, outputs)]."""
    if not samples:
        raise RuntimeError("no request completed in the window")
    items = [(sketch, out) for r, outs in samples
             for sketch, out in zip(traffic.request(r), outs)]
    refs = reference_outputs(cell.config, seed, items, device)
    return [o for _, o in items], refs


def control_outputs(cell, seed: int, traffic, requests, device,
                    quantize=None):
    """(the control's outputs, the reference's) on the sketches of
    ``requests``: the reference rounded by ``quantize`` (fp8 by default) in
    the program's place, with its own selection, judged as the program
    is."""
    from gpubench.reference.lowp import quantize_

    sketches = [s for r in requests for s in traffic.request(r)]
    control = reference_outputs(cell.config, seed,
                                [(s, None) for s in sketches], device,
                                quantize=quantize or quantize_)
    outs = as_outputs(cell.config, control)
    refs = reference_outputs(cell.config, seed, list(zip(sketches, outs)),
                             device)
    return outs, refs


def judge(cell, seed: int, samples, traffic, device) -> dict:
    """{number: {"value", "limit"}} for the window's sampled requests: the
    numbers the cell's traffic file gives limits for."""
    found = readings(cell, *compare(cell, seed, samples, traffic, device))
    limits = cell.traffic["check"]["limits"]
    return {k: {"value": found[k], "limit": limits[k]} for k in limits}
