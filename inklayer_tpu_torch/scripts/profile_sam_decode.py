"""SAM's box-prompted decode path, piece by piece, on the card (port of the
JAX package's ``scripts/profile_sam_decode.py``).

    python -m inklayer_tpu_torch.scripts.profile_sam_decode [--cap 64]
        [--hw 750] [--calls 7] [--device cuda]

At the pipeline's production shapes (``--cap`` boxes, a ``--hw``^2 seeded
sketch) through the ``SamPredictor`` of ``build_pipeline(PipelineConfig())``
(full width, seeded placeholder weights, bf16 on the card):

* ``encode``: ``compute_image_state`` (the ViT-H encode the state holds);
* ``decode``: ``decode_lowres_state`` (prompt encode, two-way transformer,
  low-res logits for every box);
* ``masks n=cap / 16 / 8``: ``masks_from_lowres`` (upsample, crop, resize
  to the image, threshold);
* ``pack_bits``: the bit-packing of the cap masks for a read-back;
* ``decode_to_masks``: decode and masks at the cap, one after the other, as
  the runner chains them.

Each piece: the p50 wall of ``--calls`` calls, each ending in a
synchronise of the card, and the device ms of one traced call
(``profiling.device_profile``).  The card's round trip
(``bench.measure_rtt_ms``) is printed once: every row holds one.  The sum
of encode, decode and masks at the cap is set beside the runner's
``segment`` stage of one default run (every output kept) on the same
sketch, with the number of boxes that run decoded.  Prints one JSON line
last.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch import bench
from inklayer_tpu_torch.build import build_pipeline
from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.ops.bits import pack_bits
from inklayer_tpu_torch.profiling import emit, sync, time_call
from inklayer_tpu_torch.runtime import compute_dtype, resolve_device


def pieces(sam, image, cap: int) -> dict:
    """{piece: function} of the decode path on ``image`` (on the model's
    device), each returning its result."""
    state = sam.compute_image_state(image)
    corners = np.random.default_rng(0).random((cap, 2, 2)) \
        * sam.cfg.image_size
    boxes = torch.from_numpy(np.concatenate(  # xyxy in model space
        [corners.min(1), corners.max(1)], 1)).float().to(sam.device)
    lowres, _ = sam.decode_lowres_state(state, boxes)
    masks = sam.masks_from_lowres(state, lowres, cap)
    fns = {"encode": lambda: sam.compute_image_state(image),
           "decode": lambda: sam.decode_lowres_state(state, boxes)}
    for n in sorted({cap, min(cap, 16), min(cap, 8)}, reverse=True):
        fns[f"masks_n{n}"] = (lambda n=n: sam.masks_from_lowres(state, lowres,
                                                                n))
    fns["pack_bits"] = lambda: pack_bits(masks)
    fns["decode_to_masks"] = lambda: sam.masks_from_lowres(
        state, sam.decode_lowres_state(state, boxes)[0], cap)
    return fns


def time_pieces(fns: dict, device, calls: int = 7) -> dict:
    """{piece: ``profiling.time_call``'s row} after one warm call each."""
    out = {}
    for name, fn in fns.items():
        def call(fn=fn):
            fn()
            sync(device)

        call()  # warm
        out[name] = time_call(call, calls, device)
    return out


def segment_stage(pipe, sketch: np.ndarray) -> tuple:
    """(the runner's segment stage in ms, boxes decoded) of one default run
    after a warm one, every output kept."""
    with tempfile.TemporaryDirectory(prefix="sam_decode_") as out:
        src = os.path.join(out, "sketch.png")
        Image.fromarray(sketch).save(src)
        for _ in range(2):
            run_dir = pipe.run(src, out)
        with open(os.path.join(run_dir, "bboxes.json")) as f:
            n_boxes = len(json.load(f)["bboxes"])
    return pipe.stage_times["segment"] * 1e3, n_boxes


def main(argv=None, pipe=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--hw", type=int, default=750)
    ap.add_argument("--calls", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if pipe is None:
        dev = resolve_device(args.device)
        pipe = build_pipeline(PipelineConfig(), device=dev,
                              dtype=compute_dtype(dev))
    dev = pipe.device
    sketch = (np.random.default_rng(0).random((args.hw, args.hw, 3)) * 255
              ).astype(np.uint8)  # the bench's seeded sketch at 750^2
    image = torch.from_numpy(sketch).to(dev)
    rows = time_pieces(pieces(pipe.sam, image, args.cap), dev, args.calls)
    rtt = bench.measure_rtt_ms(device=dev)
    seg_ms, n_boxes = segment_stage(pipe, sketch)
    cap = args.cap
    pieces_sum = sum(rows[k]["p50_ms"]
                     for k in ("encode", "decode", f"masks_n{cap}"))
    for name, r in rows.items():
        dev_ms = "" if r["device_ms"] is None else \
            f", device {r['device_ms']:.3f} ms"
        print(f"{name:18s} p50 {r['p50_ms']:8.3f} ms{dev_ms}")
    print(f"round trip {rtt:.4f} ms (one per row); encode + decode + masks "
          f"n={cap}: {pieces_sum:.2f} ms against the runner's segment stage "
          f"{seg_ms:.2f} ms ({n_boxes} boxes)")
    return emit({"cap": cap, "hw": args.hw, "calls": args.calls,
                 "pieces": rows, "rtt_ms": rtt, "pieces_sum_ms": pieces_sum,
                 "segment_stage_ms": seg_ms, "segment_boxes": n_boxes}, dev)


if __name__ == "__main__":
    main()
