"""GroundingDINO's detect call, top kernels by device time (port of the
JAX package's ``scripts/profile_gdino.py``).

    python -m inklayer_tpu_torch.scripts.profile_gdino [--iters 3]
        [--img PATH] [--device cuda]

The detector of ``build_pipeline(PipelineConfig())`` (full width, seeded
placeholder weights, bf16 on the card) on a sketch (the bench's seeded
750^2 one without ``--img``): ``detect_device`` and its read-back, the
pipeline's detect stage (the JAX script's ``detect_dispatch(img)()``);
one first call, two warm, one timed, then ``--iters`` calls traced as one
and the 25 kernels with the most device time (``profiling.top_kernels``).
Prints one JSON line last.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from inklayer_tpu_torch import bench
from inklayer_tpu_torch.build import build_detector
from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.profiling import emit, print_top, top_kernels
from inklayer_tpu_torch.runtime import compute_dtype, resolve_device


def main(argv=None, detector=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--img", default=None, help="a sketch (default: seeded)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if detector is None:
        dev = resolve_device(args.device)
        detector = build_detector(PipelineConfig(), dev, compute_dtype(dev))
    dev = detector.device
    sketch = np.array(Image.open(args.img).convert("RGB")) if args.img \
        else bench.seeded_sketch()
    image = torch.from_numpy(sketch).to(dev)

    def call():
        detector.detect_device(image)[0]()  # the read-back waits

    res = top_kernels(call, args.iters, 25, dev)
    print_top(res, args.iters)
    return emit({"iters": args.iters, **res}, dev)


if __name__ == "__main__":
    main()
