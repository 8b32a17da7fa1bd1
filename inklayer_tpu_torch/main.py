"""CLI of the PyTorch/CUDA port:

    python -m inklayer_tpu_torch.main --img <path> | --dir <path>
                                      [--out_dir ./output] [--config cfg.json]
                                      [--no_intermediate] [--inpaint]
                                      [--device cuda]

Same input flags as the JAX package's ``main.py``: the default run, and
with ``--inpaint`` the layer completion (SD1.5-inpaint + ControlNet).  It
runs on the card unless ``--device cpu`` is given.  Parameters are seeded
placeholders (no checkpoints ship with the repo).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="InkLayer on PyTorch/CUDA")
    parser.add_argument("--img", type=str, default=None)
    parser.add_argument("--dir", type=str, default=None,
                        help="directory of input images (*.png, *.jpg)")
    parser.add_argument("--out_dir", type=str, default="./output")
    parser.add_argument("--no_intermediate", action="store_true")
    parser.add_argument("--inpaint", action="store_true")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON PipelineConfig path")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.img is None and args.dir is None:
        parser.error("provide --img or --dir")

    import torch

    from inklayer_tpu_torch.config import PipelineConfig, load_config
    from inklayer_tpu_torch.build import build_pipeline

    cfg = load_config(args.config) if args.config else PipelineConfig()
    dtype = torch.bfloat16 if args.device.startswith("cuda") else torch.float32
    pipeline = build_pipeline(cfg, device=args.device, dtype=dtype)
    if args.img is not None:
        paths = [args.img]
    else:
        paths = sorted(glob.glob(os.path.join(args.dir, "*.png"))
                       + glob.glob(os.path.join(args.dir, "*.jpg")))
    if not paths:
        print("no input images found", file=sys.stderr)
        sys.exit(1)
    for p in paths:
        out = pipeline.run(p, args.out_dir,
                           no_intermediate=args.no_intermediate,
                           inpaint=args.inpaint)
        print(f"{p} -> {out}")
        print("stage times (s):", {k: round(v, 3) for k, v in
                                   pipeline.stage_times.items()})


if __name__ == "__main__":
    main()
