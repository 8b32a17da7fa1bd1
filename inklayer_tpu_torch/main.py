"""CLI of the PyTorch/CUDA port:

    python -m inklayer_tpu_torch.main --img <path> | --dir <path>
                                      [--out_dir ./output] [--config cfg.json]
                                      [--no_intermediate] [--inpaint]
                                      [--models_dir DIR] [--batch N]
                                      [--num_hosts N --host_id I]
                                      [--device cuda] [--cpu]

Same input flags as the JAX package's ``main.py``: the default run, and
with ``--inpaint`` the layer completion (SD1.5-inpaint + ControlNet).  It
runs on the card unless ``--device cpu`` is given.  More than one image
(``--dir``) goes through the directory sweep (``InkLayerPipeline.run_dir``:
``cfg.sweep_workers`` workers; ``--batch N`` runs detection and SAM's
encoder over N images at a time).  ``--cpu`` is the JAX CLI's flag: it
forces the CPU, whatever ``--device`` says.  ``--num_hosts``/``--host_id`` (default
``$INKLAYER_NUM_HOSTS``/``$INKLAYER_HOST_ID``) split the sorted inputs
round-robin over several machines without any communication: host I takes
``paths[I::N]``.  ``--models_dir`` holds
the reference checkpoints (``inklayer_gdino.pth``,
``sam_vit_h_4b8939.pth``, ``depth_anything_v2_vitb.pth`` and the diffusers
layout of :func:`inklayer_tpu_torch.build.resolve_diffusion_checkpoints`);
a model whose file is missing gets seeded placeholder params (no
checkpoints ship with the repo).
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
    parser.add_argument("--models_dir", type=str, default=None,
                        help="directory of reference checkpoints")
    parser.add_argument("--batch", type=int, default=1,
                        help="batch detection and SAM encodes over this "
                             "many images in --dir mode")
    parser.add_argument("--num_hosts", type=int,
                        default=int(os.environ.get("INKLAYER_NUM_HOSTS", 1)),
                        help="machines sharing the --dir sweep")
    parser.add_argument("--host_id", type=int,
                        default=int(os.environ.get("INKLAYER_HOST_ID", 0)),
                        help="this machine's index in [0, num_hosts)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU (the JAX CLI's flag); overrides "
                             "--device")
    args = parser.parse_args(argv)
    if args.cpu:
        args.device = "cpu"

    if args.img is None and args.dir is None:
        parser.error("provide --img or --dir")
    if args.num_hosts > 1 and not 0 <= args.host_id < args.num_hosts:
        parser.error("--host_id must be in [0, num_hosts)")

    import torch

    from inklayer_tpu_torch.config import PipelineConfig, load_config
    from inklayer_tpu_torch.build import build_pipeline

    cfg = load_config(args.config) if args.config else PipelineConfig()
    dtype = torch.bfloat16 if args.device.startswith("cuda") else torch.float32
    pipeline = build_pipeline(cfg, device=args.device, dtype=dtype,
                              models_dir=args.models_dir)
    if args.img is not None:
        paths = [args.img]
    else:
        paths = sorted(glob.glob(os.path.join(args.dir, "*.png"))
                       + glob.glob(os.path.join(args.dir, "*.jpg")))
    if not paths:
        print("no input images found", file=sys.stderr)
        sys.exit(1)
    if args.num_hosts > 1:
        paths = paths[args.host_id::args.num_hosts]
        if not paths:
            print(f"host {args.host_id}: no images in shard")
            return
    if len(paths) > 1:
        outs = pipeline.run_dir(paths, args.out_dir, args.no_intermediate,
                                args.inpaint, batch_size=args.batch)
    else:
        outs = [pipeline.run(paths[0], args.out_dir,
                             no_intermediate=args.no_intermediate,
                             inpaint=args.inpaint)]
    for p, out in zip(paths, outs):
        print(f"{p} -> {out}")
    print("stage times (s):", {k: round(v, 3) for k, v in
                               pipeline.stage_times.items()})


if __name__ == "__main__":
    main()
