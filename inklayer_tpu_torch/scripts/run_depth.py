"""Standalone Depth-Anything-V2 CLI on the port (counterpart of the JAX
package's ``scripts/run_depth.py``): images or one video.

    python -m inklayer_tpu_torch.scripts.run_depth --img-path sketch.png
    python -m inklayer_tpu_torch.scripts.run_depth --img-path dir/ \\
        [--grayscale] [--pred-only] [--encoder vits|vitb|vitl] [--cpu]
    python -m inklayer_tpu_torch.scripts.run_depth --video-path clip.mp4

``--img-path`` is a single file, a ``.txt`` list or a directory (every
file below it that PIL opens; the others are skipped).  Outputs go to
``--outdir`` as in ``depth_demo``, coloured through the [0, 1] range.
``--models_dir`` loads ``depth_anything_v2_{encoder}.pth``; without one
every parameter is 0.01, as the JAX script fills them.  It runs on the
card in bf16 unless ``--cpu`` (or ``--device cpu``) is given; then
float32.  The ViT-L preset taps blocks (4, 11, 17, 23)
(``DepthConfig.vitl``), as the reference does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from inklayer_tpu_torch.scripts.depth_colormap import colorize_unit
from inklayer_tpu_torch.scripts.depth_demo import (ENCODERS, MARGIN,
                                                   add_device_flags,
                                                   compute_dtype,
                                                   depth_frame, iter_inputs)

PLACEHOLDER = 0.01


def build_estimator(encoder: str, models_dir=None, device="cuda", cfg=None):
    """The estimator of ``encoder`` (or of ``cfg``) on ``device``: the
    checkpoint under ``models_dir``, else every parameter 0.01."""
    from inklayer_tpu_torch.io import weights
    from inklayer_tpu_torch.models.depth import (DepthAnythingV2,
                                                 DepthEstimator)
    from inklayer_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    cfg = cfg or ENCODERS[encoder]()
    model = DepthAnythingV2(cfg)
    ckpt = None
    if models_dir:
        p = os.path.join(models_dir, f"depth_anything_v2_{encoder}.pth")
        ckpt = p if os.path.exists(p) else None
    if ckpt:
        weights.load_checkpoint(model, ckpt, weights.DEPTH_IGNORE)
    else:
        print("[run_depth] no checkpoint — placeholder params (outputs are "
              "numerically meaningless; pass --models_dir)")
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(PLACEHOLDER)
    return DepthEstimator(model.to(dev, compute_dtype(dev)).eval())


def run_images(est, args) -> list:
    from PIL import Image

    os.makedirs(args.outdir, exist_ok=True)
    files = iter_inputs(args.img_path)
    written = []
    for k, fn in enumerate(files):
        try:
            rgb = np.asarray(Image.open(fn).convert("RGB"))
        except Exception:  # not an image PIL reads: skipped, as run.py does
            continue
        print(f"[{k + 1}/{len(files)}] {fn}", flush=True)
        out = depth_frame(est, rgb, args.grayscale, args.pred_only,
                          colorize=colorize_unit)
        base = os.path.splitext(os.path.basename(fn))[0]
        dst = os.path.join(args.outdir, base + ".png")
        Image.fromarray(out).save(dst)
        written.append(dst)
    return written


def run_video(est, args) -> list:
    import cv2

    os.makedirs(args.outdir, exist_ok=True)
    cap = cv2.VideoCapture(args.video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out_w = w if args.pred_only else 2 * w + MARGIN
    base = os.path.splitext(os.path.basename(args.video_path))[0]
    out_path = os.path.join(args.outdir, base + ".mp4")
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (out_w, h))
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        writer.write(depth_frame(est, frame, args.grayscale, args.pred_only,
                                 bgr=True, colorize=colorize_unit))
        n += 1
        if n % 25 == 0:
            print(f"frame {n}", flush=True)
    cap.release()
    writer.release()
    print(f"wrote {out_path} ({n} frames)")
    return [out_path]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Depth Anything V2 (PyTorch)")
    ap.add_argument("--img-path", type=str, default=None)
    ap.add_argument("--video-path", type=str, default=None)
    ap.add_argument("--outdir", type=str, default="./vis_depth")
    ap.add_argument("--encoder", type=str, default="vitb",
                    choices=["vits", "vitb", "vitl"])
    ap.add_argument("--models_dir", type=str, default=None)
    ap.add_argument("--pred-only", action="store_true")
    ap.add_argument("--grayscale", action="store_true")
    add_device_flags(ap)
    args = ap.parse_args(argv)
    if not args.img_path and not args.video_path:
        ap.error("need --img-path or --video-path")

    est = build_estimator(args.encoder, args.models_dir,
                          "cpu" if args.cpu else args.device)
    if args.img_path:
        return run_images(est, args)
    return run_video(est, args)


if __name__ == "__main__":
    main()
