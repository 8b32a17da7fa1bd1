"""Standalone Depth-Anything-V2 demos on the port (counterpart of the JAX
package's ``scripts/depth_demo.py``): images, video and a web page.

    python -m inklayer_tpu_torch.scripts.depth_demo --img-path sketch.png
    python -m inklayer_tpu_torch.scripts.depth_demo --img-path list.txt \\
        --pred-only --grayscale [--encoder vits|vitb|vitl] [--outdir D]
    python -m inklayer_tpu_torch.scripts.depth_demo --video-path clip.mp4
    python -m inklayer_tpu_torch.scripts.depth_demo --serve [--port 7860]

Inputs are a single file, a ``.txt`` list of files or a directory
(recursive).  Each output is the input, a 50 px white margin and the
Spectral_r-coloured relative depth side by side (``--pred-only``: the
depth alone; ``--grayscale``: grey levels).  ``--serve`` answers a POSTed
image with that PNG (a WSGI page on the port's ``serve/app.py`` request
parser).  ``--models_dir`` loads ``depth_anything_v2_{encoder}.pth``;
without one the model gets the port's seeded placeholder parameters.  It
runs on the card in bf16 unless ``--cpu`` (or ``--device cpu``) is given;
then float32.  Video needs OpenCV, imported only by the video path.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from typing import Callable

import numpy as np
import torch

from inklayer_tpu_torch.config import DepthConfig
from inklayer_tpu_torch.scripts.depth_colormap import colorize_u8

MARGIN = 50
ENCODERS = {"vits": DepthConfig.vits, "vitb": DepthConfig,
            "vitl": DepthConfig.vitl}


def side_by_side(raw_rgb: np.ndarray, vis: np.ndarray) -> np.ndarray:
    split = np.full((raw_rgb.shape[0], MARGIN, 3), 255, np.uint8)
    return np.concatenate([raw_rgb, split, vis], axis=1)


def compute_dtype(device) -> torch.dtype:
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def build_estimator(encoder: str, models_dir=None, input_size: int = 518,
                    device="cuda", seed: int = 0):
    """The estimator of ``encoder`` at ``input_size`` on ``device``: the
    checkpoint under ``models_dir``, else seeded placeholders."""
    from inklayer_tpu_torch.build import build_depth
    from inklayer_tpu_torch.config import PipelineConfig

    if encoder not in ENCODERS:
        raise SystemExit(f"encoder must be one of {sorted(ENCODERS)} "
                         "(vitg weights are not published)")
    cfg = ENCODERS[encoder]()
    if input_size != cfg.input_size:
        cfg = dataclasses.replace(cfg, input_size=input_size)
    return build_depth(PipelineConfig(depth=cfg), device,
                       compute_dtype(device), seed, models_dir)


def iter_inputs(path: str) -> list:
    """A single file, a ``.txt`` list of files, or a directory's files
    (recursive, sorted)."""
    if os.path.isfile(path):
        if path.endswith("txt"):
            with open(path) as f:
                return f.read().splitlines()
        return [path]
    return sorted(f for f in glob.glob(os.path.join(path, "**/*"),
                                       recursive=True) if os.path.isfile(f))


def depth_frame(est, image: np.ndarray, grayscale: bool, pred_only: bool,
                bgr: bool = False,
                colorize: Callable = colorize_u8) -> np.ndarray:
    """One image or frame: its depth coloured, beside the input unless
    ``pred_only``.  With ``bgr`` the frame and the result are in OpenCV's
    channel order."""
    rgb = image[:, :, ::-1] if bgr else image
    vis = colorize(est.infer_image(rgb), grayscale)
    out = vis if pred_only else side_by_side(rgb, vis)
    return np.ascontiguousarray(out[:, :, ::-1]) if bgr else out


def run_images(est, args) -> list:
    from PIL import Image

    os.makedirs(args.outdir, exist_ok=True)
    written = []
    files = iter_inputs(args.img_path)
    for k, filename in enumerate(files):
        print(f"Progress {k + 1}/{len(files)}: {filename}", flush=True)
        raw = np.asarray(Image.open(filename).convert("RGB"))
        out = depth_frame(est, raw, args.grayscale, args.pred_only)
        name = os.path.splitext(os.path.basename(filename))[0] + ".png"
        dst = os.path.join(args.outdir, name)
        Image.fromarray(out).save(dst)
        written.append(dst)
    return written


def run_video(est, args) -> list:
    import cv2

    os.makedirs(args.outdir, exist_ok=True)
    written = []
    files = iter_inputs(args.video_path)
    for k, filename in enumerate(files):
        print(f"Progress {k + 1}/{len(files)}: {filename}", flush=True)
        cap = cv2.VideoCapture(filename)
        fw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        fh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = int(cap.get(cv2.CAP_PROP_FPS)) or 24
        ow = fw if args.pred_only else fw * 2 + MARGIN
        dst = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(filename))[0] + ".mp4")
        writer = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (ow, fh))
        while cap.isOpened():
            ret, bgr = cap.read()
            if not ret:
                break
            writer.write(depth_frame(est, bgr, args.grayscale,
                                     args.pred_only, bgr=True))
        cap.release()
        writer.release()
        written.append(dst)
    return written


_PAGE = """<!doctype html><title>Depth Anything V2</title>
<h1>Depth Anything V2</h1>
<p>Upload an image; the estimator returns the colorized relative-depth
map beside it.</p>
<form method=post enctype=multipart/form-data action=/depth>
<input type=file name=image><button>Estimate</button></form>"""


def make_app(est):
    """The web demo's WSGI app: a POSTed ``image`` field -> the PNG of the
    image and its coloured depth side by side; anything else -> the
    upload page."""
    import io

    from PIL import Image

    from inklayer_tpu_torch.serve.app import Request

    def app(environ, start):
        if environ["REQUEST_METHOD"] == "POST":
            _, data = Request(environ).file_upload("image")
            if not data:
                start("400 Bad Request", [("Content-Type", "text/plain")])
                return [b"no image field"]
            raw = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            buf = io.BytesIO()
            Image.fromarray(depth_frame(est, raw, False, False)).save(
                buf, "PNG")
            start("200 OK", [("Content-Type", "image/png")])
            return [buf.getvalue()]
        start("200 OK", [("Content-Type", "text/html")])
        return [_PAGE.encode()]

    return app


def serve(est, host: str, port: int) -> None:
    from wsgiref.simple_server import make_server

    print(f"serving on http://{host}:{port}", flush=True)
    make_server(host, port, make_app(est)).serve_forever()


def add_device_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU; overrides --device")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Depth Anything V2 (PyTorch)")
    ap.add_argument("--img-path", type=str)
    ap.add_argument("--video-path", type=str)
    ap.add_argument("--input-size", type=int, default=518)
    ap.add_argument("--outdir", type=str, default="./vis_depth")
    ap.add_argument("--encoder", type=str, default="vitl",
                    choices=sorted(ENCODERS))
    ap.add_argument("--pred-only", dest="pred_only", action="store_true")
    ap.add_argument("--grayscale", dest="grayscale", action="store_true")
    ap.add_argument("--models_dir", default=None)
    ap.add_argument("--serve", action="store_true",
                    help="web demo instead of batch")
    ap.add_argument("--port", type=int, default=7860)
    add_device_flags(ap)
    args = ap.parse_args(argv)
    if not (args.serve or args.video_path or args.img_path):
        raise SystemExit("need --img-path, --video-path, or --serve")

    est = build_estimator(args.encoder, args.models_dir, args.input_size,
                          "cpu" if args.cpu else args.device)
    if args.serve:
        serve(est, "0.0.0.0", args.port)
    elif args.video_path:
        return run_video(est, args)
    return run_images(est, args)


if __name__ == "__main__":
    main()
