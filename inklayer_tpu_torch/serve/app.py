"""Interactive editing web app (port of :mod:`inklayer_tpu.serve.app`):
the reference Flask app's HTTP contract (custom_interface/app.py) as a
dependency-free WSGI application, servable by wsgiref or any WSGI server.

Routes ``/``, ``/segment-sketch``, ``/upload-image``,
``/save-canvas-drawing``, ``/inpaint``, and ``/get-images``,
``/get-images/<name>``, ``/get-demos``, ``/demo-image/<name>``,
``/use-demo`` (which the reference frontend calls but its backend never
defined); the ``static/uploads`` / ``static/outputs`` layout; layer URLs
sorted by index and reversed; the same status codes and JSON bodies as the
JAX package's app.  The page is the port's own copy
(``templates/index.html``).

By default one pipeline run is in flight at a time, as the reference
serves.  With ``micro_batch``, requests for different images run the
pipeline concurrently, up to the largest SAM batch bucket at once, and
share the SAM encoder launches of concurrent requests.  Requests for one
image serialise on a per-image lock, and ``/inpaint``'s diffusion on the
pipeline's ``inpaint_lock``.  Demo sketches come from
``$INKLAYER_DEMO_DIR``, else from ``<root_dir>/demos``.

Every path built from what a client sends (URL, file and image names,
layer ids) must resolve inside its directory, or the request is refused.
"""

from __future__ import annotations

import base64
import contextlib
import glob
import io
import json
import mimetypes
import os
import re
import threading
from datetime import datetime
from typing import Callable, Optional

import numpy as np
from PIL import Image

from inklayer_tpu_torch.pipeline.inpaint.orchestrate import expand_mask_to_rect
from inklayer_tpu_torch.serve.batcher import SAM_BATCH_BUCKETS


def _inside(base: str, *parts: str) -> Optional[str]:
    """``os.path.join(base, *parts)`` when it resolves (``..`` and
    symlinks followed) to ``base`` or below it, else None."""
    path = os.path.join(base, *parts)
    root = os.path.realpath(base)
    if os.path.commonpath([root, os.path.realpath(path)]) != root:
        return None
    return path


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"]
        self.path = environ["PATH_INFO"]
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        self.body = environ["wsgi.input"].read(length) if length else b""
        self.content_type = environ.get("CONTENT_TYPE", "")

    def json(self):
        try:
            return json.loads(self.body.decode("utf-8"))
        except Exception:
            return {}

    def file_upload(self, field: str):
        """Minimal multipart/form-data parser: returns (filename, bytes)."""
        m = re.search(r"boundary=([^;]+)", self.content_type)
        if not m:
            return None, None
        boundary = ("--" + m.group(1).strip('"')).encode()
        for part in self.body.split(boundary):
            if f'name="{field}"'.encode() not in part:
                continue
            header, _, data = part.partition(b"\r\n\r\n")
            fm = re.search(rb'filename="([^"]*)"', header)
            filename = fm.group(1).decode() if fm else ""
            return filename, data.rstrip(b"\r\n")
        return None, None


class InkLayerApp:
    """WSGI app.  `pipeline` is an InkLayerPipeline (built lazily via
    `pipeline_factory` on first segmentation request if not given)."""

    def __init__(self, pipeline=None, pipeline_factory: Optional[Callable] = None,
                 root_dir: Optional[str] = None, micro_batch: bool = False):
        """micro_batch (default off: one pipeline run at a time, as the
        reference serves): up to max(SAM_BATCH_BUCKETS) /segment-sketch
        requests run the pipeline concurrently and their SAM ViT-H encodes
        share batched launches through the pipeline's micro-batcher.
        Requests for one image always serialise on a per-image lock."""
        self.root_dir = root_dir or os.path.join(
            os.path.dirname(__file__), "webroot")
        self.upload_dir = os.path.join(self.root_dir, "static", "uploads")
        self.output_dir = os.path.join(self.root_dir, "static", "outputs")
        os.makedirs(self.upload_dir, exist_ok=True)
        os.makedirs(self.output_dir, exist_ok=True)
        self._pipeline = pipeline
        self._factory = pipeline_factory
        self._micro_batch = micro_batch
        self._sem = threading.BoundedSemaphore(
            max(SAM_BATCH_BUCKETS) if micro_batch else 1)
        self._build_lock = threading.Lock()  # lazy pipeline build, once
        # out-dir key -> [lock, refcount]; entries are refcounted and
        # evicted when no request holds them (names are client-chosen, so
        # a keep-forever dict is an unbounded-memory vector)
        self._name_locks: dict = {}
        self._name_locks_guard = threading.Lock()
        if (pipeline is not None and micro_batch
                and hasattr(pipeline, "enable_batched_encoder")):
            pipeline.enable_batched_encoder()

    # ------------------------------------------------------------------
    @property
    def pipeline(self):
        if self._pipeline is None:
            with self._build_lock:
                if self._pipeline is None:
                    if self._factory is None:
                        raise RuntimeError("no pipeline configured")
                    pipe = self._factory()
                    if self._micro_batch and hasattr(
                            pipe, "enable_batched_encoder"):
                        pipe.enable_batched_encoder()
                    self._pipeline = pipe
        return self._pipeline

    @contextlib.contextmanager
    def _image_lock(self, name: str):
        # key on the extension-stripped basename — the pipeline's output
        # directory key — so 'a.png' and 'a.jpg' (same out dir) serialize
        key = os.path.basename(name).split(".")[0]
        with self._name_locks_guard:
            entry = self._name_locks.setdefault(key, [threading.Lock(), 0])
            entry[1] += 1
        try:
            with entry[0]:
                yield
        finally:
            with self._name_locks_guard:
                entry[1] -= 1
                if entry[1] == 0:
                    self._name_locks.pop(key, None)

    # ------------------------------------------------------------------
    def __call__(self, environ, start_response):
        req = Request(environ)
        try:
            status, headers, body = self.route(req)
        except Exception as e:  # reference returns 500 with the message
            status, headers, body = self._json_resp(
                {"error": f"request failed: {e}"}, "500 Internal Server Error")
        start_response(status, headers)
        return [body]

    def route(self, req: Request):
        if req.path == "/" and req.method == "GET":
            return self._serve_file(os.path.join(
                os.path.dirname(__file__), "templates", "index.html"))
        if req.path.startswith("/static/") and req.method == "GET":
            return self._serve_file(
                _inside(self.root_dir, req.path.lstrip("/")))
        if req.path == "/upload-image" and req.method == "POST":
            return self.upload_image(req)
        if req.path == "/save-canvas-drawing" and req.method == "POST":
            return self.save_canvas_drawing(req)
        if req.path == "/segment-sketch" and req.method == "POST":
            return self.segment_sketch(req)
        if req.path == "/inpaint" and req.method == "POST":
            return self.inpaint(req)
        if req.path == "/get-images" and req.method == "GET":
            return self.get_images()
        if req.path.startswith("/get-images/") and req.method == "GET":
            return self.get_layers_for(req.path.split("/get-images/", 1)[1])
        if req.path == "/get-demos" and req.method == "GET":
            return self.get_demos()
        if req.path.startswith("/demo-image/") and req.method == "GET":
            name = os.path.basename(req.path.split("/demo-image/", 1)[1])
            return self._serve_file(_inside(self.demo_dir, name))
        if req.path == "/use-demo" and req.method == "POST":
            return self.use_demo(req)
        return self._json_resp({"error": "not found"}, "404 Not Found")

    # ------------------------------------------------------------------
    def _json_resp(self, obj, status="200 OK"):
        body = json.dumps(obj).encode("utf-8")
        return status, [("Content-Type", "application/json"),
                        ("Content-Length", str(len(body)))], body

    def _serve_file(self, path: Optional[str]):
        if path is None or not os.path.isfile(path):
            return self._json_resp({"error": "not found"}, "404 Not Found")
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        with open(path, "rb") as f:
            body = f.read()
        return "200 OK", [("Content-Type", ctype),
                          ("Content-Length", str(len(body)))], body

    # ------------------------------------------------------------------
    def upload_image(self, req: Request):
        filename, data = req.file_upload("image")
        filename = os.path.basename(filename or "")
        if not filename or data is None:
            return self._json_resp({"error": "No file part"}, "400 Bad Request")
        if not any(filename.lower().endswith(e)
                   for e in (".png", ".jpg", ".jpeg", ".gif", ".bmp")):
            filename = (filename.rsplit(".", 1)[0] if "." in filename
                        else filename) + ".png"
        disk_path = os.path.join(self.upload_dir, filename)
        with open(disk_path, "wb") as f:
            f.write(data)
        # flatten alpha onto white like the reference (:131-141)
        try:
            with Image.open(disk_path) as img:
                if img.mode in ("RGBA", "LA"):
                    bg = Image.new("RGB", img.size, (255, 255, 255))
                    bg.paste(img, mask=img.split()[-1])
                    bg.save(disk_path)
        except Exception as e:
            return self._json_resp({"error": f"Invalid image file: {e}"},
                                   "400 Bad Request")
        return self._json_resp({
            "message": "File uploaded successfully",
            "file_path": f"static/uploads/{filename}",
            "filename": filename,
        })

    def save_canvas_drawing(self, req: Request):
        data = req.json()
        image_data = data.get("imageData")
        filename = os.path.basename(str(data.get("filename") or "")) or \
            f"canvas_drawing_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
        if not image_data:
            return self._json_resp({"error": "No image data provided"},
                                   "400 Bad Request")
        if image_data.startswith("data:image/png;base64,"):
            image_data = image_data.split(",", 1)[1]
        if not filename.endswith(".png"):
            filename += ".png"
        with open(os.path.join(self.upload_dir, filename), "wb") as f:
            f.write(base64.b64decode(image_data))
        return self._json_resp({
            "message": "Canvas drawing saved successfully",
            "filename": filename,
            "file_path": f"static/uploads/{filename}",
        })

    def _find_upload(self, image_name: str) -> Optional[str]:
        for ext in ("png", "jpg", "jpeg", "gif", "bmp", "tiff"):
            path = _inside(self.upload_dir, f"{image_name}.{ext}")
            hits = glob.glob(path) if path else []
            if hits:
                return hits[0]
        return None

    def segment_sketch(self, req: Request):
        data = req.json()
        image_name = data.get("imageName")
        if not image_name:
            return self._json_resp({"error": "No image name provided"},
                                   "400 Bad Request")
        image_path = self._find_upload(image_name)
        if not image_path:
            return self._json_resp(
                {"error": f"Image not found: {image_name}"}, "404 Not Found")
        with self._image_lock(image_name), self._sem:
            out_dir = self.pipeline.run(image_path, self.output_dir,
                                        no_intermediate=False, inpaint=True)
        urls = sorted(
            glob.glob(os.path.join(out_dir, "complete_layers_rgba",
                                   "layer_*.png")),
            key=lambda p: int(os.path.basename(p).split("layer_")[1].split(".")[0]))
        urls = [u.replace(self.root_dir, "") for u in urls][::-1]
        return self._json_resp({
            "message": f"Segmentation completed for {image_name}",
            "layers": urls,
        })

    def inpaint(self, req: Request):
        data = req.json()
        needed = ("image_name", "layer_id", "layer_path", "prompt")
        if any(data.get(k) is None or data.get(k) == "" for k in needed):
            return self._json_resp(
                {"error": "Missing image_name, layer_id, layer_path or prompt"},
                "400 Bad Request")
        image_name = str(data["image_name"])
        layer_id = str(data["layer_id"])
        prompt = data["prompt"]
        base_dir = _inside(self.output_dir, image_name)
        out_dir = base_dir and os.path.join(base_dir, "inpaint_results")
        mask_path = base_dir and _inside(base_dir, "masks_disjoint",
                                         f"mask_{layer_id}.png")
        out_path = out_dir and _inside(out_dir,
                                       f"layer_{layer_id}_inpainted.png")
        if not (mask_path and out_path):
            return self._json_resp({"error": "Invalid image_name or layer_id"},
                                   "400 Bad Request")
        os.makedirs(out_dir, exist_ok=True)
        image_path = os.path.join(base_dir, "input.png")
        mask = np.asarray(Image.open(mask_path).convert("L")) > 127
        rect = expand_mask_to_rect(mask, pad=10)
        image = Image.open(image_path).convert("RGB")
        with self._image_lock(image_name), self._sem:
            inpainter = self.pipeline.inpainter
            if inpainter is None:
                return self._json_resp({"error": "inpainting not configured"},
                                       "500 Internal Server Error")
            # text-guided single-layer edit: user prompt, cfg 7.0, cond 0.6,
            # one pass.  The inpaint lock serialises diffusion across
            # concurrent requests (one 768^2 sample on the device).
            with self.pipeline.inpaint_lock:
                result = inpainter.inpaint_single_layer(
                    image, Image.fromarray(rect.astype(np.uint8) * 255),
                    prompt)
        # RGBA restricted to the mask (inpaint_single_layer.py:70-85)
        arr = np.asarray(result.convert("RGB"))
        rgba = np.dstack([arr, (rect * 255).astype(np.uint8)])
        Image.fromarray(rgba).save(out_path)
        return self._json_resp({
            "message": f"Inpainting completed for layer {layer_id}",
            "layer_url": out_path.replace(self.root_dir, ""),
            "layer_id": layer_id,
        })

    def get_images(self):
        files = sorted(glob.glob(os.path.join(self.upload_dir, "*")))
        return self._json_resp({
            "images": [f"/static/uploads/{os.path.basename(f)}" for f in files]})

    @property
    def demo_dir(self) -> str:
        return os.environ.get("INKLAYER_DEMO_DIR",
                              os.path.join(self.root_dir, "demos"))

    def get_demos(self):
        files = sorted(glob.glob(os.path.join(self.demo_dir, "*.png"))) \
            if os.path.exists(self.demo_dir) else []
        return self._json_resp({"demos": [os.path.basename(f) for f in files]})

    def get_layers_for(self, name: str):
        """Precomputed layers of an already-processed image (the reference
        frontend's demo flow, canvas_ui.js fetchGetDemoImages :456)."""
        name = os.path.basename(name).rsplit(".", 1)[0]
        urls = sorted(
            glob.glob(os.path.join(self.output_dir, name,
                                   "complete_layers_rgba", "layer_*.png")),
            key=lambda p: int(os.path.basename(p).split("layer_")[1].split(".")[0]))
        if not urls:  # no inpainted layers yet: serve the final masks view
            urls = sorted(
                glob.glob(os.path.join(self.output_dir, name, "masks_final",
                                       "mask_*.png")),
                key=lambda p: int(os.path.basename(p).split("mask_")[1].split(".")[0]))
        urls = [u.replace(self.root_dir, "") for u in urls][::-1]
        return self._json_resp({"layers": urls, "image_name": name})

    def use_demo(self, req: Request):
        """Copy a demo sketch into uploads so the normal pipeline flows
        apply to it."""
        import shutil

        data = req.json()
        name = os.path.basename(str(data.get("name", "")))
        src = _inside(self.demo_dir, name)
        if not name or src is None or not os.path.isfile(src):
            return self._json_resp({"error": f"demo not found: {name}"},
                                   "404 Not Found")
        os.makedirs(self.upload_dir, exist_ok=True)
        dst = os.path.join(self.upload_dir, name)
        shutil.copyfile(src, dst)
        return self._json_resp({
            "filename": name,
            "file_path": dst.replace(self.root_dir, "").lstrip("/"),
        })
