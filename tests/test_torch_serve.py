"""The port's editing web app (inklayer_tpu_torch.serve): every route case
of tests/test_serve.py against its WSGI app with the same FakePipeline; the
same requests to the JAX app and to the port's app give the same status
and JSON; the real TINY port pipeline behind the app on the CPU; the
micro-batched encoder under concurrent requests; the threaded server over
HTTP on localhost; and the runner's repairs for concurrent runs (stage
times per thread, one lazily built diffusion pipeline).
"""

import base64
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.serve.app import InkLayerApp as JaxApp
from inklayer_tpu_torch.serve.app import InkLayerApp
from tests.test_serve import FakePipeline, call


@pytest.fixture()
def app(tmp_path):
    return InkLayerApp(pipeline=FakePipeline(), root_dir=str(tmp_path))


def _png_bytes(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _data_url(arr) -> str:
    return "data:image/png;base64," + base64.b64encode(
        _png_bytes(arr)).decode()


def _multipart(field, filename, payload, boundary="XBOUND"):
    body = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{field}"; '
            f'filename="{filename}"\r\nContent-Type: image/png\r\n\r\n'
            ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _post(app, path, obj):
    return call(app, "POST", path, json.dumps(obj).encode())


# ---------------------------------------------------------------------------
# the route cases of tests/test_serve.py
# ---------------------------------------------------------------------------


def test_index_served(app):
    status, body = call(app, "GET", "/")
    assert status == "200 OK"
    assert b"InkLayer" in body


def test_canvas_tools_present(app):
    _, body = call(app, "GET", "/")
    for frag in (b'id="brushSize"', b'id="brushSizeDisplay"',
                 b'id="brushColor"', b'id="undo"', b"redrawCanvas",
                 b"paths.pop()"):
        assert frag in body, frag


def test_404(app):
    status, _ = call(app, "GET", "/nope")
    assert status == "404 Not Found"


def test_save_canvas_and_segment(app):
    status, body = _post(app, "/save-canvas-drawing", {
        "imageData": _data_url(np.full((16, 16, 3), 255, np.uint8)),
        "filename": "testsketch"})
    assert status == "200 OK"
    assert json.loads(body)["filename"] == "testsketch.png"
    status, body = _post(app, "/segment-sketch", {"imageName": "testsketch"})
    assert status == "200 OK"
    layers = json.loads(body)["layers"]
    assert len(layers) == 3
    assert "layer_2" in layers[0] and "layer_0" in layers[-1]  # reversed


def test_segment_missing_image(app):
    status, _ = _post(app, "/segment-sketch", {"imageName": "ghost"})
    assert status == "404 Not Found"
    status, _ = call(app, "POST", "/segment-sketch", b"{}")
    assert status == "400 Bad Request"


def test_upload_multipart(app):
    body, ctype = _multipart("image", "t.png",
                             _png_bytes(np.full((8, 8, 4), 128, np.uint8)))
    status, resp = call(app, "POST", "/upload-image", body, ctype)
    assert status == "200 OK"
    assert json.loads(resp)["filename"] == "t.png"
    saved = Image.open(os.path.join(app.upload_dir, "t.png"))
    assert saved.mode == "RGB"  # alpha flattened onto white


def test_get_images(app):
    with open(os.path.join(app.upload_dir, "x.png"), "wb") as f:
        f.write(b"fake")
    status, body = call(app, "GET", "/get-images")
    assert status == "200 OK"
    assert "/static/uploads/x.png" in json.loads(body)["images"]


def test_demo_gallery_flow(app, tmp_path, monkeypatch):
    demo_dir = tmp_path / "demos_elsewhere"
    os.makedirs(demo_dir)
    Image.fromarray(np.full((8, 8, 3), 255, np.uint8)).save(
        str(demo_dir / "bunny.png"))
    monkeypatch.setenv("INKLAYER_DEMO_DIR", str(demo_dir))
    status, body = call(app, "GET", "/get-demos")
    assert status == "200 OK"
    assert json.loads(body)["demos"] == ["bunny.png"]
    status, _ = call(app, "GET", "/demo-image/bunny.png")
    assert status == "200 OK"
    status, body = _post(app, "/use-demo", {"name": "bunny.png"})
    assert status == "200 OK"
    assert json.loads(body)["filename"] == "bunny.png"
    assert os.path.exists(os.path.join(app.upload_dir, "bunny.png"))
    status, _ = _post(app, "/use-demo", {"name": "../secret.png"})
    assert status == "404 Not Found"  # path traversal


def test_get_layers_for_processed_image(app):
    out = os.path.join(app.output_dir, "scene")
    os.makedirs(os.path.join(out, "complete_layers_rgba"))
    for i in range(3):
        Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(
            os.path.join(out, "complete_layers_rgba", f"layer_{i}.png"))
    status, body = call(app, "GET", "/get-images/scene")
    assert status == "200 OK"
    ids = [u.split("layer_")[1].split(".")[0]
           for u in json.loads(body)["layers"]]
    assert ids == ["2", "1", "0"]
    status, body = call(app, "GET", "/get-images/nope")
    assert status == "200 OK" and json.loads(body)["layers"] == []


def _layer_fixture(app, name):
    out = os.path.join(app.output_dir, name)
    os.makedirs(os.path.join(out, "masks_disjoint"), exist_ok=True)
    m = np.zeros((16, 16), np.uint8)
    m[4:12, 4:12] = 255
    Image.fromarray(m).save(os.path.join(out, "masks_disjoint", "mask_0.png"))
    Image.fromarray(np.full((16, 16, 3), 255, np.uint8)).save(
        os.path.join(out, "input.png"))


class _FakeInpainter:
    """Counts the single-layer edits in flight at once."""

    def __init__(self):
        self.inflight, self.max, self.guard = 0, 0, threading.Lock()

    def inpaint_single_layer(self, image, mask, prompt):
        with self.guard:
            self.inflight += 1
            self.max = max(self.max, self.inflight)
        time.sleep(0.05)
        with self.guard:
            self.inflight -= 1
        return Image.new("RGB", image.size, (255, 255, 255))


class _FakeInpaintPipeline(FakePipeline):
    def __init__(self):
        super().__init__()
        self.inpainter = _FakeInpainter()
        self.inpaint_lock = threading.Lock()


def test_concurrent_inpaint_serializes_on_single_slot_lock(tmp_path):
    # micro_batch lets two requests in at once: the inpaint lock, not the
    # one-run-at-a-time default, must serialise their diffusion
    app = InkLayerApp(pipeline=_FakeInpaintPipeline(), root_dir=str(tmp_path),
                      micro_batch=True)
    for name in ("imgA", "imgB"):
        _layer_fixture(app, name)
    results = {}

    def inpaint(name):
        status, _ = _post(app, "/inpaint", {
            "image_name": name, "layer_id": 0,
            "layer_path": f"/static/outputs/{name}/x.png",
            "prompt": "a sketch"})
        results[name] = status

    threads = [threading.Thread(target=inpaint, args=(n,))
               for n in ("imgA", "imgB")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == {"imgA": "200 OK", "imgB": "200 OK"}
    assert app.pipeline.inpainter.max == 1, "diffusion ran concurrently"


# ---------------------------------------------------------------------------
# the JAX app and the port's app answer alike
# ---------------------------------------------------------------------------

_SKETCH = np.full((16, 16, 3), 255, np.uint8)
_SAVE = ("POST", "/save-canvas-drawing",
         {"imageData": _data_url(_SKETCH), "filename": "s1"})
_INPAINT = {"image_name": "lay", "layer_id": 0,
            "layer_path": "/static/outputs/lay/x.png", "prompt": "a sketch"}
_UPLOAD = _multipart("image", "u.png",
                     _png_bytes(np.full((8, 8, 4), 128, np.uint8)))
CASES = {
    "index": [("GET", "/", None)],
    "not found": [("GET", "/nope", None), ("POST", "/", {})],
    "save canvas": [_SAVE, ("POST", "/save-canvas-drawing",
                            {"filename": "x"})],
    "segment": [_SAVE, ("POST", "/segment-sketch", {"imageName": "s1"}),
                ("GET", "/get-images/s1", None),
                ("GET", "/static/outputs/s1/complete_layers_rgba/layer_1.png",
                 None)],
    "segment refused": [("POST", "/segment-sketch", {"imageName": "ghost"}),
                        ("POST", "/segment-sketch", {})],
    "upload": [("POST", "/upload-image", _UPLOAD),
               ("POST", "/upload-image",
                _multipart("other", "u.png", b"x")),
               ("GET", "/get-images", None),
               ("GET", "/static/uploads/u.png", None)],
    "demos": [("GET", "/get-demos", None),
              ("GET", "/demo-image/bunny.png", None),
              ("POST", "/use-demo", {"name": "bunny.png"}),
              ("POST", "/use-demo", {"name": "../bunny.png"}),
              ("GET", "/demo-image/ghost.png", None)],
    "inpaint": [("POST", "/inpaint", _INPAINT),
                ("GET", "/static/outputs/lay/inpaint_results/"
                        "layer_0_inpainted.png", None),
                ("POST", "/inpaint", {"image_name": "lay", "layer_id": 0})],
    "inpaint unconfigured": [("POST", "/inpaint", _INPAINT)],
}


def _request(app, method, path, payload):
    if isinstance(payload, tuple):  # multipart (body, content type)
        return call(app, method, path, *payload)
    body = b"" if payload is None else json.dumps(payload).encode()
    return call(app, method, path, body)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_answers_as_the_jax_app(case, tmp_path, monkeypatch):
    demo_dir = tmp_path / "demos_elsewhere"
    os.makedirs(demo_dir)
    Image.fromarray(_SKETCH).save(str(demo_dir / "bunny.png"))
    monkeypatch.setenv("INKLAYER_DEMO_DIR", str(demo_dir))
    pipe = FakePipeline if case == "inpaint unconfigured" else \
        _FakeInpaintPipeline
    apps = [cls(pipeline=pipe(), root_dir=str(tmp_path / name))
            for cls, name in ((JaxApp, "jax"), (InkLayerApp, "port"))]
    for a in apps:
        _layer_fixture(a, "lay")
    for method, path, payload in CASES[case]:
        (js, jb), (ts, tb) = [_request(a, method, path, payload)
                              for a in apps]
        assert ts == js, (method, path)
        if path == "/":
            continue  # each package serves its own copy of the page
        try:
            want = json.loads(jb)
        except (UnicodeDecodeError, json.JSONDecodeError):
            assert tb == jb, (method, path)  # a file: the same bytes
        else:
            assert json.loads(tb) == want, (method, path)


class _SlowPipeline(FakePipeline):
    """Counts the pipeline runs in flight at once."""

    def __init__(self):
        super().__init__()
        self.inflight, self.max, self.guard = 0, 0, threading.Lock()

    def run(self, *args, **kwargs):
        with self.guard:
            self.inflight += 1
            self.max = max(self.max, self.inflight)
        time.sleep(0.2)
        with self.guard:
            self.inflight -= 1
        return super().run(*args, **kwargs)


@pytest.mark.parametrize("kwargs,in_flight",
                         [({}, 1), ({"micro_batch": True}, 2)])
def test_pipeline_runs_in_flight(tmp_path, kwargs, in_flight):
    """One pipeline run at a time by default; with micro_batch, requests
    for different images run at once."""
    pipe = _SlowPipeline()
    app = InkLayerApp(pipeline=pipe, root_dir=str(tmp_path), **kwargs)
    for name in ("p1", "p2"):
        _post(app, "/save-canvas-drawing",
              {"imageData": _data_url(_SKETCH), "filename": name})
    res = {}

    def segment(name):
        res[name] = _post(app, "/segment-sketch", {"imageName": name})[0]

    threads = [threading.Thread(target=segment, args=(n,))
               for n in ("p1", "p2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert res == {"p1": "200 OK", "p2": "200 OK"}
    assert pipe.max == in_flight


# ---------------------------------------------------------------------------
# requests that name paths outside the web root
# ---------------------------------------------------------------------------

SECRET = b"outside the web root"
TRAVERSAL = {
    "static": ("GET", "/static/../../secret.png", None, "404 Not Found"),
    "static deep": ("GET", "/static/uploads/../../../secret.png", None,
                    "404 Not Found"),
    "demo image": ("GET", "/demo-image/..", None, "404 Not Found"),
    "use demo": ("POST", "/use-demo", {"name": ".."}, "404 Not Found"),
    "segment": ("POST", "/segment-sketch", {"imageName": "../../../secret"},
                "404 Not Found"),
    "inpaint image": ("POST", "/inpaint", dict(_INPAINT, image_name="../.."),
                      "400 Bad Request"),
    "inpaint layer": ("POST", "/inpaint",
                      dict(_INPAINT, layer_id="0/../../../../../secret"),
                      "400 Bad Request"),
    "save canvas": ("POST", "/save-canvas-drawing",
                    {"imageData": _data_url(_SKETCH),
                     "filename": "../../../evil"}, "200 OK"),
    "upload": ("POST", "/upload-image",
               _multipart("image", "../../../evil.png", _png_bytes(_SKETCH)),
               "200 OK"),
}


@pytest.mark.parametrize("case", sorted(TRAVERSAL))
def test_paths_stay_inside_the_web_root(case, tmp_path, monkeypatch):
    """A client's path, file name, image name or layer id never reaches a
    file outside the app's directories: reads are refused, and the names
    of written files lose their directories."""
    root = tmp_path / "web"
    (tmp_path / "secret.png").write_bytes(SECRET)
    demo_dir = root / "demos"
    os.makedirs(demo_dir)
    monkeypatch.setenv("INKLAYER_DEMO_DIR", str(demo_dir))
    app = InkLayerApp(pipeline=_FakeInpaintPipeline(), root_dir=str(root))
    _layer_fixture(app, "lay")
    before = sorted(p.name for p in tmp_path.iterdir())
    method, path, payload, want = TRAVERSAL[case]
    status, body = _request(app, method, path, payload)
    assert status == want
    assert SECRET not in body
    assert (tmp_path / "secret.png").read_bytes() == SECRET
    assert sorted(p.name for p in tmp_path.iterdir()) == before
    if want == "200 OK":  # written under its base name, in uploads
        assert json.loads(body)["filename"] == "evil.png"
        assert os.path.exists(os.path.join(app.upload_dir, "evil.png"))


def test_quoted_traversal_over_http(tmp_path):
    """The server unquotes %2f into the path: still refused."""
    from wsgiref.simple_server import make_server

    from inklayer_tpu_torch.serve.server import ThreadingWSGIServer

    (tmp_path / "secret.png").write_bytes(SECRET)
    app = InkLayerApp(pipeline=FakePipeline(), root_dir=str(tmp_path / "web"))
    server = make_server("127.0.0.1", 0, app,
                         server_class=ThreadingWSGIServer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_port}"
                "/static/..%2f..%2fsecret.png", timeout=30)
        assert err.value.code == 404 and SECRET not in err.value.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


# ---------------------------------------------------------------------------
# the real TINY port pipeline behind the app
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    from tests.test_torch_weights import tiny_port_config

    return tiny_port_config(tmp_path_factory.mktemp("cfg"))[1]


def _tiny_pipeline(cfg, inpainter=None):
    from inklayer_tpu_torch.build import build_pipeline

    pipe = build_pipeline(cfg, device="cpu", dtype=torch.float32)
    pipe.inpainter = inpainter
    return pipe


def _square_sketch(size=96, at=20):
    g = np.full((size, size, 3), 255, np.uint8)
    g[at:at + 40, at:at + 3] = 0
    g[at:at + 3, at:at + 40] = 0
    g[at + 37:at + 40, at:at + 40] = 0
    g[at:at + 40, at + 37:at + 40] = 0
    return g


def test_serve_with_real_tiny_pipeline(tmp_path, tiny_cfg):
    """/save-canvas-drawing -> /segment-sketch through the real TINY port
    pipeline on the CPU; with no inpainter, run(inpaint=True) skips the
    stage (as the JAX package does) and the layers list is empty."""
    app = InkLayerApp(pipeline=_tiny_pipeline(tiny_cfg),
                      root_dir=str(tmp_path), micro_batch=False)
    status, _ = _post(app, "/save-canvas-drawing",
                      {"imageData": _data_url(_square_sketch()),
                       "filename": "real"})
    assert status == "200 OK"
    status, body = _post(app, "/segment-sketch", {"imageName": "real"})
    assert status == "200 OK"
    assert json.loads(body)["layers"] == []
    assert os.listdir(os.path.join(app.output_dir, "real", "masks_final"))


def test_serve_micro_batch_factory(tmp_path, tiny_cfg):
    """micro_batch=True wires the shared BatchedSamEncoder into the lazily
    built pipeline; /segment-sketch serves through it."""
    app = InkLayerApp(pipeline_factory=lambda: _tiny_pipeline(tiny_cfg),
                      root_dir=str(tmp_path), micro_batch=True)
    _post(app, "/save-canvas-drawing",
          {"imageData": _data_url(_square_sketch(64, 10)), "filename": "mb"})
    status, _ = _post(app, "/segment-sketch", {"imageName": "mb"})
    assert status == "200 OK"
    encoder = app._pipeline._batched_encoder
    assert encoder is not None
    assert app._pipeline.sam.encode_fn == encoder.encode
    assert encoder.batcher.launches[1] == 1
    encoder.close()


def test_concurrent_requests_share_encoder_batch(tmp_path, tiny_cfg):
    """Two /segment-sketch requests in flight at once run concurrently and
    their SAM encodes share one batched launch (the batching window is
    widened so that they meet)."""
    pipe = _tiny_pipeline(tiny_cfg)
    app = InkLayerApp(pipeline=pipe, root_dir=str(tmp_path), micro_batch=True)
    encoder = pipe._batched_encoder
    assert encoder is not None
    encoder.batcher.max_wait = 5.0
    for i, name in enumerate(("c1", "c2")):
        _post(app, "/save-canvas-drawing",
              {"imageData": _data_url(_square_sketch(64, 8 + 8 * i)),
               "filename": name})
    res = {}

    def segment(name):
        res[name] = _post(app, "/segment-sketch", {"imageName": name})[0]

    threads = [threading.Thread(target=segment, args=(n,))
               for n in ("c1", "c2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    encoder.close()
    assert res == {"c1": "200 OK", "c2": "200 OK"}
    assert encoder.batcher.launches == {1: 0, 2: 1, 4: 0}
    for name in ("c1", "c2"):
        assert os.path.exists(os.path.join(app.output_dir, name,
                                           "masks_final"))


# ---------------------------------------------------------------------------
# the runner's repairs for concurrent runs
# ---------------------------------------------------------------------------


def test_each_thread_reports_its_own_stage_times(tmp_path, tiny_cfg):
    from inklayer_tpu_torch.pipeline.runner import STAGES
    from tests.test_self_golden import _sketch

    pipe = _tiny_pipeline(tiny_cfg)
    sketch = _sketch(tmp_path)
    got, barrier = {}, threading.Barrier(2)

    def run(i):
        barrier.wait()
        t0 = time.perf_counter()
        pipe.run(sketch, str(tmp_path / f"out{i}"))
        got[i] = (dict(pipe.stage_times), time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert sorted(got) == [0, 1]
    for times, wall in got.values():
        assert sorted(times) == sorted(STAGES)
        assert sum(times.values()) <= wall  # only its own run's stages
    seen = []
    idle = threading.Thread(target=lambda: seen.append(pipe.stage_times))
    idle.start()
    idle.join(timeout=10)
    assert seen == [{}]  # a thread that ran nothing has no stage times


def test_concurrent_first_use_builds_one_diffusion_pipeline(monkeypatch,
                                                            tiny_cfg):
    from inklayer_tpu_torch import build

    built = []
    real = build.build_diffusion_models

    def slow_build(*args, **kwargs):
        built.append(1)
        time.sleep(0.2)  # both callers are inside the first use
        return real(*args, **kwargs)

    monkeypatch.setattr(build, "build_diffusion_models", slow_build)
    ink = build.build_inpainter(tiny_cfg, device="cpu", dtype=torch.float32)
    got = []
    threads = [threading.Thread(target=lambda: got.append(ink.get_pipeline()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(got) == 2 and got[0] is got[1]
    assert built == [1]


def test_run_without_inpainter_skips_the_stage(tmp_path, tiny_cfg, capsys):
    from tests.test_self_golden import _sketch

    pipe = _tiny_pipeline(tiny_cfg)
    out = pipe.run(_sketch(tmp_path), str(tmp_path / "out"), inpaint=True)
    assert "no inpainter is configured; skipping" in capsys.readouterr().out
    assert "inpaint" not in pipe.stage_times
    assert not os.path.exists(os.path.join(out, "complete_layers"))


# ---------------------------------------------------------------------------
# the threaded server
# ---------------------------------------------------------------------------


def test_threaded_server_answers_over_http(tmp_path):
    from wsgiref.simple_server import make_server

    from inklayer_tpu_torch.serve.server import ThreadingWSGIServer

    app = InkLayerApp(pipeline=FakePipeline(), root_dir=str(tmp_path))
    server = make_server("127.0.0.1", 0, app,
                         server_class=ThreadingWSGIServer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        def post(path, obj):
            req = urllib.request.Request(
                base + path, json.dumps(obj).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())

        status, body = post("/save-canvas-drawing",
                            {"imageData": _data_url(_SKETCH),
                             "filename": "h"})
        assert status == 200 and body["filename"] == "h.png"
        status, body = post("/segment-sketch", {"imageName": "h"})
        assert status == 200 and len(body["layers"]) == 3
        with urllib.request.urlopen(base + body["layers"][0],
                                    timeout=30) as r:
            assert r.status == 200 and r.read().startswith(b"\x89PNG")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_server_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from inklayer_tpu_torch.serve.server import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--port", "0"])


@pytest.mark.parametrize("flags,micro_batch",
                         [([], False), (["--micro_batch"], True)])
def test_server_micro_batch_flag(monkeypatch, flags, micro_batch):
    """The server runs one request at a time unless --micro_batch."""
    from inklayer_tpu_torch import runtime
    from inklayer_tpu_torch.serve import server

    apps = []

    class Stub:
        def serve_forever(self):
            pass

    monkeypatch.setattr(runtime, "resolve_device", lambda device: None)
    monkeypatch.setattr(server, "make_server",
                        lambda host, port, app, server_class:
                        apps.append(app) or Stub())
    server.main(["--port", "0", *flags])
    assert len(apps) == 1 and apps[0]._micro_batch is micro_batch
