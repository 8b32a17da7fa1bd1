"""Port parity: the depth scripts (``inklayer_tpu_torch/scripts/run_depth.py``
and ``depth_demo.py``) against the JAX package's ``scripts/run_depth.py``
and ``scripts/depth_demo.py`` on the CPU.

With one fake estimator the output files are byte-equal (PNG) or
frame-equal (video), and both colourings are bit-equal to the JAX
functions (which colour through matplotlib).  The models: a tiny
estimator through the parameter bridge within 1e-4 relative L2 of the
JAX ``DepthEstimator.infer_image`` (test_torch_depth.py's limit); the
0.01-filled placeholders and a tiny reference-layout ``.pth`` through
``--models_dir`` likewise.
"""

import argparse
import dataclasses
import importlib.util
import io
import os
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu import config as jax_config
from inklayer_tpu.io.weights import load_depth_params
from inklayer_tpu.models.depth import DepthAnythingV2 as JaxDepth
from inklayer_tpu.models.depth import DepthEstimator as JaxEstimator
from inklayer_tpu_torch.config import DepthConfig
from inklayer_tpu_torch.models.depth import DepthEstimator
from inklayer_tpu_torch.scripts import depth_colormap as dc
from inklayer_tpu_torch.scripts import depth_demo, run_depth
from tests.test_depth import TINY
from tests.test_torch_depth import _rel, depth_pair
from tests.test_weights import _tiny_depth_torch_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_DEMO = _load_script("depth_demo")
J_RUN = _load_script("run_depth")


class FakeEstimator:
    """A depth that depends on the image and its position."""

    def infer_image(self, image):
        h, w = image.shape[:2]
        ramp = np.linspace(0, 1, h * w, dtype=np.float32).reshape(h, w)
        return ramp * (1.0 + image.astype(np.float32).mean(-1))


def _args(**kw):
    base = dict(img_path=None, video_path=None, input_size=518,
                outdir=None, encoder="vitb", pred_only=False,
                grayscale=False, models_dir=None, serve=False, port=0)
    base.update(kw)
    return argparse.Namespace(**base)


def _maps():
    rng = np.random.default_rng(3)
    return {"random": rng.standard_normal((40, 50)).astype(np.float32) * 3,
            "ramp": np.linspace(-2, 5, 600, dtype=np.float32).reshape(20, 30),
            "constant": np.full((9, 11), 0.7, np.float32)}


def _sources(tmp_path):
    """Two images in a directory (one in a subdirectory), a file PIL cannot
    open beside them, and a .txt list of the images."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(4)
    imgs = []
    for i, p in enumerate((src / "a.png", src / "sub" / "b.png")):
        Image.fromarray((rng.random((20 + i, 30, 3)) * 255).astype(
            np.uint8)).save(p)
        imgs.append(str(p))
    (src / "notes.bin").write_bytes(b"\x00not an image")
    lst = tmp_path / "files.txt"
    lst.write_text("\n".join(imgs))
    return {"file": imgs[0], "txt": str(lst), "dir": str(src)}


def _same_files(got, want):
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and got
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read(), g


# ---------------------------------------------------------------------------
# the colormap and the presets
# ---------------------------------------------------------------------------


def test_spectral_r_table_is_matplotlibs():
    import matplotlib

    cmap = matplotlib.colormaps.get_cmap("Spectral_r")
    want = cmap(np.arange(256))[:, :3]
    assert dc.SPECTRAL_R.dtype == np.float64
    assert np.array_equal(dc.SPECTRAL_R, want)
    x = np.asarray([0.0, 1e-9, 0.5, 0.999999, 1.0, np.nan], np.float32)
    assert np.array_equal(dc.spectral_r(x), cmap(x)[:, :3])


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("which", ["random", "ramp", "constant"])
def test_colorize_u8_bit_equal_to_depth_demo(which, grayscale):
    d = _maps()[which]
    assert np.array_equal(dc.colorize_u8(d, grayscale),
                          J_DEMO.colorize(d, grayscale))


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("which", ["random", "ramp", "constant"])
def test_colorize_unit_bit_equal_to_run_depth(which, grayscale):
    d = _maps()[which]
    assert np.array_equal(dc.colorize_unit(d, grayscale),
                          J_RUN.colorize(d, grayscale))


@pytest.mark.parametrize("name", ["vits", "vitl"])
def test_depth_presets_equal_jax(name):
    got = dataclasses.asdict(getattr(DepthConfig, name)())
    want = dataclasses.asdict(getattr(jax_config.DepthConfig, name)())
    assert got == want


@pytest.mark.parametrize("name", ["vits", "vitl"])
def test_full_width_preset_maps_every_key(name):
    """Every parameter of the full ViT-S / ViT-L tree has a key of the
    port's module with the bridged shape (shapes from jax.eval_shape)."""
    import jax

    from inklayer_tpu.io.weights import DEPTH_RULES
    from inklayer_tpu_torch.models.depth import DepthAnythingV2
    from inklayer_tpu_torch.params import (flatten_tree,
                                           jax_to_torch_state_dict)

    jm = JaxDepth(getattr(jax_config.DepthConfig, name)())
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 518, 518, 3))),
                            jax.random.key(0))
    zeros = flatten_tree(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))
    got = jax_to_torch_state_dict(zeros, DEPTH_RULES)
    want = DepthAnythingV2(getattr(DepthConfig, name)()).state_dict()
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.shape == want[key].shape, key


# ---------------------------------------------------------------------------
# the scripts' files with one fake estimator
# ---------------------------------------------------------------------------


MODES = {"file": dict(), "txt": dict(pred_only=True),
         "dir": dict(pred_only=True, grayscale=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_depth_demo_run_images_byte_equal(tmp_path, mode):
    src = _sources(tmp_path)
    path = src[mode] if mode != "dir" else os.path.join(src["dir"], "sub")
    got = depth_demo.run_images(FakeEstimator(), _args(
        img_path=path, outdir=str(tmp_path / "port"), **MODES[mode]))
    want = J_DEMO.run_images(FakeEstimator(), _args(
        img_path=path, outdir=str(tmp_path / "jax"), **MODES[mode]))
    _same_files(got, want)


def _jax_run_depth_main(argv):
    with mock.patch.object(J_RUN, "build_estimator",
                           lambda *a: FakeEstimator()), \
            mock.patch("sys.argv", ["run_depth.py"] + argv):
        J_RUN.main()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_depth_images_byte_equal(tmp_path, mode):
    """The directory mode skips the file PIL cannot open."""
    src = _sources(tmp_path)
    flags = [f"--{k.replace('_', '-')}" for k in MODES[mode]]
    _jax_run_depth_main(["--img-path", src[mode], "--outdir",
                         str(tmp_path / "jax")] + flags)
    got = run_depth.run_images(FakeEstimator(), _args(
        img_path=src[mode], outdir=str(tmp_path / "port"), **MODES[mode]))
    want = [str(tmp_path / "jax" / os.path.basename(p))
            for p in sorted(os.listdir(tmp_path / "jax"))]
    assert len(got) == (1 if mode == "file" else 2)
    _same_files(sorted(got), want)


def _frames(path):
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def _clip(tmp_path):
    import cv2

    src = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 5, (32, 24))
    rng = np.random.default_rng(5)
    for _ in range(4):
        w.write((rng.random((24, 32, 3)) * 255).astype(np.uint8))
    w.release()
    return src


@pytest.mark.parametrize("script", ["depth_demo", "run_depth"])
def test_run_video_frame_equal(tmp_path, script):
    pytest.importorskip("cv2")
    src = _clip(tmp_path)
    port = str(tmp_path / "port")
    if script == "depth_demo":
        got = depth_demo.run_video(FakeEstimator(),
                                   _args(video_path=src, outdir=port))
        want = J_DEMO.run_video(FakeEstimator(), _args(
            video_path=src, outdir=str(tmp_path / "jax")))
    else:
        got = run_depth.run_video(FakeEstimator(),
                                  _args(video_path=src, outdir=port))
        _jax_run_depth_main(["--video-path", src, "--outdir",
                             str(tmp_path / "jax")])
        want = [str(tmp_path / "jax" / "clip.mp4")]
    a, b = _frames(got[0]), _frames(want[0])
    assert len(a) == len(b) == 4 and a[0].shape == (24, 32 * 2 + 50, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("pred_only", [False, True])
def test_depth_frame_bgr_is_the_video_arithmetic(pred_only):
    """The per-frame work of both video paths, without OpenCV: the frame
    in BGR, the result in BGR (``scripts/depth_demo.py`` run_video)."""
    bgr = (np.random.default_rng(6).random((12, 17, 3)) * 255).astype(
        np.uint8)
    rgb = bgr[:, :, ::-1]
    vis = J_DEMO.colorize(FakeEstimator().infer_image(rgb), False)
    frame = vis if pred_only else J_DEMO.side_by_side(rgb, vis)
    want = np.ascontiguousarray(frame[:, :, ::-1])
    got = depth_demo.depth_frame(FakeEstimator(), bgr, False, pred_only,
                                 bgr=True)
    assert got.flags.c_contiguous and np.array_equal(got, want)


def _multipart(png: bytes):
    boundary = "inklayerboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="image"; filename="x.png"\r\nContent-Type: image/png'
            f"\r\n\r\n").encode() + png + f"\r\n--{boundary}--\r\n".encode()
    return {"REQUEST_METHOD": "POST", "PATH_INFO": "/depth",
            "CONTENT_TYPE": f"multipart/form-data; boundary={boundary}",
            "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}


def _call(app, environ):
    status = []
    body = b"".join(app(environ, lambda s, h: status.append(s)))
    return status[0], body


def test_serve_app_answers_with_the_jax_apps_png():
    buf = io.BytesIO()
    Image.fromarray((np.random.default_rng(7).random((18, 26, 3)) * 255
                     ).astype(np.uint8)).save(buf, "PNG")
    captured = {}

    class Server:
        def serve_forever(self):
            pass

    def make_server(host, port, app):
        captured["app"] = app
        return Server()

    with mock.patch("wsgiref.simple_server.make_server", make_server):
        J_DEMO.serve(FakeEstimator(), "127.0.0.1", 0)
    port_app = depth_demo.make_app(FakeEstimator())
    got = _call(port_app, _multipart(buf.getvalue()))
    want = _call(captured["app"], _multipart(buf.getvalue()))
    assert got[0] == want[0] == "200 OK" and got[1] == want[1]
    assert Image.open(io.BytesIO(got[1])).size == (26 * 2 + 50, 18)
    page = _call(port_app, {"REQUEST_METHOD": "GET", "PATH_INFO": "/",
                            "wsgi.input": io.BytesIO()})
    assert page[0] == "200 OK" and b"<form" in page[1]


# ---------------------------------------------------------------------------
# the models behind the scripts
# ---------------------------------------------------------------------------


def test_infer_image_matches_jax():
    _, params, tm = depth_pair()
    image = (np.random.default_rng(8).random((61, 83, 3)) * 255).astype(
        np.uint8)
    want = np.asarray(JaxEstimator(params, TINY).infer_image(image))
    got = DepthEstimator(tm).infer_image(image)
    assert got.dtype == np.float32 and got.shape == (61, 83)
    assert _rel(got, want) <= REL


def test_run_depth_placeholders_match_jax():
    """0.01 in every parameter, as the JAX script fills them."""
    image = (np.random.default_rng(9).random((50, 64, 3)) * 255).astype(
        np.uint8)
    with mock.patch.object(jax_config, "DepthConfig", lambda **kw: TINY):
        want = J_RUN.build_estimator("vits", None).infer_image(image)
    est = run_depth.build_estimator("vits", None, "cpu", cfg=TINY)
    assert all(bool((p == 0.01).all()) for p in est.model.parameters())
    got = est.infer_image(image)
    assert np.abs(want).max() > 0
    assert _rel(got, np.asarray(want)) <= REL


@pytest.mark.parametrize("script", ["run_depth", "depth_demo"])
def test_models_dir_loads_a_reference_layout_pth(tmp_path, script,
                                                 monkeypatch):
    sd = _tiny_depth_torch_state_dict(np.random.default_rng(10))
    path = str(tmp_path / "depth_anything_v2_vitb.pth")
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    jm = JaxDepth(TINY)
    params = load_depth_params(path, TINY, jm, (jnp.zeros(
        (1, TINY.input_size, TINY.input_size, 3)),))
    image = (np.random.default_rng(11).random((40, 70, 3)) * 255).astype(
        np.uint8)
    want = np.asarray(JaxEstimator(params, TINY).infer_image(image))
    if script == "run_depth":
        est = run_depth.build_estimator("vitb", str(tmp_path), "cpu",
                                        cfg=TINY)
    else:
        # the build names the file by the configuration's encoder
        monkeypatch.setitem(depth_demo.ENCODERS, "vitb", lambda: dataclasses.
                            replace(TINY, encoder="vitb"))
        est = depth_demo.build_estimator("vitb", str(tmp_path),
                                         TINY.input_size, "cpu")
    assert torch.equal(est.model.state_dict()["pretrained.cls_token"],
                       torch.tensor(sd["pretrained.cls_token"]))
    assert _rel(est.infer_image(image), want) <= REL


@pytest.mark.parametrize("script", ["run_depth", "depth_demo"])
def test_cli_runs_on_the_cpu_when_asked_and_on_the_card_by_default(
        tmp_path, script, monkeypatch):
    monkeypatch.setitem(depth_demo.ENCODERS, "vits", lambda: TINY)
    img = str(tmp_path / "x.png")
    Image.fromarray(np.full((30, 40, 3), 90, np.uint8)).save(img)
    mod = {"run_depth": run_depth, "depth_demo": depth_demo}[script]
    argv = ["--img-path", img, "--encoder", "vits", "--outdir",
            str(tmp_path / "out")]
    if script == "depth_demo":
        argv += ["--input-size", str(TINY.input_size)]
    written = mod.main(argv + ["--cpu"])
    assert Image.open(written[0]).size == (40 * 2 + 50, 30)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
