"""Port parity: the directory sweep (``run_dir`` with its lookahead, its
worker threads and ``--batch``; the CLI's host sharding) and the batched
model entries it runs (``GDinoDetector.detect_batch``,
``SamPredictor.precompute_image_states``, ``predict_device_state``).

Both packages run TINY_PIPE (tests/test_pipeline.py) with box_threshold
0.0 and the same random detector / SAM / depth params, carried over by the
bridge, on three sketches of differing sizes (two share GroundingDINO's
square bucket with different pad masks, one takes the wide bucket), at
``no_intermediate``: the sweep's configuration, whose masks are made only
for the NMS prefilter's survivors.

* port sweep against the JAX sweep in the same mode (lookahead, 2 workers,
  batch 2): bboxes_final.json equal at tests/test_torch_pipeline.py's
  standard (kept_indices and threshold exactly, boxes within 1 px of int
  truncation, scores atol = rtol = 1e-3), every final mask IoU >= 0.99,
  depth map within 1 level;
* port sweeps against the port's own ``run`` one after another: every
  output file byte for byte; the batched sweep against the unbatched one
  as the port against JAX (batch-2 forwards sum in another order on the
  CPU), its unbatched outputs byte for byte;
* batched entries against their per-image forms (fp32, atol 1e-5) and
  against the JAX package (atol = rtol = 1e-3, masks IoU >= 0.99).
"""

import dataclasses
import json
import os
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.build import build_pipeline as jax_build_pipeline
from inklayer_tpu.config import save_config
from inklayer_tpu.io.outputs import KEEP_LIST
from inklayer_tpu_torch.models.depth import DepthEstimator
from inklayer_tpu_torch.models.gdino import GDinoDetector
from inklayer_tpu_torch.models.sam import SamPredictor
from inklayer_tpu_torch.pipeline.runner import InkLayerPipeline
from tests.test_pipeline import TINY_PIPE
from tests.test_torch_depth import depth_pair
from tests.test_torch_gdino import gdino_pair
from tests.test_torch_pipeline import PORT_OUTPUTS
from tests.test_torch_sam import sam_pair

SIZES = ((128, 128), (128, 120), (96, 150))
MODES = {"lookahead": {"workers": 1}, "workers2": {"workers": 2},
         "batch2": {"batch_size": 2}}


def _draw(path: str, h: int, w: int, shift: int) -> str:
    """A box, a shaded box and a diagonal stroke, moved by ``shift``."""
    g = np.full((h, w, 3), 255, np.uint8)
    y0, x0 = 8 + shift, 10 + shift
    g[y0:y0 + 50, x0:x0 + 3] = 0
    g[y0:y0 + 50, x0 + 47:x0 + 50] = 0
    g[y0:y0 + 3, x0:x0 + 50] = 0
    g[y0 + 47:y0 + 50, x0:x0 + 50] = 0
    g[h - 50:h - 10, w - 45:w - 8] = 40
    for i in range(40):
        g[h // 2 + i // 4, 5 + i] = 60
    Image.fromarray(g).save(path)
    return path


def _port_pipeline(cfg, g_model, s_model, d_model):
    return InkLayerPipeline(GDinoDetector(g_model),
                            SamPredictor(s_model,
                                         box_capacity=cfg.gdino.max_boxes),
                            DepthEstimator(d_model), cfg)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = dataclasses.replace(
        TINY_PIPE,
        gdino=dataclasses.replace(TINY_PIPE.gdino, box_threshold=0.0))
    _, g_params, g_model = gdino_pair(cfg.gdino)
    # std 0.5: masks that cover part of the image (std 0.2 fills them all)
    _, s_params, s_model = sam_pair(cfg.sam, std=0.5)
    _, d_params, d_model = depth_pair(cfg.depth)
    jax_pipe = jax_build_pipeline(cfg)
    jax_pipe.detector.params = g_params
    jax_pipe.sam.params = s_params
    jax_pipe.depth.params = d_params
    jax_pipe.inpainter = None
    tmp = tmp_path_factory.mktemp("sweep")
    os.makedirs(tmp / "in")
    paths = [_draw(str(tmp / "in" / f"s{i}.png"), h, w, 4 * i)
             for i, (h, w) in enumerate(SIZES)]
    return SimpleNamespace(cfg=cfg, jax=jax_pipe,
                           port=_port_pipeline(cfg, g_model, s_model, d_model),
                           paths=paths, tmp=tmp)


@pytest.fixture(scope="module")
def sweeps(setup):
    """Output directories per (package, mode), all at no_intermediate."""
    out = {}
    for mode, kw in MODES.items():
        out["jax", mode] = setup.jax.run_dir(
            setup.paths, str(setup.tmp / f"jax_{mode}"), no_intermediate=True,
            **kw)
        out["port", mode] = setup.port.run_dir(
            setup.paths, str(setup.tmp / f"port_{mode}"),
            no_intermediate=True, **kw)
    out["port", "one by one"] = [
        setup.port.run(p, str(setup.tmp / "port_seq"), no_intermediate=True)
        for p in setup.paths]
    return out


def _files(out_dir: str) -> dict:
    """{relative path: bytes} of every file under ``out_dir``."""
    got = {}
    for root, _, names in os.walk(out_dir):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                got[os.path.relpath(p, out_dir)] = f.read()
    return got


def _masks(out_dir: str, sub: str = "masks_final"):
    d = os.path.join(out_dir, sub)
    names = sorted(os.listdir(d), key=lambda n: int(n[5:-4]))
    return [np.asarray(Image.open(os.path.join(d, n)).convert("L")) > 127
            for n in names]


def _iou(a, b) -> float:
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


def _assert_close_outputs(got_dir: str, want_dir: str, hw) -> None:
    """tests/test_torch_pipeline.py's standard for two runs of one sketch
    that may differ in the last bits of the detector's and SAM's sums."""
    h, w = hw
    assert os.path.basename(got_dir) == os.path.basename(want_dir)
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) \
        == sorted(set(KEEP_LIST) & set(PORT_OUTPUTS))
    with open(os.path.join(want_dir, "bboxes_final.json")) as f:
        want = json.load(f)
    with open(os.path.join(got_dir, "bboxes_final.json")) as f:
        got = json.load(f)
    assert got["kept_indices"] == want["kept_indices"]
    assert 0 < len(got["kept_indices"])
    assert got["threshold"] == want["threshold"]
    px = np.asarray([w, h, w, h], np.float64)
    diff = np.abs(np.asarray(got["bboxes"]) - np.asarray(want["bboxes"])) * px
    assert diff.max() <= 1.0 + 1e-6, diff.max()
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3,
                               rtol=1e-3)
    t_masks, j_masks = _masks(got_dir), _masks(want_dir)
    assert len(t_masks) == len(j_masks) > 0
    for a, b in zip(t_masks, j_masks):
        assert a.shape == (h, w)
        assert _iou(a, b) >= 0.99
    a, b = (np.asarray(Image.open(os.path.join(d, "depth_map.png")))
            for d in (got_dir, want_dir))
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sweep_matches_jax(sweeps, mode):
    for jax_dir, port_dir, hw in zip(sweeps["jax", mode],
                                     sweeps["port", mode], SIZES):
        _assert_close_outputs(port_dir, jax_dir, hw)


@pytest.mark.parametrize("mode", ["lookahead", "workers2"])
def test_sweep_equals_runs_one_by_one(sweeps, mode):
    for got, want in zip(sweeps["port", mode], sweeps["port", "one by one"]):
        assert _files(got) == _files(want)


def test_batched_sweep_matches_unbatched(sweeps):
    """Batched detection and SAM encodes, and the host-box decode they lead
    to, against the unbatched sweep.  On the CPU the batch-2 forwards sum
    in another order than batch 1 (box corners differ in the 8th digit),
    so the files that depend on them are held to the port-vs-JAX standard;
    input.png and the depth map (not batched) byte for byte."""
    for got, want, hw in zip(sweeps["port", "batch2"],
                             sweeps["port", "lookahead"], SIZES):
        _assert_close_outputs(got, want, hw)
        g, w = _files(got), _files(want)
        for name in ("input.png", "depth_map.png"):
            assert g[name] == w[name]


def test_sweep_with_intermediates_equals_runs_one_by_one(setup):
    """The lookahead sweep keeping every output: all 12 items, byte for
    byte those of ``run`` one image after another."""
    port = setup.port
    swept = port.run_dir(setup.paths, str(setup.tmp / "full_sweep"),
                         workers=1)
    for p, got in zip(setup.paths, swept):
        want = port.run(p, str(setup.tmp / "full_seq"))
        assert sorted(os.listdir(got)) == PORT_OUTPUTS
        assert _files(got) == _files(want)


def test_sweep_leaves_no_pending_writes(sweeps, setup):
    assert not setup.port._pending
    assert setup.port.async_io is False
    assert set(setup.port.stage_times) >= {"detect", "segment", "write"}


def test_each_thread_drains_only_its_own_writes(setup):
    """A thread's drain waits for the writes it submitted and leaves
    another thread's writes pending."""
    pipe = setup.port
    release, done, drained = threading.Event(), [], threading.Event()

    def slow_write():
        release.wait(timeout=30)
        done.append("b")

    def thread_b():
        pipe.async_io = True
        pipe._submit(slow_write)
        drained.wait(timeout=30)
        assert len(pipe._pending) == 1  # a's drain left it pending
        release.set()
        pipe.drain()
        pipe.async_io = False

    b = threading.Thread(target=thread_b)
    b.start()
    pipe.async_io = True
    pipe._submit(done.append, "a")
    pipe.drain()
    assert done == ["a"] and not pipe._pending
    pipe.async_io = False
    drained.set()
    b.join(timeout=60)
    assert done == ["a", "b"]


# ---------------------------------------------------------------------------
# the batched model entries
# ---------------------------------------------------------------------------


def _images(setup):
    return [np.array(Image.open(p).convert("RGB")) for p in setup.paths]


def test_detect_batch_matches_detect_and_jax(setup):
    port, jax_pipe = setup.port, setup.jax
    images = _images(setup)
    tensors = [torch.from_numpy(im) for im in images]
    got = port.detector.detect_batch(tensors)
    want = jax_pipe.detector.detect_batch(images)
    for g, one, w in zip(got, [port.detector.detect(t) for t in tensors],
                         want):
        assert len(g["scores"]) == len(one["scores"]) == setup.cfg.gdino\
            .max_boxes
        for key in ("boxes", "scores", "token_logits"):
            np.testing.assert_allclose(g[key], one[key], atol=1e-5)
            np.testing.assert_allclose(g[key], w[key], atol=1e-3, rtol=1e-3)
        assert g["labels"] == one["labels"]
        assert g["caption"] == w["caption"]


def test_precompute_image_states_matches_jax(setup):
    port, jax_pipe = setup.port, setup.jax
    images = _images(setup)
    got = port.sam.precompute_image_states(
        [torch.from_numpy(im) for im in images])
    want = jax_pipe.sam.precompute_image_states(images)
    for g, w, im in zip(got, want, images):
        one = port.sam.compute_image_state(torch.from_numpy(im))
        np.testing.assert_allclose(g["embedding"].numpy(),
                                   one["embedding"].numpy(), atol=1e-5)
        np.testing.assert_allclose(g["embedding"].numpy(),
                                   np.asarray(w["embedding"]), atol=1e-3,
                                   rtol=1e-3)
        np.testing.assert_array_equal(g["scale"], w["scale"])
        assert g["orig_hw"] == w["orig_hw"] and g["input_hw"] == w["input_hw"]


def test_predict_device_state_matches_jax(setup):
    """The host-box decode the batched sweep takes: integer pixel boxes,
    padded to the box capacity (doubled once here: 12 boxes over 8)."""
    port, jax_pipe = setup.port, setup.jax
    image = _images(setup)[2]
    h, w = image.shape[:2]
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, w // 2, 12)
    y0 = rng.integers(0, h // 2, 12)
    boxes = np.stack([x0, y0, x0 + rng.integers(8, w // 2, 12),
                      y0 + rng.integers(8, h // 2, 12)], 1).astype(float)
    state = port.sam.compute_image_state(torch.from_numpy(image))
    masks, iou = port.sam.predict_device_state(state, boxes)
    jstate = jax_pipe.sam.compute_image_state(jnp.asarray(image))
    jmasks, jiou = jax_pipe.sam.predict_device_state(jstate, boxes)
    jmasks = np.asarray(jmasks)
    assert masks.shape == jmasks.shape == (12, h, w)
    assert masks.dtype == torch.bool
    np.testing.assert_allclose(iou, jiou, atol=1e-3, rtol=1e-3)
    assert any(0.05 < m.float().mean() < 0.95 for m in masks)
    for a, b in zip(masks.numpy(), jmasks):
        assert _iou(a, b) >= 0.99


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_cfg(setup):
    path = str(setup.tmp / "tiny.json")
    save_config(setup.cfg, path)
    return path


def test_cli_sweeps_a_directory_in_batches(setup, cli_cfg, capsys):
    from inklayer_tpu_torch.main import main

    out = setup.tmp / "cli_batch"
    main(["--dir", str(setup.tmp / "in"), "--out_dir", str(out), "--batch",
          "2", "--config", cli_cfg, "--device", "cpu", "--no_intermediate"])
    assert sorted(os.listdir(out)) == ["s0", "s1", "s2"]
    for name in ("s0", "s1", "s2"):
        assert sorted(os.listdir(out / name)) == sorted(
            set(KEEP_LIST) & set(PORT_OUTPUTS))
    assert "stage times (s):" in capsys.readouterr().out


@pytest.mark.parametrize("host_id,want", [(0, ["s0", "s2"]), (1, ["s1"])])
def test_cli_takes_its_hosts_share(setup, cli_cfg, host_id, want):
    from inklayer_tpu_torch.main import main

    out = setup.tmp / f"cli_host{host_id}"
    main(["--dir", str(setup.tmp / "in"), "--out_dir", str(out),
          "--num_hosts", "2", "--host_id", str(host_id), "--config", cli_cfg,
          "--device", "cpu", "--no_intermediate"])
    assert sorted(os.listdir(out)) == want


def test_cli_host_sharding_from_the_environment(setup, cli_cfg, monkeypatch):
    from inklayer_tpu_torch.main import main

    monkeypatch.setenv("INKLAYER_NUM_HOSTS", "3")
    monkeypatch.setenv("INKLAYER_HOST_ID", "2")
    out = setup.tmp / "cli_env"
    main(["--dir", str(setup.tmp / "in"), "--out_dir", str(out), "--config",
          cli_cfg, "--device", "cpu", "--no_intermediate"])
    assert sorted(os.listdir(out)) == ["s2"]


@pytest.mark.parametrize("argv", [["--num_hosts", "2", "--host_id", "2"],
                                  ["--num_hosts", "2", "--host_id", "-1"]])
def test_cli_refuses_a_host_outside_the_range(setup, argv, capsys):
    from inklayer_tpu_torch.main import main

    with pytest.raises(SystemExit) as exc:
        main(["--dir", str(setup.tmp / "in"), "--device", "cpu", *argv])
    assert exc.value.code == 2
    assert "--host_id must be in [0, num_hosts)" in capsys.readouterr().err


def test_config_with_device_front_loads(setup, tmp_path):
    """A JAX config with ``device_front: true`` loads and runs (the device
    NMS front); the JAX default (false) loads, and sweep_workers carries
    over."""
    from inklayer_tpu_torch.config import load_config
    from inklayer_tpu_torch.main import main

    path = str(tmp_path / "front.json")
    save_config(dataclasses.replace(setup.cfg, device_front=True), path)
    assert load_config(path).device_front is True
    out = tmp_path / "front_out"
    main(["--dir", str(setup.tmp / "in"), "--out_dir", str(out), "--config",
          path, "--device", "cpu", "--no_intermediate"])
    assert sorted(os.listdir(out)) == ["s0", "s1", "s2"]
    for name in ("s0", "s1", "s2"):
        assert sorted(os.listdir(out / name)) == sorted(
            set(KEEP_LIST) & set(PORT_OUTPUTS))
    save_config(dataclasses.replace(setup.cfg, sweep_workers=3), path)
    cfg = load_config(path)
    assert cfg.sweep_workers == 3 and cfg.device_front is False


@pytest.mark.parametrize("device", [[], ["--device", "cuda"]])
def test_cli_cpu_flag_forces_the_cpu(setup, cli_cfg, tmp_path, device,
                                     capsys):
    """The JAX CLI's --cpu: the run builds on the CPU, whatever --device
    says, and writes its outputs."""
    from inklayer_tpu_torch.main import main

    out = tmp_path / "cpu_out"
    main(["--img", setup.paths[0], "--out_dir", str(out), "--config",
          cli_cfg, *device, "--cpu"])
    assert sorted(os.listdir(out / "s0")) == PORT_OUTPUTS
    assert "stage times (s):" in capsys.readouterr().out


def test_many_threads_drain_their_own_writes(setup):
    """16 threads (more than this machine's cores) each submit 20 writes
    and drain, with a short switch interval: after its drain every write a
    thread submitted has run, and no thread's list holds another's."""
    import sys

    pipe = setup.port
    done, errors = [[] for _ in range(16)], []

    def worker(i):
        try:
            pipe.async_io = True
            for j in range(20):
                pipe._submit(done[i].append, j)
            pipe.drain()
            if sorted(done[i]) != list(range(20)):
                errors.append((i, done[i]))
            if pipe._pending:
                errors.append((i, "pending"))
            pipe.async_io = False
        except Exception as e:  # re-raised below, in the main thread
            errors.append((i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert all(sorted(d) == list(range(20)) for d in done)
