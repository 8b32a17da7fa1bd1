"""Port parity: the default run as a whole.

The JAX InkLayerPipeline is built on TINY_PIPE (tests/test_pipeline.py)
with box_threshold 0.0 and random detector / SAM / depth params; the port
runs the same params, carried over by the bridge, on the fixed sketch of
tests/test_self_golden.py.  The port writes the whole output contract;
each of its files is held against the JAX run's:

* bboxes.json: same count, boxes within 1 px (int truncation of f32
  corners), scores atol = rtol = 1e-3;
* masks/, masks_cleaned/, masks_disjoint/, masks_final/: same counts, each
  mask IoU >= 0.99 with its JAX counterpart;
* bboxes_final.json: same kept_indices, boxes within 1 px, scores 1e-3;
* depth_map.png: within 1 level;
* segmented_sketch.png, segmented_sketch_final.png: the JAX colouring of
  the port's own masks, exactly;
* input.png: byte-identical (both copy the source PNG);
* --no_intermediate: exactly the KEEP_LIST items that exist.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from inklayer_tpu.build import build_pipeline as jax_build_pipeline
from inklayer_tpu.io.outputs import KEEP_LIST
from inklayer_tpu_torch.models.depth import DepthEstimator
from inklayer_tpu_torch.models.gdino import GDinoDetector
from inklayer_tpu_torch.models.sam import SamPredictor
from inklayer_tpu_torch.pipeline.runner import InkLayerPipeline
from tests.test_pipeline import TINY_PIPE
from tests.test_self_golden import _sketch
from tests.test_torch_depth import depth_pair
from tests.test_torch_gdino import gdino_pair
from tests.test_torch_sam import sam_pair

PORT_OUTPUTS = sorted([
    "input.png", "bboxes.json", "bboxes.png", "masks", "segmented_sketch.png",
    "masks_cleaned", "bboxes_final.json", "bboxes_final.png",
    "masks_disjoint", "depth_map.png", "masks_final",
    "segmented_sketch_final.png"])
MASK_DIRS = ["masks", "masks_cleaned", "masks_disjoint", "masks_final"]


def _masks(out_dir, sub="masks"):
    d = os.path.join(out_dir, sub)
    names = sorted(os.listdir(d), key=lambda n: int(n[5:-4]))
    return names, [np.asarray(Image.open(os.path.join(d, n)).convert("L")) > 127
                   for n in names]


def pipeline_pair():
    """(cfg, the JAX InkLayerPipeline, the port's) on TINY_PIPE with
    box_threshold 0.0 and the same random params in both."""
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
    port = InkLayerPipeline(GDinoDetector(g_model),
                            SamPredictor(s_model,
                                         box_capacity=cfg.gdino.max_boxes),
                            DepthEstimator(d_model), cfg)
    return cfg, jax_pipe, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, jax_pipe, port = pipeline_pair()
    tmp = tmp_path_factory.mktemp("slice")
    sketch = _sketch(tmp)
    return (jax_pipe.run(sketch, str(tmp / "jax")),
            port.run(sketch, str(tmp / "torch")), cfg, port, sketch, tmp,
            jax_pipe)


def test_port_writes_the_detect_segment_outputs(runs):
    """... and the rest of the output contract: all 12 items."""
    jax_dir, port_dir = runs[:2]
    assert sorted(os.listdir(port_dir)) == PORT_OUTPUTS
    assert sorted(os.listdir(jax_dir)) == PORT_OUTPUTS


def test_bboxes_json_matches_jax(runs):
    jax_dir, port_dir, cfg = runs[:3]
    with open(os.path.join(jax_dir, "bboxes.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_dir, "bboxes.json")) as f:
        got = json.load(f)
    assert set(got) == set(want) == {"bboxes", "scores"}
    assert len(got["bboxes"]) == len(want["bboxes"]) == cfg.gdino.max_boxes
    w, h = Image.open(os.path.join(port_dir, "input.png")).size
    px = np.asarray([w, h, w, h], np.float64)
    diff = np.abs(np.asarray(got["bboxes"]) - np.asarray(want["bboxes"])) * px
    assert diff.max() <= 1.0 + 1e-6, diff.max()
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3,
                               rtol=1e-3)


def _iou(a, b):
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


def test_masks_match_jax_by_iou(runs):
    jax_dir, port_dir = runs[:2]
    j_names, j_masks = _masks(jax_dir)
    t_names, t_masks = _masks(port_dir)
    assert t_names == j_names and len(t_names) > 0
    assert any(0.05 < m.mean() < 0.95 for m in t_masks)  # not all trivial
    for name, a, b in zip(t_names, t_masks, j_masks):
        assert a.shape == b.shape == (128, 128)
        iou = _iou(a, b)
        assert iou >= 0.99, (name, iou)


@pytest.mark.parametrize("sub", MASK_DIRS[1:])
def test_later_mask_stages_match_jax_by_iou(runs, sub):
    jax_dir, port_dir = runs[:2]
    j_names, j_masks = _masks(jax_dir, sub)
    t_names, t_masks = _masks(port_dir, sub)
    assert t_names == j_names and len(t_names) > 0
    for name, a, b in zip(t_names, t_masks, j_masks):
        iou = _iou(a, b)
        assert iou >= 0.99, (sub, name, iou)


def test_bboxes_final_json_matches_jax(runs):
    jax_dir, port_dir = runs[:2]
    with open(os.path.join(jax_dir, "bboxes_final.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_dir, "bboxes_final.json")) as f:
        got = json.load(f)
    assert set(got) == set(want)
    assert got["kept_indices"] == want["kept_indices"]
    assert 0 < len(got["kept_indices"]) < 64  # NMS kept some, dropped some
    assert got["threshold"] == want["threshold"]
    w, h = Image.open(os.path.join(port_dir, "input.png")).size
    px = np.asarray([w, h, w, h], np.float64)
    diff = np.abs(np.asarray(got["bboxes"]) - np.asarray(want["bboxes"])) * px
    assert diff.max() <= 1.0 + 1e-6, diff.max()
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3,
                               rtol=1e-3)


def test_depth_map_matches_jax(runs):
    jax_dir, port_dir = runs[:2]
    a, b = (np.asarray(Image.open(os.path.join(d, "depth_map.png")))
            for d in (port_dir, jax_dir))
    assert a.shape == b.shape == (128, 128, 3)
    assert a.max() > a.min()  # not a constant map
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_segmented_sketch_final_colours_the_port_masks(runs):
    from inklayer_tpu.ops.color import color_sketch_by_masks

    port_dir = runs[1]
    _, masks = _masks(port_dir, "masks_final")
    image = np.asarray(Image.open(os.path.join(port_dir, "input.png"))
                       .convert("RGB"))
    got = np.asarray(Image.open(os.path.join(port_dir,
                                             "segmented_sketch_final.png")))
    np.testing.assert_array_equal(got, color_sketch_by_masks(image, masks))


def test_no_intermediate_keeps_only_the_keep_list(runs):
    port, sketch, tmp = runs[3:6]
    out = port.run(sketch, str(tmp / "torch_ni"), no_intermediate=True)
    assert sorted(os.listdir(out)) == sorted(
        set(KEEP_LIST) & set(PORT_OUTPUTS))
    assert sorted(port.stage_times) == sorted(
        ["detect", "segment", "depth", "clean", "nms", "refine", "write"])


def test_stage_time_keys_match_jax(runs):
    """A run's stage_times keys are the JAX StageTimes keys, plus "write":
    the port also times the run's own host work around its writes and its
    wait for them, which the JAX runner leaves out."""
    port, jax_pipe = runs[3], runs[6]
    assert set(jax_pipe.stage_times.times) == {
        "detect", "segment", "depth", "clean", "nms", "refine"}
    assert set(port.stage_times) == set(jax_pipe.stage_times.times) | {
        "write"}


def test_segmented_sketch_colours_the_port_masks(runs):
    """segmented_sketch.png is the JAX package's per-mask colouring of the
    sketch by the port's own masks, bit for bit."""
    from inklayer_tpu.ops.color import color_sketch_by_masks

    port_dir = runs[1]
    _, masks = _masks(port_dir)
    image = np.asarray(Image.open(os.path.join(port_dir, "input.png"))
                       .convert("RGB"))
    got = np.asarray(Image.open(os.path.join(port_dir,
                                             "segmented_sketch.png")))
    np.testing.assert_array_equal(got, color_sketch_by_masks(image, masks))


def test_input_png_is_a_byte_copy(runs):
    jax_dir, port_dir = runs[:2]
    with open(os.path.join(jax_dir, "input.png"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_dir, "input.png"), "rb") as f:
        assert f.read() == want


def test_device_busy_time_is_the_union_of_intervals():
    from inklayer_tpu_torch.profiling import _union_us

    assert _union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert _union_us([]) == 0.0


def test_cli_runs_the_slice_and_refuses_unported_flags(tmp_path, capsys):
    from inklayer_tpu.config import save_config
    from inklayer_tpu_torch.main import main

    cfg_path = str(tmp_path / "tiny.json")
    save_config(TINY_PIPE, cfg_path)
    sketch = _sketch(tmp_path)
    with pytest.raises(SystemExit) as exc:  # --inpaint runs (see
        main(["--inpaint"])                 # test_torch_inpaint_slice.py)
    assert exc.value.code == 2
    assert "provide --img or --dir" in capsys.readouterr().err
    main(["--img", sketch, "--out_dir", str(tmp_path / "out"), "--config",
          cfg_path, "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out" / "golden_sketch")) == \
        PORT_OUTPUTS
    main(["--img", sketch, "--out_dir", str(tmp_path / "ni"), "--config",
          cfg_path, "--device", "cpu", "--no_intermediate"])
    assert sorted(os.listdir(tmp_path / "ni" / "golden_sketch")) == sorted(
        set(KEEP_LIST) & set(PORT_OUTPUTS))
