"""Port parity: the device NMS front (``PipelineConfig.device_front``).

* ``device_prefilter_gates`` against the JAX package's
  ``_device_prefilter_gates`` on seeded top-K boxes and scores with tied
  scores, rows under the score threshold, and a box whose fp32 corner
  product truncates to another pixel than the fp64 one: valid, gate and
  order exactly, the gated bbox IoU within 1e-6;
* ``nms_depth_front_device`` against ``nms_depth_front_device`` on the
  mask stack of tests/test_torch_refine.py: every output exactly (depth
  scores within 1e-5);
* the port's default run with the front on against the front off: every
  output file byte for byte and one host read-back fewer, keeping the
  intermediates and with ``no_intermediate`` (the JAX package's
  tests/test_pipeline.py device-front case);
* the port against the JAX pipeline, both with the front on, to
  tests/test_torch_pipeline.py's standard;
* ``run_dir``'s lookahead with the front on: the runs' files one by one.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.pipeline.refine import front as JF
from inklayer_tpu_torch.pipeline.refine import front as TF
from tests.test_torch_pipeline import pipeline_pair
from tests.test_torch_refine import CFG, JCFG, H, W, _gray, _masks
from tests.test_torch_sweep import SIZES, _assert_close_outputs, _draw, _files

THRESH = 0.3


def _boundary_cx(w: int, bw: float) -> np.float32:
    """A centre whose left corner (cx - bw / 2) * w truncates to another
    pixel in fp32 (the device path) than in fp64 (the host path)."""
    for i in range(1, 2000):
        cx = np.float32(i / 2000)
        f32 = np.trunc((cx - np.float32(bw) / np.float32(2)) * np.float32(w))
        f64 = np.trunc((np.float64(cx) - np.float64(np.float32(bw)) / 2) * w)
        if f32 != f64 and 0 < f32 < w:
            return cx
    raise AssertionError("no boundary product found")


def _topk(seed: int = 0, k: int = 24):
    """Score-sorted top-K as the detector leaves it: normalised cxcywh
    boxes (the refine mask stack's rectangles first), tied scores, the
    last rows under THRESH, one box on a truncation boundary."""
    rng = np.random.default_rng(seed)
    xyxy = np.asarray([[5, 5, 51, 53], [57, 27, 101, 83], [12, 57, 38, 78],
                       [18, 50, 62, 72], [5, 5, 30, 53], [0, 0, 111, 95],
                       [56, 28, 102, 84], [60, 10, 90, 30], [6, 6, 100, 12],
                       [2, 85, 9, 95]], np.float64)
    extra = rng.random((k - len(xyxy), 4)) * [W, H, W, H]
    extra[:, 2:] = extra[:, :2] + rng.random((len(extra), 2)) * 40 + 2
    xyxy = np.concatenate([xyxy, extra]) / [W, H, W, H]
    boxes = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                            xyxy[:, 2:] - xyxy[:, :2]], 1).astype(np.float32)
    boxes[3, 2] = np.float32(0.1)
    boxes[3, 0] = _boundary_cx(W, boxes[3, 2])
    scores = np.sort(rng.random(k).astype(np.float32) * 0.6 + 0.35)[::-1]
    scores[2] = scores[3] = scores[4]          # ties among valid rows
    scores[9] = scores[10]
    scores[-4:] = [0.3, 0.2, 0.1, 0.05]        # at and under the threshold
    return boxes, scores.copy()


def test_device_prefilter_gates_match_jax():
    boxes, scores = _topk()
    gray = _gray()
    hw = (H, W)
    kw = dict(max_area_frac=CFG.nms_max_area_frac,
              max_contained=CFG.nms_max_contained,
              eps_per_kdiag=CFG.nms_eps_px_per_kdiag, thresh=THRESH)
    want = JF._device_prefilter_gates(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(gray), hw=hw, **kw)
    got = TF.device_prefilter_gates(torch.from_numpy(boxes),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(gray), hw, **kw)
    valid, gate, bb, order = (t.numpy() for t in got)
    np.testing.assert_array_equal(valid, np.asarray(want[0]))
    np.testing.assert_array_equal(gate, np.asarray(want[1]))
    np.testing.assert_allclose(bb, np.asarray(want[2]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(order, np.asarray(want[3]))
    # the cases are exercised: rows under the threshold are out, some valid
    # rows fail the other tests, gates fire, ties keep index order
    assert not valid[-3:].any() and valid[:3].all()
    assert valid[:-4].sum() < len(valid) - 4 and gate.any()
    assert list(order[:5]) == [0, 1, 2, 3, 4]


def test_nms_depth_front_device_matches_jax():
    boxes, scores = _topk(k=10 + 14)
    rng = np.random.default_rng(0)
    gray = _gray()
    masks = _masks(rng)
    masks = np.concatenate([masks, masks[::-1], masks[:4]])  # K = 24 rows
    depth = rng.random((H, W)).astype(np.float32) * 3.0
    want = JF.nms_depth_front_device(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(masks),
        jnp.asarray(gray), jnp.asarray(depth), (H, W), JCFG,
        box_threshold=THRESH)
    got = TF.nms_depth_front_device(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(masks), torch.from_numpy(gray),
        torch.from_numpy(depth), (H, W), CFG, box_threshold=THRESH)
    names = ("valid", "order", "keep", "dscores", "overlap")
    for name, g, w in zip(names, got, want):
        if name == "dscores":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    valid, order, keep = (t.numpy() for t in got[:3])
    kept = order[keep & valid[order]]
    assert 0 < len(kept) < valid.sum()  # NMS suppressed some valid rows


@pytest.fixture(scope="module")
def pipes():
    cfg, jax_pipe, port = pipeline_pair()
    return cfg, jax_pipe, port


def _with_front(pipe, cfg, on: bool):
    pipe.cfg = dataclasses.replace(cfg, device_front=on)
    return pipe


@pytest.fixture(scope="module")
def sketches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("front")
    os.makedirs(tmp / "in")
    paths = [_draw(str(tmp / "in" / f"s{i}.png"), h, w, 4 * i)
             for i, (h, w) in enumerate(SIZES)]
    return tmp, paths


@pytest.mark.parametrize("no_intermediate", [False, True])
def test_front_on_equals_front_off(pipes, sketches, no_intermediate):
    """Every file byte for byte on each sketch, and exactly one sync fewer
    per run: the detection and the front come back together."""
    cfg, _, port = pipes
    tmp, paths = sketches
    for p in paths:
        dirs, syncs = [], []
        for on in (False, True):
            _with_front(port, cfg, on)
            before = port.sync_count
            dirs.append(port.run(p, str(tmp / f"run_{on}_{no_intermediate}"),
                                 no_intermediate=no_intermediate))
            syncs.append(port.sync_count - before)
        off, on = (_files(d) for d in dirs)
        assert off == on and "bboxes_final.json" in on
        with open(os.path.join(dirs[1], "bboxes_final.json")) as f:
            assert json.load(f)["kept_indices"]
        assert syncs[1] == syncs[0] - 1, syncs
        assert syncs[0] == (3 if no_intermediate else 5)


def test_front_on_matches_jax_front_on(pipes, sketches):
    cfg, jax_pipe, port = pipes
    tmp, paths = sketches
    _with_front(port, cfg, True)
    _with_front(jax_pipe, cfg, True)
    for p, hw in zip(paths[:2], SIZES):  # GroundingDINO's square bucket
        _assert_close_outputs(
            port.run(p, str(tmp / "port_on"), no_intermediate=True),
            jax_pipe.run(p, str(tmp / "jax_on"), no_intermediate=True), hw)


def test_lookahead_with_front_equals_runs(pipes, sketches):
    cfg, _, port = pipes
    tmp, paths = sketches
    _with_front(port, cfg, True)
    swept = port.run_dir(paths, str(tmp / "sweep_on"), no_intermediate=True,
                         workers=1)
    for p, got in zip(paths, swept):
        want = port.run(p, str(tmp / "one_on"), no_intermediate=True)
        assert _files(got) == _files(want)
        # and the front-off runs' files
        _with_front(port, cfg, False)
        off = port.run(p, str(tmp / "one_off"), no_intermediate=True)
        _with_front(port, cfg, True)
        assert _files(got) == _files(off)
    assert np.asarray(Image.open(os.path.join(swept[0], "depth_map.png"))
                      ).shape[:2] == SIZES[0]
