"""Port parity: the mmdetection route's producer
(``inklayer_tpu_torch.pipeline.mmdet_route``), as tests/test_mmdet_route.py
holds the JAX package's, and the file it writes against the JAX
producer's on the TINY GroundingDINO of tests/test_gdino.py with the same
params (bridged).

The two JSON files agree key for key: the same labels, boxes within atol
1e-5 (normalised xyxy), scores within 1e-4; ``model_info`` names each
package (``model_config``, ``device``) and its time.  The score threshold
is set between two of the run's scores, more than 1e-3 from each, so that
both packages keep the same boxes.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.models.gdino import GDinoDetector as JaxDetector
from inklayer_tpu.pipeline import mmdet_route as J
from inklayer_tpu_torch.models.gdino import GDinoDetector
from inklayer_tpu_torch.pipeline import mmdet_route as T
from tests.test_gdino import TINY
from tests.test_torch_gdino import gdino_pair


class FakeDetector:
    device = torch.device("cpu")

    def detect(self, image, caption=None, box_threshold=None):
        assert caption == "dog . cat"
        assert box_threshold == 0.3
        assert isinstance(image, torch.Tensor) and image.shape == (40, 80, 3)
        return {
            "boxes": np.asarray([[0.5, 0.5, 0.2, 0.4],
                                 [0.25, 0.25, 0.1, 0.1]]),
            "scores": np.asarray([0.9, 0.4]),
            "labels": ["dog", "cat"],
        }


def test_match_noun():
    assert T._match_noun("dog", ["dog", "cat"]) == "dog"
    assert T._match_noun("the big dog", ["dog", "cat"]) == "dog"
    assert T._match_noun("", ["dog"]) == "unknown"
    assert T._match_noun("zebra", ["dog", "cat"]) == "unknown"
    for phrase in ("cat dog", "big", "hot dog", "DOG"):
        nouns = ["dog", "cat", "hot dog", "big cat"]
        assert T._match_noun(phrase, nouns) == J._match_noun(phrase, nouns)


def test_run_writes_mmdet_contract(tmp_path):
    img_path = str(tmp_path / "sketch.png")
    Image.fromarray(np.full((40, 80, 3), 255, np.uint8)).save(img_path)
    out = T.run_ft_dino_inference_on_image(
        FakeDetector(), img_path, ["dog", "cat"], str(tmp_path / "mmdet_out"),
        score_threshold=0.3)
    json_path = tmp_path / "mmdet_out" / "sketch.json"
    assert json_path.exists()
    assert (tmp_path / "mmdet_out" / "input_image.png").exists()
    assert (tmp_path / "mmdet_out" / "pred.png").exists()
    data = json.loads(json_path.read_text())
    assert data["labels"] == ["dog", "cat"]
    np.testing.assert_allclose(data["bboxes"][0], [0.4, 0.3, 0.6, 0.7],
                               atol=1e-9)
    assert data["model_info"]["score_threshold"] == 0.3
    assert data["model_info"]["model_config"] == \
        "inklayer_tpu_torch.GDinoConfig"
    assert data["model_info"]["device"] == "cpu"
    assert out["scores"] == [0.9, 0.4]


def test_pipeline_prefers_mmdet_json():
    # the preference half lives in the runner (bbox_filter.py:40-45)
    import inspect

    from inklayer_tpu_torch.pipeline import runner

    assert "mmdet_out" in inspect.getsource(runner.InkLayerPipeline.run)


@pytest.fixture(scope="module")
def detectors():
    _, params, tm = gdino_pair()
    return JaxDetector(params, TINY), GDinoDetector(tm)


def test_json_matches_jax_producer(detectors, tmp_path, monkeypatch):
    jd, td = detectors
    import inklayer_tpu_torch.build as build

    built = []  # main's detector: the tiny one, on the device --cpu names
    monkeypatch.setattr(build, "build_detector", lambda cfg, device, dtype,
                        **kw: built.append((device, dtype)) or td)
    img_path = str(tmp_path / "scene.png")
    rng = np.random.default_rng(8)
    Image.fromarray((rng.random((90, 120, 3)) * 255).astype(np.uint8)).save(
        img_path)
    nouns = ["dog", "cat"]
    probe = T.run_ft_dino_inference_on_image(
        td, img_path, nouns, str(tmp_path / "probe"), score_threshold=0.0)
    scores = np.sort(probe["scores"])
    i = int(np.argmax(np.diff(scores)))  # the widest gap between scores
    thr = float((scores[i] + scores[i + 1]) / 2)
    assert np.abs(scores - thr).min() > 1e-3
    want = J.run_ft_dino_inference_on_image(
        jd, img_path, nouns, str(tmp_path / "jax"), score_threshold=thr)
    T.main(["--img", img_path, "--nouns", *nouns, "--out_dir",
            str(tmp_path / "cli"), "--score_threshold", str(thr), "--cpu"])
    got = T.run_ft_dino_inference_on_image(
        td, img_path, nouns, str(tmp_path / "port"), score_threshold=thr)
    for d in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "input_image.png", "pred.png", "scene.json"]
    on_disk = json.loads((tmp_path / "port" / "scene.json").read_text())
    assert on_disk == json.loads(json.dumps(got))
    assert set(got) == set(want) == {"bboxes", "labels", "scores",
                                     "model_info"}
    assert set(got["model_info"]) == set(want["model_info"])
    assert got["model_info"]["device"] == "cpu"
    assert 0 < len(got["bboxes"]) < len(probe["bboxes"])
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    assert sorted(os.listdir(tmp_path / "cli")) == [
        "input_image.png", "pred.png", "scene.json"]
    assert built == [("cpu", torch.float32)]
