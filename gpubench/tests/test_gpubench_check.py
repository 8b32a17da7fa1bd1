"""The check that decides ``correct``: the reference against the port's
CPU path at tiny widths, the control (the reference in fp8) and the
program broken underneath a run, each failing it."""

import numpy as np
import pytest

from gpubench import calibrate
from gpubench.entries import models
from gpubench.harness import run_cell
from gpubench.traffic import Traffic


def test_reference_against_the_port(tiny_cell, cpu):
    """Same seeded weights and sketches: the port's plain CPU path and the
    reference agree to fp32 rounding, model by model."""
    _, cell = tiny_cell
    traffic = Traffic(cell.traffic, 5)
    system = models.build(cell, 5, cpu, traffic)
    sketches = traffic.request(0)
    outs = models.call(system, sketches)
    assert all("select" not in o for o in outs)  # not recorded in a call
    models.follow(system, [(0, outs)], traffic)
    assert all(len(o["select"]) == cell.config["models"]["gdino"][
        "num_queries"] and o["rerun_gap"] == 0.0 for o in outs)
    refs = models.reference_outputs(cell.config, 5,
                                    list(zip(sketches, outs)), cpu)
    for out, ref in zip(outs, refs):
        k = len(out["scores"])
        assert k == cell.config["models"]["gdino"]["max_boxes"]
        _, boxes, probs = models.top_k(ref["probs"], ref["boxes"], k, 0.0)
        assert np.sort(out["scores"]) == pytest.approx(
            np.sort(ref["probs"].max(-1))[-k:], abs=1e-5)
        np.testing.assert_allclose(out["depth"], ref["depth"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(out["iou"], ref["iou"], atol=1e-5)
        masks = models.unpack(out["masks"], out["width"])
        assert (masks != ref["masks"]).mean() < 1e-4
        assert (ref["select"] == out["select"]).all()
    found = models.readings(cell, outs, refs)
    assert max(found.values()) < 1e-4


def _b4_check(m, cell):
    """The tiny cell held to ``default.models-b4``'s check."""
    check = dict(m.cell("default.models-b4").traffic["check"])
    check["requests"] = cell.traffic["check"]["requests"]
    cell.traffic["check"] = check
    return check["limits"]


def test_control_fails(tiny_cell, cpu):
    """The reference rounded to fp8 in the program's place fails a limit of
    the cell (``default.models-b4``'s check)."""
    m, cell = tiny_cell
    limits = _b4_check(m, cell)
    for seed in (1, 2, 3):
        got = calibrate.control_readings(m, cell, seed, cpu, 2)
        assert any(got[k] > limits[k] for k in limits), (seed, got)


def test_calibration_readings(tiny_cell, cpu):
    """A program seed's calibration line: the compared numbers, the extras
    and the witnesses, each a share in [0, 1]."""
    m, cell = tiny_cell
    got = calibrate.program_readings(m, cell, 3, cpu, 2)
    for k in ("det_match_p90", "mask_sure_share", "det_select_miss",
              "det_rerun_gap", "witness_scores_bf16_miss",
              "witness_reference_bf16_miss") + tuple(
                  f"mask_sure_share.m{x:g}" for x in calibrate.MARGINS):
        assert 0.0 <= got[k] <= 1.0, (k, got)
    assert got["det_select_miss"] == 0.0 and got["det_rerun_gap"] == 0.0


def test_lost_selection_is_said(tiny_cell, cpu, monkeypatch, capsys):
    """Where the program's two-stage top-K is not seen, the outputs hold no
    selection and standard error says why."""
    _, cell = tiny_cell
    traffic = Traffic(cell.traffic, 4)
    system = models.build(cell, 4, cpu, traffic)
    outs = models.call(system, traffic.request(0))
    monkeypatch.setattr(models.SelectionRecorder, "topk",
                        lambda self, *a, **kw: models.torch.topk(*a, **kw))
    models.follow(system, [(0, outs)], traffic)
    assert all(o["select"] is None for o in outs)
    assert "two-stage top-K was not recorded" in capsys.readouterr().err


def _half_batch(monkeypatch):
    """The batched detect and encode compute the first half of the group
    and hand its results to the rest."""
    from inklayer_tpu_torch.models.gdino import GDinoDetector
    from inklayer_tpu_torch.models.sam import SamPredictor

    detect, encode = GDinoDetector.detect_batch, \
        SamPredictor.precompute_image_states

    def half(fn):
        def wrapped(self, images, *a, **kw):
            n = max(1, len(images) // 2)
            got = fn(self, images[:n], *a, **kw)
            return [got[i % n] for i in range(len(images))]
        return wrapped

    monkeypatch.setattr(GDinoDetector, "detect_batch", half(detect))
    monkeypatch.setattr(SamPredictor, "precompute_image_states",
                        half(encode))


def _altered_answer(monkeypatch):
    """A quarter of every sketch's detections moved where the detector
    makes them."""
    from inklayer_tpu_torch.models.gdino import GDinoDetector

    detect = GDinoDetector.detect_batch

    def moved(self, images, *a, **kw):
        dets = detect(self, images, *a, **kw)
        for d in dets:
            n = max(1, len(d["boxes"]) // 4)
            d["boxes"] = d["boxes"].copy()
            d["boxes"][:n, :2] = np.clip(d["boxes"][:n, :2] + 0.2, 0, 1)
        return dets

    monkeypatch.setattr(GDinoDetector, "detect_batch", moved)


def _altered_depth(monkeypatch):
    """The depth map scaled where the estimator makes it."""
    from inklayer_tpu_torch.models.depth import DepthEstimator

    infer = DepthEstimator.infer_image_device
    monkeypatch.setattr(DepthEstimator, "infer_image_device",
                        lambda self, image: infer(self, image) * 1.5 + 0.1)


def _shifted_masks(monkeypatch):
    """SAM's logits resampled to the sketch 4 pixels off to the right."""
    from inklayer_tpu_torch.models.sam import SamPredictor

    post = SamPredictor._postprocess_device_state
    monkeypatch.setattr(
        SamPredictor, "_postprocess_device_state",
        lambda self, state, low: post(self, state, low).roll(4, dims=-1))


@pytest.mark.parametrize("fault", [None, _half_batch, _altered_answer,
                                   _altered_depth, _shifted_masks])
def test_run_with_the_program_broken(fault, tiny_cell, cpu, monkeypatch):
    """A whole run on the CPU (the look for a card skipped): sound, it is
    correct; with a fault planted underneath, not."""
    m, cell = tiny_cell
    if fault is not None:
        fault(monkeypatch)
    _b4_check(m, cell)
    res = run_cell(m, cell, 2 ** 31 + 99, 3.0, False, cpu, 0.0)
    assert res["attempted"] >= 1
    assert res["correct"] is (fault is None), res["checks"]
