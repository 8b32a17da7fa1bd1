"""The inpainting cell's plain reference and check, on the CPU at tiny widths.

* The benchmark's plain fp32 reference (``gpubench/reference/diffusion``)
  against the port's CPU path with the same seeded weights: the UNet (with
  the ControlNet's residuals), the ControlNet, the VAE's encode and decode,
  the CLIP text encoder, single solver steps, and a 2-step sampler loop.
* The check of the ``inpaint`` entry (``gpubench/entries/inpaint.py``)
  passes the port at the cell's limits, and each planted fault fails its
  reading: one step's noise prediction x 1.01 (``solver_gap``), one
  timestep off by one (``ts_gap``), the mask channel shifted one latent
  pixel and the control image's masked pixels 0 instead of -1
  (``input_gap``), guidance 7 instead of 9 (``cfg_gap``), the edit
  mask's box one pixel wider (``edit_gap``).  The fp8 control in the
  program's place fails.
* The plain assembly (``prepost.assemble``, ``scipy.ndimage``) equals the
  program's, silhouette by silhouette.
* The scene gives four occluded layers on every request of the
  calibration seeds' pools (and whole-canvas hulls, which it does not
  use, would leave back layers empty); the sampler's spans count its
  bucket, and a traced request whose steps the entry cannot see fails.
"""

import copy
import os

import numpy as np
import pytest
import torch

from gpubench.entries import inpaint as E
from gpubench.manifest import ROOT, Cell, load_json
from gpubench.traffic import Traffic
from inklayer_tpu_torch.build import diffusion_modules
from inklayer_tpu_torch.models.diffusion import pipeline as P
from inklayer_tpu_torch.models.diffusion.clip_text import CLIPTokenizer
from inklayer_tpu_torch.models.diffusion.scheduler import (
    DPMSolverMultistepScheduler, solver_tables)
from gpubench.reference.diffusion import prepost as R
from inklayer_tpu_torch.pipeline.inpaint import masks as M
from inklayer_tpu_torch.pipeline.inpaint import orchestrate as O
from inklayer_tpu_torch.pipeline.inpaint.orchestrate import (
    assemble_inpaint_input, mask_to_bbox, mask_within_bbox)

CONFIG = load_json(os.path.join(ROOT, "gpubench/configs/"
                                "inklayer-inpaint-sd15.json"))
TRAFFIC = load_json(os.path.join(ROOT, "gpubench/workloads/"
                                 "inpaint.layers-b4.json"))
LIMITS = TRAFFIC["check"]["limits"]
# the seeds the cell's limits were calibrated on (gpubench.calibrate_inpaint)
CALIBRATION_SEEDS = [2 ** 31 + 11 * k for k in range(1, 13)]
SEED = 2 ** 31 + 99
CPU = torch.device("cpu")


def tiny_config() -> dict:
    cfg = copy.deepcopy(CONFIG)
    m = cfg["models"]
    for net in ("unet", "controlnet"):
        m[net].update(block_channels=[8, 16, 16, 16], context_dim=16,
                      num_heads=2)
    m["vae"].update(channels=[8, 8, 8, 8])
    m["text"].update(hidden=16, heads=1, max_len=16)
    cfg.update(resolution=64, num_steps=4)
    # the prompts steer the tiny UNet as they steer the full-width one
    # (the conditioned prediction's share of the guided one ~0.9 here,
    # 0.8 at full width; 0.008 with norm scales 1), so that a wrong
    # guidance scale shows
    cfg["norm_scale"] = {"text": 30.0}
    tok = CLIPTokenizer()
    cfg["prompt_ids"] = tok.encode(cfg["prompt"], 16)[0].tolist()
    cfg["negative_ids"] = tok.encode(cfg["negative_prompt"], 16)[0].tolist()
    return cfg


TINY = tiny_config()


def tiny_cell(config=TINY) -> Cell:
    traffic = copy.deepcopy(TRAFFIC)
    traffic.update(sketch_hw=[160, 160], pool=8)
    return Cell(name="tiny.inpaint", chips=1, config=config,
                config_entry={"name": "inklayer-inpaint-sd15"},
                traffic=traffic, end_to_end=[], per_layer=[])


def models(name, cfg=TINY):
    """(the port's module, the reference's) with the same seeded
    weights."""
    state = E.seeded_state(cfg, name, SEED, CPU, torch.float32)
    prog = diffusion_modules(E.diffusion_config(cfg))[name]()
    prog.load_state_dict(state, strict=True)
    ref = E.reference_model(cfg, name, SEED, CPU)
    return prog.eval(), ref.eval()


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def run():
    """The port at tiny widths: one request of the tiny cell, its traffic
    and the system."""
    cell = tiny_cell()
    traffic = Traffic(cell.traffic, SEED)
    system = E.build(cell, SEED, CPU, traffic)
    out = E.call(system, traffic.request(0))[0]
    return cell, traffic, system, out


def test_prompt_ids_are_the_programs_tokens():
    tok = CLIPTokenizer()
    assert CONFIG["prompt_ids"] == tok.encode(CONFIG["prompt"], 77)[0].tolist()
    assert CONFIG["negative_ids"] == tok.encode(CONFIG["negative_prompt"],
                                                77)[0].tolist()


@torch.no_grad()
@pytest.mark.parametrize("name", ["text", "unet", "controlnet", "vae"])
def test_reference_equals_the_port(name):
    prog, ref = models(name)
    g = torch.Generator().manual_seed(0)
    if name == "text":
        ids = torch.tensor([TINY["prompt_ids"], TINY["negative_ids"]])
        assert rel(prog(ids), ref(ids)) < 1e-5
        return
    if name == "vae":
        x = torch.rand((2, 3, 64, 64), generator=g) * 2 - 1
        assert rel(prog.encode(x), ref.encode(x)) < 1e-5
        z = torch.randn((2, 4, 8, 8), generator=g)
        assert rel(prog.decode(z), ref.decode(z)) < 1e-5
        return
    t = torch.tensor([981, 21])
    ctx = torch.randn((2, 16, 16), generator=g)
    if name == "controlnet":
        x = torch.randn((2, 4, 8, 8), generator=g)
        image = torch.rand((2, 3, 64, 64), generator=g)
        pd, pm = prog(x, t, ctx, image, conditioning_scale=1.2)
        rd, rm = ref(x, t, ctx, image, 1.2)
        assert len(pd) == len(rd) == 12
        assert max(rel(a, b) for a, b in zip(pd, rd)) < 1e-5
        assert rel(pm, rm) < 1e-5
        return
    x = torch.randn((2, 9, 8, 8), generator=g)
    cnet = models("controlnet")[1]
    down, mid = cnet(x[:, :4], t, ctx, torch.rand((2, 3, 64, 64),
                                                   generator=g), 1.2)
    assert rel(prog(x, t, ctx, down_residuals=down, mid_residual=mid),
               ref(x, t, ctx, down, mid)) < 1e-5


@pytest.mark.parametrize("step", [0, 1, 15, 29])
def test_reference_solver_step(step):
    ts, a, s, c_s, c_x0, c_d = solver_tables(DPMSolverMultistepScheduler(), 30)
    sched = E.schedule(CONFIG)
    assert (sched.timesteps == ts).all()
    rng = np.random.default_rng(step)
    x, eps, x0_prev = rng.standard_normal((3, 64))
    prog_x0 = (x - s[step] * eps) / a[step]
    prog = c_s[step] * x + c_x0[step] * prog_x0 \
        + c_d[step] * (prog_x0 - x0_prev)
    want, x0 = sched.step(step, x, eps, None if step == 0 else x0_prev)
    np.testing.assert_allclose(x0, prog_x0, rtol=1e-6)
    assert np.linalg.norm(prog - want) / np.linalg.norm(want) < 1e-6


def test_reference_two_step_loop(run):
    """The port's sampler and the reference's over the same two layers,
    two steps, the same noise."""
    cell, traffic, system, out = run
    cfg = dict(TINY, num_steps=2)
    pipe = P.ControlNetInpaintPipeline(
        {k: getattr(system.pipe, a) for k, a in (
            ("text", "text_encoder"), ("unet", "unet"),
            ("controlnet", "controlnet"), ("vae", "vae"))},
        E.diffusion_config(cfg))
    pairs = [(layer, edit) for _, layer, edit in out["inputs"][:2]]
    from PIL import Image
    from inklayer_tpu_torch.pipeline.inpaint.prepost import (
        preprocess_image, preprocess_mask)
    pipe.record = rec = []
    pipe.generate_batch(
        [preprocess_image(Image.fromarray(a)) for a, _ in pairs],
        [preprocess_mask(Image.fromarray(b.astype(np.uint8) * 255))
         for _, b in pairs])
    got = rec[0]
    want = E.reference_sample(cfg, SEED, pairs, CPU)
    assert [int(t[0]) for t in got["t"]] == [int(t[0]) for t in want["t"]]
    for a, b in zip(got["latents"], want["latents"]):
        assert rel(a[:2], b) < 1e-5
    assert rel(got["image"][:2], want["image"]) < 1e-5


def test_check_passes_the_port(run):
    cell, traffic, system, out = run
    got = E.readings(cell.config, SEED, 0, out, CPU)
    for k, limit in LIMITS.items():
        assert got[k] <= limit, (k, got[k], limit)


def _faulty(cell, traffic, monkeypatch, **patches):
    system = E.build(cell, SEED, CPU, traffic)
    for name, value in patches.items():
        monkeypatch.setattr(P, name, value)
    return E.call(system, traffic.request(0))[0]


class _ShiftedMask:
    """Stands in for ``torch.nn.functional`` in the pipeline module: the
    mask's resize to the latent grid comes out one pixel to the right."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def interpolate(x, *args, **kwargs):
        return torch.roll(torch.nn.functional.interpolate(x, *args, **kwargs),
                          1, dims=-1)


def _zero_control(image, mask):
    """The control image with masked pixels 0 instead of -1."""
    img = np.asarray(image.convert("RGB"), np.float32) / 255.0
    msk = np.asarray(mask.convert("L"), np.float32) / 255.0
    img = img.copy()
    img[msk > 0.5] = 0.0
    return img


def _tables_off_by_one(sched, steps):
    ts, *rest = solver_tables(sched, steps)
    ts = ts.copy()
    ts[1] += 1
    return (ts, *rest)


def _wide_box(mask, bbox):
    """``mask_within_bbox`` keeping the box's last row and column."""
    x1, y1, x2, y2 = bbox
    return mask_within_bbox(mask, (x1, y1, x2 + 1, y2 + 1))


@pytest.mark.parametrize("fault,reading", [
    ("eps", "solver_gap"),
    ("timestep", "ts_gap"),
    ("mask_shift", "input_gap"),
    ("control_zero", "input_gap"),
    ("cfg7", "cfg_gap"),
    ("box", "edit_gap"),
])
def test_planted_fault_fails_its_reading(run, monkeypatch, fault, reading):
    cell, traffic, system, out = run
    if fault == "box":
        monkeypatch.setattr(O, "mask_within_bbox", _wide_box)
        out = E.call(system, traffic.request(0))[0]
    elif fault == "eps":
        out = copy.copy(out)
        rec = dict(out["state"][0])
        rec["eps"] = list(rec["eps"])
        rec["eps"][2] = rec["eps"][2] * 1.01
        out["state"] = [rec]
    elif fault == "timestep":
        out = _faulty(cell, traffic, monkeypatch,
                      solver_tables=_tables_off_by_one)
    elif fault == "mask_shift":
        out = _faulty(cell, traffic, monkeypatch, F=_ShiftedMask())
    elif fault == "control_zero":
        out = _faulty(cell, traffic, monkeypatch,
                      make_inpaint_condition=_zero_control)
    else:
        out = _faulty(tiny_cell(dict(TINY, guidance_scale=7.0)), traffic,
                      monkeypatch)
    got = E.readings(cell.config, SEED, 0, out, CPU)
    assert got[reading] > LIMITS[reading], (fault, got)


def test_fp8_control_fails(run):
    cell, traffic, system, out = run
    ctl = E.control_output(cell.config, SEED, traffic, 0, CPU)
    got = E.readings(cell.config, SEED, 0, ctl, CPU)
    assert any(got[k] > limit for k, limit in LIMITS.items()), got


@pytest.mark.parametrize("seed", CALIBRATION_SEEDS)
def test_scene_occludes_four_layers(seed):
    """Every request of the pool: five non-empty masks, and each back
    layer has a pixel inside an earlier layer's box, so the program's
    assembly inpaints it (``assemble_inpaint_input``'s overlap rule)."""
    traffic = Traffic(TRAFFIC, seed)
    for r in range(traffic.pool_size // traffic.batch):
        masks, sketch = E.scene(traffic.request(r), seed, TRAFFIC["scene"])
        assert len(masks) == 5 and sketch.shape == (750, 750, 3)
        assert all(m.any() for m in masks)
        for i in range(1, 5):
            assert any(mask_within_bbox(masks[i], mask_to_bbox(masks[k]))
                       .any() for k in range(i)), (r, i)


def test_whole_canvas_hulls_leave_back_layers_empty():
    """Why the scene crops each sketch into a quadrant: with each back
    layer's region the hull of its strokes over the whole canvas, the
    first hulls cover most of it, and a later layer's region (its hull
    less every region in front) comes out empty on some requests."""
    seed = CALIBRATION_SEEDS[0]
    traffic = Traffic(TRAFFIC, seed)
    empty = 0
    for r in range(traffic.pool_size // traffic.batch):
        masks, _ = E.scene(traffic.request(r), seed, TRAFFIC["scene"])
        front = masks[0].copy()
        for sk in traffic.request(r):
            region = E.filled_hull(E._ink(sk)) & ~front
            empty += not region.any()
            front |= region
    assert empty > 0


@pytest.mark.parametrize("shape", ["ellipse", "ring", "border", "blobs"])
def test_reference_silhouette_equals_the_programs(shape):
    """``prepost.silhouette`` against the program's ``get_mask`` with the
    assembly's parameters: closed shapes (shrunk), one with a hole, one
    that reaches the border band (the open-curve rule), two components."""
    yy, xx = np.mgrid[:120, :160]
    disc = (((yy - 60) / 35.0) ** 2 + ((xx - 80) / 50.0) ** 2) <= 1
    region = {"ellipse": disc,
              "ring": disc & ((((yy - 60) / 15.0) ** 2
                               + ((xx - 80) / 20.0) ** 2) > 1),
              "border": (yy < 40) & (xx > 20),
              "blobs": ((yy - 30) ** 2 + (xx - 30) ** 2 < 200)
              | ((yy - 80) ** 2 + (xx - 120) ** 2 < 500)}[shape]
    want = M.get_mask(np.where(region, 0, 255).astype(np.uint8),
                      dilate_iter=10, kernel_size=5, safety_margin=1,
                      stroke_thick=2, border_band=3)[0]
    assert np.array_equal(R.silhouette(region), want)


def test_reference_assembly_equals_the_programs(run):
    cell, traffic, system, out = run
    masks, sketch = E.scene(traffic.request(3), SEED, cell.traffic["scene"])
    seen = {}
    for i, (layer, edit, need) in enumerate(R.assemble(masks, sketch)):
        p_edit, p_layer, _, p_need, _ = assemble_inpaint_input(
            masks, i, sketch, seen)
        assert need == p_need and np.array_equal(layer, p_layer)
        assert not need or np.array_equal(edit, p_edit)


def test_assembly_shares_each_occluders_silhouette(run):
    """``complete`` computes each occluder's silhouette once per sketch;
    the layers come out as with one computation per layer."""
    cell, traffic, system, out = run
    masks, sketch = E.scene(traffic.request(2), SEED, cell.traffic["scene"])
    seen = {}
    for i in range(len(masks)):
        shared = assemble_inpaint_input(masks, i, sketch, seen)
        alone = assemble_inpaint_input(masks, i, sketch)
        for a, b in zip(shared, alone):
            assert (a is None and b is None) or np.array_equal(a, b)
    assert list(seen) == [0]


def test_set_up_request_warms_with_few_steps(run):
    """A set-up request (sketches outside the pool) runs the sampler at
    ``WARMUP_STEPS`` steps over the same bucket and returns no unit."""
    from torch.profiler import ProfilerActivity, profile

    from inklayer_tpu_torch import spans

    cell, traffic, system, out = run
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        assert E.call(system, traffic.warmup(0)) == []
    recs = spans.take()
    assert [r.counts for r in recs if r.name == "inpaint.loop"] == [
        {"layers": 4, "slots": 4}]
    assert sum(r.name == "inpaint.step" for r in recs) == E.WARMUP_STEPS
    assert system.pipe.cfg.num_steps == TINY["num_steps"]


def test_sampler_spans_count_the_bucket(run):
    from torch.profiler import ProfilerActivity, profile

    from inklayer_tpu_torch import spans

    cell, traffic, system, out = run
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        E.call(system, traffic.request(1))
    recs = spans.take()
    loops = [r.counts for r in recs if r.name == "inpaint.loop"]
    steps = [r.counts for r in recs if r.name == "inpaint.step"]
    assert loops == [{"layers": 4, "slots": 4}]
    assert steps == [{"samples": 8}] * TINY["num_steps"]
    assert sum(r.name == "inpaint.inpaint" for r in recs) == 1
    # the image's read back to the host waits on the card
    assert any(r.name == "wait" for r in recs)


def test_traced_request_fails_where_its_steps_are_not_seen(run,
                                                          monkeypatch):
    """A program whose solver steps no longer open their span through the
    pipeline module's ``span`` leaves ``step_device_ms`` nothing to read:
    a traced request then fails rather than going silent."""
    from torch.profiler import ProfilerActivity, profile

    from inklayer_tpu_torch import spans

    cell, traffic, system, out = run
    sample = P.ControlNetInpaintPipeline._sample_batch

    def unseen(self, *args, **kwargs):
        wrapped, P.span = P.span, spans.span
        try:
            return sample(self, *args, **kwargs)
        finally:
            P.span = wrapped

    monkeypatch.setattr(P.ControlNetInpaintPipeline, "_sample_batch", unseen)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="inpaint.step"):
            E.call(system, traffic.request(1))
    spans.take()
