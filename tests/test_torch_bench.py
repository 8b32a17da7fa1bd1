"""The port's bench (``inklayer_tpu_torch.bench``) on the CPU.

* the JAX bench's schema checks (tests/test_bench_schema.py), run against
  the port; the weather cases are one parametrised test;
* detect+segment parity: the root ``bench.py``'s own ``build_workload``
  (JAX, its configs monkeypatched to a narrow GroundingDINO and a narrow,
  shallow SAM at 1024^2, which bench.py hard-codes; its ``DATA`` pointed
  at a seeded 600 x 900 sketch) against the port's ``build_workload`` at
  the same configs and sketch, both fp32.  With the bench's own constant
  0.01 weights the two return the same scalar, to 1e-3 relative (each
  sums ~1M fp32 mask logits in its own order).  Constant weights tie every
  proposal and make SAM's embedding independent of the image, so the
  chain itself is held with seeded random weights given to both sides'
  detect+segment functions (the port's through the parameter bridge): the
  top-16 scores, their xyxy boxes in SAM's 1024 space, each box's
  mask logits and IoU, box by box (each of the port's boxes paired with the
  nearest JAX box, so that scores a few ulps apart may swap places), to
  1e-4 relative (plus 1e-4 of each quantity's largest magnitude, for
  values near 0);
* ``main()`` in-process on the CPU at narrow configs; the CPU's name; the
  seeded throughput sketches; ``entry()``'s shapes.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import inklayer_tpu.config as J
import inklayer_tpu.models.gdino.gdino as jax_gdino
import inklayer_tpu.models.sam as jax_sam
from inklayer_tpu_torch import bench
from inklayer_tpu_torch import config as T
from inklayer_tpu.io.weights import GDINO_RULES, SAM_RULES
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from inklayer_tpu_torch.profiling import cpu_model

_ROOT_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
REL_TOL = 1e-4

REQUIRED_FIELDS = (
    "e2e_full_pipeline_p50_ms", "e2e_full_pipeline_min_ms", "e2e_iters",
    "e2e_sketches_per_sec_per_chip", "e2e_sweep_sketches_per_sec_per_chip",
    "e2e_sweep_best_sketches_per_sec_per_chip", "syncs_per_img",
    "device_busy_ms_per_img", "rtt_ms", "rtt_baseline_ms", "host_load_1m",
    "weather",
)
# every key the JAX bench prints, plus the card's name and power limit
MAIN_KEYS = ("metric", "value", "unit", "vs_baseline", "weights") \
    + REQUIRED_FIELDS + (
        "cc_cap_hits_per_img_noise", "e2e_blob_probe_p50_ms",
        "device_busy_ms_per_img_blob", "cc_cap_hits_per_img_blob",
        "card", "power_limit_w")


def _gdino(cfg):
    return cfg.GDinoConfig(
        hidden_dim=32, num_queries=20, enc_layers=1, dec_layers=1,
        dim_feedforward=64, nheads=4, enc_n_points=2, dec_n_points=2,
        max_text_len=16, fusion_embed_dim=64, fusion_nheads=2,
        text_enhancer_ffn=64,
        swin=cfg.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                            num_heads=(1, 2, 2, 2), window_size=7),
        bert=cfg.BertConfig(vocab_size=30522, hidden_size=16, num_layers=1,
                            num_heads=2, intermediate_size=32))


def _sam(cfg):
    return cfg.SamConfig(
        encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
        encoder_global_attn_indexes=(1,), encoder_window_size=14,
        image_size=1024, patch_size=16, prompt_embed_dim=32)


def test_e2e_fields_schema():
    fields = bench.assemble_e2e_fields(
        times_ms=[500.0, 480.0, 510.0, 495.0, 505.0],
        sweep_ts_s=[1.9, 2.0, 1.8], n_sweep=4,
        syncs_per_img=3.0, busy_ms_per_img=174.2,
        rtt_ms=bench.RTT_BASELINE_MS)
    for key in REQUIRED_FIELDS:
        assert key in fields, key
    assert fields["e2e_iters"] == 5
    assert fields["e2e_full_pipeline_min_ms"] == 480.0
    assert fields["e2e_full_pipeline_p50_ms"] == 500.0
    assert fields["e2e_sweep_sketches_per_sec_per_chip"] == round(4 / 1.9, 3)
    assert fields["e2e_sweep_best_sketches_per_sec_per_chip"] == \
        round(4 / 1.8, 3)
    assert fields["rtt_baseline_ms"] == bench.RTT_BASELINE_MS
    assert fields["weather"] == "OK"


# (rtt as a multiple of the baseline, iteration times, host load above the
# core count, the expected flag's fragment; None: "OK")
@pytest.mark.parametrize("rtt,times,extra_load,want", [
    (2.0, [500.0, 505.0], None, "rtt"),            # round trip too high
    (0.7, [400.0, 700.0, 420.0], None, "spread"),  # >1.4x max/min
    (0.8, [480.0, 490.0, 500.0], None, None),      # a quiet capture
    (0.7, [500.0, 505.0], 2.0, "host load"),       # a busy host
    (0.7, [500.0, 505.0], -1.0, None),             # ~our own one core
], ids=["rtt_excess", "iter_spread", "quiet", "busy_host", "own_load"])
def test_weather_flag(rtt, times, extra_load, want):
    if extra_load is None:
        load = 0.0
    elif extra_load < 0:
        load = 0.9  # the bench's own ~1-core load never trips the flag
    else:
        load = float((os.cpu_count() or 1) + extra_load)
    flag = bench.weather_flag(rtt * bench.RTT_BASELINE_MS, times,
                              host_load=load)
    if want is None:
        assert flag == "OK"
    else:
        assert flag.startswith("WEATHER:") and want in flag, flag


def test_busy_none_tolerated():
    """A capture whose trace had no device track still carries the field
    (null)."""
    fields = bench.assemble_e2e_fields(
        times_ms=[500.0] * 5, sweep_ts_s=[2.0] * 3, n_sweep=4,
        syncs_per_img=3, busy_ms_per_img=None, rtt_ms=0.05)
    assert fields["device_busy_ms_per_img"] is None


def test_inpaint_and_blob_probe_fields_present():
    import inspect

    src = inspect.getsource(bench.measure_inpaint)
    assert "inpaint_ms_per_sample" in src
    assert "inpaint_batch4_scaling" in src
    src = inspect.getsource(bench._blob_probe)
    for key in ("e2e_blob_probe_p50_ms", "device_busy_ms_per_img_blob",
                "cc_cap_hits_per_img_blob"):
        assert key in src, key
    assert "measure_inpaint" in inspect.getsource(bench.main)


SKETCH_HW = (600, 900)  # not square: h and w, and both scales, differ
# seeded N(0, std) weights: at 0.1 GroundingDINO's proposal scores keep
# gaps above fp32 noise, so both sides select the same 20 queries and top
# 16; at 0.5 SAM's masks cover part of the image (tests/test_torch_sam.py)
GDINO_STD, SAM_STD = 0.1, 0.5
# the mask-prompt convnet: the port's PromptEncoder holds it, the JAX param
# tree does not; no box-prompted path runs it
MASK_PROMPT = "prompt_encoder.mask_downscaling."


def _sketch_png(tmp_path):
    img = (np.random.default_rng(7).random(SKETCH_HW + (3,)) * 255
           ).astype(np.uint8)
    path = str(tmp_path / "sketch.png")
    Image.fromarray(img).save(path)
    return img, path


def _seeded(tree, seed, std):
    """Seeded N(0, std) fp32 arrays in the shape of ``tree``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * std
                                   ).astype(np.float32), tree)


def _jax_bench(monkeypatch, sketch_path):
    """The root bench.py's build_workload at the narrow configs on the
    sketch; (its detect+segment function, params, image, the parts
    recorded through debug callbacks by the last call)."""
    gcfg, scfg = _gdino(J), _sam(J)
    monkeypatch.setattr(J, "GDinoConfig", lambda: gcfg)
    monkeypatch.setattr(J, "SamConfig", lambda: scfg)
    parts = {}
    top = jax_gdino.top_detections
    decode = jax_sam.Sam.decode_boxes

    def top_detections(logits, boxes, k):
        out = top(logits, boxes, k)
        jax.debug.callback(
            lambda s: parts.__setitem__("scores", np.asarray(s)), out[0])
        return out

    def decode_boxes(self, emb, boxes):
        m, iou = decode(self, emb, boxes)
        jax.debug.callback(lambda b, m, i: parts.update(
            boxes=np.asarray(b), masks=np.asarray(m), iou=np.asarray(i)),
            boxes, m, iou)
        return m, iou

    monkeypatch.setattr(jax_gdino, "top_detections", top_detections)
    monkeypatch.setattr(jax_sam.Sam, "decode_boxes", decode_boxes)
    spec = importlib.util.spec_from_file_location("bench_jax", _ROOT_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DATA = sketch_path
    fn, gp, sp, img = mod.build_workload()
    return fn, gp, sp, img, parts


def _port_bench(monkeypatch, img):
    fn, g, s, dev_img = bench.build_workload(_gdino(T), _sam(T), "cpu",
                                             image=img)
    parts = {}
    top = bench.top_detections
    decode = s.decode_boxes

    def top_detections(logits, boxes, k):
        out = top(logits, boxes, k)
        parts["scores"] = out[0].numpy()
        return out

    def decode_boxes(emb, boxes):
        m, iou = decode(emb, boxes)
        parts.update(boxes=boxes.numpy(), masks=m.numpy(), iou=iou.numpy())
        return m, iou

    monkeypatch.setattr(bench, "top_detections", top_detections)
    s.decode_boxes = decode_boxes
    return fn, g, s, dev_img, parts


def _load_bridged(g, s, gp, sp):
    g.load_state_dict(jax_to_torch_state_dict(
        flatten_tree(gp["params"]), GDINO_RULES), strict=True)
    sd = jax_to_torch_state_dict(flatten_tree(sp["params"]), SAM_RULES)
    sd.update({k: v for k, v in s.state_dict().items()
               if k.startswith(MASK_PROMPT)})
    s.load_state_dict(sd, strict=True)


def _close(got, want, name):
    atol = REL_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=REL_TOL, atol=atol,
                               err_msg=name)


def test_detect_segment_matches_jax_bench(monkeypatch, tmp_path):
    img, path = _sketch_png(tmp_path)
    jfn, gp, sp, jimg, want = _jax_bench(monkeypatch, path)
    np.testing.assert_array_equal(np.asarray(jimg), img)
    pfn, g, s, pimg, got = _port_bench(monkeypatch, img)

    # the bench's own workload: constant 0.01 fp32 weights on both sides
    assert all(np.all(np.asarray(a) == np.float32(0.01))
               for a in jax.tree.leaves((gp, sp)))
    assert all(p.dtype == torch.float32 and torch.all(p == 0.01)
               for m in (g, s) for p in m.parameters())
    jax_value = float(jfn(gp, sp, jimg))
    value = pfn(g, s, pimg).item()
    assert np.isfinite(value)
    np.testing.assert_allclose(value, jax_value, rtol=1e-3)

    # the chain, with seeded weights given to both functions
    gp, sp = _seeded(gp, 11, GDINO_STD), _seeded(sp, 12, SAM_STD)
    jax_value = float(jfn(gp, sp, jimg))
    jax.effects_barrier()
    _load_bridged(g, s, gp, sp)
    value = pfn(g, s, pimg).item()
    assert got["masks"].shape == want["masks"].shape == (16, 1, 256, 256)
    for side in (got, want):
        assert np.all(np.diff(side["scores"].ravel()) <= 0)  # descending
    # box by box: pair each of the port's boxes with the JAX box nearest to
    # it (scores a few ulps apart may swap places); the pairing must be
    # one to one
    dist = np.abs(got["boxes"][:, None] - want["boxes"][None]).max(-1)
    pair = dist.argmin(1)
    assert sorted(pair) == list(range(16))
    _close(got["boxes"], want["boxes"][pair], "boxes")
    _close(got["scores"][0], want["scores"][0][pair], "scores")
    _close(got["masks"], want["masks"][pair], "masks")
    _close(got["iou"], want["iou"][pair], "iou")
    b = want["boxes"]  # xyxy: corners in order
    assert np.all(b[:, 2] > b[:, 0]) and np.all(b[:, 3] > b[:, 1])
    np.testing.assert_allclose(value, jax_value, rtol=1e-3)


def _tiny_pipeline_config():
    from tests.test_pipeline import TINY_PIPE

    return T.PipelineConfig(
        gdino=_port_section(T.GDinoConfig, TINY_PIPE.gdino),
        sam=_port_section(T.SamConfig, TINY_PIPE.sam),
        depth=_port_section(T.DepthConfig, TINY_PIPE.depth),
        refine=_port_section(T.RefineConfig, TINY_PIPE.refine))


def _port_section(cls, jax_cfg):
    kw = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _port_section(getattr(T, type(v).__name__), v)
        kw[f.name] = v
    return cls(**kw)


def test_main_prints_every_key_on_the_cpu(monkeypatch, capsys):
    gcfg, scfg, pcfg = _gdino(T), _sam(T), _tiny_pipeline_config()
    monkeypatch.setattr(bench, "GDinoConfig", lambda: gcfg)
    monkeypatch.setattr(bench, "SamConfig", lambda: scfg)
    monkeypatch.setattr(bench, "PipelineConfig", lambda: pcfg)
    monkeypatch.setattr(bench, "measure_full_pipeline", functools.partial(
        bench.measure_full_pipeline, iters=1, n_sweep=2, sweeps=1))
    monkeypatch.setattr(bench, "_blob_probe",
                        functools.partial(bench._blob_probe, iters=1))
    bench.main(["--cpu", "--skip-inpaint", "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in MAIN_KEYS:
        assert key in line, key
    assert "e2e_error" not in line and "inpaint_error" not in line
    assert line["value"] > 0 and np.isfinite(line["value"])
    assert line["power_limit_w"] is None and line["card"]
    # no device track on the CPU: the busy fields are null, not host time
    assert line["device_busy_ms_per_img"] is None
    assert line["device_busy_ms_per_img_blob"] is None
    assert line["cc_cap_hits_per_img_noise"] == 0.0
    assert line["e2e_iters"] == 1


@pytest.mark.parametrize("cpuinfo,want", [
    ("processor\t: 0\nmodel name\t: Intel(R) Xeon(R) Platinum 8480+\n",
     "Intel(R) Xeon(R) Platinum 8480+"),
    ("processor\t: 0\nCPU part\t: 0xd4f\nModel name\t: Neoverse-V2\n",
     "Neoverse-V2"),
    ("processor\t: 0\nHardware\t: BCM2835\n", "BCM2835"),
    ("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
     "model\t\t: 207\nmodel name\t: unknown\n",
     "GenuineIntel family 6 model 207"),
    ("processor\t: 0\n", None),
], ids=["x86", "arm_model", "arm_hardware", "hidden_name", "no_model_line"])
def test_cpu_model_names_the_cpu(tmp_path, cpuinfo, want):
    path = tmp_path / "cpuinfo"
    path.write_text(cpuinfo)
    name = cpu_model(str(path))
    if want is not None:
        assert name == want
    assert name and name != "unknown"


def test_throughput_falls_back_to_seeded_sketches(monkeypatch, tmp_path):
    imgs = bench.load_sketches(4)
    assert len(imgs) == 4 and all(i.shape == (750, 750, 3) and
                                  i.dtype == np.uint8 for i in imgs)
    # seed 0 is the JAX bench's own fallback sketch
    np.testing.assert_array_equal(imgs[0], (np.random.default_rng(0).random(
        (750, 750, 3)) * 255).astype(np.uint8))
    assert len({i.tobytes() for i in imgs}) == 4
    # an empty data directory falls back the same way
    assert all(np.array_equal(a, b) for a, b in
               zip(bench.load_sketches(4, str(tmp_path)), imgs))
    gcfg, scfg = _gdino(T), _sam(T)
    monkeypatch.setattr(bench, "GDinoConfig", lambda: gcfg)
    monkeypatch.setattr(bench, "SamConfig", lambda: scfg)
    sps = bench.measure_throughput(batch=2, iters=1, device="cpu")
    assert sps > 0 and np.isfinite(sps)


def test_entry_shapes():
    from inklayer_tpu_torch.entry import entry

    fn, (image, boxes) = entry(device="cpu", cfg=dataclasses.replace(
        _sam(T), image_size=64))
    assert image.shape == (1, 64, 64, 3) and boxes.shape == (8, 4)
    logits, iou = fn(image, boxes)
    assert logits.shape == (8, 1, 16, 16) and iou.shape == (8, 1)
    assert torch.isfinite(logits).all() and torch.isfinite(iou).all()
    # ViT-H without running it: the example arguments, on the meta device
    _, (image, boxes) = entry(device="meta")
    assert image.shape == (1, 1024, 1024, 3) and boxes.shape == (8, 4)
