#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inklayer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile the hand-written kernels (csrc/*.cu, nvcc, sm_90a);
2. kernels — each kernel against its plain PyTorch version at the shapes
             of the detect+segment path, inputs seeded random bf16, the
             plain version in fp32 on the card (TF32 off), tolerances
             stated below; median times from CUDA events;
3. slice   — the full-width slice (GroundingDINO SwinT-OGC at the 800^2
             bucket + SAM ViT-H at 1024^2, seeded placeholder weights, bf16)
             through ``build_pipeline`` / ``InkLayerPipeline.run`` on a
             750x750 sketch drawn here: one warm-up, then timed runs; every
             kernel's launch counter is reset before each run and checked
             after it; then one traced run (device busy time, idle share,
             the kernels with the most device time);
4. reference — the same modules at full width but cut depth, on the card in
             bf16 (kernels) against the CPU in fp32 (plain versions), on
             the same sketch: relative error of the SAM embedding, the SAM
             low-res logits and the GDINO encoder memory.

The line before the last is one JSON object with each kernel's route,
source, the TPU kernel it replaces, launches in the last slice run, error
and times; the last line is the device record.  Exits non-zero without a
card, and when run outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
TIMED_RUNS = 3
ITERS = 20

# kernel name -> (route, source, TPU kernel it replaces)
KERNELS = {
    "relpos_attention": (
        "cuda", "inklayer_tpu_torch/csrc/relpos_attention.cu",
        "inklayer_tpu/ops/attention.py:589 sam_window_block_attention + "
        "inklayer_tpu/ops/attention.py:334 sam_global_attention2"),
    "mlp_gelu": (
        "cuda", "inklayer_tpu_torch/csrc/linear_bias_act.cu",
        "inklayer_tpu/ops/mlp.py:95 mlp_gelu"),
    "layernorm": (
        "cuda", "inklayer_tpu_torch/csrc/layernorm.cu",
        "inklayer_tpu/ops/norm.py:80 layernorm_2d + "
        "inklayer_tpu/ops/norm.py:34 layernorm_residual_2d"),
    "ms_deform_attn": (
        "cuda", "inklayer_tpu_torch/csrc/ms_deform_attn.cu",
        "inklayer_tpu/ops/deformable.py:841 _ms_deform_attn_pallas_tiled + "
        "inklayer_tpu/ops/deformable.py:371 _ms_deform_attn_pallas_fused"),
}
# launches of each kernel in one detect+segment run of the full model
EXPECTED_LAUNCHES = {"relpos_attention": 32, "mlp_gelu": 32,
                     "ms_deform_attn": 12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def draw_sketch(path: str, size: int = 750) -> None:
    """Deterministic line sketch: boxes, a shaded block, a diagonal."""
    from PIL import Image

    g = np.full((size, size, 3), 255, np.uint8)
    for (y0, x0, y1, x1, v) in ((60, 60, 360, 380, 0), (420, 300, 700, 690, 20),
                                (100, 480, 300, 700, 40)):
        g[y0:y1, x0:x0 + 6] = v
        g[y0:y1, x1 - 6:x1] = v
        g[y0:y0 + 6, x0:x1] = v
        g[y1 - 6:y1, x0:x1] = v
    g[520:620, 80:220] = 90
    for i in range(300):
        g[400 + i // 2: 404 + i // 2, 40 + i: 44 + i] = 0
    Image.fromarray(g).save(path)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _check(name, got, ref, atol, rtol) -> float:
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    max_abs = float(err.max())
    if not bool(torch.isfinite(got).all()) or \
            bool((err > atol + rtol * ref.abs()).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max_abs_err "
            f"{max_abs:.3e} (atol {atol}, rtol {rtol})")
    return max_abs


def _kernel_case(results, kernel, case, fn, plain, args, atol, rtol):
    """fn(*args) (the kernel, bf16 inputs) against plain(*args in fp32);
    times the kernel, the plain version on the same inputs, and the plain
    version in fp32."""
    f32 = [t.float() for t in args]
    got, ref = fn(*args), plain(*f32)
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    err = max(_check(kernel, g, r, atol, rtol) for g, r in pairs)
    ms = cuda_median_ms(lambda: fn(*args))
    plain_ms = cuda_median_ms(lambda: plain(*args))
    plain32_ms = cuda_median_ms(lambda: plain(*f32))
    results.setdefault(kernel, []).append(
        {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(f"  {kernel:17s} {case:30s} max_abs_err {err:.3e}  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  plain(fp32) {plain32_ms:.4f} ms")


def phase_kernels(results: dict) -> None:
    import torch

    from inklayer_tpu_torch.ops import attention, deformable, mlp, norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)

    # relpos attention: SAM ViT-H windows (25 windows x 16 heads, 14x14) and
    # global (16 heads, 64x64); head_dim 80.  Tolerance: bf16 output and
    # bf16 probabilities in PV -> atol 2e-2, rtol 2e-2.
    scale = 80 ** -0.5
    for case, bh, kh in (("windows (400,196,80) kh=kw=14", 400, 14),
                         ("global (16,4096,80) kh=kw=64", 16, 64)):
        n = kh * kh
        _kernel_case(
            results, "relpos_attention", case,
            lambda *a: attention.relpos_attention(*a, scale),
            lambda *a: attention.relpos_attention_plain(*a, scale),
            [randn(bh, n, 80), randn(bh, n, 80), randn(bh, n, 80),
             randn(bh, n, kh), randn(bh, n, kh)], 2e-2, 2e-2)

    # fused MLP at SAM ViT-H: T=4096, C=1280, H=5120, weights ~ 1/sqrt(fan_in).
    # Tolerance: the hidden activation is rounded to bf16 (as on the TPU)
    # and the output is bf16 -> atol 2e-2, rtol 2e-2.
    _kernel_case(
        results, "mlp_gelu", "(4096,1280)->(5120)->(1280)", mlp.mlp_gelu,
        mlp.mlp_gelu_plain,
        [randn(4096, 1280), randn(5120, 1280, std=1280 ** -0.5),
         randn(5120, std=0.1), randn(1280, 5120, std=5120 ** -0.5),
         randn(1280, std=0.1)], 2e-2, 2e-2)

    # LayerNorm: SAM (4096, 1280) with and without the residual, Swin stage-0
    # (40000, 96).  Tolerance: fp32 statistics, bf16 outputs -> 2e-2 / 2e-2.
    for case, rows, c, res in (("(4096,1280)", 4096, 1280, False),
                               ("(4096,1280) + residual", 4096, 1280, True),
                               ("(40000,96)", 40000, 96, False)):
        params = [1.0 + randn(c, std=0.1), randn(c, std=0.1)]
        if res:
            _kernel_case(results, "layernorm", case, norm.layernorm_residual_2d,
                         norm.layernorm_residual_2d_plain,
                         [randn(rows, c), randn(rows, c)] + params, 2e-2, 2e-2)
        else:
            _kernel_case(results, "layernorm", case, norm.layernorm_2d,
                         norm.layernorm_2d_plain, [randn(rows, c)] + params,
                         2e-2, 2e-2)

    # MSDA at the GDINO 800^2 bucket: levels 100^2, 50^2, 25^2, 13^2, 8 heads
    # x 32, 4 levels x 4 points; locations in [-0.1, 1.1] (some corners
    # outside), softmax weights (both fp32, as the module makes them).
    # Tolerance: bf16 values, fp32 sums, bf16 output -> atol 1e-2, rtol 2e-2.
    shapes = ((100, 100), (50, 50), (25, 25), (13, 13))
    s_tot = sum(h * w for h, w in shapes)
    value = randn(1, s_tot, 8, 32)
    for case, lq in (("encoder Lq=13294", s_tot), ("decoder Lq=900", 900)):
        loc = (torch.rand(1, lq, 8, 4, 4, 2, generator=gen, device=dev)
               * 1.2 - 0.1)
        att = torch.softmax(torch.randn(1, lq, 8, 16, generator=gen,
                                        device=dev), -1).reshape(1, lq, 8, 4, 4)
        _kernel_case(
            results, "ms_deform_attn", case,
            lambda v: deformable.ms_deform_attn(v, shapes, loc, att),
            lambda v: deformable.ms_deform_attn_plain(v, shapes, loc, att),
            [value], 1e-2, 2e-2)


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


def phase_slice(card: str) -> dict:
    import torch
    from PIL import Image

    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.profiling import device_profile

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, gdino=dataclasses.replace(cfg.gdino, box_threshold=0.0))
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"  build_pipeline {time.perf_counter() - t0:.1f} s")

    captured = {}
    pipe.detector.model.register_forward_hook(
        lambda m, i, o: captured.__setitem__("logits", o[0]))
    pipe.sam.model.image_encoder.register_forward_hook(
        lambda m, i, o: captured.__setitem__("embedding", o))

    sketch = os.path.join(WORK, "sketch750.png")
    draw_sketch(sketch)
    out_base = os.path.join(WORK, "out")
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_RUNS):
        captured.clear()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out_dir = pipe.run(sketch, out_base)
        total = time.perf_counter() - t0
        counts = _kernels.launch_counts()
        for name, want in EXPECTED_LAUNCHES.items():
            if counts[name] != want:
                raise AssertionError(f"run {i}: {name} launched "
                                     f"{counts[name]} times, expected {want}")
        if counts["layernorm"] <= 0:
            raise AssertionError(f"run {i}: layernorm kernel never launched")
        for item in ("input.png", "bboxes.json", "bboxes.png", "masks",
                     "segmented_sketch.png"):
            if not os.path.exists(os.path.join(out_dir, item)):
                raise AssertionError(f"missing output {item}")
        for key in ("logits", "embedding"):
            t = captured[key]
            finite = torch.isfinite(t.float())
            if key == "logits":  # padded text positions are -inf by design
                finite = finite | torch.isneginf(t.float())
            if not bool(finite.all()):
                raise AssertionError(f"non-finite {key}")
        if tuple(captured["embedding"].shape) != (1, 64, 64, 256):
            raise AssertionError(f"embedding {tuple(captured['embedding'].shape)}")
        names = sorted(os.listdir(os.path.join(out_dir, "masks")))
        masks = np.stack([np.asarray(Image.open(
            os.path.join(out_dir, "masks", n)).convert("L")) > 127
            for n in names])
        if masks.shape != (64, 750, 750):
            raise AssertionError(f"mask stack {masks.shape}")
        with open(os.path.join(out_dir, "bboxes.json")) as f:
            if len(json.load(f)["bboxes"]) != 64:
                raise AssertionError("bboxes.json does not hold 64 boxes")
        runs.append({"total": total * 1e3, "counts": counts,
                     **{k: v * 1e3 for k, v in pipe.stage_times.items()}})
        log(f"  run {i}{' (warm-up)' if i == 0 else ''}: total {total * 1e3:.1f}"
            f" ms, detect {pipe.stage_times['detect'] * 1e3:.1f} ms, segment "
            f"{pipe.stage_times['segment'] * 1e3:.1f} ms, launches {counts}")
    timed = runs[1:]
    p50 = {k: statistics.median(r[k] for r in timed)
           for k in ("detect", "segment", "total")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  slice p50 over {len(timed)} warm runs [{card}]: detect "
        f"{p50['detect']:.1f} ms, segment {p50['segment']:.1f} ms, whole run "
        f"{p50['total']:.1f} ms; peak memory allocated {peak:.2f} GiB")
    log(f"  stage p50: " + ", ".join(
        f"{k} {statistics.median(r[k] for r in timed):.1f} ms"
        for k in timed[-1] if k not in ("total", "counts")))

    # one more run, traced: where the device time goes (not timed above)
    prof = device_profile(lambda: pipe.run(sketch, out_base))
    log(f"  traced run [{card}]: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; "
        f"stages " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                               for k, v in pipe.stage_times.items()))
    for name, ms, calls in prof["kernels"]:
        log(f"    {ms:8.3f} ms  {calls:5d} x  {name[:90]}")
    return {"p50_ms": p50, "peak_gib": peak, "launches": timed[-1]["counts"]}


# ---------------------------------------------------------------------------
# phase 4: cut-depth reference, card (bf16, kernels) vs CPU (fp32, plain)
# ---------------------------------------------------------------------------


def phase_reference() -> dict:
    import torch
    from PIL import Image

    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch.build import build_detector, build_sam

    base = PipelineConfig()
    cfg = dataclasses.replace(
        base,
        sam=dataclasses.replace(base.sam, encoder_depth=2,
                                encoder_global_attn_indexes=(1,)),
        gdino=dataclasses.replace(base.gdino, enc_layers=1, dec_layers=1))
    image = torch.from_numpy(np.array(Image.open(
        os.path.join(WORK, "sketch750.png")).convert("RGB")))
    boxes = torch.tensor([[40.0, 40.0, 500.0, 520.0], [300.0, 200.0, 1000.0,
                                                       900.0]])
    out = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        sam = build_sam(cfg, dev, dtype, seed=0)
        state = sam.compute_image_state(image.to(dev))
        low, _ = sam.decode_lowres_state(state, boxes.to(dev))
        det = build_detector(cfg, dev, dtype, seed=0)
        enc = det.model.transformer.encoder.layers[-1]
        mem = {}
        hook = enc.register_forward_hook(lambda m, i, o: mem.__setitem__("m", o))
        det.detect(image.to(dev))
        hook.remove()
        out[dev] = {"sam_embedding": state["embedding"].float().cpu(),
                    "sam_lowres_logits": low.float().cpu(),
                    "gdino_encoder_memory": mem["m"].float().cpu()}
        del sam, det
    rel = {}
    for key in out["cpu"]:
        a, b = out["cuda"][key], out["cpu"][key]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"reference: non-finite {key} on the card")
        rel[key] = float((a - b).norm() / b.norm())
        log(f"  {key:22s} relative error (card bf16 vs CPU fp32) "
            f"{rel[key]:.3e}")
        # bf16 activations through cut-depth stacks: 5% relative
        if rel[key] > 0.05:
            raise AssertionError(f"reference: {key} off by {rel[key]:.3e}")
    return rel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, REPO)
    import inklayer_tpu_torch  # noqa: F401  (fails outside a checkout)
    from inklayer_tpu_torch import _kernels

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}")
    os.makedirs(WORK, exist_ok=True)

    log("phase 1: build")
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    log(f"  {os.path.relpath(path, REPO)} ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{'not run: reused' if _kernels.build_seconds is None else f'{_kernels.build_seconds:.1f} s'})")

    log(f"phase 2: kernels vs plain versions [{card}]")
    results = {}
    phase_kernels(results)

    log(f"phase 3: detect+segment slice at full width [{card}]")
    slice_res = phase_slice(card)

    log("phase 4: cut-depth reference, card bf16 vs CPU fp32")
    phase_reference()

    line = {"kernels": []}
    for name, (route, source, replaces) in KERNELS.items():
        cases = results[name]
        line["kernels"].append({
            # ms / plain_ms: sums of the phase-2 medians over the cases
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": slice_res["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases)})
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
