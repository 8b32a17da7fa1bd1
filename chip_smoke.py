#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inklayer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile the hand-written kernels (csrc/*.cu, one nvcc per
             source, all started together, sm_90a);
2. kernels — each kernel against its plain PyTorch version at the shapes
             of the default run, inputs seeded random bf16 with the plain
             version in fp32 on the card (TF32 off), tolerances stated
             below; the connected-components kernels on a seeded bool mask
             stack, exactly; median times from CUDA events;
3. slice   — the default run at full width (GroundingDINO SwinT-OGC at the
             800^2 bucket, SAM ViT-H at 1024^2, Depth-Anything-V2 ViT-B at
             518^2, the refine stages; seeded placeholder weights, bf16)
             through ``build_pipeline`` / ``InkLayerPipeline.run`` on a
             750x750 sketch drawn here: one warm-up, then timed runs; every
             kernel's launch counter is reset before each run and checked
             after it, and all 12 outputs must exist; one more run with
             ``no_intermediate`` must leave only the keep-list; then one
             traced run (device busy time, idle share, the kernels with the
             most device time);
4. reference — the same modules at full width but cut depth, on the card in
             bf16 (kernels) against the CPU in fp32 (plain versions), on
             the same sketch: relative error of the SAM embedding, the SAM
             low-res logits, the GDINO encoder memory and the depth map;
             then one fixed mask stack cleaned and refined on the card and
             on the CPU (cleaned masks identical, final masks IoU >= 0.99).

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
    "clean_components": (
        "cuda", "inklayer_tpu_torch/csrc/components.cu",
        "inklayer_tpu/ops/components.py:337 _clean_components_pallas"),
    "connected_components": (
        "cuda", "inklayer_tpu_torch/csrc/components.cu",
        "inklayer_tpu/ops/components.py:252 _connected_components_pallas"),
    "flash_attention": (
        "cuda", "inklayer_tpu_torch/csrc/flash_attention.cu",
        "inklayer_tpu/ops/attention.py:145 flash_attention"),
}
# launches of each kernel in one default run of the full models: SAM's 32
# blocks, GDINO's 6 + 6 deformable layers, DINOv2's 12 blocks, one cleaning
# call over the mask stack, one labelling in the watershed (when NMS keeps
# a mask)
EXPECTED_LAUNCHES = {"relpos_attention": 32, "mlp_gelu": 32,
                     "ms_deform_attn": 12, "flash_attention": 12,
                     "clean_components": 1, "connected_components": 1}
OUTPUTS = ("input.png", "bboxes.json", "bboxes.png", "masks",
           "segmented_sketch.png", "masks_cleaned", "bboxes_final.json",
           "bboxes_final.png", "masks_disjoint", "depth_map.png",
           "masks_final", "segmented_sketch_final.png")


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


def _check(name, got, ref, atol, rtol, rel_l2=None):
    """Every element within atol + rtol * |ref|, and, where ``rel_l2`` is
    given, ||got - ref|| / ||ref|| within it (a uniform scaling of the
    output, as from unmasked padded keys, hides inside an element-wise
    rtol).  Returns (max abs error, relative L2 error)."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    max_abs = float(err.max())
    rel = float((got - ref).norm() / ref.norm())
    if not bool(torch.isfinite(got).all()) or \
            bool((err > atol + rtol * ref.abs()).any()) or \
            (rel_l2 is not None and rel > rel_l2):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max_abs_err "
            f"{max_abs:.3e} (atol {atol}, rtol {rtol}), relative L2 "
            f"{rel:.3e} (limit {rel_l2})")
    return max_abs, rel


def _kernel_case(results, kernel, case, fn, plain, args, atol, rtol,
                 rel_l2=None):
    """fn(*args) (the kernel, bf16 inputs) against plain(*args in fp32);
    times the kernel, the plain version on the same inputs, and the plain
    version in fp32."""
    f32 = [t.float() for t in args]
    got, ref = fn(*args), plain(*f32)
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    errs = [_check(kernel, g, r, atol, rtol, rel_l2) for g, r in pairs]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    ms = cuda_median_ms(lambda: fn(*args))
    plain_ms = cuda_median_ms(lambda: plain(*args))
    plain32_ms = cuda_median_ms(lambda: plain(*f32))
    results.setdefault(kernel, []).append(
        {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(f"  {kernel:17s} {case:30s} max_abs_err {err:.3e}  rel_l2 {rel:.3e}"
        f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  plain(fp32) "
        f"{plain32_ms:.4f} ms")


def _exact_case(results, kernel, case, fn, plain, args):
    """fn(*args) (the kernel) equal to plain(*args) exactly; times both."""
    import torch

    got, ref = fn(*args), plain(*args)
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    for g, r in pairs:
        if not torch.equal(g, r):
            raise AssertionError(f"{kernel}: kernel differs from its plain "
                                 f"version in {int((g != r).sum())} elements")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn(*args)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    ms = cuda_median_ms(lambda: fn(*args))
    plain_ms = cuda_median_ms(lambda: plain(*args), iters=5, warmup=1)
    results.setdefault(kernel, []).append(
        {"case": case, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms})
    log(f"  {kernel:17s} {case:30s} exact  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  (no fp32 variant: bool in, bool/int32 out); "
        f"kernel peak memory above its inputs {peak:.1f} MiB")


def mask_stack(gen, n: int = 64, h: int = 750, w: int = 750):
    """Seeded (n, h, w) bool masks: blobs (thresholded upsampled noise),
    thin strokes (long horizontal / vertical lines, a diagonal) and
    speckle, so that both keep rules fire and many small components
    occur."""
    import torch
    import torch.nn.functional as F

    dev = gen.device
    noise = torch.rand(n, 1, h // 25, w // 25, generator=gen, device=dev)
    masks = F.interpolate(noise, size=(h, w), mode="bilinear")[:, 0] > 0.62
    masks |= torch.rand(n, h, w, generator=gen, device=dev) > 0.998
    rows = torch.randint(0, h, (n, 4), generator=gen, device=dev)
    cols = torch.randint(0, w, (n, 4), generator=gen, device=dev)
    for i in range(n):
        for r, c in zip(rows[i].tolist(), cols[i].tolist()):
            masks[i, r, max(0, c - 200):c] = True
            masks[i, max(0, r - 150):r, c] = True
    idx = torch.arange(min(h, w), device=dev)
    masks[:, idx, idx] = True
    return masks


def phase_kernels(results: dict) -> None:
    import torch

    from inklayer_tpu_torch.ops import (attention, components, deformable,
                                        mlp, norm)

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
                               ("(40000,96)", 40000, 96, False),
                               ("(1370,768) DINOv2", 1370, 768, False)):
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

    # flash attention at DINOv2 ViT-B, 518^2 bucket: 12 heads x 1370 tokens
    # x 64 (the last 64-key tile holds 26 keys), and (2, 70, 64), whose last
    # tile holds 6.  Tolerance: bf16 probabilities in PV, bf16 output ->
    # element-wise 2e-2 / 2e-2, and relative L2 <= 5e-3: the kernel reads
    # 2.1e-3 to 2.3e-3 at every shape; with the tail mask left out it reads
    # 1.7e-2 at (12, 1370, 64) (every output scaled by ~0.983) and 0.33 at
    # (2, 70, 64).
    for case, bh, n in (("(12,1370,64)", 12, 1370),
                        ("(2,70,64) tail 6 of 64 keys", 2, 70)):
        _kernel_case(
            results, "flash_attention", case,
            lambda *a: attention.flash_attention(*a, 64 ** -0.5),
            lambda *a: attention.flash_attention_plain(*a, 64 ** -0.5),
            [randn(bh, n, 64), randn(bh, n, 64), randn(bh, n, 64)],
            2e-2, 2e-2, rel_l2=5e-3)

    # connected components on the cleaning stage's shape: 64 masks of 750^2
    masks = mask_stack(gen)
    _exact_case(results, "connected_components", "(64,750,750) labels",
                components.connected_components,
                components.connected_components_plain, [masks])
    _exact_case(results, "clean_components",
                "(64,750,750) area>500|aspect>1.1",
                lambda m: components.clean_components(m, 500, 1.1),
                lambda m: components.clean_components_plain(m, 500, 1.1),
                [masks])
    kept, _ = components.clean_components(masks, 500, 1.1)
    if not 0 < int(kept.sum()) < int(masks.sum()):
        raise AssertionError("clean_components: the stack should lose some "
                             "pixels and keep others")


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


def _read_masks(out_dir: str, sub: str) -> np.ndarray:
    from PIL import Image

    d = os.path.join(out_dir, sub)
    names = sorted(os.listdir(d), key=lambda n: int(n[5:-4]))
    if not names:
        return np.zeros((0, 750, 750), bool)
    return np.stack([np.asarray(Image.open(os.path.join(d, n)).convert("L"))
                     > 127 for n in names])


def _check_outputs(out_dir: str, captured: dict) -> dict:
    """The 12 outputs exist and hold what the run must produce; returns
    the mask counts per stage."""
    import torch
    from PIL import Image

    for item in OUTPUTS:
        if not os.path.exists(os.path.join(out_dir, item)):
            raise AssertionError(f"missing output {item}")
    for key in ("logits", "embedding", "depth"):
        t = captured[key].float()
        finite = torch.isfinite(t)
        if key == "logits":  # padded text positions are -inf by design
            finite = finite | torch.isneginf(t)
        if not bool(finite.all()):
            raise AssertionError(f"non-finite {key}")
    if tuple(captured["embedding"].shape) != (1, 64, 64, 256):
        raise AssertionError(f"embedding {tuple(captured['embedding'].shape)}")
    if tuple(captured["depth"].shape) != (1, 518, 518):
        raise AssertionError(f"depth {tuple(captured['depth'].shape)}")
    with open(os.path.join(out_dir, "bboxes.json")) as f:
        if len(json.load(f)["bboxes"]) != 64:
            raise AssertionError("bboxes.json does not hold 64 boxes")
    with open(os.path.join(out_dir, "bboxes_final.json")) as f:
        kept = json.load(f)["kept_indices"]
    counts = {sub: len(_read_masks(out_dir, sub)) for sub in
              ("masks", "masks_cleaned", "masks_disjoint", "masks_final")}
    if counts["masks"] != 64 or counts["masks_cleaned"] != 64:
        raise AssertionError(f"mask stacks {counts}")
    if not 0 < len(kept) <= 64 or not 0 < counts["masks_final"] <= 65:
        raise AssertionError(f"kept {len(kept)}, final {counts}")
    final = _read_masks(out_dir, "masks_final")
    if final.shape[1:] != (750, 750):
        raise AssertionError(f"final masks {final.shape}")
    dm = np.asarray(Image.open(os.path.join(out_dir, "depth_map.png")))
    if dm.shape != (750, 750, 3):
        raise AssertionError(f"depth_map.png {dm.shape}")
    return {"kept": len(kept), **counts}


def phase_slice(card: str) -> dict:
    import torch

    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.io.outputs import KEEP_LIST
    from inklayer_tpu_torch.pipeline.runner import STAGES
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
    pipe.depth.model.register_forward_hook(
        lambda m, i, o: captured.__setitem__("depth", o))

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
        stacks = _check_outputs(out_dir, captured)
        runs.append({"total": total * 1e3, "counts": counts,
                     **{k: v * 1e3 for k, v in pipe.stage_times.items()}})
        log(f"  run {i}{' (warm-up)' if i == 0 else ''}: total "
            f"{total * 1e3:.1f} ms, " + ", ".join(
                f"{k} {pipe.stage_times[k] * 1e3:.1f}" for k in STAGES)
            + f" ms; masks {stacks}; launches {counts}")
    timed = runs[1:]
    p50 = {k: statistics.median(r[k] for r in timed)
           for k in STAGES + ("total",)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  default run p50 over {len(timed)} warm runs [{card}]: whole run "
        f"{p50['total']:.1f} ms; stages " + ", ".join(
            f"{k} {p50[k]:.1f}" for k in STAGES)
        + f" ms; peak memory allocated {peak:.2f} GiB")

    # --no_intermediate: only the keep-list survives
    ni_dir = pipe.run(sketch, os.path.join(WORK, "out_ni"),
                      no_intermediate=True)
    left = sorted(os.listdir(ni_dir))
    if left != sorted(set(KEEP_LIST) & set(OUTPUTS)):
        raise AssertionError(f"no_intermediate left {left}")
    log(f"  no_intermediate run left {left}")

    # one more run, traced: where the device time goes (not timed above)
    prof = device_profile(lambda: pipe.run(sketch, out_base))
    log(f"  traced run [{card}]: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; "
        f"stages " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                               for k, v in pipe.stage_times.items()))
    for name, ms, calls in prof["kernels"]:
        log(f"    {ms:8.3f} ms  {calls:5d} x  {name[:90]}")
    refine_loops(card)
    return {"p50_ms": p50, "peak_gib": peak, "launches": timed[-1]["counts"]}


def refine_loops(card: str) -> None:
    """The refine stage's fixed-iteration eager loops at the default run's
    shapes: wall time (synchronised) and device ops of one call each."""
    import torch

    from inklayer_tpu_torch.ops.distance import chamfer_distance, label_flood
    from inklayer_tpu_torch.profiling import device_profile

    gen = torch.Generator(device="cuda").manual_seed(1)
    seeds = torch.rand(750, 750, generator=gen, device="cuda") > 0.999
    markers = torch.zeros(750, 750, dtype=torch.int32, device="cuda")
    markers[seeds] = torch.arange(1, int(seeds.sum()) + 1, dtype=torch.int32,
                                  device="cuda")
    cost = torch.rand(750, 750, generator=gen, device="cuda")
    region = torch.rand(750, 750, generator=gen, device="cuda") > 0.2
    small = mask_stack(gen, 8, 188, 188)
    for name, fn in (
            ("chamfer_distance 750^2 x 64", lambda: chamfer_distance(seeds)),
            ("label_flood 750^2 x 256",
             lambda: label_flood(markers, cost, region)),
            ("chamfer_distance (8,188,188) x 96 (box assignment)",
             lambda: chamfer_distance(small, iters=96))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof = device_profile(lambda: (fn(), torch.cuda.synchronize()))
        log(f"  refine loop {name} [{card}]: {wall:.1f} ms wall, "
            f"{prof['device_ops']} device ops, device busy "
            f"{prof['busy_ms']:.1f} ms")


# ---------------------------------------------------------------------------
# phase 4: cut-depth reference, card (bf16, kernels) vs CPU (fp32, plain)
# ---------------------------------------------------------------------------


def _rel_check(key: str, a, b) -> float:
    import torch

    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"reference: non-finite {key} on the card")
    rel = float((a - b).norm() / b.norm())
    log(f"  {key:22s} relative error (card bf16 vs CPU fp32) {rel:.3e}")
    # bf16 activations through cut-depth stacks: 5% relative
    if rel > 0.05:
        raise AssertionError(f"reference: {key} off by {rel:.3e}")
    return rel


def reference_masks(gray: np.ndarray) -> np.ndarray:
    """A fixed (8, H, W) mask stack over the drawn sketch: rectangles
    around its shapes, overlapping pairs, a ring and seeded speckle."""
    h, w = gray.shape
    rng = np.random.default_rng(0)
    m = np.zeros((8, h, w), bool)
    for i, (y0, x0, y1, x1) in enumerate(((50, 50, 370, 390),
                                          (410, 290, 710, 700),
                                          (90, 470, 310, 710),
                                          (510, 70, 630, 230),
                                          (380, 30, 560, 360))):
        m[i, y0:y1, x0:x1] = True
    m[5, 40:380, 40:400] = True
    m[5, 80:340, 80:360] = False
    m[6] = rng.random((h, w)) < 0.002
    m[6, 500:700, 300:500] = True
    m[7, 0:h, 0:w] = True
    return m


def phase_reference() -> dict:
    import torch
    from PIL import Image

    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch.build import build_depth, build_detector, build_sam
    from inklayer_tpu_torch.pipeline.refine.mask_cleaner import \
        clean_masks_device
    from inklayer_tpu_torch.pipeline.refine.refiner import (
        improve_masks_deferred, parse_masks_to_disjoint)

    base = PipelineConfig()
    cfg = dataclasses.replace(
        base,
        sam=dataclasses.replace(base.sam, encoder_depth=2,
                                encoder_global_attn_indexes=(1,)),
        gdino=dataclasses.replace(base.gdino, enc_layers=1, dec_layers=1),
        depth=dataclasses.replace(base.depth, depth=4,
                                  intermediate_layers=(0, 1, 2, 3)))
    rgb = np.array(Image.open(os.path.join(WORK, "sketch750.png"))
                   .convert("RGB"))
    image = torch.from_numpy(rgb)
    gray = np.array(Image.fromarray(rgb).convert("L"))
    masks = torch.from_numpy(reference_masks(gray))
    boxes = torch.tensor([[40.0, 40.0, 500.0, 520.0], [300.0, 200.0, 1000.0,
                                                       900.0]])
    out = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        t0 = time.perf_counter()
        sam = build_sam(cfg, dev, dtype, seed=0)
        state = sam.compute_image_state(image.to(dev))
        low, _ = sam.decode_lowres_state(state, boxes.to(dev))
        det = build_detector(cfg, dev, dtype, seed=0)
        enc = det.model.transformer.encoder.layers[-1]
        mem = {}
        hook = enc.register_forward_hook(lambda m, i, o: mem.__setitem__("m", o))
        det.detect(image.to(dev))
        hook.remove()
        est = build_depth(cfg, dev, dtype, seed=0)
        hook = est.model.pretrained.register_forward_hook(
            lambda m, i, o: mem.__setitem__("taps", o))
        depth = est.infer_image_device(image.to(dev))
        hook.remove()
        out[dev] = {"sam_embedding": state["embedding"].float().cpu(),
                    "sam_lowres_logits": low.float().cpu(),
                    "gdino_encoder_memory": mem["m"].float().cpu(),
                    "dinov2_last_tap": mem["taps"][-1][0].float().cpu(),
                    "depth_750x750": depth.float().cpu()}
        del sam, det
        # cleaning and refinement of the fixed mask stack
        gray_dev = torch.from_numpy(gray).to(dev)
        cleaned, _ = clean_masks_device(masks.to(dev), cfg.refine)
        order = list(range(masks.shape[0]))
        boxes_px = np.asarray([[0, 0, 749, 749]] * masks.shape[0], float)
        disjoint, sboxes, _ = parse_masks_to_disjoint(
            cleaned, boxes_px, gray_dev, cfg.refine, sort_result=order)
        final, has = improve_masks_deferred(disjoint, np.asarray(sboxes),
                                            gray_dev, cfg.refine)
        out[dev]["cleaned"] = cleaned.cpu()
        out[dev]["final"] = (final if bool(has) else final[:-1]).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"  {dev}: reference models + clean/refine "
            f"{time.perf_counter() - t0:.1f} s")
    rel = {key: _rel_check(key, out["cuda"][key], out["cpu"][key])
           for key in ("sam_embedding", "sam_lowres_logits",
                       "gdino_encoder_memory", "dinov2_last_tap",
                       "depth_750x750")}
    if not torch.equal(out["cuda"]["cleaned"], out["cpu"]["cleaned"]):
        raise AssertionError("reference: cleaned masks differ between the "
                             "card and the CPU")
    a, b = out["cuda"]["final"], out["cpu"]["final"]
    if a.shape != b.shape or a.shape[0] == 0:
        raise AssertionError(f"reference: final stacks {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
    ious = [float((x & y).sum()) / int((x | y).sum()) if bool((x | y).any())
            else 1.0 for x, y in zip(a, b)]
    # an empty pair scores 1.0; at least 3 non-empty masks keep an
    # all-empty result from passing
    filled = int(b.flatten(1).any(dim=1).sum())
    log(f"  cleaned masks identical ({int(out['cpu']['cleaned'].sum())} px); "
        f"final masks {tuple(a.shape)} ({filled} non-empty), px per mask "
        f"card {a.flatten(1).sum(1).tolist()} CPU {b.flatten(1).sum(1).tolist()}"
        f", {int((a != b).sum())} px differ, min IoU card vs CPU "
        f"{min(ious):.4f}")
    if min(ious) < 0.99 or filled < 3:
        raise AssertionError(f"reference: final mask IoU {min(ious):.4f}, "
                             f"{filled} non-empty masks")
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

    log(f"phase 3: the default run at full width [{card}]")
    slice_res = phase_slice(card)

    log("phase 4: cut-depth reference and clean/refine, card vs CPU")
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
