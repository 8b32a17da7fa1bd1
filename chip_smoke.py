#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inklayer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile the hand-written kernels (csrc/*.cu, one nvcc per
             source, all started together, sm_90a, ``-Xptxas -v``) and
             print each attention and GEMM instance's registers, spills and
             shared memory;
2. kernels — each kernel against its plain PyTorch version at the shapes
             of the default run and of the inpainting path, inputs seeded
             random bf16 with the plain version in fp32 on the card (TF32
             off), tolerances stated below; the connected-components
             kernels exactly, on a seeded bool mask stack, on its first
             mask alone (the refiner's call) and on a stack built to
             break the tile decomposition; median times
             from CUDA events of the kernel, its plain version and, where
             one PyTorch call computes the same function, that call (timed
             only: nothing in the port calls it); for the kernel and the
             library call also the device time per call (10 calls captured
             in a CUDA graph and replayed: the host's part drops out) and
             the wall time per call of 100 calls issued back to back, best
             of 5 (the larger of the host's cost per call and the device
             time); each
             case's bound, the larger of its bytes over the HBM rate and
             its operations over the peak rate for their type (H100 SXM
             data sheet), its share of that bound and its ratio to the
             library call;
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
             one fixed mask stack cleaned and refined on the card and on
             the CPU (cleaned masks identical, final masks IoU >= 0.99);
             the CLIP text encoder, one UNet + ControlNet step and one VAE
             encode + decode at 512^2, full depth;
5. inpaint — the inpainting path at full width (SD1.5-inpaint UNet +
             ControlNet v11p + VAE + CLIP-L at 768^2, 30 DPM-Solver++ steps,
             CFG 9.0, two passes, bf16, placeholder weights) on a 750^2
             sketch with three overlapping depth-ordered masks drawn here:
             ``Inpainter.run_on_sketch_dir`` once to warm up and once timed
             (layers 1 and 2 batched, bucket 2), then ``inpaint_fn`` on one
             layer, each with exact launch counts, finite latents and every
             output file; one traced pass; then ``main --inpaint`` on the
             phase-3 sketch, with and without ``--no_intermediate``;
6. serving — checkpoints and the web editor.  The seeded placeholder
             params at full width are written in the reference layouts
             (GroundingDINO, SAM ViT-H, Depth-Anything-V2 as fp32 ``.pth``
             with the keys the loader must drop; the four diffusion
             components as diffusers-layout ``.safetensors``), the pipeline
             is built from that ``models_dir`` and must equal phase 3's
             in-memory build (rebuilt here from the same seed, and freed
             before serving) tensor by tensor and give bit-identical
             detect + segment results; then the WSGI app behind the
             threaded server on 127.0.0.1, micro-batched SAM encoder on,
             answers, through urllib, 4 ``/save-canvas-drawing``, one
             ``/segment-sketch`` alone, the 4 sketches one after another,
             the 4 at once from 4 threads and two ``/inpaint`` (the first
             builds the diffusion models from the files, which must equal
             what was written); each request's kernel launches must be
             exactly what it has to launch (the 4 at once: what the 4 did
             one after another, the SAM encoder's part scaled to the
             batched encodes that ran), the encoder must launch at least
             once at a bucket above 1, and the 4 sketches encoded batched
             and one by one must agree.

Phase 2 also holds the SAM encoder's kernels (relpos attention, MLP,
LayerNorm) at the SAM batch of 2 and 4 images that the micro-batched
encoder launches.

The line before the last is one JSON object with each kernel's route,
source, the TPU kernel it replaces, launches in the last runs of phases 3
and 5 and in the serving run of phase 6, error, times and bound; the last
line is the device record.  Exits non-zero without a card, and when run
outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
TIMED_RUNS = 3
ITERS = 20

# line entry -> (route, source, TPU kernel it replaces); the flash
# attention has one entry per head-dim instance (its launch counter key)
K7 = "inklayer_tpu/ops/attention.py:145 flash_attention"
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
    "flash_attention/d64": (
        "cuda", "inklayer_tpu_torch/csrc/flash_attention.cu", K7),
    "flash_attention/d40": (
        "cuda", "inklayer_tpu_torch/csrc/flash_attention.cu", K7),
    "flash_attention/d80": (
        "cuda", "inklayer_tpu_torch/csrc/flash_attention.cu", K7),
}
# launches of each kernel in one default run of the full models: SAM's 32
# blocks, GDINO's 6 + 6 deformable layers, DINOv2's 12 blocks, one cleaning
# call over the mask stack, one labelling in the watershed (when NMS keeps
# a mask)
EXPECTED_LAUNCHES = {"relpos_attention": 32, "mlp_gelu": 32,
                     "ms_deform_attn": 12, "flash_attention/d64": 12,
                     "clean_components": 1, "connected_components": 1}
# launches in one inpainting call of 2 passes x 30 steps.  Per step the
# UNet's self-attention runs the flash kernel at 96^2 = 9216 tokens (head
# dim 40: down 0 x2, up 3 x3) and 48^2 = 2304 (head dim 80: down 1 x2,
# up 2 x3), the ControlNet at both (down 0 x2, down 1 x2): 7 + 7; 24^2 and
# 12^2 tokens take sdpa.  LayerNorm: 3 per transformer block with >= 512
# rows: 16 UNet + 7 ControlNet blocks at a CFG batch of 4 (bucket 2); at a
# batch of 2 the mid blocks' 2 x 144 rows take the plain version.
STEPS = 30
STEPS_X_PASSES = 2 * STEPS
EXPECTED_INPAINT = {
    "bucket 2": {"flash_attention/d40": 7 * STEPS_X_PASSES,
                 "flash_attention/d80": 7 * STEPS_X_PASSES,
                 "layernorm": 3 * 23 * STEPS_X_PASSES},
    "one layer": {"flash_attention/d40": 7 * STEPS_X_PASSES,
                  "flash_attention/d80": 7 * STEPS_X_PASSES,
                  "layernorm": 3 * 21 * STEPS_X_PASSES},
}
# one /inpaint: a single pass of the one-layer call, and nothing else
EXPECTED_EDIT = {"flash_attention": 14 * STEPS,
                 "flash_attention/d40": 7 * STEPS,
                 "flash_attention/d80": 7 * STEPS,
                 "layernorm": 3 * 21 * STEPS}
# H100 SXM data-sheet rates (dense): bf16 tensor cores, fp32 outside them,
# HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
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


def graph_ms(fn, reps: int = 10, iters: int = 10):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, median of ``iters`` replays over ``reps``; None when the call
    cannot be captured (it synchronises with the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:  # a measurement only: the call was checked above
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def back_to_back_ms(fn, calls: int = 100, runs: int = 5) -> float:
    """Wall time per call of ``calls`` calls issued back to back with one
    synchronise at the end, the least of ``runs`` runs (the host is shared:
    the least is the call's own cost): the larger of the host's cost per
    call and the device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / calls)
    return best


def _fmt(ms) -> str:
    return "not captured" if ms is None else f"{ms:.4f} ms"


def draw_sketch(path: str, size: int = 750, shift: int = 0) -> None:
    """Deterministic line sketch: boxes, a shaded block, a diagonal; with
    ``shift``, the boxes move by ``shift`` px down and right (another
    sketch of the same kind)."""
    from PIL import Image

    g = np.full((size, size, 3), 255, np.uint8)
    for (y0, x0, y1, x1, v) in ((60, 60, 360, 380, 0), (420, 300, 700, 690, 20),
                                (100, 480, 300, 700, 40)):
        y0, x0 = y0 + shift // 2, x0 + shift // 2
        y1, x1 = min(y1 + shift, size), min(x1 + shift, size)
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


def bound(ops: float, nbytes: float, peak: float):
    """(ms, "operations" | "bytes"): the least time the card could take
    for ``ops`` operations at ``peak`` per second and ``nbytes`` moved at
    the HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _record(results, kernel, case, err, ms, plain_ms, bnd, library_ms,
            split):
    results.setdefault(kernel, []).append(
        {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
         **split})


def _split(fn, library):
    """Device time (CUDA graph) and back-to-back time per call of the
    kernel's wrapper and of the library call (None where there is none)."""
    out = {"device_ms": graph_ms(fn), "b2b_ms": back_to_back_ms(fn),
           "library_device_ms": None, "library_b2b_ms": None}
    if library is not None:
        out["library_device_ms"] = graph_ms(library)
        out["library_b2b_ms"] = back_to_back_ms(library)
    return out


def _split_text(split) -> str:
    text = (f"  device {_fmt(split['device_ms'])}  back-to-back "
            f"{split['b2b_ms']:.4f} ms")
    if split["library_b2b_ms"] is not None:
        text += (f"  library device {_fmt(split['library_device_ms'])}  "
                 f"back-to-back {split['library_b2b_ms']:.4f} ms")
    return text


def _kernel_case(results, kernel, case, fn, plain, args, atol, rtol,
                 bnd, library=None, rel_l2=None):
    """fn(*args) (the kernel, bf16 inputs) against plain(*args in fp32);
    times the kernel, the plain version on the same inputs, the plain
    version in fp32 and ``library()`` (one PyTorch call computing the same
    function on the same inputs, or None)."""
    f32 = [t.float() for t in args]
    got, ref = fn(*args), plain(*f32)
    pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
    errs = [_check(kernel, g, r, atol, rtol, rel_l2) for g, r in pairs]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    del got, ref, pairs
    ms = cuda_median_ms(lambda: fn(*args))
    plain_ms = cuda_median_ms(lambda: plain(*args))
    plain32_ms = cuda_median_ms(lambda: plain(*f32))
    library_ms = None if library is None else cuda_median_ms(library)
    split = _split(lambda: fn(*args), library)
    _record(results, kernel, case, err, ms, plain_ms, bnd, library_ms, split)
    lib = "none" if library_ms is None else (
        f"{library_ms:.4f} ms (kernel / library {ms / library_ms:.2f})")
    log(f"  {kernel:19s} {case:30s} max_abs_err {err:.3e}  rel_l2 {rel:.3e}"
        f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  plain(fp32) "
        f"{plain32_ms:.4f} ms  library {lib}  bound {bnd[0]:.4f} ms "
        f"({bnd[1]}; {bnd[0] / ms:.3f} of it);" + _split_text(split))


def _exact_case(results, kernel, case, fn, plain, args, bnd):
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
    split = _split(lambda: fn(*args), None)
    _record(results, kernel, case, 0.0, ms, plain_ms, bnd, None, split)
    log(f"  {kernel:19s} {case:30s} exact  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  library none  bound {bnd[0]:.4f} ms "
        f"({bnd[1]}; no fp32 variant: bool in, bool/int32 out); kernel "
        f"peak memory above its inputs {peak:.1f} MiB;" + _split_text(split))


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


def adversarial_stack(n: int = 64, h: int = 750, w: int = 750):
    """(n, h, w) bool masks on the card built to break the tile-based
    labelling (``tests/torch_masks.py``: a serpentine, a spiral, a comb, a
    full mask, a checkerboard, pairs across tile corners, blobs), each kind
    shifted to meet the 32 x 32 tiles at other phases."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_masks import MASK_KINDS, adversarial_mask

    kinds = [adversarial_mask(k, h, w) for k in MASK_KINDS]
    return torch.stack([torch.roll(kinds[i % len(kinds)], (i, 3 * i), (0, 1))
                        for i in range(n)]).cuda()


def phase_kernels(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from inklayer_tpu_torch.ops import (attention, components, deformable,
                                        mlp, norm)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)

    def attn_bound(bh, n, d, extra_bytes=0):
        # QK^T and PV on the tensor cores; q, k, v read, out written (bf16)
        return bound(4.0 * bh * n * n * d, 2.0 * 4 * bh * n * d + extra_bytes,
                     PEAK_BF16)

    # relpos attention: SAM ViT-H windows (25 windows x 16 heads, 14x14),
    # global (16 heads, 64x64) and the global grid of a 768^2 SAM (48x48,
    # the shape of the TPU kernel sam_global_attention, K2b); head_dim 80.
    # Tolerance: bf16 output and bf16 probabilities in PV -> atol 2e-2,
    # rtol 2e-2, and relative L2 <= 5e-3 (a missing tail-key mask at 196
    # tokens passes the element-wise limit).  Library: SDPA with the
    # expanded rel-pos bias as a float mask (built outside the timing), on
    # (1, BH, N, D) views: SDPA's fused backends take 4-D inputs only.
    # Then the micro-batched encoder's SAM batches of 2 and 4 images
    # (windows 25 * 16 * B, global 16 * B heads).
    scale = 80 ** -0.5
    for case, bh, kh in (("windows (400,196,80) kh=kw=14", 400, 14),
                         ("global (16,4096,80) kh=kw=64", 16, 64),
                         ("global (16,2304,80) kh=kw=48 (K2b)", 16, 48),
                         ("windows (800,196,80) SAM batch 2", 800, 14),
                         ("global (32,4096,80) SAM batch 2", 32, 64),
                         ("windows (1600,196,80) SAM batch 4", 1600, 14),
                         ("global (64,4096,80) SAM batch 4", 64, 64)):
        n = kh * kh
        args = [randn(bh, n, 80), randn(bh, n, 80), randn(bh, n, 80),
                randn(bh, n, kh), randn(bh, n, kh)]
        bias = (args[3][..., :, None] + args[4][..., None, :]).reshape(
            bh, n, n)
        _kernel_case(
            results, "relpos_attention", case,
            lambda *a: attention.relpos_attention(*a, scale),
            lambda *a: attention.relpos_attention_plain(*a, scale),
            args, 2e-2, 2e-2, attn_bound(bh, n, 80, 2.0 * 2 * bh * n * kh),
            lambda: F.scaled_dot_product_attention(
                *(a[None] for a in args[:3]), attn_mask=bias[None],
                scale=scale), rel_l2=5e-3)
        del bias

    # fused MLP at SAM ViT-H: T=4096, C=1280, H=5120, weights ~ 1/sqrt(fan_in),
    # and at the SAM batches of 2 and 4 images (T = 8192, 16384).
    # Tolerance: the hidden activation is rounded to bf16 (as on the TPU)
    # and the output is bf16 -> atol 2e-2, rtol 2e-2, and relative L2 <=
    # 5e-3.  Library: F.linear -> F.gelu -> F.linear (cuBLAS).  Then fc2
    # alone (the GEMM launch with the bias epilogue, 128 x 160 tiles) on a
    # seeded hidden activation; library F.linear.
    c, h = 1280, 5120
    weights = [randn(h, c, std=c ** -0.5), randn(h, std=0.1),
               randn(c, h, std=h ** -0.5), randn(c, std=0.1)]
    for case, t in (("(4096,1280)->(5120)->(1280)", 4096),
                    ("(8192,1280)->(5120)->(1280) SAM batch 2", 8192),
                    ("(16384,1280)->(5120)->(1280) SAM batch 4", 16384)):
        args = [randn(t, c)] + weights
        _kernel_case(
            results, "mlp_gelu", case, mlp.mlp_gelu, mlp.mlp_gelu_plain, args,
            2e-2, 2e-2,
            bound(4.0 * t * c * h, 2.0 * (2 * t * c + 2 * h * c + h + c),
                  PEAK_BF16),
            lambda: F.linear(F.gelu(F.linear(args[0], args[1], args[2])),
                             args[3], args[4]), rel_l2=5e-3)
    t = 4096
    fc2 = [randn(t, h, std=0.5), weights[2], weights[3]]
    _kernel_case(
        results, "mlp_gelu", "fc2 (4096,5120)->(1280)",
        lambda a, w, b: mlp._linear_bias_act(a, w, b, gelu=False), F.linear,
        fc2, 2e-2, 2e-2,
        bound(2.0 * t * h * c, 2.0 * (t * h + h * c + c + t * c), PEAK_BF16),
        lambda: F.linear(*fc2), rel_l2=5e-3)

    # LayerNorm: SAM (4096, 1280) with and without the residual (and at the
    # SAM batches of 2 and 4 images), Swin stage-0 (40000, 96), DINOv2
    # (1370, 768), and the UNet's transformer blocks at the inpainting
    # path's CFG batch of 2 (levels 0, 1 and 2 at 768^2).
    # Tolerance: fp32 statistics, bf16 outputs -> 2e-2 / 2e-2.  Library:
    # F.layer_norm (the residual form: add + F.layer_norm).  Bound: bytes
    # (about 8 fp32 operations per element).
    for case, rows, c, res in (("(4096,1280)", 4096, 1280, False),
                               ("(4096,1280) + residual", 4096, 1280, True),
                               ("(8192,1280) SAM batch 2", 8192, 1280, False),
                               ("(8192,1280) + residual SAM batch 2", 8192,
                                1280, True),
                               ("(16384,1280) SAM batch 4", 16384, 1280,
                                False),
                               ("(16384,1280) + residual SAM batch 4", 16384,
                                1280, True),
                               ("(40000,96)", 40000, 96, False),
                               ("(1370,768) DINOv2", 1370, 768, False),
                               ("(18432,320) UNet level 0", 18432, 320, False),
                               ("(4608,640) UNet level 1", 4608, 640, False),
                               ("(1152,1280) UNet level 2", 1152, 1280,
                                False)):
        params = [1.0 + randn(c, std=0.1), randn(c, std=0.1)]
        x = randn(rows, c)
        moved = 2.0 * (rows * c * (4 if res else 2) + 2 * c)
        bnd = bound(8.0 * rows * c, moved, PEAK_FP32)
        if res:
            y = randn(rows, c)
            _kernel_case(results, "layernorm", case, norm.layernorm_residual_2d,
                         norm.layernorm_residual_2d_plain,
                         [x, y] + params, 2e-2, 2e-2, bnd,
                         lambda: F.layer_norm(x + y, (c,), *params, eps=1e-6))
        else:
            _kernel_case(results, "layernorm", case, norm.layernorm_2d,
                         norm.layernorm_2d_plain, [x] + params, 2e-2, 2e-2,
                         bnd, lambda: F.layer_norm(x, (c,), *params, eps=1e-6))

    # MSDA at the GDINO 800^2 bucket: levels 100^2, 50^2, 25^2, 13^2, 8 heads
    # x 32, 4 levels x 4 points; locations in [-0.1, 1.1] (some corners
    # outside), softmax weights (both fp32, as the module makes them).
    # Tolerance: bf16 values, fp32 sums, bf16 output -> atol 1e-2, rtol 2e-2.
    # No single PyTorch call computes it.  Bound: per query, head, level and
    # point 4 corners x 32 channels x 2 fp32 operations (and the weights);
    # bytes: value, locations, weights, output.
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
            [value], 1e-2, 2e-2,
            bound(lq * 8 * 16 * (4 * 32 * 2 + 4 * 6),
                  2.0 * s_tot * 256 + 4.0 * lq * 8 * 16 * 3 + 2.0 * lq * 256,
                  PEAK_FP32))

    # flash attention.  Head dim 64: DINOv2 ViT-B at the 518^2 bucket, 12
    # heads x 1370 tokens (the last 128-key tile holds 90 keys), and
    # (2, 70, 64), one partial tile.  Head dims 40 and 80: the UNet's
    # self-attention at 768^2 for one layer with CFG (2 x 8 heads), 9216
    # tokens at level 0 and 2304 at level 1 (no partial tile), and tail
    # cases (2, 70, 40) and (2, 100, 80).  Tolerance: bf16 probabilities in
    # PV, bf16 output -> element-wise 2e-2 / 2e-2, and relative L2 <= 5e-3:
    # the kernels read 2.0e-3 to 2.3e-3, while a kernel that leaves the
    # tail keys unmasked scales whole rows (by ~0.983 at (12, 1370, 64))
    # and reads 1.7e-2 there, 0.33 at (2, 70, 64) (measured on 64-key
    # tiles).  Library: F.scaled_dot_product_attention on
    # (1, BH, N, D) views (on 3-D inputs it takes its unfused math path).
    for case, bh, n, d in (("(12,1370,64)", 12, 1370, 64),
                           ("(2,70,64) 70 of 128 keys", 2, 70, 64),
                           ("(16,9216,40) UNet level 0", 16, 9216, 40),
                           ("(2,70,40) 70 of 128 keys", 2, 70, 40),
                           ("(16,2304,80) UNet level 1", 16, 2304, 80),
                           ("(2,100,80) 100 of 128 keys", 2, 100, 80)):
        args = [randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)]
        sc = d ** -0.5
        _kernel_case(
            results, f"flash_attention/d{d}", case,
            lambda *a: attention.flash_attention(*a, sc),
            lambda *a: attention.flash_attention_plain(*a, sc),
            args, 2e-2, 2e-2, attn_bound(bh, n, d),
            lambda: F.scaled_dot_product_attention(
                *(a[None] for a in args), scale=sc),
            rel_l2=5e-3)
    torch.cuda.empty_cache()

    # connected components on the cleaning stage's shape, 64 masks of 750^2,
    # on the refiner's (one mask of 750^2: large_component_mask), and on 64
    # masks built to break the tile decomposition.  Bound: bytes (the bool
    # masks in; int32 labels or bool masks out); the union-find does a few
    # integer operations per pixel.
    masks = mask_stack(gen)
    adversarial = adversarial_stack()
    for case, m in (("(64,750,750) labels", masks),
                    ("(1,750,750) labels (refiner)", masks[:1].clone()),
                    ("(64,750,750) adversarial labels", adversarial)):
        _exact_case(results, "connected_components", case,
                    components.connected_components,
                    components.connected_components_plain, [m],
                    bound(0.0, m.numel() * (1 + 4), PEAK_FP32))
    # the cleaning on the same stacks, and on 4 masks of 27 x 37 (H * W % 4
    # == 3), full ones beside lone pixels at (0, 0): the keep pass's groups
    # of four pixels straddle two masks
    from torch_masks import straddle_stack

    for case, m in (("(64,750,750) area>500|aspect>1.1", masks),
                    ("(64,750,750) adversarial", adversarial),
                    ("(4,27,37) groups straddle masks",
                     straddle_stack(4, 27, 37).cuda())):
        _exact_case(results, "clean_components", case,
                    lambda m: components.clean_components(m, 500, 1.1),
                    lambda m: components.clean_components_plain(m, 500, 1.1),
                    [m], bound(0.0, m.numel() * 2, PEAK_FP32))
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


def slice_config():
    """The default configuration with every one of the top-K boxes kept,
    so that the placeholder weights give a full mask stack."""
    from inklayer_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    return dataclasses.replace(
        cfg, gdino=dataclasses.replace(cfg.gdino, box_threshold=0.0))


def phase_slice(card: str) -> dict:
    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.io.outputs import KEEP_LIST
    from inklayer_tpu_torch.pipeline.runner import STAGES
    from inklayer_tpu_torch.profiling import device_profile

    cfg = slice_config()
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
            if counts.get(name, 0) != want:
                raise AssertionError(f"run {i}: {name} launched "
                                     f"{counts.get(name, 0)} times, expected "
                                     f"{want}")
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

    # one more run, traced: where the device time goes (not timed above),
    # the ten kernels with the most device time, then the components and
    # deformable-attention kernels wherever they rank
    prof = device_profile(lambda: pipe.run(sketch, out_base), top=10 ** 6)
    log(f"  traced run [{card}]: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; "
        f"stages " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                               for k, v in pipe.stage_times.items()))
    for i, (name, ms, calls) in enumerate(prof["kernels"]):
        if i < 10 or "::cc_" in name or "ms_deform_attn_kernel" in name:
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


def reference_diffusion() -> dict:
    """The diffusion models at full depth and width, card bf16 against CPU
    fp32 with the same seeded weights: the CLIP text encoder on the
    prompt, one ControlNet + UNet step (CFG batch 2) and one VAE encode +
    decode, at 512^2 (64^2 = 4096 latent tokens at head dim 40 and 32^2 =
    1024 at head dim 80: both take the flash kernel on the card)."""
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from inklayer_tpu_torch.build import build_diffusion_models
    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch.models.diffusion import CLIPTokenizer

    cfg = PipelineConfig()
    d = cfg.diffusion
    size = 512
    gen = torch.Generator().manual_seed(7)
    lat = torch.randn(1, d.latent_channels, size // 8, size // 8,
                      generator=gen)
    rgb = np.array(Image.open(os.path.join(WORK, "sketch750.png")).convert(
        "RGB").resize((size, size), Image.LANCZOS), np.float32) / 255.0
    img01 = torch.from_numpy(rgb).permute(2, 0, 1)[None]
    mask = torch.zeros(1, 1, size, size)
    mask[:, :, 100:300, 150:400] = 1.0
    img = img01 * 2.0 - 1.0
    cond = torch.where(mask > 0.5, -1.0, img01)  # ControlNet inpaint control
    ids = torch.from_numpy(np.concatenate([
        CLIPTokenizer().encode(d.negative_prompt, d.text_maxlen),
        CLIPTokenizer().encode(d.prompt, d.text_maxlen)])).long()
    ts = torch.tensor([500, 500], dtype=torch.int32)
    out = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        t0 = time.perf_counter()
        m = build_diffusion_models(cfg, dev, dtype, seed=0)
        cl = torch.channels_last
        with torch.inference_mode():
            text = m["text"](ids.to(dev))
            masked = m["vae"].encode((img * (mask < 0.5)).to(dev).contiguous(
                memory_format=cl))
            lat2 = torch.cat([lat, lat]).to(dev, dtype)
            down, mid = m["controlnet"](
                lat2.contiguous(memory_format=cl), ts.to(dev), text,
                torch.cat([cond, cond]).to(dev, dtype).contiguous(
                    memory_format=cl), conditioning_scale=1.2)
            mask_lat = F.interpolate(mask, size=lat.shape[2:],
                                     mode="nearest-exact").to(dev, dtype)
            extra = torch.cat([mask_lat, masked], dim=1)
            nine = torch.cat([lat2, torch.cat([extra, extra])], dim=1)
            eps = m["unet"](nine.contiguous(memory_format=cl), ts.to(dev),
                            text, down_residuals=down, mid_residual=mid)
            z = m["vae"].encode(img.to(dev).contiguous(memory_format=cl))
            dec = m["vae"].decode(z.float().contiguous(memory_format=cl))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"clip_text_hidden": text.float().cpu(),
                    "controlnet_mid_512": mid.float().cpu(),
                    "unet_eps_512": eps.float().cpu(),
                    "vae_latent_512": z.float().cpu(),
                    "vae_decode_512": dec.float().cpu()}
        del m, text, masked, down, mid, eps, z, dec
        log(f"  {dev}: diffusion models at 512^2, one step + VAE "
            f"{time.perf_counter() - t0:.1f} s (build included)")
    torch.cuda.empty_cache()
    return {key: _rel_check(key, out["cuda"][key], out["cpu"][key])
            for key in out["cpu"]}


# ---------------------------------------------------------------------------
# phase 5: the inpainting path at full width
# ---------------------------------------------------------------------------


def draw_layered_sketch(sketch_dir: str, size: int = 750) -> None:
    """A sketch directory as the default run leaves it for the inpainter:
    ``input.png`` (a circle in front of a box, both in front of a large
    ellipse) and ``masks_final/`` with three disjoint depth-ordered masks
    (0 = front), so that layers 1 and 2 need inpainting."""
    from PIL import Image

    os.makedirs(os.path.join(sketch_dir, "masks_final"), exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    circle = np.hypot(yy - 300, xx - 330)
    ellipse = np.hypot((yy - 420) / 300.0, (xx - 330) / 270.0)
    box = np.zeros((size, size), bool)
    box[150:560, 380:700] = True
    front = circle < 160
    mid = box & ~front
    back = (ellipse < 1.0) & ~front & ~mid
    ink = np.full((size, size), 255, np.uint8)
    ink[(np.abs(ellipse - 0.97) < 0.012) & back] = 0
    ink[mid & ~np.pad(box[6:-6, 6:-6], 6)] = 0
    ink[np.abs(circle - 152) < 4] = 0
    ink[250:350, 280:290] = 40  # detail strokes inside the circle
    ink[600:606, 150:500][back[600:606, 150:500]] = 20
    Image.fromarray(np.repeat(ink[..., None], 3, axis=2)).save(
        os.path.join(sketch_dir, "input.png"))
    for i, m in enumerate((front, mid, back)):
        Image.fromarray(m.astype(np.uint8) * 255).save(
            os.path.join(sketch_dir, "masks_final", f"mask_{i}.png"))


def _check_layer_files(sketch_dir: str, inpainted=(1, 2)) -> None:
    for i in range(3):
        for rel in (f"complete_layers/layer_{i}.png",
                    f"complete_layers_rgba/layer_{i}.png",
                    f"complete_layers_process/mask_{i}/sketch_layer.png"):
            if not os.path.exists(os.path.join(sketch_dir, rel)):
                raise AssertionError(f"inpaint: missing {rel}")
    for i in inpainted:
        for f in ("debug_vis", "edit_mask", "inpainted_image",
                  "final_composited"):
            rel = f"complete_layers_process/mask_{i}/{f}.png"
            if not os.path.exists(os.path.join(sketch_dir, rel)):
                raise AssertionError(f"inpaint: missing {rel}")


def _check_counts(run: str, counts: dict) -> None:
    for name, want in EXPECTED_INPAINT[run].items():
        if counts.get(name, 0) != want:
            raise AssertionError(f"inpaint {run}: {name} launched "
                                 f"{counts.get(name, 0)} times, expected "
                                 f"{want}")


def phase_inpaint(card: str) -> dict:
    import torch
    from PIL import Image

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_inpainter
    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch.io.outputs import KEEP_LIST
    from inklayer_tpu_torch.main import main as cli_main
    from inklayer_tpu_torch.profiling import device_profile

    cfg = PipelineConfig()
    sketch_dir = os.path.join(WORK, "layered")
    draw_layered_sketch(sketch_dir)
    ink = build_inpainter(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    t0 = time.perf_counter()
    pipe = ink.get_pipeline()
    torch.cuda.synchronize()
    log(f"  diffusion models built in {time.perf_counter() - t0:.1f} s")
    latents = []
    decode = pipe.vae.decode
    pipe.vae.decode = lambda z: (latents.append(z), decode(z))[1]

    def stages(p_times, i_times):
        steps = p_times["steps"]
        return (f"per solver step {p_times['loop'] / steps * 1e3:.1f} ms "
                f"({steps} steps); encode {p_times['encode'] * 1e3:.1f}, "
                f"loop {p_times['loop'] * 1e3:.1f}, decode "
                f"{p_times['decode'] * 1e3:.1f}, pre/post "
                f"{p_times['prepost'] * 1e3:.1f} ms" + (
                    "" if i_times is None else
                    f"; masks and layer assembly "
                    f"{i_times['assemble'] * 1e3:.1f}, composite "
                    f"{i_times['composite'] * 1e3:.1f}, RGBA layers "
                    f"{i_times['rgba'] * 1e3:.1f} ms"))

    res = {}
    for i, label in enumerate(("warm-up", "timed")):
        latents.clear()
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ink.run_on_sketch_dir(sketch_dir)
        total = time.perf_counter() - t0
        counts = _kernels.launch_counts()
        _check_counts("bucket 2", counts)
        _check_layer_files(sketch_dir)
        finite = [bool(torch.isfinite(z).all()) for z in latents]
        if len(latents) != 2 or latents[0].shape != (2, 4, 96, 96) or \
                not all(finite):
            raise AssertionError(f"inpaint: final latents "
                                 f"{[tuple(z.shape) for z in latents]}, "
                                 f"finite {finite}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  run_on_sketch_dir ({label}, layers 1 and 2 at bucket 2) "
            f"[{card}]: {total * 1e3:.1f} ms; "
            + stages(pipe.stage_times, ink.stage_times)
            + f"; peak memory allocated {peak:.2f} GiB; launches {counts}")
        res["bucket2"] = {"total_ms": total * 1e3, "counts": counts,
                          "step_ms": pipe.stage_times["loop"]
                          / pipe.stage_times["steps"] * 1e3, "peak": peak}

    # one layer through the unbatched path
    layer = Image.open(os.path.join(
        sketch_dir, "complete_layers_process", "mask_1", "sketch_layer.png"))
    edit = Image.open(os.path.join(
        sketch_dir, "complete_layers_process", "mask_1", "edit_mask.png"))
    latents.clear()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = ink.inpaint_func(layer, edit)
    total = time.perf_counter() - t0
    _check_counts("one layer", _kernels.launch_counts())
    if out.size != layer.size or len(latents) != 2 or \
            not all(bool(torch.isfinite(z).all()) for z in latents):
        raise AssertionError("inpaint: the one-layer call failed its checks")
    log(f"  inpaint_fn (one layer, CFG batch 2) [{card}]: "
        f"{total * 1e3:.1f} ms; " + stages(pipe.stage_times, None))
    res["one_layer_step_ms"] = pipe.stage_times["loop"] / \
        pipe.stage_times["steps"] * 1e3

    # one traced pass at bucket 2
    pairs = [(Image.open(os.path.join(
        sketch_dir, "complete_layers_process", f"mask_{i}", n)))
        for i in (1, 2) for n in ("sketch_layer.png", "edit_mask.png")]
    prof = device_profile(lambda: (pipe.generate_batch(
        pairs[0::2], pairs[1::2], num_passes=1), torch.cuda.synchronize()))
    log(f"  traced pass (bucket 2, 30 steps) [{card}]: wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, "
        f"idle share {prof['idle_share']:.3f}, {prof['device_ops']} device "
        f"ops")
    for name, ms, calls in prof["kernels"]:
        log(f"    {ms:9.3f} ms  {calls:6d} x  {name[:90]}")
    pipe.vae.decode = decode
    del ink, pipe
    torch.cuda.empty_cache()

    # the CLI with --inpaint on the phase-3 sketch: placeholder weights leave
    # one layer, so nothing is inpainted, but the stage runs and writes
    layers = {"complete_layers", "complete_layers_process",
              "complete_layers_rgba"}
    for flags, want in (([], set(OUTPUTS) | layers),
                        (["--no_intermediate"],
                         set(KEEP_LIST) & (set(OUTPUTS) | layers))):
        cli_out = os.path.join(WORK, "cli_inpaint" + "".join(flags))
        t0 = time.perf_counter()
        cli_main(["--img", os.path.join(WORK, "sketch750.png"), "--out_dir",
                  cli_out, "--inpaint", *flags])
        left = sorted(os.listdir(os.path.join(cli_out, "sketch750")))
        if left != sorted(want):
            raise AssertionError(f"main --inpaint {flags} left {left}")
        log(f"  main --inpaint {' '.join(flags)}: "
            f"{time.perf_counter() - t0:.1f} s (build included), left {left}")
    return res


# ---------------------------------------------------------------------------
# phase 6: checkpoints and serving
# ---------------------------------------------------------------------------

# diffusers-layout files of the four diffusion components (what
# build.resolve_diffusion_checkpoints looks for)
DIFFUSION_FILES = {
    "unet": "stable-diffusion-inpainting/unet/"
            "diffusion_pytorch_model.safetensors",
    "vae": "stable-diffusion-inpainting/vae/"
           "diffusion_pytorch_model.safetensors",
    "text": "stable-diffusion-inpainting/text_encoder/model.safetensors",
    "controlnet": "control_v11p_sd15_inpaint/"
                  "diffusion_pytorch_model.safetensors",
}


def _equal_models(what: str, got, want) -> None:
    """Two modules' state dicts equal tensor by tensor (``want`` may be a
    state dict)."""
    import torch

    a = got.state_dict()
    b = want if isinstance(want, dict) else want.state_dict()
    if sorted(a) != sorted(b):
        raise AssertionError(f"checkpoints: {what} keys differ: "
                             f"{sorted(set(a) ^ set(b))[:10]}")
    for k, v in b.items():
        if not torch.equal(a[k].cpu(), v.cpu()):
            raise AssertionError(f"checkpoints: {what} differs at {k}")


def write_main_checkpoints(cfg, models_dir: str) -> float:
    """The seeded fp32 placeholder params of GroundingDINO, SAM and
    Depth-Anything-V2 (build_* with seed 0, on the CPU) as reference-layout
    ``.pth`` files, with the keys a published checkpoint carries and the
    loader must drop; returns the bytes written."""
    import torch

    from inklayer_tpu_torch.build import build_depth, build_detector, build_sam

    gdino = build_detector(cfg, "cpu", torch.float32, seed=0).model
    sd = {"module." + k: v for k, v in gdino.state_dict().items()}
    h = cfg.gdino.hidden_dim
    bert = cfg.gdino.bert.hidden_size
    sd.update({  # the BERT pooler, the denoising embedding, shared copies
        "module.bert.pooler.dense.weight": torch.zeros(bert, bert),
        "module.bert.pooler.dense.bias": torch.zeros(bert),
        "module.bert.embeddings.position_ids": torch.arange(512)[None],
        "module.label_enc.weight": torch.zeros(2001, h),
        "module.bbox_embed.1.layers.0.weight": torch.zeros(h, h),
        "module.transformer.decoder.bbox_embed.0.layers.0.weight":
            torch.zeros(h, h)})
    torch.save({"model": sd}, os.path.join(models_dir, "inklayer_gdino.pth"))
    del gdino, sd
    # SAM: its mask-prompt convnet (mask_downscaling) is part of the module
    sam = build_sam(cfg, "cpu", torch.float32, seed=0).model
    torch.save(sam.state_dict(),
               os.path.join(models_dir, "sam_vit_h_4b8939.pth"))
    del sam
    depth = build_depth(cfg, "cpu", torch.float32, seed=0).model
    sd = dict(depth.state_dict())
    f = cfg.depth.features
    sd["pretrained.mask_token"] = torch.zeros(1, cfg.depth.embed_dim)
    for conv in ("conv1", "conv2"):  # refinenet4's unit that never runs
        key = f"depth_head.scratch.refinenet4.resConfUnit1.{conv}"
        sd[f"{key}.weight"] = torch.zeros(f, f, 3, 3)
        sd[f"{key}.bias"] = torch.zeros(f)
    torch.save(sd, os.path.join(
        models_dir, f"depth_anything_v2_{cfg.depth.encoder}.pth"))
    return float(sum(os.path.getsize(os.path.join(models_dir, n))
                     for n in os.listdir(models_dir)))


def write_diffusion_checkpoints(cfg, models_dir: str) -> dict:
    """The seeded placeholder diffusion models as built for the card (bf16)
    written as diffusers-layout ``.safetensors``; returns {component:
    state dict written (CPU)}."""
    import torch

    from inklayer_tpu_torch.build import build_diffusion_models
    from inklayer_tpu_torch.io.weights import save_safetensors

    models = build_diffusion_models(cfg, "cuda", torch.bfloat16, seed=0)
    written = {}
    for name, rel in DIFFUSION_FILES.items():
        path = os.path.join(models_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        written[name] = {k: v.cpu() for k, v in
                         models[name].state_dict().items()}
        save_safetensors(written[name], path)
    del models
    torch.cuda.empty_cache()
    return written


def detect_segment(pipe, image) -> dict:
    """The default run's detect + segment on one image, as the runner
    chains them: top-K boxes, scores, low-res logits and the masks."""
    from inklayer_tpu_torch.pipeline.runner import boxes_cxcywh_to_sam_space

    h, w = image.shape[:2]
    fin, scores, boxes = pipe.detector.detect_device(image)
    state = pipe.sam.compute_image_state(image)
    lowres, iou = pipe.sam.decode_lowres_state(
        state, boxes_cxcywh_to_sam_space(boxes, (h, w), state["scale"]))
    det = fin()
    masks = pipe.sam.masks_from_lowres(state, lowres, max(len(det["boxes"]),
                                                          1))
    return {"scores": scores, "boxes": boxes, "lowres": lowres, "iou": iou,
            "masks": masks}


def _post(base: str, path: str, obj: dict):
    """A JSON request to the server through urllib: (status, body,
    seconds)."""
    import urllib.request

    req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read()), time.perf_counter() - t0


def phase_serving(card: str) -> dict:
    from wsgiref.simple_server import make_server

    import torch
    from PIL import Image

    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.serve.app import InkLayerApp
    from inklayer_tpu_torch.serve.server import ThreadingWSGIServer

    cfg = slice_config()
    models_dir = tempfile.mkdtemp(prefix="models_", dir=WORK)
    web_root = tempfile.mkdtemp(prefix="web_", dir=WORK)
    try:
        # (a) checkpoints: write, build from them, compare
        t0 = time.perf_counter()
        nbytes = write_main_checkpoints(cfg, models_dir)
        log(f"  wrote GroundingDINO, SAM and Depth-Anything-V2 as fp32 .pth: "
            f"{nbytes / 2 ** 30:.2f} GiB in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pipe = build_pipeline(cfg, device="cuda", dtype=torch.bfloat16,
                              models_dir=models_dir)
        torch.cuda.synchronize()
        log(f"  build_pipeline(models_dir=...) {time.perf_counter() - t0:.1f}"
            f" s (per component: the [build] lines above) [{card}]")
        # phase 3's in-memory build, again from seed 0; freed before serving
        in_memory = build_pipeline(cfg, device="cuda", dtype=torch.bfloat16,
                                   seed=0)
        for what, a, b in (("gdino", pipe.detector.model,
                            in_memory.detector.model),
                           ("sam", pipe.sam.model, in_memory.sam.model),
                           ("depth", pipe.depth.model, in_memory.depth.model)):
            _equal_models(what, a, b)
        rgb = np.array(Image.open(os.path.join(WORK, "sketch750.png"))
                       .convert("RGB"))
        image = torch.from_numpy(rgb).cuda()
        got, want = detect_segment(pipe, image), detect_segment(in_memory,
                                                                image)
        for key in want:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"checkpoints: {key} of detect + segment "
                                     f"differs from the in-memory build")
        log(f"  loaded models equal the in-memory build tensor by tensor; "
            f"detect + segment bit-identical ({tuple(want['masks'].shape)} "
            f"masks, {int(want['masks'].sum())} px)")
        del in_memory, got, want, image
        torch.cuda.empty_cache()
        for name in os.listdir(models_dir):  # the pipeline holds them now
            os.remove(os.path.join(models_dir, name))
        t0 = time.perf_counter()
        written = write_diffusion_checkpoints(cfg, models_dir)
        nbytes = sum(os.path.getsize(os.path.join(models_dir, r))
                     for r in DIFFUSION_FILES.values())
        log(f"  wrote the diffusion components as bf16 .safetensors: "
            f"{nbytes / 2 ** 30:.2f} GiB in {time.perf_counter() - t0:.1f} s")

        # (b) serving
        app = InkLayerApp(pipeline=pipe, root_dir=web_root, micro_batch=True)
        encoder = pipe._batched_encoder
        server = make_server("127.0.0.1", 0, app,
                             server_class=ThreadingWSGIServer)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            res = serve_requests(
                card, f"http://127.0.0.1:{server.server_port}", app, web_root)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            encoder.close()
        diffusion = pipe.inpainter.get_pipeline()
        for name, attr in (("text", "text_encoder"), ("unet", "unet"),
                           ("controlnet", "controlnet"), ("vae", "vae")):
            _equal_models(name, getattr(diffusion, attr), written[name])
        log("  diffusion components loaded by the server equal what was "
            "written, tensor by tensor")

        # the encoder's batch dimension end to end: B = 4 against B = 1
        pres = []
        for i in range(4):
            img = np.array(Image.open(os.path.join(
                web_root, "static", "uploads", f"serve{i}.png")).convert("RGB"))
            pres.append(pipe.sam._preprocess_meta(
                torch.from_numpy(img).cuda())[0])
        with torch.inference_mode():
            batched = pipe.sam.model.encode(torch.stack(pres)).float()
            rels = [float((batched[i] - one[0].float()).norm()
                          / one[0].float().norm())
                    for i, one in enumerate(pipe.sam.model.encode(p[None])
                                            for p in pres)]
        log(f"  SAM embeddings of the 4 sketches, batch 4 against one by one:"
            f" relative L2 {', '.join(f'{r:.3e}' for r in rels)} (limit "
            f"5e-3) [{card}]")
        if max(rels) > 5e-3:
            raise AssertionError(f"serving: batched embeddings off by "
                                 f"{max(rels):.3e}")
        del pipe, diffusion, app
        torch.cuda.empty_cache()
        return res
    finally:
        shutil.rmtree(models_dir, ignore_errors=True)
        shutil.rmtree(web_root, ignore_errors=True)


def _check_layers(app_root: str, urls) -> None:
    for url in urls:
        if not os.path.exists(os.path.join(app_root, url.lstrip("/"))):
            raise AssertionError(f"serving: layer URL {url} names no file")


def _delta(after: dict, before: dict) -> dict:
    """The launches between two snapshots of the counters, zeros left
    out."""
    d = {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}
    return {k: v for k, v in sorted(d.items()) if v}


def serve_requests(card: str, base: str, app, web_root: str) -> dict:
    """The requests of phase 6 through the running server: one
    ``/segment-sketch`` alone, the 4 sketches one after another, the 4 at
    once, two ``/inpaint``.  Each request's kernel launches are held to
    what it must launch: a sketch alone launches the default run's counts;
    the 4 at once launch what the 4 did one after another, with the SAM
    encoder's part scaled from 4 encodes to the batched encodes that ran.
    Returns the launches of the whole serving run."""
    import base64

    import torch
    from PIL import Image

    from inklayer_tpu_torch import _kernels

    pipe = app.pipeline
    for i in range(4):
        path = os.path.join(WORK, f"serve{i}.png")
        draw_sketch(path, shift=24 * i)
        with open(path, "rb") as f:
            data = base64.b64encode(f.read()).decode()
        status, body, _ = _post(base, "/save-canvas-drawing", {
            "imageData": "data:image/png;base64," + data,
            "filename": f"serve{i}"})
        if status != 200 or body["filename"] != f"serve{i}.png":
            raise AssertionError(f"serving: save-canvas-drawing {status} "
                                 f"{body}")
    encoder = pipe._batched_encoder
    # the launches of one SAM encode (any batch), read outside the run
    rgb = np.array(Image.open(os.path.join(WORK, "serve0.png")).convert("RGB"))
    pre = pipe.sam._preprocess_meta(torch.from_numpy(rgb).cuda())[0]
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        pipe.sam.model.encode(pre[None])
    per_encode = _delta(_kernels.launch_counts(), {})
    _kernels.reset_launch_counts()

    def segment(name, out):
        status, body, sec = _post(base, "/segment-sketch",
                                  {"imageName": name})
        if status != 200 or not body["layers"]:
            raise AssertionError(f"serving: segment-sketch {name}: {status} "
                                 f"{body}")
        _check_layers(web_root, body["layers"])
        out[name] = (sec, len(body["layers"]))

    def one(name, out):
        """A request on its own: one bucket-1 encode and the default
        run's launches."""
        counts, enc = _kernels.launch_counts(), dict(encoder.batcher.launches)
        segment(name, out)
        d = _delta(_kernels.launch_counts(), counts)
        e = _delta(encoder.batcher.launches, enc)
        if e != {1: 1} or any(d.get(k, 0) != n
                              for k, n in EXPECTED_LAUNCHES.items()):
            raise AssertionError(f"serving: {name} alone: launches {d}, "
                                 f"encoder {e}")
        return d

    alone = {}
    one("serve0", alone)
    log(f"  /segment-sketch alone [{card}]: {alone['serve0'][0] * 1e3:.1f} ms"
        f" ({alone['serve0'][1]} layers; the first request of this pipeline)")
    serial = {}
    t0 = time.perf_counter()
    serial_counts = [one(f"serve{i}", serial) for i in range(4)]
    serial_s = time.perf_counter() - t0
    secs = [serial[f"serve{i}"][0] * 1e3 for i in range(4)]
    log(f"  /segment-sketch, the 4 one after another [{card}]: "
        f"{serial_s * 1e3:.1f} ms in all ({4 / serial_s:.3f} requests/s), "
        f"each {', '.join(f'{x:.1f}' for x in secs)} ms")

    torch.cuda.reset_peak_memory_stats()
    together, errors = {}, []

    def guarded(name):
        try:
            segment(name, together)
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    counts, enc = _kernels.launch_counts(), dict(encoder.batcher.launches)
    threads = [threading.Thread(target=guarded, args=(f"serve{i}",))
               for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    window_s = time.perf_counter() - t0
    if errors or len(together) != 4:
        raise AssertionError(f"serving: concurrent requests failed: {errors}")
    d = _delta(_kernels.launch_counts(), counts)
    e = _delta(encoder.batcher.launches, enc)
    encodes = sum(e.values())
    want = {}
    for c in serial_counts:
        for k, n in c.items():
            want[k] = want.get(k, 0) + n
    for k, n in per_encode.items():
        want[k] = want.get(k, 0) + (encodes - 4) * n
    want = {k: n for k, n in sorted(want.items()) if n}
    if d != want:
        raise AssertionError(f"serving: 4 at once launched {d}, expected "
                             f"{want} ({encodes} encodes: {e})")
    if not any(b > 1 for b in e):
        raise AssertionError(f"serving: no encoder launch at a bucket above "
                             f"1: {e}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    secs = sorted(v[0] * 1e3 for v in together.values())
    log(f"  /segment-sketch, 4 at once from 4 threads [{card}]: "
        f"{window_s * 1e3:.1f} ms in all ({4 / window_s:.3f} requests/s), p50 "
        f"{statistics.median(secs):.1f} ms, max {secs[-1]:.1f} ms (each "
        f"{', '.join(f'{x:.1f}' for x in secs)}); peak memory allocated "
        f"{peak:.2f} GiB; encoder launches per bucket {e}; kernel launches "
        f"as expected from the 4 one after another ({encodes} encodes)")
    inpaint = []
    for label in ("first: builds the diffusion models from the files",
                  "warm"):
        counts = _kernels.launch_counts()
        status, body, sec = _post(base, "/inpaint", {
            "image_name": "serve0", "layer_id": 0,
            "layer_path": "/static/outputs/serve0/complete_layers_rgba/"
                          "layer_0.png", "prompt": "a cat"})
        if status != 200:
            raise AssertionError(f"serving: inpaint {status} {body}")
        _check_layers(web_root, [body["layer_url"]])
        d = _delta(_kernels.launch_counts(), counts)
        if d != EXPECTED_EDIT:
            raise AssertionError(f"serving: /inpaint launched {d}, expected "
                                 f"{EXPECTED_EDIT}")
        inpaint.append(sec * 1e3)
        log(f"  /inpaint ({label}) [{card}]: {sec * 1e3:.1f} ms")
    counts = _kernels.launch_counts()
    missing = [n for n in KERNELS if not counts.get(n)]
    log(f"  serving run [{card}]: launches {counts}; encoder launches per "
        f"bucket {encoder.batcher.launches}, requests they served "
        f"{encoder.batcher.served}")
    if missing:
        raise AssertionError(f"serving: kernels never launched: {missing}")
    return {"launches": counts, "alone_ms": alone["serve0"][0] * 1e3,
            "serial_ms": serial_s * 1e3, "together_ms": secs,
            "window_ms": window_s * 1e3, "inpaint_ms": inpaint,
            "peak_gib": peak, "buckets": dict(encoder.batcher.launches),
            "served": dict(encoder.batcher.served)}


def ptxas_entries(log_text: str) -> dict:
    """{mangled kernel name: {"regs", "stack", "spill_stores", "spill_loads",
    "smem"}} from nvcc's ``-Xptxas -v`` messages."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


def kernel_resources() -> None:
    """Registers, spills and shared memory of each attention and GEMM
    instance (the ptxas messages of this build, and the dynamic shared
    memory the launch asks for), and the LayerNorm instances' range."""
    import re

    from inklayer_tpu_torch import _kernels

    if not _kernels.build_log:
        log("  instances: library reused, no ptxas messages")
        return
    lib = _kernels.lib()
    ln = []
    for src, text in sorted(_kernels.build_log.items()):
        for name, info in ptxas_entries(text).items():
            m = re.search(r"attention_tile_kernelILi(\d+)ELb([01])E", name)
            g = re.search(r"gemm_bias_act_kernelILi(\d+)ELb([01])E", name)
            if "layernorm_kernel" in name:
                ln.append(info)
                continue
            if m:
                d, rel = int(m.group(1)), int(m.group(2))
                label = (f"attention_tile_kernel<{d}, "
                         f"{'true' if rel else 'false'}>")
                dyn = lib.ik_attention_smem_bytes(d, rel)
            elif g:
                bn, gelu = int(g.group(1)), int(g.group(2))
                label = (f"gemm_bias_act_kernel<{bn}, "
                         f"{'true' if gelu else 'false'}>")
                dyn = lib.ik_gemm_smem_bytes(bn)
            else:
                continue
            log(f"  {src:22s} {label}: {info.get('regs')} registers"
                f" (launch), {info.get('spill_stores')} B spill stores, "
                f"{info.get('spill_loads')} B spill loads, "
                f"{info.get('stack')} B stack, {info['smem']} B static + "
                f"{dyn} B dynamic shared memory")
            if info.get("spill_stores") or info.get("spill_loads"):
                log("    spills: the times below include them")
    if ln:
        regs = [i.get("regs", 0) for i in ln]
        spills = sum(i.get("spill_stores", 0) + i.get("spill_loads", 0)
                     for i in ln)
        log(f"  layernorm.cu {len(ln)} layernorm_kernel instances: "
            f"{min(regs)}-{max(regs)} registers, {spills} B spilled")


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
    path = _kernels.build(verbose=True)
    _kernels.lib()
    log(f"  {os.path.relpath(path, REPO)} ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{'not run: reused' if _kernels.build_seconds is None else f'{_kernels.build_seconds:.1f} s'})")
    kernel_resources()

    log(f"phase 2: kernels vs plain versions [{card}]")
    t0 = time.perf_counter()
    results = {}
    phase_kernels(results)
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    log(f"phase 3: the default run at full width [{card}]")
    t0 = time.perf_counter()
    slice_res = phase_slice(card)
    log(f"  phase 3: {time.perf_counter() - t0:.1f} s")

    log("phase 4: reference, card (bf16) vs CPU (fp32)")
    t0 = time.perf_counter()
    phase_reference()
    reference_diffusion()
    log(f"  phase 4: {time.perf_counter() - t0:.1f} s")

    log(f"phase 5: the inpainting path at full width [{card}]")
    t0 = time.perf_counter()
    inpaint_res = phase_inpaint(card)
    log(f"  phase 5: {time.perf_counter() - t0:.1f} s")

    log(f"phase 6: checkpoints and serving [{card}]")
    t0 = time.perf_counter()
    serve_res = phase_serving(card)
    log(f"  phase 6: {time.perf_counter() - t0:.1f} s")

    line = {"kernels": []}
    for name, (route, source, replaces) in KERNELS.items():
        cases = results[name]
        libs = [c["library_ms"] for c in cases]
        worst = max(cases, key=lambda c: c["bound_ms"])
        line["kernels"].append({
            # ms, plain_ms, bound_ms, library_ms: sums over the phase-2
            # cases; launches: the last timed runs of phases 3 and 5 and
            # the serving run of phase 6
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": slice_res["launches"].get(name, 0)
            + inpaint_res["bucket2"]["counts"].get(name, 0)
            + serve_res["launches"].get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": worst["bound_by"],
            "library_ms": None if None in libs else sum(libs)})
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
