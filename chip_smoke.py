#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (inklayer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build   — compile the hand-written kernels (csrc/*.cu, one nvcc per
             source, all started together, sm_90a, ``-Xptxas -v``) and
             print each attention, GEMM and convolution instance's
             registers, spills and shared memory;
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
             encode + decode at 512^2, full depth; SDXL's CLIP-L and
             OpenCLIP-bigG towers at full depth (penultimate states and
             the pooled output) and one SDXL UNet step at 512^2 with the
             pooled text and time_ids, full width, transformer depths cut
             to (0, 2, 2);
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

7. sweep   — the directory sweep (``InkLayerPipeline.run_dir``) at full
             width on 8 distinct 750^2 sketches with ``no_intermediate``
             (the JAX bench's sweep configuration, 16 sketches there, cut
             to 8 to keep the script in its time): the 8 runs one after
             another (the outputs and launches every sweep is held to),
             one warm sweep, then one timed sweep each with 1 worker (the
             lookahead), 2 workers, and batches of 2 and 4; each
             sweep's launches exact (the runs', with detection and SAM's
             encode counted once per batch of images), its outputs equal
             to the runs' file for file (IoU >= 0.99 of the final masks
             where batched), sketches/s; one sweep keeping every output
             (all 12 items per sketch), one traced sweep (idle share),
             peak memory; then ``main --dir --batch 2 --num_hosts 2
             --host_id 1`` on 4 sketches must write sketches 1 and 3;
8. conv    — the 3x3 NHWC convolution's entry point,
             ``scripts/torch_conv_ab.py``, at its four levels (checked,
             timed beside cuDNN, its TMA bytes per call);
9. sdxl    — the SDXL inpainting backend at full width
             (``SDXLInpaintPipeline.generate`` with the default
             ``SDXLConfig``: the 2.6 B-parameter UNet, the CLIP-L and
             OpenCLIP-bigG towers and the VAE at 1024^2, 20 steps, CFG
             batch 2; seeded placeholder weights, bf16) on a 1024^2 sketch
             and mask drawn here: one warm-up and one timed call, each with
             exactly 1400 flash-attention (head dim 64) and 4200 LayerNorm
             launches, finite latents and an output of the input's size;
             stage times, ms per step, peak memory; one traced call;
10. prompts — the device NMS front (``PipelineConfig.device_front``) on
             phase 3's sketch and configuration, off and on in turns (one
             warm-up each, then 3 pairs), keeping the intermediates and
             with ``no_intermediate``: launches exact and equal both ways,
             one read-back wait fewer with the front, bboxes_final.json and
             every masks_final/ PNG equal, p50 both ways, and the front
             alone traced (the traced runs each way were cut to keep the
             script in its time: phase 3 traces the run); the automatic mask
             generator (``SamAutomaticMaskGenerator.generate``) on the same
             sketch at the reference defaults (32 points per side, 64 a
             batch; a warm-up and a timed call) and with every stage
             exercised (16 per side, crop_n_layers 1, open thresholds),
             each with exact launches (SAM's encodes and decode batches,
             ``sam_launches``) and checked records; ``SamPredictor``
             point prompts with multimask output, then a mask prompt (the
             LayerNorm kernel at 64 x 64^2 rows of 16 channels); and
             ``python -m inklayer_tpu_torch.pipeline.mmdet_route`` writing
             the JAX package's JSON keys;
11. train  — fine-tuning through the train CLI's functions
             (``inklayer_tpu_torch.scripts.train``) at full width, fp32,
             seeded placeholder weights and synthetic samples: the ``sam``
             recipe at ``SamConfig()`` (ViT-H, 1024^2), ``depth`` at
             ``DepthConfig()`` (ViT-B, 518^2) and ``gdino`` at
             ``GDinoConfig()`` (Swin-T, 800^2), one warm step and 3 timed
             steps each (the depth model's output-head biases zeroed: on
             the placeholders its last ReLU is 0 everywhere): finite
             losses and gradient norms, parameters that move, no kernel
             launched, step times and peak memory; the
             full-width SAM decoder exported (``torch.export``), saved,
             loaded and run on the card against ``decode_boxes``; the
             three recipes at phase 4's cut depths on the card (fp32, TF32
             off for matmuls and cuDNN) against the CPU, one step each
             (loss and global gradient norm); the depth recipe through the
             CLI with a checkpoint and ``--resume`` (restored exactly);
             the eval CLI (``inklayer_tpu_torch.scripts.eval_inkscenes
             --sketch_dir``) on two sketches drawn here, scored against
             label matrices this script writes as MAT level-5 files, its
             launches phase 3's per run;
12. mesh   — two ranks on the one card (``parallel/mesh.py``, one process
             each): a probe of NCCL (two ranks on one device) and of the
             backend the rule picks (gloo), its collectives on CUDA
             tensors; SAM ViT-H at 1024², bf16, kernels on, encoded over
             tp=2 (head-parallel) against the single-process encode on
             the card (relative L2, exact per-rank launches: K1 + K2 32,
             K3 32 at hidden 2560, K4/K4r 66); GroundingDINO at 800²,
             bf16, over dp=2 on 2 images, each rank's boxes and logits
             against its rows of the batched forward (its launches the
             batched forward's); one fp32 SAM ViT-H train step over
             (1, 1, 2) and over (2, 1, 1) (and (1, 2, 1) where the
             backend gathers and scatters CUDA tensors) against one
             process within ``TRAIN_REL_TOL``, ms and peak memory per
             rank; ``dryrun_multichip(2)``; the train CLI under
             ``torchrun`` (GroundingDINO, dp=2, a checkpoint) resumed in
             one process; GroundingDINO at 800² and SAM ViT-H's mask
             decoder on 64 boxes, bf16, over tp=2 (head-parallel: 12
             MSDA launches per rank at 4 heads), each output's relative
             L2 to an fp32 plain run within 1.1 times the one-process
             bf16 result's;
13. depth  — the depth scripts (``inklayer_tpu_torch/scripts/depth_demo``
             and ``run_depth``) at full width, Depth-Anything-V2 ViT-L and
             ViT-S at 518², bf16, seeded placeholders: ``run_images`` on
             two 750² sketches and on a ``.txt`` list with ``--pred-only
             --grayscale`` (output sizes checked), exact flash-attention
             and LayerNorm launches per image, ms per image (p50 of 3 warm
             runs) and peak memory per encoder; ViT-L at cut depth (4
             blocks, full width) on the card against the CPU in fp32
             (relative error 5%, as phase 4); one ``--serve`` request
             through urllib answered with a PNG of the expected size; the
             ``run_depth`` CLI on the card as a subprocess; the video path
             where OpenCV is installed (a line says so where it is not);
14. bench  — the port's bench (``inklayer_tpu_torch.bench``): ``python -m
             inklayer_tpu_torch.bench --skip-full --skip-inpaint --iters
             3`` as a subprocess (every key, a finite p50, the card's
             name); one ``build_workload`` call at full width with exact
             launches (``BENCH_LAUNCHES``); ``measure_full_pipeline`` at
             cut counts (2 runs, one sweep of 2 sketches): every key,
             device busy ms per image, with and without the blob probe,
             non-null and below the wall time, ``masks_from_lowres``
             restored; ``measure_inpaint`` at 2 solver steps;
             ``scripts/bench_sam_vith.main()``; ``entry()``'s forward
             with exact launches.

Phase 2 also holds the flash attention and LayerNorm kernels at SDXL's
shapes (head dim 64 over 4096 and 1024 tokens; 8192 x 640 and 2048 x 1280
rows), the LayerNorm kernel at the SAM mask prompt's 64 x 64^2 rows of 16
channels, and the SAM encoder's kernels (relpos attention, MLP,
LayerNorm) at the SAM batch of 2 and 4 images that the micro-batched
encoder launches, multi-scale deformable attention at GroundingDINO's
batch of 2 and 4 images (the batched sweep), and the 3x3 convolution at
the four levels of the TPU prototype ``scripts/ablate_pallas_conv.py``,
each level's line naming ``ops/conv.py conv_config``'s choice.

The line before the last is one JSON object with each kernel's route,
source, the TPU kernel it replaces, launches in the last runs of phases 3
and 5, the serving run of phase 6, the timed sweeps of phase 7, phase 8,
the timed call of phase 9, the checked calls of phase 10, phase 11's
eval CLI, phase 12's sharded encodes and detects (both ranks) and phase
14's checked calls, error, times and bound; the last line is the device
record.  ``python3 chip_smoke.py --mesh-rank ...`` is one rank of phase
12 (started by the script itself).  Exits
non-zero without a card, and when run outside a checkout of the
repository.
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
    "conv3x3": (
        "cuda", "inklayer_tpu_torch/csrc/conv3x3.cu",
        "scripts/ablate_pallas_conv.py:51 make_pallas_conv_concat + "
        "scripts/ablate_pallas_conv.py:106 make_pallas_conv"),
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

    from inklayer_tpu_torch.ops import (attention, components, conv,
                                        deformable, mlp, norm)

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
                         ("global (64,4096,80) SAM batch 4", 64, 64),
                         ("windows (200,196,80) tp=2 rank", 200, 14),
                         ("global (8,4096,80) tp=2 rank", 8, 64)):
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
    # a tp=2 rank of SAM ViT-H: hidden 2560 (fc1 N = 2560, fc2 K = 2560;
    # the rank's partial sum, fc2's bias on one rank)
    hl = h // 2
    args = [randn(4096, c), randn(hl, c, std=c ** -0.5), randn(hl, std=0.1),
            randn(c, hl, std=hl ** -0.5), randn(c, std=0.1)]
    _kernel_case(
        results, "mlp_gelu", "(4096,1280)->(2560)->(1280) tp=2 rank",
        mlp.mlp_gelu, mlp.mlp_gelu_plain, args, 2e-2, 2e-2,
        bound(4.0 * 4096 * c * hl,
              2.0 * (2 * 4096 * c + 2 * hl * c + hl + c), PEAK_BF16),
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
    # path's CFG batch of 2 (levels 0, 1 and 2 at 768^2), SDXL's at
    # 1024^2 with CFG batch 2 (levels 1 and 2: 2 x 64^2 and 2 x 32^2 rows),
    # and the SAM mask prompt's LN(16) over the 64 prompts' 64^2 rows (2
    # lanes a row).
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
                               ("(1370,1024) DINOv2 ViT-L", 1370, 1024,
                                False),
                               ("(1370,384) DINOv2 ViT-S", 1370, 384, False),
                               ("(18432,320) UNet level 0", 18432, 320, False),
                               ("(4608,640) UNet level 1", 4608, 640, False),
                               ("(1152,1280) UNet level 2", 1152, 1280,
                                False),
                               ("(8192,640) SDXL level 1", 8192, 640, False),
                               ("(2048,1280) SDXL level 2", 2048, 1280,
                                False),
                               ("(262144,16) SAM mask prompt 64 x 64^2",
                                64 * 4096, 16, False)):
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
    # a tp=2 rank of GroundingDINO: its 4 of the 8 heads
    value_4 = randn(1, s_tot, 4, 32)
    for case, lq in (("encoder Lq=13294 tp=2 rank (4 heads)", s_tot),
                     ("decoder Lq=900 tp=2 rank (4 heads)", 900)):
        loc = (torch.rand(1, lq, 4, 4, 4, 2, generator=gen, device=dev)
               * 1.2 - 0.1)
        att = torch.softmax(torch.randn(1, lq, 4, 16, generator=gen,
                                        device=dev), -1).reshape(1, lq, 4, 4, 4)
        _kernel_case(
            results, "ms_deform_attn", case,
            lambda v: deformable.ms_deform_attn(v, shapes, loc, att),
            lambda v: deformable.ms_deform_attn_plain(v, shapes, loc, att),
            [value_4], 1e-2, 2e-2,
            bound(lq * 4 * 16 * (4 * 32 * 2 + 4 * 6),
                  2.0 * s_tot * 128 + 4.0 * lq * 4 * 16 * 3 + 2.0 * lq * 128,
                  PEAK_FP32))
    del value_4
    # the batched sweep's GroundingDINO at 2 and 4 images: b images' values,
    # queries and outputs in one launch
    for b in (2, 4):
        value_b = randn(b, s_tot, 8, 32)
        for case, lq in ((f"encoder Lq=13294 GDINO batch {b}", s_tot),
                         (f"decoder Lq=900 GDINO batch {b}", 900)):
            loc = (torch.rand(b, lq, 8, 4, 4, 2, generator=gen, device=dev)
                   * 1.2 - 0.1)
            att = torch.softmax(torch.randn(b, lq, 8, 16, generator=gen,
                                            device=dev), -1).reshape(
                b, lq, 8, 4, 4)
            _kernel_case(
                results, "ms_deform_attn", case,
                lambda v: deformable.ms_deform_attn(v, shapes, loc, att),
                lambda v: deformable.ms_deform_attn_plain(v, shapes, loc,
                                                          att),
                [value_b], 1e-2, 2e-2,
                bound(b * lq * 8 * 16 * (4 * 32 * 2 + 4 * 6),
                      b * (2.0 * s_tot * 256 + 4.0 * lq * 8 * 16 * 3
                           + 2.0 * lq * 256), PEAK_FP32))
        del value_b

    # the 3x3 NHWC convolution (KC) at the prototype's four levels, batch 2
    # (scripts/ablate_pallas_conv.py LEVELS): x normal, w normal x 0.02, as
    # there.  Tolerance: K = 9C sums up to 11,520 fp32 products before one
    # bf16 rounding -> relative L2 <= 5e-3, element-wise 1e-2 / 1e-2.
    # Library: F.conv2d (cuDNN, bf16) on the channels_last NCHW view with
    # OIHW weights.  Bound: 2 B H W 9 C Cout on the tensor cores; bytes:
    # x, w and the output once.
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_conv_ab import LEVELS as CONV_LEVELS, config_text, conv_bound

    from inklayer_tpu_torch import _kernels

    for li, (h, w, c) in enumerate(CONV_LEVELS):
        log(f"  conv3x3 level {li}: " + config_text(
            conv.conv_config(2, h, w, c, c, _kernels.sm_count(0))))
        x = randn(2, h, w, c)
        wt = randn(3, 3, c, c, std=0.02)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0,
                                                           1).contiguous()
        _kernel_case(
            results, "conv3x3", f"level {li} (2,{h},{w},{c})->{c}",
            conv.conv3x3_nhwc, conv.conv3x3_nhwc_plain, [x, wt], 1e-2, 1e-2,
            conv_bound(2, h, w, c, c),
            lambda: F.conv2d(x_nchw, w_oihw, padding=1), rel_l2=5e-3)
        del x, wt, x_nchw, w_oihw

    # flash attention.  Head dim 64: DINOv2 ViT-B at the 518^2 bucket, 12
    # heads x 1370 tokens (the last 128-key tile holds 90 keys), and
    # (2, 70, 64), one partial tile.  Head dims 40 and 80: the UNet's
    # self-attention at 768^2 for one layer with CFG (2 x 8 heads), 9216
    # tokens at level 0 and 2304 at level 1 (no partial tile), and tail
    # cases (2, 70, 40) and (2, 100, 80).  SDXL at 1024^2 with CFG batch 2:
    # 2 x 10 heads over 64^2 tokens (level 1) and 2 x 20 heads over 32^2
    # (level 2, 8 query tiles per head), head dim 64.  Tolerance: bf16
    # probabilities in PV, bf16 output -> element-wise 2e-2 / 2e-2, and
    # relative L2 <= 5e-3:
    # the kernels read 2.0e-3 to 2.3e-3, while a kernel that leaves the
    # tail keys unmasked scales whole rows (by ~0.983 at (12, 1370, 64))
    # and reads 1.7e-2 there, 0.33 at (2, 70, 64) (measured on 64-key
    # tiles).  Library: F.scaled_dot_product_attention on
    # (1, BH, N, D) views (on 3-D inputs it takes its unfused math path).
    for case, bh, n, d in (("(12,1370,64)", 12, 1370, 64),
                           ("(2,70,64) 70 of 128 keys", 2, 70, 64),
                           ("(6,1370,64) ViT-S / ViT-B tp=2 rank", 6, 1370,
                            64),
                           ("(16,1370,64) DINOv2 ViT-L", 16, 1370, 64),
                           ("(16,9216,40) UNet level 0", 16, 9216, 40),
                           ("(2,70,40) 70 of 128 keys", 2, 70, 40),
                           ("(16,2304,80) UNet level 1", 16, 2304, 80),
                           ("(2,100,80) 100 of 128 keys", 2, 100, 80),
                           ("(20,4096,64) SDXL level 1", 20, 4096, 64),
                           ("(40,1024,64) SDXL level 2", 40, 1024, 64)):
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


def reference_sdxl() -> dict:
    """SDXL's models at full width, card bf16 against CPU fp32 with the
    same seeded weights: both text towers at full depth on the default
    prompts (the penultimate states and the pooled output), and one UNet
    step (CFG batch 2, the pooled text and time_ids) at 512^2 with the
    transformer depths cut to (0, 2, 2) (level 1's 32^2 = 1024 tokens take
    the flash kernel on the card, level 2's 16^2 = 256 the plain sdpa).
    Built once on the CPU; the CPU runs first, then the same modules move
    to the card."""
    import torch

    from inklayer_tpu_torch.build import build_sdxl_models
    from inklayer_tpu_torch.models.diffusion import CLIPTokenizer
    from inklayer_tpu_torch.models.diffusion.sdxl import SDXLConfig

    cfg = SDXLConfig(resolution=512, transformer_layers=(0, 2, 2))
    s8 = cfg.resolution // 8
    t0 = time.perf_counter()
    models = build_sdxl_models(cfg, "cpu", torch.float32, seed=0)
    del models["vae"]
    log(f"  SDXL towers and cut-depth UNet built on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(8)
    lat = torch.randn(1, 4, s8, s8, generator=gen)
    mask_lat = (torch.rand(1, 1, s8, s8, generator=gen) > 0.5).float()
    nine = torch.cat([lat, mask_lat, torch.randn(1, 4, s8, s8, generator=gen)],
                     dim=1).expand(2, -1, -1, -1)
    ids = torch.from_numpy(np.concatenate([
        CLIPTokenizer().encode(cfg.negative_prompt),
        CLIPTokenizer().encode(cfg.prompt)])).long()
    ts = torch.tensor([500, 500], dtype=torch.int32)
    size = cfg.resolution
    tids = torch.tensor([[size, size, 0, 0, size, size]] * 2,
                        dtype=torch.float32)
    out = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        t0 = time.perf_counter()
        if dev == "cuda":
            for name, m in models.items():
                models[name] = m.to(device=dev, dtype=dtype)
            models["unet"] = models["unet"].to(
                memory_format=torch.channels_last)
        with torch.inference_mode():
            pen_l, _ = models["text_l"](ids.to(dev))
            pen_g, pooled = models["text_g"](ids.to(dev))
            eps = models["unet"](
                nine.to(dev).contiguous(memory_format=torch.channels_last),
                ts.to(dev), torch.cat([pen_l, pen_g], dim=-1),
                pooled_text=pooled, time_ids=tids.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"sdxl_clip_l_penultimate": pen_l.float().cpu(),
                    "sdxl_bigg_penultimate": pen_g.float().cpu(),
                    "sdxl_bigg_pooled": pooled.float().cpu(),
                    "sdxl_unet_eps_512": eps.float().cpu()}
        log(f"  {dev}: SDXL towers + one cut-depth UNet step at 512^2 "
            f"{time.perf_counter() - t0:.1f} s")
    del models
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
    # every kernel of the default run and the inpainting path (KC's path
    # is its own entry point, phase 8)
    missing = [n for n in KERNELS if n != "conv3x3" and not counts.get(n)]
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


# ---------------------------------------------------------------------------
# phase 7: the directory sweep
# ---------------------------------------------------------------------------

SWEEP_SKETCHES = 8
# the timed sweeps: (label, run_dir keywords); the batched ones with the
# default workers
SWEEP_MODES = (("workers 1 (lookahead)", {"workers": 1}),
               ("workers 2", {"workers": 2}),
               ("batch 2", {"batch_size": 2}),
               ("batch 4", {"batch_size": 4}))


def _tree_files(out_dir: str) -> dict:
    """{relative path: bytes} of every file under ``out_dir``."""
    got = {}
    for root, _, names in os.walk(out_dir):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                got[os.path.relpath(path, out_dir)] = f.read()
    return got


def _add_counts(total: dict, counts: dict, times: int = 1) -> dict:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + times * n
    return total


def _same_by_iou(got_dir: str, want_dir: str) -> float:
    """The least IoU of the final masks of two runs of one sketch, which
    must have as many; raises where they do not."""
    a, b = (_read_masks(d, "masks_final") for d in (got_dir, want_dir))
    if len(a) != len(b) or not len(a):
        raise AssertionError(f"sweep: {got_dir} has {len(a)} final masks, "
                             f"the run on its own {len(b)}")
    ious = [1.0 if not (x | y).any() else (x & y).sum() / (x | y).sum()
            for x, y in zip(a, b)]
    return float(min(ious))


def phase_sweep(card: str) -> dict:
    """The directory sweep at full width on 8 distinct 750^2 sketches,
    ``no_intermediate`` (the JAX bench's sweep configuration): per-image
    runs one after another (the outputs and launches each sweep must
    equal), one warm sweep, one timed sweep per mode with exact launch
    counts, one sweep keeping every output, one traced sweep, and the CLI
    sharded over two hosts."""
    import torch
    from PIL import Image

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.io.outputs import KEEP_LIST
    from inklayer_tpu_torch.main import main as cli_main
    from inklayer_tpu_torch.profiling import device_profile

    cfg = slice_config()
    pipe = build_pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    sketch_dir = os.path.join(WORK, "sweep_in")
    os.makedirs(sketch_dir, exist_ok=True)
    paths = []
    for i in range(SWEEP_SKETCHES):
        paths.append(os.path.join(sketch_dir, f"sketch{i:02d}.png"))
        draw_sketch(paths[-1], shift=i)
    names = [os.path.basename(p)[:-4] for p in paths]
    out = os.path.join(WORK, "sweep_out")

    # what one batched detection + SAM encode launches, at 1, 2 and 4
    # images (the batched sweep launches these once per group)
    images = [torch.from_numpy(np.array(Image.open(p).convert("RGB"))).cuda()
              for p in paths[:4]]
    front = {}
    for b in (1, 2, 4):
        _kernels.reset_launch_counts()
        pipe.detector.detect_batch(images[:b])
        pipe.sam.precompute_image_states(images[:b])
        front[b] = _delta(_kernels.launch_counts(), {})
    del images

    # the runs one after another: the outputs and launches to hold each
    # sweep to
    pipe.run(paths[0], os.path.join(out, "warm"), no_intermediate=True)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ref = [pipe.run(p, os.path.join(out, "one_by_one"), no_intermediate=True)
           for p in paths]
    one_by_one_s = time.perf_counter() - t0
    per_run = _delta(_kernels.launch_counts(), {})
    ref_files = [_tree_files(d) for d in ref]
    log(f"  run one image after another [{card}]: {one_by_one_s * 1e3:.1f} ms "
        f"for {len(paths)} sketches ({len(paths) / one_by_one_s:.3f} "
        f"sketches/s); launches {per_run}")
    pipe.run_dir(paths, os.path.join(out, "warm_sweep"), no_intermediate=True)

    res = {"one_by_one_sps": len(paths) / one_by_one_s, "modes": {},
           "launches": {}}
    peak = 0.0
    for label, kw in SWEEP_MODES:
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = pipe.run_dir(paths, os.path.join(out, label.split()[0]
                                                + label.split()[1]),
                            no_intermediate=True, **kw)
        sec = time.perf_counter() - t0
        counts = _delta(_kernels.launch_counts(), {})
        b = kw.get("batch_size", 1)
        want = dict(per_run)
        if b > 1:  # detection and SAM's encode once per group of b images
            _add_counts(want, front[1], -len(paths))
            _add_counts(want, front[b], len(paths) // b)
            want = {k: n for k, n in sorted(want.items()) if n}
        if counts != want:
            raise AssertionError(f"sweep {label}: launched {counts}, expected "
                                 f"{want}")
        if [os.path.basename(d) for d in outs] != names:
            raise AssertionError(f"sweep {label}: output dirs {outs}")
        for d in outs:
            left = sorted(os.listdir(d))
            if left != sorted(set(KEEP_LIST) & set(OUTPUTS)):
                raise AssertionError(f"sweep {label}: {d} holds {left}")
        if b == 1:  # the same device work as the runs on their own
            same = [_tree_files(d) == want_f for d, want_f in zip(outs,
                                                                  ref_files)]
            if not all(same):
                raise AssertionError(f"sweep {label}: outputs differ from the "
                                     f"runs on their own: {same}")
            agree = "every output file equal to the run's on its own"
        else:
            iou = min(_same_by_iou(d, r) for d, r in zip(outs, ref))
            if iou < 0.99:
                raise AssertionError(f"sweep {label}: final-mask IoU {iou}")
            agree = f"final masks IoU >= {iou:.4f} against the runs"
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        peak = max(peak, mem)
        sps = len(paths) / sec
        res["modes"][label] = {"sketches_per_s": sps, "ms": sec * 1e3,
                               "peak_gib": mem}
        _add_counts(res["launches"], counts)
        log(f"  sweep {label} [{card}]: {sec * 1e3:.1f} ms for {len(paths)} "
            f"sketches, {sps:.3f} sketches/s; stage sums " + ", ".join(
                f"{k} {v * 1e3:.1f}" for k, v in pipe.stage_times.items())
            + f" ms; peak memory allocated {mem:.2f} GiB; launches exact; "
            + agree)

    # every output kept, on 4 sketches
    outs = pipe.run_dir(paths[:4], os.path.join(out, "full"))
    for d in outs:
        if sorted(os.listdir(d)) != sorted(OUTPUTS):
            raise AssertionError(f"sweep with intermediates: {d} holds "
                                 f"{sorted(os.listdir(d))}")
    log(f"  sweep keeping every output: all {len(OUTPUTS)} items in each of "
        f"{len(outs)} sketches")
    # one traced sweep of 4 sketches in the default mode
    prof = device_profile(lambda: (pipe.run_dir(
        paths[:4], os.path.join(out, "traced"), no_intermediate=True),
        torch.cuda.synchronize()))
    res["idle_share"] = prof["idle_share"]
    log(f"  traced sweep (4 sketches, workers {cfg.sweep_workers}) [{card}]: "
        f"wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
        f"ms, idle share {prof['idle_share']:.3f}")
    res["peak_gib"] = peak
    log(f"  sweep peak memory allocated {peak:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()

    # the CLI: --dir of 4 sketches, batched, host 1 of 2 takes 1 and 3
    shard_in = os.path.join(WORK, "sweep_cli_in")
    os.makedirs(shard_in, exist_ok=True)
    for p in paths[:4]:
        shutil.copy(p, shard_in)
    cli_out = os.path.join(WORK, "sweep_cli_out")
    t0 = time.perf_counter()
    cli_main(["--dir", shard_in, "--out_dir", cli_out, "--batch", "2",
              "--num_hosts", "2", "--host_id", "1", "--no_intermediate"])
    if sorted(os.listdir(cli_out)) != [names[1], names[3]]:
        raise AssertionError(f"main --num_hosts 2 --host_id 1 wrote "
                             f"{sorted(os.listdir(cli_out))}")
    log(f"  main --dir --batch 2 --num_hosts 2 --host_id 1: "
        f"{time.perf_counter() - t0:.1f} s (build included), wrote "
        f"{sorted(os.listdir(cli_out))}")
    return res


def conv_entry(card: str) -> dict:
    """KC's entry point, ``scripts/torch_conv_ab.py``, at the four levels
    (batch 2): every level checked and timed; returns the launches."""
    from inklayer_tpu_torch import _kernels

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_conv_ab

    _kernels.reset_launch_counts()
    rows = torch_conv_ab.run([0, 1, 2, 3], batch=2, reps=5)
    counts = _kernels.launch_counts()
    log(f"  scripts/torch_conv_ab.py [{card}]: {len(rows)} levels; launches "
        f"{_delta(counts, {})}")
    if not counts["conv3x3"]:
        raise AssertionError("torch_conv_ab: conv3x3 never launched")
    return counts


# ---------------------------------------------------------------------------
# phase 9: the SDXL inpainting backend at full width
# ---------------------------------------------------------------------------

# one SDXL UNet forward (CFG batch 2, 1024^2: 128^2 latents) runs 70 basic
# blocks (down level 1: 2 x 2, level 2: 2 x 10; mid 10; up level 2: 3 x 10,
# level 1: 3 x 2): self-attention at 64^2 = 4096 tokens (10 blocks) and
# 32^2 = 1024 (60) takes the flash kernel at head dim 64, and their 3
# LayerNorms each (rows 2 x 4096 and 2 x 1024) the LayerNorm kernel; the
# text towers' 154 rows and 77 keys, the cross-attention and the VAE take
# the plain versions.  20 steps at strength 0.99 (t_start 0).
SDXL_STEPS = 20
EXPECTED_SDXL = {"flash_attention": 70 * SDXL_STEPS,
                 "flash_attention/d64": 70 * SDXL_STEPS,
                 "layernorm": 3 * 70 * SDXL_STEPS}


def sdxl_mask(size: int = 1024):
    """The region to inpaint: an ellipse over the sketch's lower boxes."""
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size]
    inside = np.hypot((yy - 640) / 220.0, (xx - 560) / 300.0) < 1.0
    return Image.fromarray(inside.astype(np.uint8) * 255)


def phase_sdxl(card: str) -> dict:
    """``SDXLInpaintPipeline.generate`` at full width (the default
    ``SDXLConfig``: 1024^2, 20 steps, strength 0.99, CFG 7.5 at batch 2),
    seeded placeholder weights, bf16, on a 1024^2 sketch and mask drawn
    here: one warm-up and one timed call, each with exact launch counts,
    finite latents of the right shape and an output of the input's size;
    then one traced call."""
    import gc

    import torch
    from PIL import Image

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_sdxl_models
    from inklayer_tpu_torch.models.diffusion.sdxl import (SDXLConfig,
                                                          SDXLInpaintPipeline)
    from inklayer_tpu_torch.profiling import device_profile

    cfg = SDXLConfig()
    assert cfg.num_steps == SDXL_STEPS and \
        round(cfg.num_steps * (1 - cfg.strength)) == 0
    t0 = time.perf_counter()
    models = build_sdxl_models(cfg, "cuda", torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  SDXL models built in {build_s:.1f} s")
    pipe = SDXLInpaintPipeline(models, cfg)
    path = os.path.join(WORK, "sketch1024.png")
    draw_sketch(path, size=cfg.resolution)
    image = Image.open(path).convert("RGB")
    mask = sdxl_mask(cfg.resolution)
    latents = []
    decode = pipe.vae.decode
    pipe.vae.decode = lambda z: (latents.append(z), decode(z))[1]
    res = {"build_s": build_s}
    for label in ("warm-up", "timed"):
        latents.clear()
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe.generate(image, mask)
        total = time.perf_counter() - t0
        counts = {k: n for k, n in _kernels.launch_counts().items() if n}
        if counts != EXPECTED_SDXL:
            raise AssertionError(f"sdxl {label}: launched {counts}, expected "
                                 f"{EXPECTED_SDXL}")
        finite = [bool(torch.isfinite(z).all()) for z in latents]
        if out.size != image.size or len(latents) != 1 or \
                tuple(latents[0].shape) != (1, 4, 128, 128) or \
                not all(finite):
            raise AssertionError(f"sdxl {label}: output {out.size}, final "
                                 f"latents {[tuple(z.shape) for z in latents]}"
                                 f", finite {finite}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        st = pipe.stage_times
        step_ms = st["loop"] / st["steps"] * 1e3
        log(f"  generate ({label}) [{card}]: {total * 1e3:.1f} ms; per step "
            f"{step_ms:.1f} ms ({st['steps']} steps, CFG batch 2); encode "
            f"{st['encode'] * 1e3:.1f}, loop {st['loop'] * 1e3:.1f}, decode "
            f"{st['decode'] * 1e3:.1f} ms; latents |max| "
            f"{float(latents[0].abs().max()):.3f}; peak memory allocated "
            f"{peak:.2f} GiB; launches {counts}")
        res.update(total_ms=total * 1e3, step_ms=step_ms, peak_gib=peak,
                   launches=counts)
    prof = device_profile(lambda: (pipe.generate(image, mask),
                                   torch.cuda.synchronize()))
    res["idle_share"] = prof["idle_share"]
    log(f"  traced generate [{card}]: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {prof['busy_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}, {prof['device_ops']} device ops")
    for name, ms, calls in prof["kernels"]:
        log(f"    {ms:9.3f} ms  {calls:6d} x  {name[:90]}")
    pipe.vae.decode = decode
    del pipe, models, latents
    gc.collect()
    torch.cuda.empty_cache()
    return res

# ---------------------------------------------------------------------------
# phase 10: the device NMS front, SAM's point and mask prompts, the
# automatic mask generator and the mmdetection route's producer
# ---------------------------------------------------------------------------

SAM_BLOCKS = 32
# LayerNorm launches of SAM ViT-H: per encode, the residual pair of each of
# the 32 blocks (norm1, norm2: 4096 x 1280 rows) and the neck's two (4096 x
# 256); per decode of n prompts with t sparse tokens each, the keys' norm4
# of both two-way layers (n x 4096 rows) and the upscaling LN(64) (n x
# 128^2), and the 7 query norms (norm1-3 of both layers, norm_final_attn)
# only when their n x (5 + t) rows reach the kernel's 512 (at the 64
# prompts of a box or point batch, t = 2: 448 rows, so not); a mask prompt
# adds LN(16) over n x 64^2 rows (LN(4) takes the plain version)
LN_PER_ENCODE = 2 * SAM_BLOCKS + 2


def sam_layernorm_launches(encodes: int, decodes: int, n: int = 64,
                           t: int = 2, mask_prompts: int = 0) -> int:
    per_decode = 2 + 1 + (7 if n * (5 + t) >= 512 else 0)
    return encodes * LN_PER_ENCODE + decodes * per_decode + mask_prompts


def sam_launches(encodes: int, decodes: int, mask_prompts: int = 0) -> dict:
    """Every kernel launch of SAM encodes and 64-prompt decodes."""
    return {"layernorm": sam_layernorm_launches(encodes, decodes,
                                                mask_prompts=mask_prompts),
            "mlp_gelu": SAM_BLOCKS * encodes,
            "relpos_attention": SAM_BLOCKS * encodes}


def _front_pairs(card: str, pipe, cfg, sketch: str, no_intermediate: bool):
    """The default run with the device front off and on, in turns: one
    warm-up each, then TIMED_RUNS pairs; launches exact and equal both
    ways, one read-back fewer with the front, and the same final files."""
    from inklayer_tpu_torch import _kernels

    mode = "no_intermediate" if no_intermediate else "intermediates kept"
    times = {False: [], True: []}
    dirs, syncs, counts = {}, {}, {}
    for i in range(1 + TIMED_RUNS):
        for on in (False, True):
            pipe.cfg = dataclasses.replace(cfg, device_front=on)
            _kernels.reset_launch_counts()
            before = pipe.sync_count
            t0 = time.perf_counter()
            dirs[on] = pipe.run(sketch, os.path.join(
                WORK, f"front_{int(on)}_{int(no_intermediate)}"),
                no_intermediate=no_intermediate)
            ms = (time.perf_counter() - t0) * 1e3
            syncs[on] = pipe.sync_count - before
            counts[on] = _delta(_kernels.launch_counts(), {})
            if i:
                times[on].append(ms)
        for name, want in EXPECTED_LAUNCHES.items():
            if counts[True].get(name, 0) != want:
                raise AssertionError(f"device front ({mode}): {name} "
                                     f"launched {counts[True].get(name, 0)} "
                                     f"times, expected {want}")
        if counts[True] != counts[False]:
            raise AssertionError(f"device front ({mode}): launches "
                                 f"{counts[True]} with it, {counts[False]} "
                                 f"without")
        if syncs[True] != syncs[False] - 1:
            raise AssertionError(f"device front ({mode}): {syncs[True]} "
                                 f"read-back waits with it, {syncs[False]} "
                                 f"without (one fewer expected)")
        _same_final_outputs(dirs[False], dirs[True], mode)
    p50 = {on: statistics.median(times[on]) for on in times}
    log(f"  device front {mode} [{card}]: p50 over {TIMED_RUNS} pairs in "
        f"turns, off {p50[False]:.1f} ms, on {p50[True]:.1f} ms (runs off "
        f"{[round(t, 1) for t in times[False]]}, on "
        f"{[round(t, 1) for t in times[True]]}); read-back waits per run "
        f"off {syncs[False]}, on {syncs[True]}; launches exact and equal "
        f"{counts[True]}; bboxes_final.json and masks_final/ equal")
    pipe.cfg = cfg
    return {"p50_ms": p50, "launches": counts[True], "syncs": syncs}


def _same_final_outputs(off_dir: str, on_dir: str, mode: str) -> None:
    """bboxes_final.json and every masks_final/ PNG of the two runs equal;
    where they are not, the row and both values are printed and the phase
    fails."""
    with open(os.path.join(off_dir, "bboxes_final.json")) as f:
        off = json.load(f)
    with open(os.path.join(on_dir, "bboxes_final.json")) as f:
        on = json.load(f)
    if off != on:
        for key in sorted(set(off) | set(on)):
            a, b = off.get(key), on.get(key)
            if a != b:
                log(f"  device front ({mode}): bboxes_final.json[{key!r}] off "
                    f"{a} on {b}")
        raise AssertionError(f"device front ({mode}): bboxes_final.json "
                             f"differs")
    names_off = sorted(os.listdir(os.path.join(off_dir, "masks_final")))
    names_on = sorted(os.listdir(os.path.join(on_dir, "masks_final")))
    if names_off != names_on:
        raise AssertionError(f"device front ({mode}): masks_final off "
                             f"{names_off}, on {names_on}")
    a = _read_masks(off_dir, "masks_final")
    b = _read_masks(on_dir, "masks_final")
    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            ys, xs = np.nonzero(x != y)
            log(f"  device front ({mode}): mask_{i}.png differs in "
                f"{len(ys)} pixels, first at row {ys[0]} col {xs[0]}: off "
                f"{bool(x[ys[0], xs[0]])} on {bool(y[ys[0], xs[0]])}")
            raise AssertionError(f"device front ({mode}): masks_final "
                                 f"differ")


def _front_alone(card: str, pipe, sketch: str) -> None:
    """The device front's own cost: one call on the arguments a run gave
    it, traced (its eager greedy scan: K steps of a few launches)."""
    import torch

    from inklayer_tpu_torch.pipeline import runner
    from inklayer_tpu_torch.pipeline.refine import front, nms
    from inklayer_tpu_torch.profiling import device_profile

    seen = []

    def keep_args(*args, **kw):
        seen.append((args, kw))
        return front.nms_depth_front_device(*args, **kw)

    cfg = pipe.cfg
    runner.nms_depth_front_device = keep_args
    pipe.cfg = dataclasses.replace(cfg, device_front=True)
    try:
        pipe.run(sketch, os.path.join(WORK, "front_args"),
                 no_intermediate=True)
    finally:
        runner.nms_depth_front_device = front.nms_depth_front_device
        pipe.cfg = cfg
    args, kw = seen[0]
    fn = lambda: (front.nms_depth_front_device(*args, **kw),
                  torch.cuda.synchronize())
    fn()
    t0 = time.perf_counter()
    fn()
    wall = (time.perf_counter() - t0) * 1e3
    prof = device_profile(fn)
    valid, gate, bb, order = front.device_prefilter_gates(
        args[0], args[1], args[3], args[5], args[6].nms_max_area_frac,
        args[6].nms_max_contained, args[6].nms_eps_px_per_kdiag,
        kw["box_threshold"])
    iou = torch.rand(len(order), len(order), device="cuda")
    scan = lambda: (nms.greedy_nms(iou, gate, bb, order, 0.5, 0.7),
                    torch.cuda.synchronize())
    scan()
    scan_prof = device_profile(scan)
    log(f"  nms_depth_front_device alone at K {len(order)} [{card}]: "
        f"{wall:.1f} ms wall, {prof['device_ops']} device ops, device busy "
        f"{prof['busy_ms']:.2f} ms; its greedy scan alone "
        f"{scan_prof['wall_ms']:.1f} ms traced wall, "
        f"{scan_prof['device_ops']} device ops, busy "
        f"{scan_prof['busy_ms']:.2f} ms")


def _check_amg_records(records, hw, what: str) -> None:
    from inklayer_tpu_torch.models.sam.amg import rle_to_mask

    keys = {"segmentation", "rle", "area", "bbox", "bbox_xyxy", "crop_box",
            "predicted_iou", "stability_score", "point_coords"}
    h, w = hw
    for i, r in enumerate(records):
        if set(r) != keys:
            raise AssertionError(f"{what}: record {i} keys {sorted(r)}")
        seg = r["segmentation"]
        if seg.shape != (h, w) or seg.dtype != bool:
            raise AssertionError(f"{what}: record {i} segmentation "
                                 f"{seg.shape} {seg.dtype}")
        if not np.array_equal(rle_to_mask(r["rle"]), seg):
            raise AssertionError(f"{what}: record {i}: rle_to_mask(rle) is "
                                 f"not the segmentation")
        x0, y0, x1, y1 = r["bbox_xyxy"]
        if not (0 <= x0 <= x1 <= w and 0 <= y0 <= y1 <= h):
            raise AssertionError(f"{what}: record {i} box {r['bbox_xyxy']} "
                                 f"outside the {w} x {h} image")
        if r["area"] != int(seg.sum()) or not np.isfinite(
                [r["predicted_iou"], r["stability_score"]]).all():
            raise AssertionError(f"{what}: record {i} area or scores")


def _amg_call(card: str, amg, image, what: str, want: dict,
              timed: bool) -> tuple:
    import torch

    from inklayer_tpu_torch import _kernels

    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    records = amg.generate(image)
    ms = (time.perf_counter() - t0) * 1e3
    counts = _delta(_kernels.launch_counts(), {})
    if counts != want:
        raise AssertionError(f"{what}: launched {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if timed:
        log(f"  {what} [{card}]: {ms:.1f} ms per call, {len(records)} "
            f"records, {amg.last_survivors} survivors of the IoU and "
            f"stability filters before NMS, peak memory allocated "
            f"{peak:.2f} GiB; launches exact {counts}")
    return records, counts


def phase_prompts(card: str) -> dict:
    """The device NMS front against the host front (both run modes), the
    automatic mask generator at the reference defaults and with every
    stage exercised, point and mask prompts through the predictor, and
    the mmdetection route's producer."""
    import torch
    from PIL import Image

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.models.sam.amg import SamAutomaticMaskGenerator

    cfg = slice_config()
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    sketch = os.path.join(WORK, "sketch750.png")
    draw_sketch(sketch)
    total = {}
    for no_intermediate in (False, True):
        res = _front_pairs(card, pipe, cfg, sketch, no_intermediate)
        _add_counts(total, res["launches"], 2)
    _front_alone(card, pipe, sketch)
    log(f"  the device front: {time.perf_counter() - t0:.1f} s (build "
        f"included)")
    t0 = time.perf_counter()

    image = np.array(Image.open(sketch).convert("RGB"))
    amg = SamAutomaticMaskGenerator(pipe.sam)  # 32 per side, 64 a batch
    want = sam_launches(1, 32 * 32 // 64)
    _amg_call(card, amg, image, "AMG defaults (warm-up)", want, False)
    records, counts = _amg_call(card, amg, image,
                                "AMG at the reference defaults, 32 per side",
                                want, True)
    _check_amg_records(records, image.shape[:2], "AMG defaults")
    _add_counts(total, counts)
    amg = SamAutomaticMaskGenerator(
        pipe.sam, points_per_side=16, crop_n_layers=1,
        pred_iou_thresh=-float("inf"), stability_score_thresh=0.0)
    want = sam_launches(5, 5 * 16 * 16 // 64)
    records, counts = _amg_call(
        card, amg, image, "AMG 16 per side, crop_n_layers 1, open thresholds",
        want, True)
    if not records:
        raise AssertionError("AMG with open thresholds made no record")
    _check_amg_records(records, image.shape[:2], "AMG crop_n_layers 1")
    _add_counts(total, counts)

    # points, multimask, then a mask prompt from the first decode
    sam = pipe.sam
    _kernels.reset_launch_counts()
    sam.set_image(image)
    coords = np.asarray([[[200.0, 210.0]], [[500.0, 560.0]], [[700.0, 30.0]]])
    labels = np.ones((3, 1), np.int64)
    masks, iou, low = sam.predict(point_coords=coords, point_labels=labels,
                                  multimask_output=True)
    counts = _delta(_kernels.launch_counts(), {})
    if counts != sam_launches(1, 1):
        raise AssertionError(f"set_image + point predict launched {counts}, "
                             f"expected {sam_launches(1, 1)}")
    if masks.shape != (3, 3) + image.shape[:2] \
            or not np.isfinite(iou).all() \
            or iou.shape != (3, 3):
        raise AssertionError(f"point predict: masks {masks.shape}, iou "
                             f"{iou}")
    _add_counts(total, counts)
    _kernels.reset_launch_counts()
    m2, iou2, low2 = sam.predict(point_coords=coords, point_labels=labels,
                                 mask_input=low[:, 0])
    counts = _delta(_kernels.launch_counts(), {})
    want = _delta({"layernorm": sam_layernorm_launches(0, 1,
                                                       mask_prompts=1)}, {})
    if counts != want:
        raise AssertionError(f"mask-prompt decode launched {counts}, "
                             f"expected {want}")
    if m2.shape != (3,) + image.shape[:2] or not (np.isfinite(iou2).all()
                                         and np.isfinite(low2).all()):
        raise AssertionError("mask-prompt decode is not finite")
    _add_counts(total, counts)
    log(f"  SamPredictor.set_image + predict (3 points, multimask) [{card}]: "
        f"masks {masks.shape}, iou finite, launches exact; mask-prompt "
        f"decode: masks {m2.shape}, finite, launches {counts} (LN(16) over "
        f"64 x 64^2 rows included); AMG and prompts "
        f"{time.perf_counter() - t0:.1f} s")
    del pipe, sam, amg
    torch.cuda.empty_cache()

    # the mmdetection route's producer, as its users call it
    out = os.path.join(WORK, "mmdet_out")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "inklayer_tpu_torch.pipeline.mmdet_route", "--img",
                    sketch, "--nouns", "cat", "dog", "--out_dir", out],
                   cwd=REPO, check=True)
    with open(os.path.join(out, "sketch750.json")) as f:
        data = json.load(f)
    if set(data) != {"bboxes", "labels", "scores", "model_info"} or set(
            data["model_info"]) != {"model_config", "weights", "device",
                                    "score_threshold", "time"}:
        raise AssertionError(f"mmdet_out/sketch750.json keys {sorted(data)}")
    if sorted(os.listdir(out)) != ["input_image.png", "pred.png",
                                   "sketch750.json"]:
        raise AssertionError(f"mmdet_out holds {sorted(os.listdir(out))}")
    log(f"  python -m inklayer_tpu_torch.pipeline.mmdet_route: "
        f"{time.perf_counter() - t0:.1f} s (start and build included), "
        f"{len(data['bboxes'])} boxes, model_info {data['model_info']}")
    return {"launches": total}



# ---------------------------------------------------------------------------
# phase 11: fine-tuning, checkpoints, evaluation, export
# ---------------------------------------------------------------------------

TRAIN_TASKS = ("sam", "depth", "gdino")
TRAIN_STEPS = 3
# card (fp32, TF32 off) against the CPU at cut depth, one train step from
# the same params and batch: (loss, global gradient norm, clipped
# gradients' L2 over every leaf), each relative.  Per recipe, between the
# sound readings (fp32 on both sides, other summation orders) and a
# control step on the card with TF32 on for matmuls and cuDNN, which must
# fail them.  Read on an H100 80GB HBM3 at 700 W, sound / control: SAM
# 1.05e-7 / 1.36e-4, 9.21e-8 / 3.12e-4, 3.14e-7 / 9.0e-3; depth 6e-8 /
# 1.01e-5, 5.22e-6 / 5.55e-5, 6.89e-7 / 4.09e-5; GDINO 2.44e-7 / 5.16e-3,
# 2.23e-7 / 8.8e-4, 1.2e-6 / 7.98e-3
TRAIN_REL_TOL = {"sam": (3e-6, 3e-6, 3e-5), "depth": (1e-6, 1.5e-5, 5e-6),
                 "gdino": (3e-5, 1e-5, 1e-4)}
# the exported decoder against decode_boxes on the card, both fp32 with the
# LayerNorm kernel (the program as its custom op): relative L2 of the
# logits and the IoU; the same ops, other graphs (PR 12 read 3.4e-7 with
# the program's LayerNorm plain)
EXPORT_REL_L2 = 1e-5


def train_cut_config(task: str, cfg):
    """Full width, cut depth (phase 4's cuts)."""
    if task == "sam":
        return dataclasses.replace(cfg, encoder_depth=2,
                                   encoder_global_attn_indexes=(1,))
    if task == "depth":
        return dataclasses.replace(cfg, depth=4,
                                   intermediate_layers=(0, 1, 2, 3))
    return dataclasses.replace(cfg, enc_layers=1, dec_layers=1)


def live_depth_head(model) -> None:
    """Zero the DPT output head's biases (flax's bias init, what the JAX
    CLI's ``model.init`` gives).  With the std-0.02 placeholder biases the
    head's last ReLU is 0 at every pixel of the full-width model, so the
    SiLog loss has no gradient and no parameter could move."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("depth_head.scratch.output_conv2.") and \
                    name.endswith(".bias"):
                p.zero_()


def live_sam_logits(model) -> None:
    """Scale the mask decoder's hypernetwork output layers by 100: with the
    std-0.02 placeholders SAM's mask logits are ~1e-2 (the loss is the
    p = 0.5 constant and the gradient sits in the decoder's last layers);
    scaled, they are O(1) and the gradient reaches the image encoder."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("mask_decoder.output_hypernetworks_mlps.") \
                    and ".layers.2." in name:
                p.mul_(100.0)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _train_full(card: str, task: str, export_dir: str) -> dict:
    """The recipe at full width through the CLI's functions: one warm step
    and TRAIN_STEPS timed ones, no kernel launch, finite losses and
    gradients, parameters that move; for SAM also the decoder export."""
    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.train import Trainer, adamw
    from inklayer_tpu_torch.scripts import train as cli

    args = cli.parse_args(["--task", task, "--synthetic", "2"])
    cfg, size = cli.task_config(args)
    t0 = time.perf_counter()
    t = cli.make_task(task, cfg, size, np.random.default_rng(args.seed))
    model = cli.init_model(t, "cuda", args.seed)
    if task == "depth":
        live_depth_head(model)
    n_params = sum(p.numel() for p in model.parameters())
    it = cli.batches(cli.load_samples(args, t), args.batch)
    trainer = Trainer(t.loss_fn, model,
                      optimizer=adamw(model.parameters(), args.lr),
                      max_grad_norm=1.0)
    watch = [p for p in trainer.params[:2] + trainer.params[-2:]]
    before = [p.detach().clone() for p in watch]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, norms, times = [], [], []
    for step in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = trainer.train_step(next(it))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        norms.append(float(trainer.grad_norm))
    launched = {k: v for k, v in _kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launched:
        raise AssertionError(f"train {task}: kernels launched in the train "
                             f"steps: {launched}")
    # one more step under the FLOP counter (matmuls, convolutions and
    # attention, forward and backward; elementwise work is not counted)
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        losses.append(float(trainer.train_step(next(it))))
        norms.append(float(trainer.grad_norm))
    flops = counter.get_total_flops()
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"train {task}: losses {losses}, grad norms "
                             f"{norms}")
    moved = sum(float((p.detach() - b).abs().sum())
                for p, b in zip(watch, before))
    if not moved > 0:
        raise AssertionError(f"train {task}: the parameters did not move")
    step_ms = statistics.median(times[1:])
    log(f"  train {task} at full width ({n_params / 1e6:.1f} M params, "
        f"fp32, batch {args.batch}) [{card}]: built in {build_s:.1f} s; "
        f"warm step {times[0]:.1f} ms, steps "
        f"{', '.join(f'{x:.1f}' for x in times[1:])} ms (median "
        f"{step_ms:.1f}); losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"grad norms {', '.join(f'{x:.4g}' for x in norms)}; peak memory "
        f"allocated {peak:.2f} GiB; no kernel launched; counted "
        f"{flops / 1e12:.4f} TFLOP per step (torch.utils.flop_counter), "
        f"{flops / step_ms / 1e9:.2f} TFLOP/s at the median step, "
        f"{flops / step_ms * 1e3 / PEAK_FP32:.3f} of the fp32 "
        f"peak")
    out = {"step_ms": step_ms, "peak_gib": peak, "tflop": flops / 1e12}
    if task == "sam":
        del trainer
        out["export"] = _export_decoder(card, model.eval(), cfg, export_dir)
    del model
    torch.cuda.empty_cache()
    return out


def _export_decoder(card: str, model, cfg, export_dir: str) -> dict:
    """The full-width SAM decoder exported, saved, loaded and run on the
    card against ``decode_boxes``."""
    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.io.export import export_sam_decoder, load_exported

    path = os.path.join(export_dir, "sam_decoder.pt2")
    t0 = time.perf_counter()
    _, blob = export_sam_decoder(model, cfg, path, box_capacity=64)
    program = load_exported(path).module()
    export_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(7)
    grid = cfg.image_size // cfg.patch_size
    emb = torch.randn((1, grid, grid, cfg.prompt_embed_dim),
                      generator=gen).cuda()
    xy = torch.rand((64, 2), generator=gen) * 700
    boxes = torch.cat([xy, xy + 40 + torch.rand((64, 2), generator=gen)
                       * 300], 1).cuda()
    with torch.no_grad():
        _kernels.reset_launch_counts()
        got = program(emb, boxes)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _kernels.launch_counts().items() if v}
        _kernels.reset_launch_counts()
        want = model.decode_boxes(emb, boxes)
        kernels = {k: v for k, v in _kernels.launch_counts().items() if v}
    if kernels != {"layernorm": sam_layernorm_launches(0, 1)} or \
            launched != kernels:
        raise AssertionError(f"export: the program launched {launched}, "
                             f"decode_boxes {kernels}")
    errs = []
    for name, a, b in zip(("logits", "iou"), got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"export: {name} {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)} or not finite")
        errs.append(float((a - b).float().norm() / b.float().norm()))
        if errs[-1] > EXPORT_REL_L2:
            raise AssertionError(f"export: {name} relative L2 {errs[-1]:.3g}"
                                 f" > {EXPORT_REL_L2}")
    log(f"  export of the full-width SAM decoder [{card}]: "
        f"{len(blob) / 2 ** 20:.1f} MiB .pt2 in {export_s:.1f} s; loaded "
        f"program on the card vs decode_boxes: relative L2 logits "
        f"{errs[0]:.3g}, iou {errs[1]:.3g} (limit {EXPORT_REL_L2}); both "
        f"launched {launched}")
    return {"rel_l2": errs, "launches": launched}


def _train_step_readings(task: str) -> dict:
    """One train step at cut depth from the same params and batch on the
    CPU, on the card (fp32, TF32 off) and on the card with TF32 on (the
    control): {device: (loss, grad norm, clipped gradients on the CPU,
    seconds)}."""
    import copy

    import torch

    from inklayer_tpu_torch.parallel.train import Trainer, adamw
    from inklayer_tpu_torch.scripts import train as cli

    args = cli.parse_args(["--task", task, "--synthetic", "1"])
    cfg, size = cli.task_config(args)
    cfg = train_cut_config(task, cfg)
    t = cli.make_task(task, cfg, size, np.random.default_rng(args.seed))
    cpu_model = cli.init_model(t, "cpu", args.seed)
    if task == "depth":
        live_depth_head(cpu_model)
    if task == "sam":
        live_sam_logits(cpu_model)
    models = {"cuda": copy.deepcopy(cpu_model).cuda(),
              "tf32": copy.deepcopy(cpu_model).cuda(), "cpu": cpu_model}
    batch = next(cli.batches(cli.load_samples(args, t), 1))
    got = {}
    for dev, model in models.items():
        tf32 = dev == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            t0 = time.perf_counter()
            trainer = Trainer(t.loss_fn, model, optimizer=adamw(
                model.parameters(), args.lr), max_grad_norm=1.0)
            loss = float(trainer.train_step(batch))
            grads = [p.grad.detach().float().cpu() for p in trainer.params]
            got[dev] = (loss, float(trainer.grad_norm), grads,
                        time.perf_counter() - t0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        del trainer
        models[dev] = None
        del model
    torch.cuda.empty_cache()
    return got


def _against_cpu(got: dict, dev: str):
    """(loss, grad norm, gradient) relative errors of ``dev`` against the
    CPU."""
    loss, norm, grads, _ = got[dev]
    want = got["cpu"]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(grads, want[2]))
    den = sum(float((b ** 2).sum()) for b in want[2])
    return (_rel(loss, want[0]), _rel(norm, want[1]),
            (num / max(den, 1e-30)) ** 0.5)


def _train_reference(task: str) -> dict:
    """Card (fp32, TF32 off) against the CPU at cut depth within the
    recipe's limits, and the TF32 control outside them."""
    got = _train_step_readings(task)
    sound = _against_cpu(got, "cuda")
    control = _against_cpu(got, "tf32")
    limit = TRAIN_REL_TOL[task]
    fmt = lambda r: ", ".join(f"{k} {v:.3g}" for k, v in zip(
        ("loss", "grad norm", "gradients"), r))
    log(f"  train {task} at cut depth, against the CPU (loss "
        f"{got['cpu'][0]!r}, grad norm {got['cpu'][1]!r}, CPU step "
        f"{got['cpu'][3]:.1f} s): card fp32, TF32 off: {fmt(sound)}; card "
        f"TF32 on (control): {fmt(control)}; limits {limit}")
    if not all(r <= lim for r, lim in zip(sound, limit)):
        raise AssertionError(f"train {task}: card and CPU disagree "
                             f"({fmt(sound)}; limits {limit})")
    if all(r <= lim for r, lim in zip(control, limit)):
        raise AssertionError(f"train {task}: the TF32 control passes the "
                             f"limits {limit} ({fmt(control)})")
    return {"sound": sound, "control": control}


def _cli_losses(argv) -> tuple:
    """(trainer, {step: loss}) of one train CLI run; its lines echoed."""
    import contextlib
    import io
    import re

    from inklayer_tpu_torch.scripts import train as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = cli.main(argv)
    for line in out.getvalue().splitlines():
        log(f"    {line}")
    return trainer, {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step +(\d+) +loss (\S+)", out.getvalue())}


def _train_checkpoint(card: str) -> None:
    """The GroundingDINO recipe at full width through the CLI on the card:
    three steps with a checkpoint after the second, which must differ
    from a fresh init; a resume that restores it exactly; a resumed step
    whose loss is the third step's (same params, same sample)."""
    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.io.checkpoint import load_params
    from inklayer_tpu_torch.scripts import train as cli

    ckpt = os.path.join(WORK, "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--task", "gdino", "--synthetic", "2"]
    step2 = os.path.join(ckpt, "step_2")
    t0 = time.perf_counter()
    _kernels.reset_launch_counts()
    trained, losses = _cli_losses(base + ["--steps", "3", "--ckpt", ckpt,
                                          "--ckpt_every", "2"])
    last = load_params(os.path.join(ckpt, "step_3"))
    for k, v in trained.model.state_dict().items():
        if not torch.equal(last[k], v.cpu()):
            raise AssertionError(f"checkpoint: {k} differs from the model")
    del trained, last
    saved = load_params(step2)
    args = cli.parse_args(base)
    fresh = cli.init_model(cli.make_task("gdino", *cli.task_config(args),
                                         np.random.default_rng(args.seed)),
                           "cpu", args.seed).state_dict()
    moved = sum(not torch.equal(saved[k], v) for k, v in fresh.items())
    if not moved:
        raise AssertionError("checkpoint: step 2 equals a fresh init")
    del fresh
    resumed, _ = _cli_losses(base + ["--steps", "0", "--resume", step2])
    for k, v in resumed.model.state_dict().items():
        if not torch.equal(saved[k], v.cpu()):
            raise AssertionError(f"resume: {k} differs from the checkpoint")
    del resumed
    step, again = _cli_losses(base + ["--steps", "1", "--resume", step2])
    if not _rel(again[1], losses[3]) <= 1e-5:
        raise AssertionError(f"resumed step loss {again[1]}, the third "
                             f"step's {losses[3]}")
    launched = {k: v for k, v in _kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"train CLI launched kernels {launched}")
    size = os.path.getsize(os.path.join(step2, "params.safetensors"))
    del step
    torch.cuda.empty_cache()
    log(f"  train CLI (gdino, full width) [{card}]: 3 steps, checkpoint "
        f"after step 2 ({size / 2 ** 20:.1f} MiB; {moved} of {len(saved)} "
        f"tensors moved from the fresh init); resume restored it exactly; "
        f"the resumed step's loss {again[1]} against the third step's "
        f"{losses[3]}; {time.perf_counter() - t0:.1f} s; no kernel launched")
    shutil.rmtree(ckpt, ignore_errors=True)


def write_label_mat(path: str, labels: np.ndarray,
                    name: str = "INSTANCE_GT") -> None:
    """An uncompressed little-endian MAT level-5 file holding one uint8
    matrix (what the InkScenes ground truth holds; scipy need not be on
    the card's machine)."""
    import struct

    def element(mtype: int, data: bytes) -> bytes:
        return (struct.pack("<II", mtype, len(data)) + data
                + b"\0" * (-len(data) % 8))

    body = (element(6, struct.pack("<II", 9, 0))  # mxUINT8_CLASS
            + element(5, struct.pack("<2i", *labels.shape))
            + element(1, name.encode())
            + element(2, labels.astype(np.uint8).tobytes(order="F")))
    head = b"MATLAB 5.0 MAT-file, chip_smoke".ljust(116, b" ") + b"\0" * 8
    with open(path, "wb") as f:
        f.write(head + struct.pack("<H", 0x0100) + b"IM"
                + struct.pack("<II", 14, len(body)) + body)


def _eval_cli(card: str, per_run: dict) -> dict:
    """The eval CLI with --sketch_dir on two sketches, scored against label
    matrices written here; its launches must be phase 3's per run."""
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.config import to_jsonable
    from inklayer_tpu_torch.io.matfile import loadmat
    from inklayer_tpu_torch.scripts import eval_inkscenes

    root = os.path.join(WORK, "eval")
    shutil.rmtree(root, ignore_errors=True)
    sketches, gt, out = (os.path.join(root, d)
                         for d in ("sketches", "gt", "out"))
    os.makedirs(sketches)
    os.makedirs(gt)
    for i in range(2):
        draw_sketch(os.path.join(sketches, f"sketch{i:02d}.png"), shift=i)
        lm = np.zeros((750, 750), np.uint8)
        for label, (y0, x0, y1, x1) in enumerate(
                ((60, 60, 360, 380), (420, 300, 700, 690),
                 (100, 480, 300, 700), (520, 80, 620, 220)), start=1):
            lm[y0 + i // 2:y1 + i, x0 + i // 2:x1 + i] = label
        path = os.path.join(gt, f"sketch{i:02d}.mat")
        write_label_mat(path, lm)
        if not np.array_equal(loadmat(path)["INSTANCE_GT"], lm):
            raise AssertionError("loadmat does not read back the label matrix")
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(to_jsonable(slice_config()), f)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = eval_inkscenes.main(["--sketch_dir", sketches, "--gt_dir", gt,
                                  "--outputs", out, "--config", cfg_path])
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    want = {k: 2 * v for k, v in per_run.items() if v}
    if counts != want:
        raise AssertionError(f"eval CLI launches {counts}, phase 3's two "
                             f"runs {want}")
    agg = report["aggregate"]
    if sorted(report["images"]) != ["sketch00", "sketch01"] or not all(
            np.isfinite(v) for v in agg.values()):
        raise AssertionError(f"eval report {report}")
    log(f"  eval CLI --sketch_dir on 2 sketches [{card}]: {wall:.1f} s "
        f"(build included); launches {counts} (phase 3's per run x 2); "
        f"aggregate {json.dumps(agg)}")
    return counts


def phase_train(card: str, per_run: dict) -> dict:
    """Fine-tuning at full width, card against CPU at cut depth, the train
    CLI's checkpoints, the eval CLI and the SAM decoder export, all in
    fp32 with TF32 off for matmuls and cuDNN (as phase 2 leaves them)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    full = {}
    for task in TRAIN_TASKS:
        full[task] = _train_full(card, task, WORK)
    for task in TRAIN_TASKS:
        _train_reference(task)
    _train_checkpoint(card)
    counts = _add_counts(_eval_cli(card, per_run),
                         full["sam"]["export"]["launches"])
    log(f"  phase 11 steps [{card}]: " + ", ".join(
        f"{k} {v['step_ms']:.1f} ms ({v['peak_gib']:.2f} GiB)"
        for k, v in full.items()) + f"; {time.perf_counter() - t0:.1f} s")
    return {"launches": counts, "full": full}


# ---------------------------------------------------------------------------
# phase 12: the mesh, two ranks on one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_TIMEOUT_S = 420
# relative L2, bf16 with kernels, of the tp=2 SAM ViT-H encode and the
# tp=2 DINOv2 ViT-B tapped features against one process on the same card,
# and of each dp=2 rank's GroundingDINO boxes and finite logits against its
# rows of the batched forward.  Read on an H100 80GB HBM3 at 700 W (every
# input seeded; the kernels and the two-rank fp32 sums are deterministic):
# SAM 1.66e-2 (each rank's K3 output is rounded to bf16 before the sum, 32
# blocks deep), DINOv2 1.15e-3, GDINO boxes 1.88e-2 / 4.4e-5 and logits
# 1.62e-2 / 8.9e-3 on ranks 0 / 1 (a batch of one is another GEMM shape
# than a batch of two in bf16; each rank equals its image run alone in
# one process exactly, which is checked too).  A wrong head split or a
# bias added twice reads O(1).
MESH_SAM_REL_L2 = 2e-2
MESH_DINOV2_REL_L2 = 3e-3
MESH_GDINO_REL_L2 = 4e-2
# the head-parallel GroundingDINO forward and SAM mask decode at tp=2: each
# output's relative L2 to the fp32 plain run may exceed the one-process bf16
# result's by at most 10% (a wrong head split or a bias added twice reads
# O(1) against an error of ~1e-2)
MESH_TP_ERROR_MARGIN = 1.1
# per-rank launches of one tp=2 encode: K1 28 + K2 4 (relpos), K3 32 at
# hidden 2560, K4/K4r as a single encode (66)
EXPECTED_TP_ENCODE = {"relpos_attention": 32, "mlp_gelu": 32,
                      "layernorm": LN_PER_ENCODE}


def _probe_collectives(dev) -> dict:
    """Which collectives this rank's backend runs on CUDA tensors (a probe:
    each one's error is the reading)."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    full = lambda k: torch.full((k,), r + 1.0, device=dev)
    total = n * (n + 1) / 2.0  # the sum of the ranks' r + 1

    def all_reduce():
        t = full(4)
        dist.all_reduce(t)
        return bool((t == total).all())

    def all_gather_into_tensor():
        out = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(out, full(4))
        return torch.equal(out.cpu(),
                           torch.arange(1.0, n + 1).repeat_interleave(4))

    def reduce_scatter_tensor():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, full(4 * n))
        return bool((out == total).all())

    out = {}
    for fn in (all_reduce, all_gather_into_tensor, reduce_scatter_tensor):
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[fn.__name__] = "ok" if ok else "wrong result"
        except Exception as e:  # the probe's reading, not a fallback
            out[fn.__name__] = (f"{type(e).__name__}: "
                                f"{str(e).splitlines()[0][:160]}")
    return out


def _rank_nccl() -> None:
    """One rank of the NCCL probe: two ranks on one card."""
    import torch
    import torch.distributed as dist

    from inklayer_tpu_torch.parallel.mesh import INIT_ENV

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=os.environ[INIT_ENV],
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(json.dumps({"nccl_all_reduce": t.tolist()}), flush=True)
    dist.destroy_process_group()


def _mesh_tp_encode(dev, base, size: int) -> dict:
    """SAM ViT-H at 1024², bf16, kernels on: the single-process encode, then
    the model's tp=2 plan and the rank's encode, its launches counted."""
    import copy

    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.mesh import make_mesh
    from inklayer_tpu_torch.parallel.sharding import apply_tp

    from inklayer_tpu_torch.runtime import disable_kernels

    gen = torch.Generator().manual_seed(11)
    x = torch.randn((1, size, size, 3), generator=gen).to(dev)
    with torch.no_grad(), disable_kernels():  # the fp32 yardstick, plain
        sam = copy.deepcopy(base).to(dev).eval()
        ref32 = sam.encode(x).float()
    del sam
    torch.cuda.empty_cache()
    sam = copy.deepcopy(base).to(dev, torch.bfloat16).eval()
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        ref = sam.encode(x)
        single_ms = cuda_median_ms(lambda: sam.encode(x), iters=3, warmup=1)
        apply_tp(sam, make_mesh(1, 1, MESH_RANKS))
        sam.encode(x)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = sam.encode(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
        tp_ms = cuda_median_ms(lambda: sam.encode(x), iters=3, warmup=1)
    rel = lambda a, b: float((a.float() - b).norm() / b.norm())
    finite = bool(torch.isfinite(out).all())
    del sam
    torch.cuda.empty_cache()
    return {"rel_l2": rel(out, ref.float()), "finite": finite,
            "single_to_fp32": rel(ref, ref32), "tp_to_fp32": rel(out, ref32),
            "shape": list(out.shape), "counts": counts,
            "single_ms": single_ms, "tp_ms": tp_ms}


def _mesh_tp_dinov2(dev) -> dict:
    """Depth-Anything-V2's DINOv2 ViT-B at 518², bf16, kernels on: the
    tapped features of one process, then of the rank's tp=2 blocks."""
    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.mesh import make_mesh
    from inklayer_tpu_torch.parallel.sharding import apply_tp
    from inklayer_tpu_torch.scripts import train as cli

    args = cli.parse_args(["--task", "depth"])
    cfg, size = cli.task_config(args)
    t = cli.make_task("depth", cfg, size, np.random.default_rng(0))
    vit = cli.init_model(t, "cpu", args.seed).pretrained.to(
        dev, torch.bfloat16)
    gen = torch.Generator().manual_seed(13)
    x = torch.randn((1, size, size, 3), generator=gen).to(dev,
                                                          torch.bfloat16)
    taps = cfg.intermediate_layers
    feats = lambda: torch.cat([f for pair in vit(x, taps) for f in
                               (pair[0].flatten(), pair[1].flatten())])
    with torch.no_grad():
        _kernels.reset_launch_counts()
        ref = feats()
        torch.cuda.synchronize()
        single = {k: v for k, v in _kernels.launch_counts().items() if v}
        apply_tp(vit, make_mesh(1, 1, MESH_RANKS))
        _kernels.reset_launch_counts()
        out = feats()
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    del vit
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "finite": bool(torch.isfinite(out).all()),
            "counts": counts, "single_counts": single}


def _detect_inputs(size: int, seed: int):
    """One seeded 800^2 image, no padding, the train CLI's caption."""
    import torch

    from inklayer_tpu_torch.models.gdino.bert import subsentence_masks
    from inklayer_tpu_torch.scripts import train as cli

    attn, pos = subsentence_masks(cli.CAPTION_IDS)
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((1, size, size, 3), generator=gen),
            torch.zeros((1, size, size), dtype=torch.bool),
            torch.from_numpy(cli.CAPTION_IDS), torch.from_numpy(attn),
            torch.from_numpy(pos)]


def _tp_errors(names, ref32, single, out) -> dict:
    """Relative L2 of the one-process bf16 result and of the tp one
    against the fp32 plain result (finite entries), per output."""
    import torch

    res = {}
    for name, r, a, b in zip(names, ref32, single, out):
        fin = torch.isfinite(r)
        if not (torch.equal(torch.isfinite(a), fin)
                and torch.equal(torch.isfinite(b), fin)):
            raise AssertionError(f"tp {name}: non-finite entries differ")
        r = r.float()
        rel = lambda x: float((x[fin].float() - r[fin]).norm()
                              / r[fin].norm())
        res[name] = {"single_to_fp32": rel(a), "tp_to_fp32": rel(b),
                     "tp_to_single": float((b[fin].float() - a[fin].float())
                                           .norm() / a[fin].float().norm())}
    return res


def _mesh_tp_detect(dev) -> dict:
    """GroundingDINO SwinT-OGC at 800², one image: the fp32 plain forward
    (the yardstick), the one-process bf16 forward with kernels, then the
    model's tp=2 plan and the rank's forward, its launches counted."""
    import copy

    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.models.gdino.transformer import MSDeformAttn
    from inklayer_tpu_torch.parallel.mesh import make_mesh
    from inklayer_tpu_torch.parallel.sharding import apply_tp
    from inklayer_tpu_torch.runtime import disable_kernels
    from inklayer_tpu_torch.scripts import train as cli

    args = cli.parse_args(["--task", "gdino"])
    cfg, size = cli.task_config(args)
    t = cli.make_task("gdino", cfg, size, np.random.default_rng(0))
    base = cli.init_model(t, "cpu", args.seed)
    x = [a.to(dev) for a in _detect_inputs(size, 14)]
    with torch.no_grad(), disable_kernels():
        model = copy.deepcopy(base).to(dev).eval()
        ref32 = [o.float() for o in model(*x)]
    del model
    model = base.to(dev, torch.bfloat16).eval()
    with torch.no_grad():
        _kernels.reset_launch_counts()
        single = model(*x)
        torch.cuda.synchronize()
        single_counts = {k: v for k, v in _kernels.launch_counts().items()
                         if v}
        single_ms = cuda_median_ms(lambda: model(*x), iters=3, warmup=1)
        layout = apply_tp(model, make_mesh(1, 1, MESH_RANKS))
        heads = sorted({m.n_heads for m in model.modules()
                        if isinstance(m, MSDeformAttn)})
        model(*x)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        out = model(*x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
        t0 = time.perf_counter()
        model(*x)
        torch.cuda.synchronize()
        tp_ms = (time.perf_counter() - t0) * 1e3
    res = {"errors": _tp_errors(("logits", "boxes"), ref32, single, out),
           "counts": counts, "single_counts": single_counts,
           "msda_heads": heads, "sharded": len(layout),
           "single_ms": single_ms, "tp_ms": tp_ms,
           "finite_boxes": bool(torch.isfinite(out[1]).all())}
    del model, base
    torch.cuda.empty_cache()
    return res


def _mesh_tp_decoder(dev, base) -> dict:
    """SAM ViT-H's mask decoder on 64 seeded boxes of one encoded image:
    fp32 plain, one process bf16, then its tp=2 plan (8 heads, 4 a
    rank)."""
    import copy

    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.mesh import make_mesh
    from inklayer_tpu_torch.parallel.sharding import apply_tp
    from inklayer_tpu_torch.runtime import disable_kernels

    gen = torch.Generator().manual_seed(15)
    xy = torch.rand((64, 2), generator=gen) * 700
    wh = 24 + torch.rand((64, 2), generator=gen) * 300
    boxes = torch.cat([xy, (xy + wh).clamp(max=1023)], 1).to(dev)
    with torch.no_grad():
        sam = copy.deepcopy(base).to(dev, torch.bfloat16).eval()
        emb = sam.encode(torch.randn((1, 1024, 1024, 3),
                                     generator=gen).to(dev))
        with disable_kernels():
            dec32 = copy.deepcopy(base).to(dev).eval()
            ref32 = dec32.decode_boxes(emb.float(), boxes)
        del dec32
        _kernels.reset_launch_counts()
        single = sam.decode_boxes(emb, boxes)
        torch.cuda.synchronize()
        single_counts = {k: v for k, v in _kernels.launch_counts().items()
                         if v}
        layout = apply_tp(sam.mask_decoder, make_mesh(1, 1, MESH_RANKS))
        _kernels.reset_launch_counts()
        out = sam.decode_boxes(emb, boxes)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
    res = {"errors": _tp_errors(("mask logits", "iou"), ref32, single, out),
           "counts": counts, "single_counts": single_counts,
           "sharded": len(layout), "shape": list(out[0].shape)}
    del sam
    torch.cuda.empty_cache()
    return res


def _mesh_dp_detect(dev) -> dict:
    """GroundingDINO SwinT-OGC at 800², bf16, kernels on: the batched
    forward on 2 images, then this rank's image (its dp slice), then the
    same image in a plain batch-1 forward."""
    import torch
    import torch.distributed as dist

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.mesh import make_mesh
    from inklayer_tpu_torch.parallel.sharding import shard_batch
    from inklayer_tpu_torch.scripts import train as cli

    args = cli.parse_args(["--task", "gdino"])
    cfg, size = cli.task_config(args)
    t = cli.make_task("gdino", cfg, size, np.random.default_rng(0))
    model = cli.init_model(t, "cpu", args.seed).to(dev, torch.bfloat16)
    from inklayer_tpu_torch.models.gdino.bert import subsentence_masks

    attn, pos = subsentence_masks(cli.CAPTION_IDS)
    gen = torch.Generator().manual_seed(12)
    rep = lambda a: torch.from_numpy(np.repeat(a, MESH_RANKS, 0)).to(dev)
    inputs = {"image": torch.randn((MESH_RANKS, size, size, 3),
                                   generator=gen).to(dev),
              "pad": torch.zeros((MESH_RANKS, size, size), dtype=torch.bool,
                                 device=dev),
              "ids": rep(cli.CAPTION_IDS), "attn": rep(attn), "pos": rep(pos)}
    order = ("image", "pad", "ids", "attn", "pos")
    with torch.no_grad():
        _kernels.reset_launch_counts()
        ref_logits, ref_boxes = model(*(inputs[k] for k in order))
        torch.cuda.synchronize()
        batched = {k: v for k, v in _kernels.launch_counts().items() if v}
        mine = shard_batch({**inputs, "logits": ref_logits,
                            "boxes": ref_boxes},
                           make_mesh(MESH_RANKS, 1, 1))
        _kernels.reset_launch_counts()
        logits, boxes = model(*(mine[k] for k in order))
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kernels.launch_counts().items() if v}
        # the same image alone in one process: the dp rank runs exactly it
        r = dist.get_rank()
        alone = model(*(inputs[k][r:r + 1] for k in order))
    fin = torch.isfinite(mine["logits"])
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())
    out = {"boxes_rel_l2": rel(boxes, mine["boxes"]),
           "logits_rel_l2": rel(logits[fin], mine["logits"][fin]),
           "same_finite": bool(torch.equal(torch.isfinite(logits), fin)),
           "equal_alone": bool(torch.equal(logits, alone[0])
                               and torch.equal(boxes, alone[1])),
           "counts": counts, "batched_counts": batched}
    del model
    torch.cuda.empty_cache()
    return out


def _mesh_train(dev, base, probe: dict) -> dict:
    """SAM ViT-H at full width, fp32, TF32 off: rank 0's single-process
    steps (batch 1 and 2: the references), then one step over each mesh
    of two ranks on both: (1, 1, 2) on batch 1, (2, 1, 1) on batch 2, and
    (1, 2, 1) on batch 1 where the backend gathers and scatters CUDA
    tensors.  Loss, grad norm, ms and peak memory of each."""
    import copy

    import torch
    import torch.distributed as dist

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.train import Trainer, adamw
    from inklayer_tpu_torch.scripts import train as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = cli.parse_args(["--task", "sam", "--synthetic", "2"])
    t = cli.make_task("sam", *cli.task_config(args),
                      np.random.default_rng(args.seed))
    samples = cli.load_samples(args, t)
    batches = {1: next(cli.batches(samples[:1], 1)),
               2: next(cli.batches(samples, 2))}
    live = copy.deepcopy(base)
    live_sam_logits(live)
    meshes = [((1, 1, 2), 1), ((2, 1, 1), 2)]
    if probe["all_gather_into_tensor"] == probe["reduce_scatter_tensor"] \
            == "ok":
        meshes.append(((1, 2, 1), 1))

    def step(shape, b):
        model = copy.deepcopy(live).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(t.loss_fn, model, mesh=shape,
                          optimizer=lambda ps: adamw(ps, args.lr),
                          max_grad_norm=1.0)
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(batches[b]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out = {"mesh": list(shape) if shape else None, "batch": b,
               "loss": loss, "grad_norm": float(trainer.grad_norm),
               "ms": ms, "peak_gib": torch.cuda.max_memory_allocated()
               / 2 ** 30,
               "launches": sum(_kernels.launch_counts().values())}
        del trainer, model
        torch.cuda.empty_cache()
        return out

    refs = {}
    if dist.get_rank() == 0:
        refs = {b: step(None, b) for b in (1, 2)}
    dist.barrier()
    steps = []
    for shape, b in meshes:
        steps.append(step(shape, b))
        dist.barrier()
    return {"refs": refs, "steps": steps}


def _rank_main(out_dir: str) -> None:
    """One rank of phase 12's main job: the backend's collectives, the
    tp=2 encode, the dp=2 detect, the training steps."""
    import torch
    import torch.distributed as dist

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.parallel.mesh import init_distributed
    from inklayer_tpu_torch.scripts import train as cli

    dev = init_distributed()
    _kernels.lib()
    if _kernels.build_seconds is not None:
        raise AssertionError("a rank ran nvcc: phase 1's library was not "
                             "found")
    res = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": str(dev), "probe": _probe_collectives(dev)}
    if res["probe"]["all_reduce"] != "ok":
        raise AssertionError(f"backend {res['backend']}: all_reduce of "
                             f"CUDA tensors: {res['probe']['all_reduce']}")
    args = cli.parse_args(["--task", "sam"])
    cfg, size = cli.task_config(args)
    t = cli.make_task("sam", cfg, size, np.random.default_rng(args.seed))
    t0 = time.perf_counter()
    base = cli.init_model(t, "cpu", args.seed)
    res["build_s"] = time.perf_counter() - t0
    res["sam"] = _mesh_tp_encode(dev, base, size)
    res["dinov2"] = _mesh_tp_dinov2(dev)
    res["gdino"] = _mesh_dp_detect(dev)
    res["gdino_tp"] = _mesh_tp_detect(dev)
    res["sam_decoder_tp"] = _mesh_tp_decoder(dev, base)
    res["train"] = _mesh_train(dev, base, res["probe"])
    with open(os.path.join(out_dir, f"rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _mesh_cli(card: str) -> None:
    """The train CLI under torchrun on the card (GroundingDINO at full
    width, dp=2, a checkpoint), then one process resuming it."""
    import re

    import torch

    from inklayer_tpu_torch.io.checkpoint import load_params

    ckpt = os.path.join(WORK, "mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--task", "gdino", "--synthetic", "2", "--batch", "2"]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(MESH_RANKS), "-m",
         "inklayer_tpu_torch.scripts.train", *base, "--dp", str(MESH_RANKS),
         "--steps", "3", "--ckpt", ckpt, "--ckpt_every", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"torchrun train CLI exit {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    for line in res.stdout.splitlines():
        log(f"    {line}")
    losses = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step +(\d+) +loss (\S+)", res.stdout)}
    if sorted(os.listdir(ckpt)) != ["step_2", "step_3"] or \
            sorted(losses) != [1, 3]:
        raise AssertionError(f"torchrun train CLI: {os.listdir(ckpt)}, "
                             f"{losses}")
    step2 = os.path.join(ckpt, "step_2")
    saved = load_params(step2)
    resumed, _ = _cli_losses(base + ["--steps", "0", "--resume", step2])
    for k, v in resumed.model.state_dict().items():
        if not torch.equal(saved[k], v.cpu()):
            raise AssertionError(f"resume: {k} differs from the mesh's "
                                 f"checkpoint")
    del resumed
    _, again = _cli_losses(base + ["--steps", "1", "--resume", step2])
    if not _rel(again[1], losses[3]) <= 1e-5:
        raise AssertionError(f"resumed step's loss {again[1]}, the mesh's "
                             f"third step's {losses[3]}")
    torch.cuda.empty_cache()
    log(f"  train CLI under torchrun (gdino, full width, dp=2, 3 steps) "
        f"[{card}]: {wall:.1f} s; the whole-model checkpoint after step 2 "
        f"resumed in one process exactly; its step's loss {again[1]} "
        f"against the mesh's third step's {losses[3]}")
    shutil.rmtree(ckpt, ignore_errors=True)


def _tp_report(card: str, res: dict) -> dict:
    """Phase 12's checks of one rank's head-parallel GroundingDINO detect
    and SAM mask decode; returns their launches."""
    counts = {}
    for what, job in (("GDINO 800² bf16 tp=2 detect", res["gdino_tp"]),
                      ("SAM ViT-H mask decoder bf16 tp=2, 64 boxes",
                       res["sam_decoder_tp"])):
        errs = job["errors"]
        log(f"  rank {res['rank']} [{card}]: {what}: " + "; ".join(
            f"{k} relative L2 to fp32 plain: tp {e['tp_to_fp32']:.4g}, "
            f"one process {e['single_to_fp32']:.4g} (limit x"
            f"{MESH_TP_ERROR_MARGIN}); tp to one process "
            f"{e['tp_to_single']:.3g}" for k, e in errs.items())
            + f"; {job['sharded']} tp-sharded parameters; launches "
            f"{job['counts']} (one process {job['single_counts']})"
            + (f"; MSDA heads per rank {job['msda_heads']}; "
               f"{job['tp_ms']:.1f} ms per rank (one process "
               f"{job['single_ms']:.1f} ms; both ranks on one card)"
               if "msda_heads" in job else ""))
        if job["counts"] != job["single_counts"] or any(
                e["tp_to_fp32"] > MESH_TP_ERROR_MARGIN
                * e["single_to_fp32"] for e in errs.values()):
            raise AssertionError(f"rank {res['rank']} {what}: {job}")
        _add_counts(counts, job["counts"])
    gt = res["gdino_tp"]
    if gt["counts"].get("ms_deform_attn") != 12 or \
            gt["msda_heads"] != [4] or not gt["finite_boxes"]:
        raise AssertionError(f"rank {res['rank']} tp=2 GDINO: {gt}")
    return counts


def _mesh_report(card: str, ranks: list, main_s: float) -> dict:
    """Phase 12's checks of the main job's ranks; returns their launches
    summed over the ranks."""
    counts = {}
    for res in ranks:
        sam, gd, vit = res["sam"], res["gdino"], res["dinov2"]
        log(f"  rank {res['rank']} [{card}]: SAM ViT-H 1024² bf16 tp=2 "
            f"encode {tuple(sam['shape'])}, relative L2 {sam['rel_l2']:.3g} "
            f"to the single-process encode (limit {MESH_SAM_REL_L2}); to "
            f"the fp32 plain encode: tp=2 {sam['tp_to_fp32']:.3g}, single "
            f"process {sam['single_to_fp32']:.3g}; "
            f"launches {sam['counts']}; {sam['tp_ms']:.1f} ms (single "
            f"process {sam['single_ms']:.1f} ms, both ranks on one card); "
            f"DINOv2 ViT-B 518² bf16 tp=2 tapped features, relative L2 "
            f"{vit['rel_l2']:.3g} (limit {MESH_DINOV2_REL_L2}), launches "
            f"{vit['counts']}; GDINO 800² bf16 dp=2: boxes "
            f"{gd['boxes_rel_l2']:.3g}, finite logits "
            f"{gd['logits_rel_l2']:.3g} to its rows of the batched forward "
            f"(limit {MESH_GDINO_REL_L2}), equal to its image alone in one "
            f"process: {gd['equal_alone']}; launches {gd['counts']}")
        if sam["counts"] != EXPECTED_TP_ENCODE or not sam["finite"] or \
                sam["rel_l2"] > MESH_SAM_REL_L2:
            raise AssertionError(f"rank {res['rank']} tp=2 SAM encode: "
                                 f"{sam}")
        if vit["counts"] != vit["single_counts"] or \
                vit["counts"].get("flash_attention/d64") != 12 or \
                not vit["finite"] or vit["rel_l2"] > MESH_DINOV2_REL_L2:
            raise AssertionError(f"rank {res['rank']} tp=2 DINOv2: {vit}")
        if gd["counts"] != gd["batched_counts"] or \
                gd["counts"].get("ms_deform_attn") != 12 or \
                not gd["same_finite"] or not gd["equal_alone"] or \
                max(gd["boxes_rel_l2"], gd["logits_rel_l2"]) > \
                MESH_GDINO_REL_L2:
            raise AssertionError(f"rank {res['rank']} dp=2 GDINO: {gd}")
        _add_counts(counts, sam["counts"])
        _add_counts(counts, vit["counts"])
        _add_counts(counts, gd["counts"])
        _add_counts(counts, _tp_report(card, res))

    refs = {int(k): v for k, v in ranks[0]["train"]["refs"].items()}
    limit = TRAIN_REL_TOL["sam"]
    for res in ranks:
        for st in res["train"]["steps"]:
            ref = refs[st["batch"]]
            errs = (_rel(st["loss"], ref["loss"]),
                    _rel(st["grad_norm"], ref["grad_norm"]))
            log(f"  rank {res['rank']} train SAM ViT-H fp32 over "
                f"{tuple(st['mesh'])}, batch {st['batch']} [{card}]: loss "
                f"{st['loss']!r}, grad norm {st['grad_norm']!r}; against "
                f"one process (loss {ref['loss']!r}, grad norm "
                f"{ref['grad_norm']!r}, {ref['ms']:.1f} ms, "
                f"{ref['peak_gib']:.2f} GiB): relative {errs[0]:.3g}, "
                f"{errs[1]:.3g} (limits {limit[0]}, {limit[1]}); "
                f"{st['ms']:.1f} ms per step, peak {st['peak_gib']:.2f} GiB "
                f"on this rank; {st['launches']} kernel launches")
            if not (errs[0] <= limit[0] and errs[1] <= limit[1]) or \
                    st["launches"]:
                raise AssertionError(f"rank {res['rank']} train step over "
                                     f"{st['mesh']}: {st}, one process "
                                     f"{ref}")
    probe = ranks[0]["probe"]
    shapes = [tuple(st["mesh"]) for st in ranks[0]["train"]["steps"]]
    if (1, 2, 1) not in shapes:
        log(f"  (1, 2, 1) not run: {ranks[0]['backend']} on CUDA tensors: "
            f"{probe['all_gather_into_tensor']}; "
            f"{probe['reduce_scatter_tensor']}")
    log(f"  main job: {main_s:.1f} s (SAM placeholders drawn in "
        f"{ranks[0]['build_s']:.1f} s per rank)")

    return counts


def phase_mesh(card: str) -> dict:
    """Two ranks on the one card: the backend probe, the tp=2 SAM encode
    and dp=2 detect at full width with their launches, the dry run, the
    training steps against one process, the train CLI under torchrun."""
    import torch

    from inklayer_tpu_torch.parallel import dryrun
    from inklayer_tpu_torch.parallel.mesh import backend_for, spawn

    torch.cuda.empty_cache()
    me = [os.path.abspath(__file__), "--mesh-rank"]
    t0 = time.perf_counter()
    try:
        outs = spawn(MESH_RANKS, me + ["nccl"], 120, cpu=False)
        nccl = f"carried an all_reduce: {outs[0].strip()[-200:]}"
    except RuntimeError as e:  # the probe's reading
        lines = [l.strip() for l in str(e).splitlines()
                 if "duplicate" in l.lower()] or \
            [l.strip() for l in str(e).splitlines() if "nccl" in l.lower()]
        nccl = "refused: " + (lines[0][:300] if lines else
                              str(e).splitlines()[0])
    rule = backend_for("cuda", MESH_RANKS, torch.cuda.device_count())
    log(f"  backend probe, {MESH_RANKS} ranks on {torch.cuda.device_count()} "
        f"card(s) [{card}]: nccl {nccl} ({time.perf_counter() - t0:.1f} s)")

    out_dir = os.path.join(WORK, "mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    spawn(MESH_RANKS, me + ["main", out_dir], MESH_TIMEOUT_S, cpu=False)
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    main_s = time.perf_counter() - t0
    probe = ranks[0]["probe"]
    log(f"  rule (parallel/mesh.py backend_for): {MESH_RANKS} ranks, "
        f"{torch.cuda.device_count()} card -> {rule}; the ranks ran "
        f"{ranks[0]['backend']}; {rule} on CUDA tensors: " + ", ".join(
            f"{k} {v}" for k, v in probe.items()))
    if ranks[0]["backend"] != rule:
        raise AssertionError(f"the ranks ran {ranks[0]['backend']}, the "
                             f"rule says {rule}")

    counts = _mesh_report(card, ranks, main_s)

    t0 = time.perf_counter()
    line = dryrun.dryrun_multichip(MESH_RANKS, timeout=MESH_TIMEOUT_S)
    log(f"  {line} [{card}] ({time.perf_counter() - t0:.1f} s)")
    _mesh_cli(card)
    return {"launches": counts, "probe": probe, "nccl": nccl,
            "train": ranks[0]["train"]}


# ---------------------------------------------------------------------------
# phase 13: the depth scripts
# ---------------------------------------------------------------------------

DEPTH_ENCODERS = ("vitl", "vits")


def depth_launches(cfg, images: int = 1) -> dict:
    """K7 and K4 launches of ``images`` images at the 518² bucket (1370
    tokens): one flash attention per block (counted in total and at head
    dim 64); two LayerNorms per block and the final norm at each tap."""
    return {"flash_attention": images * cfg.depth,
            "flash_attention/d64": images * cfg.depth,
            "layernorm": images * (2 * cfg.depth
                                   + len(cfg.intermediate_layers))}


def _counted(fn):
    """fn()'s result and the kernel launches it made."""
    import torch

    from inklayer_tpu_torch import _kernels

    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _kernels.launch_counts().items() if v}


def _multipart(field: str, data: bytes):
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="x.png"\r\nContent-Type: image/png'
            f"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _depth_serve(card: str, est, sketch: str, want: dict) -> dict:
    """One POST to the web demo behind a threaded server on 127.0.0.1."""
    import io
    import urllib.request
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from PIL import Image

    from inklayer_tpu_torch.scripts import depth_demo

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    srv = make_server("127.0.0.1", 0, depth_demo.make_app(est),
                      handler_class=Quiet)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        with open(sketch, "rb") as f:
            body, ctype = _multipart("image", f.read())
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_port}/depth", data=body,
            headers={"Content-Type": ctype})
        t0 = time.perf_counter()
        (kind, png), counts = _counted(lambda: (
            lambda r: (r.headers["Content-Type"], r.read()))(
                urllib.request.urlopen(req, timeout=120)))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()
    img = Image.open(io.BytesIO(png))
    if kind != "image/png" or img.size != (2 * 750 + 50, 750) or \
            counts != want:
        raise AssertionError(f"depth --serve: {kind} {img.size}, launches "
                             f"{counts} (want {want})")
    log(f"  --serve: one POST answered with a {img.size} PNG in {ms:.1f} ms "
        f"[{card}], launches {counts}")
    return counts


def _depth_encoder(card: str, encoder: str, src_dir: str,
                   sketches: list) -> dict:
    """One encoder through ``depth_demo``: the builds, the two image runs,
    the timed calls, the web demo; returns the checked runs' launches."""
    import argparse

    import torch
    from PIL import Image

    from inklayer_tpu_torch.scripts import depth_demo

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    est = depth_demo.build_estimator(encoder, None, 518, "cuda")
    build_s = time.perf_counter() - t0
    cfg = est.cfg
    total = {}
    out = os.path.join(WORK, f"depth_{encoder}")
    shutil.rmtree(out, ignore_errors=True)
    rgb = np.asarray(Image.open(sketches[0]).convert("RGB"))
    est.infer_image(rgb)  # warm-up
    runs = (("dir", dict(img_path=src_dir, pred_only=False, grayscale=False),
             (2 * 750 + 50, 750)),
            ("txt --pred-only --grayscale",
             dict(img_path=src_dir + ".txt",
                  pred_only=True, grayscale=True), (750, 750)))
    for what, kw, size in runs:
        args = argparse.Namespace(outdir=os.path.join(out, what.split()[0]),
                                  **kw)
        written, counts = _counted(lambda: depth_demo.run_images(est, args))
        want = depth_launches(cfg, len(sketches))
        sizes = [Image.open(p).size for p in written]
        gray = all(np.ptp(np.asarray(Image.open(p)), axis=-1).max() == 0
                   for p in written) if kw["grayscale"] else True
        if len(written) != len(sketches) or set(sizes) != {size} or \
                counts != want or not gray:
            raise AssertionError(f"{encoder} run_images ({what}): {written} "
                                 f"{sizes}, launches {counts} (want {want})")
        _add_counts(total, counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        depth = est.infer_image(rgb)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if depth.shape != (750, 750) or not np.isfinite(depth).all():
        raise AssertionError(f"{encoder} depth {depth.shape}")
    log(f"  {encoder} ({cfg.embed_dim} wide, {cfg.depth} blocks, "
        f"{cfg.num_heads} heads; placeholders built in {build_s:.1f} s) "
        f"[{card}]: run_images on {len(sketches)} sketches and on a .txt "
        f"list with --pred-only --grayscale, sizes checked; launches per "
        f"image {depth_launches(cfg)} exact; infer_image 750² p50 "
        f"{statistics.median(times):.2f} ms over {TIMED_RUNS} warm runs "
        f"({', '.join(f'{t:.2f}' for t in times)}), peak memory allocated "
        f"{peak:.2f} GiB (the weights included, earlier phases' not)")
    if encoder == "vitl":
        _add_counts(total, _depth_serve(card, est, sketches[0],
                                        depth_launches(cfg)))
    del est
    torch.cuda.empty_cache()
    return total


def _depth_reference(card: str, sketch: str) -> None:
    """ViT-L at full width and cut depth (4 blocks): the card in bf16
    against the CPU in fp32, the depth map and the last tap."""
    import copy

    import torch
    from PIL import Image

    from inklayer_tpu_torch.build import init_placeholder_params
    from inklayer_tpu_torch.config import DepthConfig
    from inklayer_tpu_torch.models.depth import (DepthAnythingV2,
                                                 DepthEstimator)

    cfg = dataclasses.replace(DepthConfig.vitl(), depth=4,
                              intermediate_layers=(0, 1, 2, 3))
    model = init_placeholder_params(DepthAnythingV2(cfg), 2).eval()
    live_depth_head(model)
    rgb = np.asarray(Image.open(sketch).convert("RGB"))
    out = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        t0 = time.perf_counter()
        m = copy.deepcopy(model).to(dev, dtype)
        taps = {}
        m.pretrained.register_forward_hook(
            lambda mod, i, o: taps.__setitem__("last", o[-1][0]))
        depth = DepthEstimator(m).infer_image(rgb)
        out[dev] = {"vitl_cut_depth_750x750": torch.from_numpy(depth),
                    "vitl_cut_last_tap": taps["last"].float().cpu()}
        log(f"  ViT-L cut depth on {dev}: {time.perf_counter() - t0:.1f} s")
        del m
    for key in out["cpu"]:
        _rel_check(key, out["cuda"][key], out["cpu"][key])


def phase_depth_scripts(card: str) -> dict:
    """The depth scripts at full width on the card; returns the launches
    of the checked runs."""
    import importlib.util

    from PIL import Image

    src = os.path.join(WORK, "depth_src")
    shutil.rmtree(src, ignore_errors=True)
    os.makedirs(src)
    sketches = [os.path.join(src, f"sketch{i}.png") for i in range(2)]
    for i, p in enumerate(sketches):
        draw_sketch(p, shift=40 * i)
    with open(src + ".txt", "w") as f:
        f.write("\n".join(sketches))
    total = {}
    for encoder in DEPTH_ENCODERS:
        _add_counts(total, _depth_encoder(card, encoder, src, sketches))
    _depth_reference(card, sketches[0])

    # the CLI as a user runs it: on the card by default
    out = os.path.join(WORK, "depth_cli")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "inklayer_tpu_torch.scripts.run_depth",
         "--img-path", src + ".txt", "--encoder", "vitl",
         "--outdir", out], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    sizes = sorted(Image.open(os.path.join(out, n)).size
                   for n in os.listdir(out)) if res.returncode == 0 else []
    if res.returncode != 0 or sizes != [(2 * 750 + 50, 750)] * 2:
        raise AssertionError(f"run_depth CLI exit {res.returncode} {sizes}:"
                             f"\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    log(f"  python -m inklayer_tpu_torch.scripts.run_depth --encoder vitl "
        f"(on the card by default): 2 images in "
        f"{time.perf_counter() - t0:.1f} s, process start included")

    if importlib.util.find_spec("cv2") is None:
        log("  video path not run: OpenCV (cv2) is not installed on this "
            "machine")
    else:
        import argparse

        import cv2

        from inklayer_tpu_torch.scripts import depth_demo

        clip = os.path.join(src, "clip.mp4")
        w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                            (750, 750))
        for p in sketches:
            w.write(np.asarray(Image.open(p).convert("RGB"))[:, :, ::-1])
        w.release()
        est = depth_demo.build_estimator("vits", None, 518, "cuda")
        written = depth_demo.run_video(est, argparse.Namespace(
            video_path=clip, outdir=os.path.join(WORK, "depth_video"),
            pred_only=False, grayscale=False))
        cap = cv2.VideoCapture(written[0])
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if n != len(sketches):
            raise AssertionError(f"run_video wrote {n} frames")
        log(f"  run_video: {n} frames of {2 * 750 + 50}x750")
    return {"launches": total}

# ---------------------------------------------------------------------------
# phase 14: the bench
# ---------------------------------------------------------------------------

# launches of one detect+segment call of the bench (``build_workload``) at
# full width: SAM ViT-H's 32 blocks (relpos attention, MLP), GroundingDINO's
# 6 + 6 deformable layers, and the LayerNorm kernel wherever rows >= 512 and
# C % 8 == 0: GroundingDINO 75 (Swin-T 31: the patch embedding, 24 block
# norms, 3 patch merges, 3 outputs; encoder 6 x 3: the fusion's image norm
# and the two post-norms; the proposals' norm; decoder 6 x 4 and its final
# norm; BERT's 4 tokens take the plain version) and SAM's encode and one
# decode (``sam_layernorm_launches``: 16 boxes, so the query norms' 112
# rows take the plain version)
GDINO_LN = 31 + 6 * 3 + 1 + 6 * 4 + 1
BENCH_LAUNCHES = {"relpos_attention": SAM_BLOCKS, "mlp_gelu": SAM_BLOCKS,
                  "ms_deform_attn": 12,
                  "layernorm": GDINO_LN + sam_layernorm_launches(1, 1, 16)}
# the full pipeline and the inpainting measurement at cut counts (the
# defaults: 5 runs, 16 sketches x 5 sweeps, 30 steps)
BENCH_FULL_CUT = {"iters": 2, "n_sweep": 2, "sweeps": 1}
BENCH_INPAINT_STEPS = 2
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "weights", "card",
              "power_limit_w")
BENCH_E2E_KEYS = (
    "e2e_full_pipeline_p50_ms", "e2e_full_pipeline_min_ms", "e2e_iters",
    "e2e_sketches_per_sec_per_chip", "e2e_sweep_sketches_per_sec_per_chip",
    "e2e_sweep_best_sketches_per_sec_per_chip", "syncs_per_img",
    "device_busy_ms_per_img", "rtt_ms", "rtt_baseline_ms", "host_load_1m",
    "weather", "cc_cap_hits_per_img_noise", "e2e_blob_probe_p50_ms",
    "device_busy_ms_per_img_blob", "cc_cap_hits_per_img_blob")


def _bench_cli(card: str) -> dict:
    """``python -m inklayer_tpu_torch.bench`` as a user runs it (on the
    card by default), the full pipeline and inpainting skipped."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "inklayer_tpu_torch.bench", "--skip-full",
         "--skip-inpaint", "--iters", "3"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if res.returncode == 0 and lines else {}
    missing = [k for k in BENCH_KEYS if k not in line]
    value = line.get("value")
    if res.returncode != 0 or missing or not isinstance(value, float) or \
            not np.isfinite(value) or value <= 0 or \
            line["card"] not in card or any(k.endswith("_error")
                                            for k in line):
        raise AssertionError(f"bench CLI exit {res.returncode}, missing "
                             f"{missing}: {res.stdout[-2000:]}\n"
                             f"{res.stderr[-2000:]}")
    log(f"  python -m inklayer_tpu_torch.bench --skip-full --skip-inpaint "
        f"--iters 3 ({time.perf_counter() - t0:.1f} s, process start "
        f"included): {json.dumps(line)}")
    return line


def phase_bench(card: str) -> dict:
    """The port's bench on the card: the CLI, ``build_workload``'s exact
    launches, the full pipeline with the blob probe and the inpainting
    measurement at cut counts, ``bench_sam_vith`` and ``entry()``; returns
    the launches of the checked calls."""
    import torch

    from inklayer_tpu_torch import _kernels, bench
    from inklayer_tpu_torch.build import build_pipeline
    from inklayer_tpu_torch.config import PipelineConfig
    from inklayer_tpu_torch.entry import entry
    from inklayer_tpu_torch.scripts import bench_sam_vith

    total = {}
    _bench_cli(card)

    fn, g, s, img = bench.build_workload()
    fn(g, s, img).item()  # warm
    value, counts = _counted(lambda: fn(g, s, img).item())
    if counts != BENCH_LAUNCHES or not np.isfinite(value):
        raise AssertionError(f"build_workload: {value}, launches {counts} "
                             f"(want {BENCH_LAUNCHES})")
    _add_counts(total, counts)
    log(f"  build_workload (full width, bf16): {value:.4f}, launches "
        f"{counts} exact")
    del fn, g, s, img

    t0 = time.perf_counter()
    pipe = build_pipeline(PipelineConfig(), device="cuda",
                          dtype=torch.bfloat16)
    full, counts = _counted(lambda: bench.measure_full_pipeline(
        pipe=pipe, **BENCH_FULL_CUT))
    missing = [k for k in BENCH_E2E_KEYS if k not in full]
    busy, blob_busy = (full.get("device_busy_ms_per_img"),
                       full.get("device_busy_ms_per_img_blob"))
    if missing or busy is None or blob_busy is None or \
            not 0 < busy < full["e2e_full_pipeline_p50_ms"] or \
            not 0 < blob_busy < full["e2e_blob_probe_p50_ms"] or \
            "masks_from_lowres" in vars(pipe.sam):
        raise AssertionError(f"measure_full_pipeline: missing {missing}, "
                             f"{full}; masks_from_lowres restored: "
                             f"{'masks_from_lowres' not in vars(pipe.sam)}")
    _add_counts(total, counts)
    log(f"  measure_full_pipeline({BENCH_FULL_CUT}) "
        f"({time.perf_counter() - t0:.1f} s, build included) [{card}]: "
        f"{json.dumps(full)}; masks_from_lowres restored")
    del pipe
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, num_steps=BENCH_INPAINT_STEPS))
    inp, counts = _counted(lambda: bench.measure_inpaint(cfg))
    if not (inp["inpaint_ms_per_sample"] > 0
            and np.isfinite(inp["inpaint_batch4_scaling"])):
        raise AssertionError(f"measure_inpaint: {inp}")
    _add_counts(total, counts)
    log(f"  measure_inpaint at {BENCH_INPAINT_STEPS} steps "
        f"({time.perf_counter() - t0:.1f} s, build included) [{card}]: "
        f"{json.dumps(inp)}")
    torch.cuda.empty_cache()

    vit, counts = _counted(lambda: bench_sam_vith.main([]))
    if not (vit["value"] > 0 and vit["device_ms"] and vit["tflop"] > 0):
        raise AssertionError(f"bench_sam_vith: {vit}")
    _add_counts(total, counts)

    fwd, args = entry()
    (logits, iou), counts = _counted(lambda: fwd(*args))
    want = sam_launches(1, 1)
    want["layernorm"] = sam_layernorm_launches(1, 1, n=8)
    if tuple(logits.shape) != (8, 1, 256, 256) or \
            tuple(iou.shape) != (8, 1) or counts != want or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"entry(): {tuple(logits.shape)} "
                             f"{tuple(iou.shape)}, launches {counts} "
                             f"(want {want})")
    _add_counts(total, counts)
    log(f"  entry(): SAM ViT-H box-prompted forward, logits "
        f"{tuple(logits.shape)}, iou {tuple(iou.shape)}, launches {counts} "
        f"exact")
    del fwd, args
    torch.cuda.empty_cache()
    return {"launches": total}


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


def kernel_resources(sources=None) -> None:
    """Registers, spills and shared memory of each attention, GEMM and
    convolution instance (the ptxas messages of this build, and the
    dynamic shared memory the launch asks for), and the LayerNorm
    instances' range; ``sources`` limits it to those source files."""
    import re

    from inklayer_tpu_torch import _kernels

    if not _kernels.build_log:
        log("  instances: library reused, no ptxas messages")
        return
    lib = _kernels.lib()
    ln = []
    for src, text in sorted(_kernels.build_log.items()):
        if sources is not None and src not in sources:
            continue
        for name, info in ptxas_entries(text).items():
            m = re.search(r"attention_tile_kernelILi(\d+)ELb([01])E", name)
            g = re.search(r"gemm_bias_act_kernelILi(\d+)ELb([01])E", name)
            cv = re.search(r"conv3x3_kernelILi(\d+)EE", name)
            if "layernorm_kernel" in name:
                ln.append(info)
                continue
            if cv:
                label = f"conv3x3_kernel<{cv.group(1)}>"
                dyn = lib.ik_conv_smem_bytes(int(cv.group(1)))
            elif "conv3x3_reduce_kernel" in name:
                label, dyn = "conv3x3_reduce_kernel", 0
            elif m:
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

    if len(sys.argv) > 2 and sys.argv[1] == "--mesh-rank":
        sys.path.insert(0, REPO)
        if sys.argv[2] == "nccl":
            _rank_nccl()
        else:
            _rank_main(sys.argv[3])
        return 0
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
    reference_sdxl()
    log(f"  phase 4: {time.perf_counter() - t0:.1f} s")

    log(f"phase 5: the inpainting path at full width [{card}]")
    t0 = time.perf_counter()
    inpaint_res = phase_inpaint(card)
    log(f"  phase 5: {time.perf_counter() - t0:.1f} s")

    log(f"phase 6: checkpoints and serving [{card}]")
    t0 = time.perf_counter()
    serve_res = phase_serving(card)
    log(f"  phase 6: {time.perf_counter() - t0:.1f} s")

    log(f"phase 7: the directory sweep [{card}]")
    t0 = time.perf_counter()
    sweep_res = phase_sweep(card)
    log(f"  phase 7: {time.perf_counter() - t0:.1f} s")

    log(f"phase 8: the convolution's entry point [{card}]")
    t0 = time.perf_counter()
    conv_counts = conv_entry(card)
    log(f"  phase 8: {time.perf_counter() - t0:.1f} s")

    log(f"phase 9: the SDXL inpainting backend at full width [{card}]")
    t0 = time.perf_counter()
    sdxl_res = phase_sdxl(card)
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s")

    log(f"phase 10: the device front, prompts, AMG, the mmdet producer "
        f"[{card}]")
    t0 = time.perf_counter()
    prompts_res = phase_prompts(card)
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")

    log(f"phase 11: fine-tuning, checkpoints, evaluation, export [{card}]")
    t0 = time.perf_counter()
    train_res = phase_train(card, slice_res["launches"])
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")

    log(f"phase 12: the mesh, {MESH_RANKS} ranks on one card [{card}]")
    t0 = time.perf_counter()
    mesh_res = phase_mesh(card)
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

    log(f"phase 13: the depth scripts, ViT-L and ViT-S [{card}]")
    t0 = time.perf_counter()
    depth_res = phase_depth_scripts(card)
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")

    log(f"phase 14: the bench [{card}]")
    t0 = time.perf_counter()
    bench_res = phase_bench(card)
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")

    line = {"kernels": []}
    for name, (route, source, replaces) in KERNELS.items():
        cases = results[name]
        libs = [c["library_ms"] for c in cases]
        worst = max(cases, key=lambda c: c["bound_ms"])
        line["kernels"].append({
            # ms, plain_ms, bound_ms, library_ms: sums over the phase-2
            # cases; launches: the last timed runs of phases 3 and 5, the
            # serving run of phase 6, the timed sweeps of phase 7, the
            # convolution's entry point (phase 8), the timed generate
            # of phase 9, phase 10's checked runs and calls, phase 11's
            # eval CLI and exported decoder (the train steps launch none),
            # phase 12's tp=2 encodes, detects and decodes and dp=2 detects
            # on both ranks, phase 13's checked image runs and request, and
            # phase 14's checked calls
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": slice_res["launches"].get(name, 0)
            + inpaint_res["bucket2"]["counts"].get(name, 0)
            + serve_res["launches"].get(name, 0)
            + sweep_res["launches"].get(name, 0)
            + conv_counts.get(name, 0)
            + sdxl_res["launches"].get(name, 0)
            + prompts_res["launches"].get(name, 0)
            + train_res["launches"].get(name, 0)
            + mesh_res["launches"].get(name, 0)
            + depth_res["launches"].get(name, 0)
            + bench_res["launches"].get(name, 0),
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
