"""One ControlNet-inpainting pass on the card: wall time, counted FLOPs
against the bf16 peak, and device time by kernel class per stage (port of
the JAX package's ``scripts/profile_diffusion.py``).

    python -m inklayer_tpu_torch.scripts.profile_diffusion [--steps 30]
        [--res 768] [--batch 1] [--trace] [--device cuda]

The SD1.5-inpaint UNet, ControlNet v11p, VAE and CLIP-L of
``build_diffusion_models`` (full width, seeded placeholder weights, bf16 on
the card) in a ``ControlNetInpaintPipeline``; one pass of ``--steps``
DPM-Solver++(2M) steps with CFG 9.0 and ControlNet scale 1.2 at
``--res``^2 through ``_sample`` (``--batch 1``) or ``_sample_batch``
(``--batch`` layers in one launch per step), on seeded inputs:

* the warm wall time per pass (median of 3 after a first call) and per
  step, and the pipeline's stage times (encode / loop / decode);
* the FLOPs: one CFG step of the UNet and ControlNet times the steps, plus
  the text encoder and the VAE's encode and decode once, counted over the
  plain versions (``profiling.counted_flops``; a step is the difference of
  a 2-step and a 1-step pass).  The count holds products, convolutions and
  attention only: the JAX script's XLA count had the elementwise work too.
  As a share of the H100's 989 TFLOP/s dense bf16 peak over the wall.
* with ``--trace``: one pass traced stage by stage, each stage of the
  pipeline's own ``_add_time`` keys (encode: the VAE encode; loop: the
  solver steps; decode: the VAE decode) in a trace of its own
  (``profiling.device_profile_stages``), its device time summed into
  kernel classes (attention, convolution, GroupNorm, elementwise, GEMM,
  the port's kernels, other) that add up to its device-op time.

Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np
import torch

from inklayer_tpu_torch.build import build_diffusion_models
from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.models.diffusion import ControlNetInpaintPipeline
from inklayer_tpu_torch.models.diffusion.scheduler import solver_tables
from inklayer_tpu_torch.profiling import (PEAK_BF16, classify, counted_flops,
                                          device_profile_stages, emit,
                                          print_classes, sync, wall_ms)
from inklayer_tpu_torch.runtime import compute_dtype, resolve_device


def sample_call(pipe, steps: int, batch: int = 1):
    """A function running one pass of ``steps`` steps over ``batch``
    seeded layers at the pipeline's resolution."""
    cfg, dev = pipe.cfg, pipe.device
    size = cfg.resolution
    text_emb = pipe.encode_prompt(cfg.prompt, cfg.negative_prompt)
    tables = solver_tables(pipe.scheduler, steps)

    def seeded(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).random(
            shape, np.float32)).to(dev)

    img01 = seeded(0, (batch, 3, size, size))
    mask01 = (seeded(1, (batch, 1, size, size)) > 0.5).float()
    control = seeded(2, (batch, 3, size, size)) * 2 - 1
    noise = pipe.initial_noise(3, (batch, cfg.latent_channels, size // 8,
                                   size // 8))
    args = (steps, cfg.guidance_scale, cfg.controlnet_scale)
    if batch == 1:
        return lambda: pipe._sample(text_emb, img01[0], mask01[0],
                                    control[0], noise, tables, *args)
    return lambda: pipe._sample_batch(text_emb, img01, mask01, control,
                                      noise, tables, *args)


def counted(pipe, steps: int, batch: int) -> dict:
    """GFLOP of one CFG step, of the text encoder and of the VAE (encode +
    decode), and TFLOP of a pass, over the plain versions."""
    models = (pipe.text_encoder, pipe.unet, pipe.controlnet, pipe.vae)
    one, two = (counted_flops(sample_call(pipe, s, batch), *models)
                for s in (1, 2))
    step = two - one
    cfg = pipe.cfg
    ids = torch.from_numpy(np.concatenate([
        pipe.tokenizer.encode(cfg.negative_prompt, cfg.text_maxlen),
        pipe.tokenizer.encode(cfg.prompt, cfg.text_maxlen)])).long()
    text = counted_flops(lambda: pipe.text_encoder(ids.to(pipe.device)),
                         pipe.text_encoder)
    vae = one - step
    return {"gflop_step": step / 1e9, "gflop_text": text / 1e9,
            "gflop_vae": vae / 1e9,
            "tflop_pass": (text + vae + steps * step) / 1e12}


def traced_stages(pipe, call) -> dict:
    """{stage: {'busy_ms', 'wall_ms', 'op_ms', 'device_ops', 'classes'}}
    of one traced pass."""
    stages = device_profile_stages(lambda: (call(), sync(pipe.device)), pipe,
                                   "_add_time")
    return {k: {"busy_ms": p["busy_ms"], "wall_ms": p["wall_ms"],
                "op_ms": p["op_ms"], "device_ops": p["device_ops"],
                "classes": classify(p["kernels"])}
            for k, p in stages.items()}


def main(argv=None, pipe=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--res", type=int, default=768)
    ap.add_argument("--batch", type=int, default=1,
                    help="layers per launch (_sample_batch)")
    ap.add_argument("--trace", action="store_true",
                    help="device time by kernel class per stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if pipe is None:
        dev = resolve_device(args.device)
        cfg = PipelineConfig()
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion, resolution=args.res, num_steps=args.steps))
        pipe = ControlNetInpaintPipeline(
            build_diffusion_models(cfg, dev, compute_dtype(dev)),
            cfg.diffusion)
    dev = pipe.device
    if args.trace and dev.type != "cuda":
        ap.error("--trace reads the card's trace")
    sample = sample_call(pipe, args.steps, args.batch)

    def call():
        pipe.stage_times = {}  # the last pass's, as generate() keeps
        sample()
        sync(dev)

    first_s = wall_ms(call, 1)[0] / 1e3
    wall = statistics.median(wall_ms(call, 3))
    stage_ms = {k: v * 1e3 for k, v in pipe.stage_times.items()
                if k != "steps"}
    flops = counted(pipe, args.steps, args.batch)
    res = {"steps": args.steps, "res": pipe.cfg.resolution,
           "batch": args.batch, "first_s": first_s,
           "wall_ms_per_pass": wall, "ms_per_step": wall / args.steps,
           "stage_ms": stage_ms, **flops,
           "peak_share_wall": flops["tflop_pass"] * 1e12 / (wall / 1e3)
           / PEAK_BF16, "trace": None}
    print(f"pass of {args.steps} steps at {res['res']}^2, batch "
          f"{args.batch}: {wall:.1f} ms warm ({res['ms_per_step']:.2f} ms a "
          f"step; first call {first_s:.1f} s); stages "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in stage_ms.items()))
    print(f"counted: {flops['gflop_step']:.1f} GFLOP a CFG step, text "
          f"{flops['gflop_text']:.1f}, VAE {flops['gflop_vae']:.1f}; "
          f"{flops['tflop_pass']:.3f} TFLOP a pass = "
          f"{res['peak_share_wall']:.4f} of 989 TFLOP/s over the wall "
          f"(products, convolutions, attention only)")
    if args.trace:
        res["trace"] = traced_stages(pipe, sample)
        for stage, t in res["trace"].items():
            print(f"{stage}: busy {t['busy_ms']:.1f} ms of "
                  f"{t['wall_ms']:.1f} ms traced wall, {t['device_ops']} "
                  f"device ops")
            print_classes(t["classes"], t["op_ms"])
    return emit(res, dev)


if __name__ == "__main__":
    main()
