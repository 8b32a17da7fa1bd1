"""The detect forward against the card's bf16 peak, and its device time by
kernel class (port of the JAX package's
``scripts/profile_gdino_roofline.py``).

    python -m inklayer_tpu_torch.scripts.profile_gdino_roofline
        [--iters 12] [--device cuda]

``GroundingDINO(GDinoConfig())`` with every floating parameter 0.01
(``runtime.constant_model``, bf16 on the card) at the 800^2 bucket
(``BUCKET``), caption "object .":

* the p50 wall of ``--iters`` forwards (each ends in a synchronise) and the
  card's round trip (``bench.measure_rtt_ms``), printed, not subtracted;
* the FLOPs: the products, convolutions and attention counted over the
  plain versions (``profiling.counted_flops``; there is no XLA cost
  analysis, and a ctypes launch is invisible to the counter) plus the
  deformable sampling's irreducible work (:func:`msda_flops`, which the
  counter cannot see: the plain version samples by gathers), as shares of
  the H100's 989 TFLOP/s dense bf16 peak over the wall and over the device
  busy time;
* one traced forward: the top 30 kernels, and every kernel summed into
  classes by name (``profiling.classify``: the port's own kernels, GEMM,
  convolution, elementwise, reduction, copy/layout, other), which add up
  to the traced device-op time.

Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from inklayer_tpu_torch import bench
from inklayer_tpu_torch.config import GDinoConfig
from inklayer_tpu_torch.models.gdino import GroundingDINO
from inklayer_tpu_torch.profiling import (PEAK_BF16, classify, counted_flops,
                                          device_profile, emit, print_classes,
                                          sync, wall_ms)
from inklayer_tpu_torch.runtime import (compute_dtype, constant_model,
                                        resolve_device)
from inklayer_tpu_torch.scripts.ablate_gdino import level_shapes, parts

CAPTION_IDS = [101, 4874, 1012, 102]  # "[CLS] object . [SEP]"
BUCKET = 800  # the image side, the pipeline's first shape bucket


def msda_flops(cfg, bucket: int = BUCKET) -> float:
    """The deformable attention's irreducible work in one forward: per
    query, heads x levels x points samples, 4 bilinear taps each, head_dim
    multiply-adds per tap, times 2 for interpolation and weighting (the
    JAX script's expression, ``profile_gdino_roofline.py:88-98``).  As
    there, the decoder's term counts ``enc_n_points`` samples per level
    (equal to ``dec_n_points`` in ``GDinoConfig()``)."""
    nq_enc = sum(h * w for h, w in level_shapes(cfg, bucket))
    hd = cfg.hidden_dim // cfg.nheads
    samples = cfg.nheads * cfg.num_feature_levels * cfg.enc_n_points
    per_query = samples * 4 * hd * 2 * 2
    return float(cfg.enc_layers * nq_enc * per_query
                 + cfg.dec_layers * cfg.num_queries * per_query)


def main(argv=None, model=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if model is None:
        dev = resolve_device(args.device)
        model = constant_model(lambda: GroundingDINO(GDinoConfig()), dev,
                               compute_dtype(dev))
    dev = model.feat_map.weight.device
    fwd = parts(model, BUCKET, CAPTION_IDS)["full"]

    @torch.inference_mode()
    def call():
        fwd()
        sync(dev)

    first_s = wall_ms(call, 1)[0] / 1e3
    wall = statistics.median(wall_ms(call, args.iters))
    rtt = bench.measure_rtt_ms(device=dev)
    counted = counted_flops(fwd, model)
    msda = msda_flops(model.cfg, BUCKET)
    total = counted + msda
    res = {"bucket": BUCKET, "iters": args.iters, "p50_ms": wall,
           "first_s": first_s, "rtt_ms": rtt, "counted_gflop": counted / 1e9,
           "msda_gflop": msda / 1e9, "total_gflop": total / 1e9,
           "peak_share_wall": total / (wall / 1e3) / PEAK_BF16,
           "device_ms": None, "traced_wall_ms": None, "op_ms": None,
           "peak_share_device": None, "top_kernels": None, "classes": None}
    print(f"forward p50 {wall:.3f} ms (round trip {rtt:.4f} ms, first call "
          f"{first_s:.2f} s); {counted / 1e9:.1f} GFLOP counted + "
          f"{msda / 1e9:.1f} deformable = {total / 1e9:.1f} GFLOP: "
          f"{res['peak_share_wall']:.4f} of 989 TFLOP/s over the wall")
    if dev.type == "cuda":
        prof = device_profile(call, top=None)
        res.update(device_ms=prof["busy_ms"], traced_wall_ms=prof["wall_ms"],
                   op_ms=prof["op_ms"], top_kernels=prof["kernels"][:30],
                   classes=classify(prof["kernels"]),
                   peak_share_device=total / (prof["busy_ms"] / 1e3)
                   / PEAK_BF16)
        print(f"device busy {prof['busy_ms']:.3f} ms: "
              f"{res['peak_share_device']:.4f} of the peak; top kernels:")
        for name, ms, calls in res["top_kernels"]:
            print(f"  {ms:9.3f} ms x{calls:5d}  {name[:100]}")
        print("classes:")
        print_classes(res["classes"], prof["op_ms"])
    return emit(res, dev)


if __name__ == "__main__":
    main()
