"""SAM ViT-H image encoder forward p50 on the card (port of the JAX
package's ``scripts/bench_sam_vith.py``): the pipeline's encoder at full
width (32 blocks, 4 global and 28 windowed, rel-pos, bf16, constant 0.01
parameters) on a seeded 1024^2 input.

    python -m inklayer_tpu_torch.scripts.bench_sam_vith [--device cuda]

Three warm calls, then the p50 of 10 wall times (each ends in a read-back
of the output's sum); the device ms of one traced call
(``profiling.device_profile``); and the FLOPs of one forward counted by
``torch.utils.flop_counter`` with the plain versions (a ctypes kernel
launch is invisible to the counter), as a share of the H100's dense bf16
peak over the wall and over the device time.  Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from inklayer_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from inklayer_tpu_torch.profiling import card_info, device_profile
from inklayer_tpu_torch.runtime import (compute_dtype, constant_model,
                                        disable_kernels, resolve_device)

# H100 SXM data sheet, dense bf16 tensor-core rate at 700 W
PEAK_BF16 = 989e12
WARM_CALLS = 3
TIMED_CALLS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = compute_dtype(dev)
    model = constant_model(ImageEncoderViT, dev, dtype)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 1024, 1024, 3)
                         ).to(dev, dtype)

    @torch.inference_mode()
    def fwd() -> float:
        return model(x).float().sum().item()

    t0 = time.perf_counter()
    fwd()
    first_s = time.perf_counter() - t0
    for _ in range(WARM_CALLS):
        fwd()
    ts = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        fwd()
        ts.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(ts, 50))
    device_ms = device_profile(fwd)["busy_ms"] if dev.type == "cuda" \
        else None  # no device track on the CPU
    with FlopCounterMode(display=False) as counter, disable_kernels(), \
            torch.inference_mode():
        model(x)
    flops = counter.get_total_flops()
    card, power = card_info(dev)
    on_card = dev.type == "cuda"  # the peak is the card's
    res = {"metric": "SAM ViT-H encoder forward p50", "value": round(p50, 3),
           "unit": "ms", "first_call_s": round(first_s, 2),
           "device_ms": None if device_ms is None else round(device_ms, 3),
           "tflop": round(flops / 1e12, 4),
           "peak_share_wall": round(flops / (p50 / 1e3) / PEAK_BF16, 4)
           if on_card else None,
           "peak_share_device": round(flops / (device_ms / 1e3) / PEAK_BF16,
                                      4) if on_card else None,
           "card": card, "power_limit_w": power}
    print(f"ViT-H fwd p50 {p50:.3f} ms wall over {TIMED_CALLS} calls "
          f"({', '.join(f'{t:.2f}' for t in ts)}); device {device_ms} ms; "
          f"{flops / 1e12:.4f} TFLOP counted; [{card}, {power} W]")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
