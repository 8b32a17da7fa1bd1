#!/usr/bin/env python3
"""The 3x3 same-pad NHWC convolution (``inklayer_tpu_torch/ops/conv.py``,
kernel ``csrc/conv3x3.cu``) at the levels of the TPU prototype
``scripts/ablate_pallas_conv.py``, beside its plain version and cuDNN: the
port of that prototype, and the kernel's entry point.

    python3 scripts/torch_conv_ab.py [--levels 0,1,2,3] [--batch 2]
                                     [--reps 20]

Level i is the UNet's (H, W, C) at 768^2: (96, 96, 320), (48, 48, 640),
(24, 24, 1280), (12, 12, 1280), Cout = C, as in the prototype.  Inputs
are seeded bf16 (x normal, w normal x 0.02, the prototype's draws).  Each
level first checks the kernel against the plain version in fp32 (TF32
off): relative L2 <= 5e-3 (K = 9C sums up to 11,520 products before one
bf16 rounding) and element-wise 1e-2 / 1e-2.  Then, for the kernel, the
plain version (bf16 inputs) and ``F.conv2d`` on the channels_last NCHW
view with OIHW weights (cuDNN, timed only: the port does not call it), it
prints the median time per call of ``--reps`` calls (CUDA events around
each call), the device time per call (10 calls captured in a CUDA graph
and replayed), the bound, max(2 B H W 9 C Cout / 989 TFLOP/s, bytes /
3.35 TB/s) with x, w and the output moved once, and each one's share of
that bound.  Each level's line names the launch configuration
``ops/conv.py conv_config`` chose (patch, tile width, whole and split
tiles, units, grid) and the bytes its TMA loads bring through L2 into
shared memory per call (:func:`tma_bytes`: every tap re-reads its image
box, every M tile its weight boxes), with their rate at the device time.
The card's name and power limit come first, then the kernel instances'
registers, spills and shared memory (where this process built the
library); a JSON object of every number comes last.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = [(96, 96, 320), (48, 48, 640), (24, 24, 1280), (12, 12, 1280)]
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def conv_bound(b: int, h: int, w: int, c: int, cout: int):
    """(ms, "operations" | "bytes") for one convolution."""
    t_ops = 2.0 * b * h * w * 9 * c * cout / PEAK_BF16
    t_bytes = 2.0 * (b * h * w * c + 9 * c * cout + b * h * w * cout) \
        / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def config_text(cfg) -> str:
    """One line of a conv_config choice."""
    split = (f", the last {cfg.tail} in {cfg.splits} splits"
             if cfg.tail else "")
    return (f"patch {cfg.bh} x {cfg.bw}, BN {cfg.bn}: "
            f"{cfg.m_tiles * cfg.n_tiles} tiles of 128 x {cfg.bn}, "
            f"{cfg.full} whole{split}; {cfg.units} units on a grid of "
            f"{cfg.grid}")


def tma_bytes(cfg, cout: int) -> int:
    """Bytes the kernel's TMA loads move into shared memory per call under
    ``cfg`` (``ops/conv.py`` ConvConfig): per slab of a unit two image
    boxes of bh * bw rows of 128 bytes and the weight boxes of 64 x 64
    that hold a column below Cout."""
    from inklayer_tpu_torch.ops import conv

    total = 0
    for u in range(cfg.units):
        _, nt, _, k0, k1 = conv.unit_work(cfg, u)
        boxes = min(cfg.bn // 64, -(-(cout - nt * cfg.bn) // 64))
        total += (k1 - k0) * (2 * cfg.bh * cfg.bw * 128 + boxes * 8192)
    return total


def run(levels, batch: int = 2, reps: int = 20) -> list:
    """Check and time each level; returns one dict per level."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    import chip_smoke
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import conv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for li in levels:
        h, w, c = LEVELS[li]
        gen = torch.Generator(device="cuda").manual_seed(li)
        x = torch.randn(batch, h, w, c, generator=gen, device="cuda").to(
            torch.bfloat16)
        wt = (torch.randn(3, 3, c, c, generator=gen, device="cuda")
              * 0.02).to(torch.bfloat16)
        err, rel = chip_smoke._check(
            f"conv3x3 level {li}", conv.conv3x3_nhwc(x, wt),
            conv.conv3x3_nhwc_plain(x.float(), wt.float()), 1e-2, 1e-2, 5e-3)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last: the same memory
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        calls = {"kernel": lambda: conv.conv3x3_nhwc(x, wt),
                 "plain": lambda: conv.conv3x3_nhwc_plain(x, wt),
                 "cudnn": lambda: F.conv2d(x_nchw, w_oihw, padding=1)}
        bnd = conv_bound(batch, h, w, c, c)
        cfg = conv.conv_config(batch, h, w, c, c, _kernels.sm_count(0))
        row = {"level": li, "shape": [batch, h, w, c, c],
               "config": cfg._asdict(), "tma_bytes": tma_bytes(cfg, c),
               "max_abs_err": err, "rel_l2": rel, "bound_ms": bnd[0],
               "bound_by": bnd[1]}
        for name, fn in calls.items():
            row[f"{name}_ms"] = chip_smoke.cuda_median_ms(fn, iters=reps)
            row[f"{name}_device_ms"] = chip_smoke.graph_ms(fn)
        rows.append(row)
        print(f"  level {li} ({batch}, {h}, {w}, {c}) -> {c}: max_abs_err "
              f"{err:.3e}, rel_l2 {rel:.3e}; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}); {config_text(cfg)}", flush=True)
        if row["kernel_device_ms"] is not None:
            rate = row["tma_bytes"] / row["kernel_device_ms"] / 1e9
            print(f"    kernel TMA loads {row['tma_bytes'] / 1e6:.1f} MB per "
                  f"call, {rate:.2f} TB/s through L2 at its device time",
                  flush=True)
        for name in calls:
            ms, dev = row[f"{name}_ms"], row[f"{name}_device_ms"]
            print(f"    {name:6s} {ms:8.4f} ms per call ({bnd[0] / ms:.3f} of "
                  f"the bound), device {chip_smoke._fmt(dev)}"
                  + ("" if dev is None else
                     f" ({bnd[0] / dev:.3f} of the bound)"), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=str, default="0,1,2,3")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_ab: needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    from inklayer_tpu_torch import _kernels

    card = chip_smoke.card_line()
    print(card, flush=True)
    _kernels.build(verbose=True)
    chip_smoke.kernel_resources({"conv3x3.cu"})
    rows = run([int(s) for s in args.levels.split(",")], args.batch,
               args.reps)
    print(json.dumps({"card": card, "levels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
