#!/usr/bin/env python3
"""Split the host cost of one kernel launch into its pieces, on the card,
beside the library call's: LayerNorm (K4) or multi-scale deformable
attention (K5f, the decoder's launch).

    python3 scripts/torch_launch_cost.py [--op layernorm] [--rows 1370]
        [--cols 768]
    python3 scripts/torch_launch_cost.py --op msda [--lq 900]

Times, per call, the best of 5 runs of 2000 calls issued back to back
(wall clock; the device work queues behind and is drained once per run):

* ``layernorm``, bf16 (rows, cols): the whole wrapper
  (``ops.norm.layernorm_2d``) and ``F.layer_norm``; the pieces of the
  wrapper's path: the device rule (``use_kernel``), the launch
  configuration (``layernorm_config``, cached), the checks of the three
  tensors, the output allocation (``torch.empty_like``), the current
  stream's handle, and the packed entry point itself (argument packing,
  ctypes, the C entry and ``cudaLaunchKernel``);
* ``msda``, GDINO's levels at the 800^2 bucket, bf16 values, Lq queries:
  the whole wrapper (``ops.deformable.ms_deform_attn``; no library call
  computes it); the device rule, the level table (cached per shape set),
  the shape checks, the type and contiguity checks, the output
  allocation, the stream's handle, the packed entry point, and for
  comparison the two numpy level arrays the wrapper built on every call
  before the table was cached;
* the device time per call from a CUDA graph of 10 calls, for the wrapper
  (and ``F.layer_norm``).

Prints one line per item and a JSON object last.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def layernorm_items(rows: int, c: int, gen):
    """(shape, {item: fn}, items timed on the device) for LayerNorm."""
    import torch
    import torch.nn.functional as F

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import norm
    from inklayer_tpu_torch.runtime import use_kernel

    x = torch.randn(rows, c, generator=gen, device="cuda").to(torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(
        torch.bfloat16)
    bi = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(
        torch.bfloat16)
    dev = x.get_device()
    lanes, vpl, threads = norm.layernorm_config(rows, c, 2,
                                                _kernels.sm_count(dev))
    out = torch.empty_like(x)
    entry = _kernels.lib().ik_layernorm

    def checks():
        for t in (x, sc, bi):
            if t.dtype is not torch.bfloat16 or t.get_device() != dev:
                raise TypeError
            if not t.is_contiguous() or t.data_ptr() & 15:
                raise ValueError

    def launch():
        return entry(x.data_ptr(), 0, sc.data_ptr(), bi.data_ptr(), 0,
                     out.data_ptr(), rows, c, lanes, vpl, threads, 1e-6, 1,
                     _kernels.stream(dev))

    items = {
        "wrapper layernorm_2d": lambda: norm.layernorm_2d(x, sc, bi),
        "F.layer_norm": lambda: F.layer_norm(x, (c,), sc, bi, 1e-6),
        "use_kernel": lambda: use_kernel(x, sc, bi),
        "layernorm_config (cached)": lambda: norm.layernorm_config(
            rows, c, 2, _kernels.sm_count(dev)),
        "checks of 3 tensors": checks,
        "torch.empty_like": lambda: torch.empty_like(x),
        "stream handle": lambda: _kernels.stream(dev),
        "packed entry + launch": launch,
    }
    return [rows, c], items, ("wrapper layernorm_2d", "F.layer_norm")


def msda_items(lq: int, gen):
    """(shape, {item: fn}, items timed on the device) for the deformable
    attention at GDINO's 800^2 levels."""
    import numpy as np
    import torch

    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import deformable
    from inklayer_tpu_torch.runtime import use_kernel

    shapes = ((100, 100), (50, 50), (25, 25), (13, 13))
    s = sum(h * w for h, w in shapes)
    value = torch.randn(1, s, 8, 32, generator=gen, device="cuda").to(
        torch.bfloat16)
    loc = torch.rand(1, lq, 8, 4, 4, 2, generator=gen, device="cuda")
    att = torch.softmax(torch.randn(1, lq, 8, 16, generator=gen,
                                    device="cuda"), -1).reshape(1, lq, 8, 4, 4)
    dev = value.get_device()
    out = torch.empty(1, lq, 256, dtype=torch.bfloat16, device="cuda")
    s_tot, *levels = deformable.level_table(shapes)
    entry = _kernels.lib().ik_ms_deform_attn

    def shape_checks():
        b, s_, heads, d = value.shape
        _, q, _, n_levels, n_points, _ = loc.shape
        if d != 32 or s_tot != s_ or len(shapes) != n_levels or \
                loc.shape != (b, q, heads, n_levels, n_points, 2) or \
                att.shape != (b, q, heads, n_levels, n_points):
            raise ValueError

    def type_checks():
        if value.dtype not in (torch.bfloat16, torch.float32) or \
                loc.dtype != torch.float32 or att.dtype != torch.float32:
            raise TypeError
        if not (value.is_contiguous() and loc.is_contiguous()
                and att.is_contiguous()):
            raise ValueError

    def numpy_levels():
        np.asarray(shapes, np.int32).reshape(-1)
        np.cumsum([0] + [h * w for h, w in shapes])[:-1].astype(np.int32)

    def launch():
        return entry(value.data_ptr(), loc.data_ptr(), att.data_ptr(),
                     out.data_ptr(), 1, s, lq, 8, 4, 4, 1, *levels,
                     _kernels.stream(dev))

    items = {
        "wrapper ms_deform_attn": lambda: deformable.ms_deform_attn(
            value, shapes, loc, att),
        "use_kernel": lambda: use_kernel(value, loc, att),
        "level_table (cached)": lambda: deformable.level_table(shapes),
        "shape checks": shape_checks,
        "type and contiguity checks": type_checks,
        "torch.empty": lambda: torch.empty((1, lq, 256), dtype=value.dtype,
                                           device=value.device),
        "stream handle": lambda: _kernels.stream(dev),
        "packed entry + launch": launch,
        "numpy level arrays (before)": numpy_levels,
    }
    return [lq, s], items, ("wrapper ms_deform_attn",)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--op", choices=("layernorm", "msda"),
                        default="layernorm")
    parser.add_argument("--rows", type=int, default=1370)
    parser.add_argument("--cols", type=int, default=768)
    parser.add_argument("--lq", type=int, default=900)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.op == "layernorm":
        shape, items, timed = layernorm_items(args.rows, args.cols, gen)
    else:
        shape, items, timed = msda_items(args.lq, gen)
    res = {"card": card, "op": args.op, "shape": shape, "host_us": {},
           "device_us": {}}
    for name, fn in items.items():
        us = chip_smoke.back_to_back_ms(fn, calls=2000) * 1e3
        res["host_us"][name] = us
        print(f"  {name:28s} {us:8.3f} us per call back to back", flush=True)
    for name in timed:
        us = chip_smoke.graph_ms(items[name]) * 1e3
        res["device_us"][name] = us
        print(f"  {name:28s} {us:8.3f} us per call on the device (graph)",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
