#!/usr/bin/env python3
"""Split the host cost of one LayerNorm launch (K4) into its pieces, on the
card, beside ``F.layer_norm``'s.

    python3 scripts/torch_launch_cost.py [--rows 1370] [--cols 768]

For bf16 (rows, cols) inputs times, per call, the best of 5 runs of 2000
calls issued back to back (wall clock; the device work queues behind and
is drained once per run):

* the whole wrapper (``ops.norm.layernorm_2d``) and ``F.layer_norm``;
* the pieces of the wrapper's path: the device rule (``use_kernel``), the
  launch configuration (``layernorm_config``, cached), the checks of the
  three tensors, the output allocation (``torch.empty_like``), the current
  stream's handle, and the packed entry point itself (argument packing,
  ctypes, the C entry and ``cudaLaunchKernel``);
* the device time per call from a CUDA graph of 10 calls, for both.

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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=1370)
    parser.add_argument("--cols", type=int, default=768)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import norm
    from inklayer_tpu_torch.runtime import use_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows, c = args.rows, args.cols
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    res = {"card": card, "shape": [rows, c], "host_us": {}, "device_us": {}}
    for name, fn in items.items():
        us = chip_smoke.back_to_back_ms(fn, calls=2000) * 1e3
        res["host_us"][name] = us
        print(f"  {name:28s} {us:8.3f} us per call back to back", flush=True)
    for name in ("wrapper layernorm_2d", "F.layer_norm"):
        us = chip_smoke.graph_ms(items[name]) * 1e3
        res["device_us"][name] = us
        print(f"  {name:28s} {us:8.3f} us per call on the device (graph)",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
