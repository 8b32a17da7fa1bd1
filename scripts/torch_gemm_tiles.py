#!/usr/bin/env python3
"""Device time of the MLP GEMM (K3, ``csrc/linear_bias_act.cu``) at SAM
ViT-H's two launches, for every tile width and epilogue, beside
``F.linear``.

    python3 scripts/torch_gemm_tiles.py

fc1 is (4096, 1280) x (5120, 1280)^T and fc2 (4096, 5120) x (1280,
5120)^T, bf16, seeded.  Each launch goes straight to the kernel's entry
point with the tile width forced (128 x 256, 128 x 160, 128 x 128 where
it divides N) and the erf-GELU epilogue on and off, on a grid of one
block per SM; the device time per call is 10 calls captured in a CUDA
graph and replayed (chip_smoke.py's ``graph_ms``).  ``ops/mlp.py
gemm_config`` picks the width for each launch; this shows what the
others would cost, and what the epilogue costs.  Every result is first
checked against ``F.linear`` (+ ``F.gelu``) in fp32 (element-wise 2e-2,
relative L2 5e-3).  Prints one line per case and a JSON object last.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"fc1": (4096, 5120, 1280), "fc2": (4096, 1280, 5120)}  # M, N, K


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops.mlp import GEMM_BLOCK_N, gemm_config

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _kernels.lib()
    dev = torch.cuda.current_device()
    n_sm = _kernels.sm_count(dev)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(
            torch.bfloat16)

    res = {"card": card, "rows": []}
    for name, (m, n, k) in SHAPES.items():
        a, w, b = randn(m, k), randn(n, k, std=k ** -0.5), randn(n, std=0.1)
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        chosen = gemm_config(m, n, k, n_sm)[0]
        for bn in GEMM_BLOCK_N:
            if n % bn:
                continue
            for gelu in (True, False):
                def launch():
                    _kernels.check(lib.ik_linear_bias_act(
                        a.data_ptr(), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), m, n, k, gelu, bn, n_sm,
                        _kernels.stream(dev)), "mlp_gelu")

                launch()
                want = F.linear(a.float(), w.float(), b.float())
                if gelu:
                    want = F.gelu(want)
                chip_smoke._check(f"{name} {bn}", out, want, 2e-2, 2e-2, 5e-3)
                ms = chip_smoke.graph_ms(launch)
                res["rows"].append({"launch": name, "block_n": bn,
                                    "gelu": gelu, "device_ms": ms,
                                    "chosen": bn == chosen})
                print(f"  {name} ({m}, {k}) -> {n}  128 x {bn}"
                      f"{' (chosen)' if bn == chosen else ''}  GELU "
                      f"{'on ' if gelu else 'off'}: device {ms:.4f} ms "
                      f"({2.0 * m * n * k / ms / 1e9:.0f} TFLOP/s)",
                      flush=True)
        ms = chip_smoke.graph_ms(lambda: F.linear(a, w, b))
        res["rows"].append({"launch": name, "library": "F.linear",
                            "device_ms": ms})
        print(f"  {name} F.linear: device {ms:.4f} ms", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
