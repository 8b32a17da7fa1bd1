#!/usr/bin/env python3
"""Time the port's attention kernels (flash K7 and rel-pos K1/K2) against
the same kernels built from another ``csrc`` directory, on one card, in
one process.

    git archive <rev> inklayer_tpu_torch/csrc | tar -x -C build/ab_base \\
        --strip-components=2
    python3 scripts/torch_attention_ab.py build/ab_base [--iters 20]

Builds both kernel libraries (the baseline into ``build/ab_base_lib/``),
then for each attention case of chip_smoke.py's phase 2 (plus the UNet's
level-0 and level-1 shapes at a CFG batch of 4, BH = 32) times
``inklayer_tpu_torch.ops.attention.flash_attention`` /
``relpos_attention`` on each library in turns (baseline, current,
current, baseline), both through the same Python wrapper:

* per launch: CUDA events around one call, median of ``--iters`` (the
  wrapper's host cost included, as in chip_smoke.py);
* device: 20 calls captured in a CUDA graph and replayed, per call (the
  host cost drops out);
* throughput: wall time of 100 calls issued back to back, per call: the
  larger of the wrapper's host cost and the device time;

and ``F.scaled_dot_product_attention`` on the same inputs (4-D views; the
rel-pos bias expanded as a float mask).  Each current result is checked
against the plain version first (element-wise 2e-2, relative L2 5e-3).
Prints one line per case and a JSON object last.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLASH = ((12, 1370, 64), (2, 70, 64), (16, 9216, 40), (2, 70, 40),
         (16, 2304, 80), (2, 100, 80), (32, 9216, 40), (32, 2304, 80))
RELPOS = ((400, 14), (16, 64), (16, 48))  # (BH, kh = kw), head dim 80
ORDER = ("baseline", "current", "current", "baseline")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("baseline", help="a csrc directory to compare with")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import attention as A

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    base = ctypes.CDLL(_kernels.build(
        csrc_dir=os.path.abspath(args.baseline),
        build_dir=os.path.join(REPO, "build", "ab_base_lib")))
    for name, argtypes in _kernels._SIGNATURES.items():
        if hasattr(base, name):  # the baseline may lack newer entry points
            getattr(base, name).argtypes = argtypes
            getattr(base, name).restype = ctypes.c_int
    base.ik_error_string.argtypes = [ctypes.c_int]
    base.ik_error_string.restype = ctypes.c_char_p
    libs = {"baseline": base, "current": _kernels.lib()}

    def on(name, fn):
        def run():
            _kernels._lib = libs[name]
            return fn()
        return run

    def per_launch_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def throughput_ms(fn, calls=100):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    def device_ms(fn, reps=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(max(args.iters // 2, 1)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def check(case, got, want):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        rel = float((got - want).norm() / want.norm())
        if not bool(torch.isfinite(got).all()) or rel > 5e-3 or \
                bool((err > 2e-2 + 2e-2 * want.abs()).any()):
            raise AssertionError(f"{case}: current kernel off its plain "
                                 f"version (relative L2 {rel:.3e})")

    _kernels._lib = libs["current"]
    rows = []

    def run_case(case, fn, library):
        row = {"case": case, "per_launch_ms": {}, "device_ms": {},
               "throughput_ms": {}}
        for timer, key in ((per_launch_ms, "per_launch_ms"),
                           (device_ms, "device_ms"),
                           (throughput_ms, "throughput_ms")):
            for name in ORDER:
                row[key].setdefault(name, []).append(timer(on(name, fn)))
        _kernels._lib = libs["current"]
        row["library_ms"] = per_launch_ms(library)
        rows.append(row)
        print(f"  {case:28s} " + "  ".join(
            f"{key[:-3]} " + " ".join(
                f"{name} {'/'.join(f'{t:.4f}' for t in row[key][name])}"
                for name in ("baseline", "current"))
            for key in ("per_launch_ms", "device_ms", "throughput_ms"))
            + f"  library {row['library_ms']:.4f} ms", flush=True)

    for bh, n, d in FLASH:
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        sc = d ** -0.5
        case = f"flash ({bh},{n},{d})"
        check(case, A.flash_attention(q, k, v, sc),
              A.flash_attention_plain(q.float(), k.float(), v.float(), sc))
        run_case(case, lambda: A.flash_attention(q, k, v, sc),
                 lambda: F.scaled_dot_product_attention(
                     q[None], k[None], v[None], scale=sc))
    for bh, kh in RELPOS:
        n, sc = kh * kh, 80 ** -0.5
        t = [randn(bh, n, 80) for _ in range(3)] + [randn(bh, n, kh),
                                                    randn(bh, n, kh)]
        case = f"relpos ({bh},{n},80) kh=kw={kh}"
        check(case, A.relpos_attention(*t, sc),
              A.relpos_attention_plain(*[x.float() for x in t], sc))
        bias = (t[3][..., :, None] + t[4][..., None, :]).reshape(bh, n, n)
        run_case(case, lambda: A.relpos_attention(*t, sc),
                 lambda: F.scaled_dot_product_attention(
                     *(x[None] for x in t[:3]), attn_mask=bias[None],
                     scale=sc))
        del bias
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
