#!/usr/bin/env python3
"""Time the port's hand-written kernels — flash attention (K7), rel-pos
attention (K1/K2), the MLP GEMM (K3) and LayerNorm (K4/K4r) — against the
same entry points of another revision of the port, on one card, in turns.

    mkdir -p build/ab_base && git archive <rev> | tar -x -C build/ab_base
    python3 scripts/torch_attention_ab.py build/ab_base [--iters 20]

Each side runs in a worker process of its own that imports
``inklayer_tpu_torch`` from its tree (this checkout, or the unpacked
baseline), builds that tree's kernel library into its own ``build/``, and
times the public entry points (``ops.attention.flash_attention`` /
``relpos_attention``, ``ops.mlp.mlp_gelu``, ``ops.norm.layernorm_2d`` /
``layernorm_residual_2d``), so both the CUDA code and the Python wrapper
with its launch path are the side's own.  The workers run in turns
(baseline, current, current, baseline); for each case of chip_smoke.py's
phase 2 (plus the UNet's attention at a CFG batch of 4, BH = 32) each
prints:

* per launch: CUDA events around one call, median of ``--iters`` (the
  wrapper's host cost included, as in chip_smoke.py);
* device: 10 calls captured in a CUDA graph and replayed, per call (the
  host cost drops out);
* back to back: wall time per call of 100 calls issued without a
  synchronise, the least of 5 runs (the host is shared): the larger of the
  wrapper's host cost and the device time;

and the same three for the library call computing the same function
(``F.scaled_dot_product_attention`` on 4-D views with the rel-pos bias
expanded as a float mask, ``F.linear`` -> ``F.gelu`` -> ``F.linear``,
``F.layer_norm``; timed only).  Each worker first checks every result
against the plain version (element-wise 2e-2, relative L2 5e-3).  Prints
one line per case and side, and a JSON object last.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
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
MLP = ((4096, 1280, 5120),)  # (T, C, H)
LAYERNORM = ((4096, 1280, False), (4096, 1280, True), (40000, 96, False),
             (1370, 768, False), (18432, 320, False), (4608, 640, False),
             (1152, 1280, False))  # (rows, C, residual)
ORDER = ("baseline", "current", "current", "baseline")
TIMERS = ("per_launch_ms", "device_ms", "b2b_ms")


def worker(root: str, iters: int) -> dict:
    """Time every case with the package and kernels of the tree ``root``."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, root)
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import attention as A
    from inklayer_tpu_torch.ops import mlp, norm

    if not os.path.abspath(_kernels.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"imported {_kernels.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.lib()  # build this tree's kernels before any timing

    def per_launch_ms(fn):
        for _ in range(3):
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

    def b2b_ms(fn, calls=100, runs=5):
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

    def device_ms(fn, reps=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(max(iters // 2, 1)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(
            torch.bfloat16)

    def check(case, got, want):
        for g, w in (zip(got, want) if isinstance(got, tuple)
                     else [(got, want)]):
            g, w = g.float(), w.float()
            err = (g - w).abs()
            rel = float((g - w).norm() / w.norm())
            if not bool(torch.isfinite(g).all()) or rel > 5e-3 or \
                    bool((err > 2e-2 + 2e-2 * w.abs()).any()):
                raise AssertionError(f"{case}: kernel off its plain version "
                                     f"(relative L2 {rel:.3e})")

    rows = {}

    def run_case(case, fn, library):
        row = {t: fn_t(fn) for t, fn_t in zip(
            TIMERS, (per_launch_ms, device_ms, b2b_ms))}
        row.update({f"library_{t}": fn_t(library) for t, fn_t in zip(
            TIMERS, (per_launch_ms, device_ms, b2b_ms))})
        rows[case] = row

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
    for tok, c, h in MLP:
        args = [randn(tok, c), randn(h, c, std=c ** -0.5), randn(h, std=0.1),
                randn(c, h, std=h ** -0.5), randn(c, std=0.1)]
        case = f"mlp_gelu ({tok},{c})->({h})->({c})"
        check(case, mlp.mlp_gelu(*args),
              mlp.mlp_gelu_plain(*[x.float() for x in args]))
        run_case(case, lambda: mlp.mlp_gelu(*args),
                 lambda: F.linear(F.gelu(F.linear(args[0], args[1], args[2])),
                                  args[3], args[4]))
    for r, c, res in LAYERNORM:
        x, y = randn(r, c), randn(r, c)
        p = [1.0 + randn(c, std=0.1), randn(c, std=0.1)]
        case = f"layernorm ({r},{c}){' + residual' if res else ''}"
        if res:
            check(case, norm.layernorm_residual_2d(x, y, *p),
                  norm.layernorm_residual_2d_plain(
                      x.float(), y.float(), *[a.float() for a in p]))
            run_case(case, lambda: norm.layernorm_residual_2d(x, y, *p),
                     lambda: F.layer_norm(x + y, (c,), *p, eps=1e-6))
        else:
            check(case, norm.layernorm_2d(x, *p),
                  norm.layernorm_2d_plain(x.float(), *[a.float() for a in p]))
            run_case(case, lambda: norm.layernorm_2d(x, *p),
                     lambda: F.layer_norm(x, (c,), *p, eps=1e-6))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("baseline", help="a tree of the repository to "
                        "compare with (git archive of a revision)")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--worker", action="store_true",
                        help="time the tree given as `baseline` and print "
                        "its results as JSON (run by the parent)")
    args = parser.parse_args()

    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.baseline), args.iters)))
        return 0

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"baseline": os.path.abspath(args.baseline), "current": REPO}
    runs = {"baseline": [], "current": []}
    for side in ORDER:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), trees[side],
             "--worker", "--iters", str(args.iters)],
            capture_output=True, text=True, cwd=trees[side])
        if proc.returncode != 0:
            raise RuntimeError(f"{side} worker failed:\n{proc.stderr[-4000:]}")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"  {side} worker: {time.perf_counter() - t0:.1f} s", flush=True)

    out = []
    for case in runs["current"][0]:
        row = {"case": case}
        for side in ("baseline", "current"):
            for t in TIMERS:
                row.setdefault(t, {})[side] = [r[case][t] for r in runs[side]]
        for t in TIMERS:
            row[f"library_{t}"] = [r[case][f"library_{t}"]
                                   for side in ORDER[:2] for r in runs[side]]
        out.append(row)
        print(f"  {case:30s} " + "  ".join(
            f"{t[:-3]} " + " ".join(
                f"{side} {'/'.join(f'{v:.4f}' for v in row[t][side])}"
                for side in ("baseline", "current"))
            + f" library {statistics.median(row[f'library_{t}']):.4f}"
            for t in TIMERS) + " ms", flush=True)
    print(json.dumps({"card": card, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
