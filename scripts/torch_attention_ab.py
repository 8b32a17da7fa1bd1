#!/usr/bin/env python3
"""Time the port's hand-written kernels — flash attention (K7), rel-pos
attention (K1/K2), the MLP GEMM (K3), LayerNorm (K4/K4r), multi-scale
deformable attention (K5t/K5f) and the connected components (K6/K6b) —
against the same entry points of another revision of the port, on one
card, in turns.

    mkdir -p build/ab_base && git archive <rev> | tar -x -C build/ab_base
    python3 scripts/torch_attention_ab.py build/ab_base [--iters 20]
        [--kernels attention,mlp,layernorm,msda,components]

Each side runs in a worker process of its own that imports
``inklayer_tpu_torch`` from its tree (this checkout, or the unpacked
baseline), builds that tree's kernel library into its own ``build/``, and
times the public entry points (``ops.attention.flash_attention`` /
``relpos_attention``, ``ops.mlp.mlp_gelu``, ``ops.norm.layernorm_2d`` /
``layernorm_residual_2d``, ``ops.deformable.ms_deform_attn``,
``ops.components.connected_components`` / ``clean_components``), so both
the CUDA code and the Python wrapper with its launch path are the side's
own; ``--kernels`` picks the groups.  The workers run in turns (baseline,
current, current, baseline); for each case of chip_smoke.py's phase 2
(plus the UNet's attention at a CFG batch of 4, BH = 32; the inputs made
by this checkout's code for both sides) each prints:

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
``F.layer_norm``; timed only; the deformable attention and the
components have none).  Each worker first checks every result against the
plain version (element-wise 2e-2, relative L2 5e-3; MSDA atol 1e-2 /
rtol 2e-2; the components exactly).  Prints
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
MSDA_LEVELS = ((100, 100), (50, 50), (25, 25), (13, 13))  # GDINO at 800^2
MSDA = (13294, 900)  # Lq: encoder, decoder
GROUPS = ("attention", "mlp", "layernorm", "msda", "components")
ORDER = ("baseline", "current", "current", "baseline")
TIMERS = ("per_launch_ms", "device_ms", "b2b_ms")


def worker(root: str, iters: int, groups) -> dict:
    """Time every case of ``groups`` with the package and kernels of the
    tree ``root``."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, REPO)
    import chip_smoke  # this checkout's input makers, for both sides

    sys.path[0] = root
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops import attention as A
    from inklayer_tpu_torch.ops import components, deformable, mlp, norm

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

    def check(case, got, want, atol=2e-2, rel_l2=5e-3):
        for g, w in (zip(got, want) if isinstance(got, tuple)
                     else [(got, want)]):
            g, w = g.float(), w.float()
            err = (g - w).abs()
            rel = float((g - w).norm() / w.norm())
            if not bool(torch.isfinite(g).all()) or rel > rel_l2 or \
                    bool((err > atol + 2e-2 * w.abs()).any()):
                raise AssertionError(f"{case}: kernel off its plain version "
                                     f"(relative L2 {rel:.3e})")

    rows = {}

    def run_case(case, fn, library):
        timers = (per_launch_ms, device_ms, b2b_ms)
        row = {t: fn_t(fn) for t, fn_t in zip(TIMERS, timers)}
        row.update({f"library_{t}": None if library is None else fn_t(library)
                    for t, fn_t in zip(TIMERS, timers)})
        rows[case] = row

    if "msda" in groups:
        s_tot = sum(h * w for h, w in MSDA_LEVELS)
        value = randn(1, s_tot, 8, 32)
        for lq in MSDA:
            loc = (torch.rand(1, lq, 8, 4, 4, 2, generator=gen,
                              device="cuda") * 1.2 - 0.1)
            att = torch.softmax(torch.randn(1, lq, 8, 16, generator=gen,
                                            device="cuda"), -1).reshape(
                                                1, lq, 8, 4, 4)
            case = f"ms_deform_attn Lq={lq}"
            check(case, deformable.ms_deform_attn(value, MSDA_LEVELS, loc,
                                                  att),
                  deformable.ms_deform_attn_plain(value.float(), MSDA_LEVELS,
                                                  loc, att),
                  atol=1e-2, rel_l2=float("inf"))
            run_case(case, lambda: deformable.ms_deform_attn(
                value, MSDA_LEVELS, loc, att), None)
    if "components" in groups:
        stack = chip_smoke.mask_stack(gen)
        for case, masks in (("components (64,750,750)", stack),
                            ("components (1,750,750)", stack[:1].clone()),
                            ("components (64,750,750) adversarial",
                             chip_smoke.adversarial_stack())):
            if not torch.equal(components.connected_components(masks),
                               components.connected_components_plain(masks)):
                raise AssertionError(f"{case}: labels differ")
            kept = components.clean_components(masks, 500, 1.1)[0]
            if not torch.equal(kept, components.clean_components_plain(
                    masks, 500, 1.1)[0]):
                raise AssertionError(f"{case}: cleaned masks differ")
            run_case(case.replace("components", "connected_components"),
                     lambda: components.connected_components(masks), None)
            run_case(case.replace("components", "clean_components"),
                     lambda: components.clean_components(masks, 500, 1.1),
                     None)
    for bh, n, d in FLASH if "attention" in groups else ():
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        sc = d ** -0.5
        case = f"flash ({bh},{n},{d})"
        check(case, A.flash_attention(q, k, v, sc),
              A.flash_attention_plain(q.float(), k.float(), v.float(), sc))
        run_case(case, lambda: A.flash_attention(q, k, v, sc),
                 lambda: F.scaled_dot_product_attention(
                     q[None], k[None], v[None], scale=sc))
    for bh, kh in RELPOS if "attention" in groups else ():
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
    for tok, c, h in MLP if "mlp" in groups else ():
        args = [randn(tok, c), randn(h, c, std=c ** -0.5), randn(h, std=0.1),
                randn(c, h, std=h ** -0.5), randn(c, std=0.1)]
        case = f"mlp_gelu ({tok},{c})->({h})->({c})"
        check(case, mlp.mlp_gelu(*args),
              mlp.mlp_gelu_plain(*[x.float() for x in args]))
        run_case(case, lambda: mlp.mlp_gelu(*args),
                 lambda: F.linear(F.gelu(F.linear(args[0], args[1], args[2])),
                                  args[3], args[4]))
    for r, c, res in LAYERNORM if "layernorm" in groups else ():
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
    parser.add_argument("--kernels", default=",".join(GROUPS),
                        help="comma-separated groups of cases, of "
                        + ", ".join(GROUPS))
    parser.add_argument("--worker", action="store_true",
                        help="time the tree given as `baseline` and print "
                        "its results as JSON (run by the parent)")
    args = parser.parse_args()

    groups = args.kernels.split(",")
    if set(groups) - set(GROUPS):
        parser.error(f"--kernels: groups of {GROUPS}")
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.baseline), args.iters,
                                groups)))
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
             "--worker", "--iters", str(args.iters), "--kernels",
             args.kernels],
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
            libs = [r[case][f"library_{t}"] for side in ORDER[:2]
                    for r in runs[side]]
            row[f"library_{t}"] = None if None in libs else libs
        out.append(row)
        print(f"  {case:30s} " + "  ".join(
            f"{t[:-3]} " + " ".join(
                f"{side} {'/'.join(f'{v:.4f}' for v in row[t][side])}"
                for side in ("baseline", "current"))
            + ("" if row[f"library_{t}"] is None else
               f" library {statistics.median(row[f'library_{t}']):.4f}")
            for t in TIMERS) + " ms", flush=True)
    print(json.dumps({"card": card, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
