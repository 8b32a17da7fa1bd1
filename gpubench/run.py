"""One run of one benchmark cell of the port (``inklayer_tpu_torch``).

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
its last key, ``checks``, holds each number compared with its limit, which
are also the last lines of standard error.

Exits non-zero and prints no result when the card is missing or fewer
cards are present than the cell asks for, when the run fails, and when a
module of JAX or of the JAX package is loaded in this process once the
window has closed.  Every cache the run writes lies inside the checkout
(``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the JAX package and JAX itself, compared with whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "inklayer_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of
    :data:`FORBIDDEN` (``inklayer_tpu_torch`` is not ``inklayer_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def cache_dirs(root: str) -> dict:
    """Fixed cache directories inside the checkout, for the libraries the
    program may compile with; the port's own ``nvcc`` library lands in
    ``build/kernels/`` beside its package."""
    base = os.path.join(root, "build", "gpubench_cache")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda")}


def card_info() -> dict:
    import torch

    kind = torch.cuda.get_device_name(0)
    info = {"kind": kind, "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout
        info["power_limit_w"] = out.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def format_checks(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def finish(result: dict, card: dict, chips: int):
    """(the lines for standard error, the result's JSON line): the device
    described, the checks as the last key and as the last lines."""
    result = dict(result)
    result["device"] = {"platform": "gpu", "kind": card["kind"],
                        "count": chips,
                        "power_limit_w": card.get("power_limit_w"),
                        **result["device"]}
    checks = result.pop("checks")
    result["checks"] = checks
    return format_checks(checks), json.dumps(result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench.harness import process_start_s
    t_process = process_start_s()
    from gpubench.manifest import ROOT, Manifest

    for k, v in cache_dirs(ROOT).items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("gpubench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    card = card_info()

    from gpubench.harness import run_cell

    result = run_cell(manifest, cell, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_process,
                      card)
    found = forbidden_modules()
    if found:
        print(f"gpubench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    lines, last = finish(result, card, cell.chips)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(last, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
