#!/usr/bin/env python3
"""Hold the port's flash-attention kernel at head_dim 40 (boxes padded to
48 columns in shared memory by TMA's zero fill) against three altered
copies of it, to show which faults chip_smoke.py's limits catch.

    python3 scripts/torch_flash_padding_check.py [--seeds 3]

Copies ``inklayer_tpu_torch/csrc`` into ``build/flash_padding_check/``,
alters each copy there, builds every copy with the port's nvcc flags and
runs ``ik_flash_attention`` of each library on the same seeded bf16
inputs at (16, 9216, 40) (the UNet's level 0 for one layer with CFG) and
(2, 70, 40) (70 keys of one 128-key tile), against the plain version in
fp32:

* ``kernel``: the sources as they are;
* ``scale 48^-0.5``: the head-dim-40 instance scaled by the padded
  width's 48 ** -0.5 instead of the caller's 40 ** -0.5;
* ``map width 48 (pad from the next row)``: the tensor maps' column
  extent is the padded 48 instead of the real 40, at the row stride of
  40, so TMA fills columns 40..47 with the next row's first 8;
* ``out-of-bounds fill NaN (pad not zeroed)``: the tensor maps fill what
  lies outside (D, N, BH) with NaN instead of zeros, so the pad columns
  (and the keys past N) are not zero.

A copy whose tile loads write only the 40 data columns (``pad columns not
zeroed``, a fault of the earlier WMMA loop, which zeroed them itself) no
longer applies: no code of the kernel writes the pad columns, TMA's
out-of-bounds fill does on every load; its counterpart is the NaN fill
above.

Prints, per copy, shape and seed, the max abs and relative L2 error and
whether chip_smoke's limits hold (every element within atol = rtol =
2e-2, relative L2 <= 5e-3).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "build", "flash_padding_check")
ATOL = RTOL = 2e-2
REL_L2 = 5e-3

# copy name -> [(file, regex, replacement)], each applied exactly once
VARIANTS = {
    "kernel": [],
    "scale 48^-0.5": [(
        "flash_attention.cu",
        r"(launch_attention<40, false>\([^;]*?)scale, s\)",
        r"\1rsqrtf(48.f), s)")],
    "map width 48 (pad from the next row)": [(
        "attention_tile.cuh", r"\{static_cast<cuuint64_t>\(D\),",
        "{static_cast<cuuint64_t>((D + 15) / 16 * 16),")],
    "out-of-bounds fill NaN (pad not zeroed)": [(
        "attention_tile.cuh", r"CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE",
        "CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA")],
}
SHAPES = ((16, 9216), (2, 70))


def make_copy(name: str, edits, csrc: str) -> str:
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    dst = os.path.join(WORK, slug, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for fname, pattern, repl in edits:
        path = os.path.join(dst, fname)
        with open(path) as f:
            text, n = re.subn(pattern, repl, f.read(), flags=re.S)
        if n != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
        with open(path, "w") as f:
            f.write(text)
    return dst


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, REPO)
    from inklayer_tpu_torch import _kernels
    from inklayer_tpu_torch.ops.attention import flash_attention_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {}
    for name, edits in VARIANTS.items():
        src = make_copy(name, edits, _kernels.CSRC_DIR)
        libs[name] = _kernels.load(_kernels.build(
            csrc_dir=src, build_dir=os.path.dirname(src)))
    rows = []
    for bh, n in SHAPES:
        for seed in range(args.seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = (torch.randn(bh, n, 40, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                        40 ** -0.5)
            for name, lib in libs.items():
                out = torch.empty_like(q)
                status = lib.ik_flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, n, 40, 40 ** -0.5, _kernels.stream(q.get_device()))
                _kernels.check(status, name)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs()
                row = {"copy": name, "shape": [bh, n, 40], "seed": seed,
                       "max_abs_err": float(err.max()),
                       "rel_l2": float((out.float() - ref).norm() / ref.norm()),
                       "elementwise_ok": bool(
                           (err <= ATOL + RTOL * ref.abs()).all()),
                       "finite": bool(torch.isfinite(out).all())}
                row["passes"] = (row["elementwise_ok"] and row["finite"]
                                 and row["rel_l2"] <= REL_L2)
                rows.append(row)
                print(f"  {name:30s} ({bh},{n},40) seed {seed}: max abs "
                      f"{row['max_abs_err']:.3e}  rel L2 {row['rel_l2']:.3e}"
                      f"  {'passes' if row['passes'] else 'FAILS'} the "
                      f"limits", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
