"""Stage times and host pieces of the full pipeline on the card (port of
the JAX package's ``scripts/profile_pipeline.py``).

    python -m inklayer_tpu_torch.scripts.profile_pipeline [--iters 3]
        [--trace] [--intermediate] [--img PATH] [--device cuda]

Builds ``build_pipeline(PipelineConfig())`` (full width, seeded
placeholder weights, bf16 on the card), runs ``InkLayerPipeline.run(...,
no_intermediate=True)`` and ``drain()`` once to warm up, then ``--iters``
times, and prints the mean per run of:

* each stage of ``pipe.stage_times`` (kept per thread: the run's own);
* each host piece of :func:`host_keys`, timed where the runner looks it up
  (``profiling.patch``; put back on exit), with the CPU (``thread_time``)
  and wall time of its calls and the threads they ran on: ``run`` (the
  calling thread), ``writer`` (the runner's two writer threads) or
  ``pool`` (the sweep's decode thread and workers).  A key ending in
  ``.wait`` is the wait of the read-back that the key before it started.

``--trace`` adds one traced run (``profiling.device_profile``): busy ms,
idle share, device ops and the top kernels.  ``--intermediate`` keeps every
output (``no_intermediate=False``), which adds the intermediate read-backs.
Without ``--img`` the sketch is the bench's seeded 750^2 one.  Prints one
JSON line last.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time

from PIL import Image

from inklayer_tpu_torch import bench
from inklayer_tpu_torch.build import build_pipeline
from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.io import outputs as io_out
from inklayer_tpu_torch.models.gdino import gdino as gdino_mod
from inklayer_tpu_torch.pipeline import runner
from inklayer_tpu_torch.profiling import (HostAccount, device_profile, emit,
                                          patches, sync,
                                          thread_clock_step_ms)
from inklayer_tpu_torch.runtime import compute_dtype, resolve_device


def host_keys(pipe, intermediate: bool = False, batch: int = 1) -> list:
    """(namespace, name, key, wait key) of the host pieces a run calls.

    The runner binds most of them by ``from ... import`` (runner.py
    imports), so they are patched on ``pipeline.runner``; the writers
    through ``io_out``; the detection's read-back where ``GDinoDetector``
    looks it up.  The set follows the run's mode, so that every key is
    called: the device front reads the detection and the front back in one
    read-back, and a batched sweep detects over the batch with host boxes
    (the front is then off)."""
    det = pipe.detector
    keys = [(io_out, "save_input_png", "save_input_png", None),
            (io_out, "save_masks_dir", "save_masks_dir", None),
            (io_out, "draw_boxes_image", "draw_boxes_image", None),
            (io_out, "save_png", "save_png", None),
            (runner, "decode_image", "decode_image", None),
            (runner, "upload", "upload", None),
            (runner, "final_readback", "final_readback",
             "final_readback.wait"),
            (runner, "color_sketch_by_label_map",
             "color_sketch_by_label_map", None)]
    front = pipe.cfg.device_front and batch == 1
    if front:
        keys += [(det, "detect_device_parts", "detect_device_parts", None)]
    elif batch > 1:
        keys += [(det, "detect_batch", "detect_batch", None)]
    else:
        keys += [(det, "detect_device", "detect_device", None),
                 (gdino_mod, "readback", "detect_readback",
                  "detect_readback.wait")]
    if not front:
        keys += [(runner, "nms_host_prefilter", "nms_host_prefilter", None),
                 (runner, "nms_depth_front", "nms_depth_front", None)]
    if front or intermediate:  # the front's, or the SAM outputs'
        keys += [(runner, "readback", "readback", "readback.wait")]
    if intermediate:
        keys += [(io_out, "save_norm_bboxes", "save_norm_bboxes", None),
                 (runner, "masks_readback", "masks_readback",
                  "masks_readback.wait")]
    return keys


def thread_kinds(pipe):
    """thread ident -> 'run' (the calling thread), 'writer' (the runner's
    writer threads) or 'pool' (any other)."""
    caller = threading.get_ident()
    writers = {t.ident for t in pipe._writer._threads}
    return lambda ident: ("run" if ident == caller else
                          "writer" if ident in writers else "pool")


def sketch_png(img, out_dir: str) -> str:
    """``img``, or the bench's seeded 750^2 sketch written under
    ``out_dir``."""
    if img:
        return img
    path = os.path.join(out_dir, "sketch.png")
    Image.fromarray(bench.seeded_sketch()).save(path)
    return path


def profile_runs(pipe, src: str, out: str, iters: int = 3,
                 trace: bool = False, no_intermediate: bool = True) -> dict:
    """One warm run, then ``iters`` timed runs of ``pipe`` on ``src`` with
    the host pieces timed; with ``trace``, one traced run."""
    account = HostAccount()

    def run():
        pipe.run(src, out, no_intermediate=no_intermediate, inpaint=False)
        pipe.drain()

    stages, times = {}, []
    with patches(host_keys(pipe, not no_intermediate), account):
        run()  # warm: the kernel build, allocations
        account.reset()
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
            for k, v in pipe.stage_times.items():
                stages[k] = stages.get(k, 0.0) + v * 1e3 / iters
        host = account.table(per=iters, kind=thread_kinds(pipe))
    res = {"iters": iters, "no_intermediate": no_intermediate,
           "run_ms": times, "run_ms_mean": sum(times) / iters,
           "stage_ms": stages, "host": host,
           "thread_clock_step_ms": thread_clock_step_ms(), "trace": None}
    if trace:
        prof = device_profile(lambda: (run(), sync(pipe.device)))
        res["trace"] = {k: prof[k] for k in ("wall_ms", "busy_ms",
                                              "idle_share", "device_ops",
                                              "op_ms", "kernels")}
    return res


def print_host(host: dict, per: str) -> None:
    print(f"  {'key':28s} {'threads':12s} {'cpu ms':>9s} {'wall ms':>9s} "
          f"{'calls':>7s}  (per {per})")
    for key in sorted(host, key=lambda k: -host[k]["wall_ms"]):
        h = host[key]
        print(f"  {key:28s} {','.join(h['threads']):12s} {h['cpu_ms']:9.2f}"
              f" {h['wall_ms']:9.2f} {h['calls']:7.2f}")


def print_trace(trace: dict) -> None:
    print(f"traced run: busy {trace['busy_ms']:.1f} ms of "
          f"{trace['wall_ms']:.1f} ms wall (idle share "
          f"{trace['idle_share']:.3f}), "
          f"{trace['device_ops']} device ops, {trace['op_ms']:.1f} ms of "
          f"device-op time; top kernels:")
    for name, ms, calls in trace["kernels"]:
        print(f"  {ms:9.3f} ms x{calls:5d}  {name[:100]}")


def main(argv=None, pipe=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", action="store_true",
                    help="one traced run: busy ms, idle share, top kernels")
    ap.add_argument("--intermediate", action="store_true",
                    help="keep every output (no_intermediate=False)")
    ap.add_argument("--img", default=None, help="a sketch (default: seeded)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if pipe is None:
        dev = resolve_device(args.device)
        pipe = build_pipeline(PipelineConfig(), device=dev,
                              dtype=compute_dtype(dev))
    if args.trace and pipe.device.type != "cuda":
        ap.error("--trace reads the card's trace")
    with tempfile.TemporaryDirectory(prefix="profile_pipeline_") as out:
        res = profile_runs(pipe, sketch_png(args.img, out), out, args.iters,
                           args.trace, not args.intermediate)
    print("run ms: " + ", ".join(f"{t:.1f}" for t in res["run_ms"]))
    print(f"stage ms (mean of {args.iters} runs):")
    for k, v in res["stage_ms"].items():
        print(f"  {k:10s} {v:9.2f}")
    print(f"host pieces (the thread CPU clock steps by "
          f"{res['thread_clock_step_ms']:.3f} ms):")
    print_host(res["host"], "run")
    if res["trace"]:
        print_trace(res["trace"])
    return emit(res, pipe.device)


if __name__ == "__main__":
    main()
