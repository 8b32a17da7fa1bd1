"""Where the directory sweep's time goes, on the card (port of the JAX
package's ``scripts/analyze_sweep_stalls4.py``).

    python -m inklayer_tpu_torch.scripts.analyze_sweep_stalls4 [--n 8]
        [--reps 3] [--workers W] [--batch B] [--device-front] [--img PATH]
        [--device cuda]

``InkLayerPipeline.run_dir`` over ``--n`` copies of one sketch (the bench's
seeded 750^2 one without ``--img``), ``no_intermediate``, ``--workers``
(default ``PipelineConfig.sweep_workers``) and ``--batch``, on
``build_pipeline(PipelineConfig())`` (full width, seeded placeholder
weights, bf16 on the card).  Two warm sweeps, ``--reps`` timed ones, then
one traced sweep.  It prints:

* wall per image and sketches/s, the median of the timed sweeps;
* the traced sweep's device busy time per image, the occupancy (busy over
  the untraced wall) and the ceiling it sets (sketches/s at 100% busy);
* the process's CPU (``process_time``, every thread) per image, as a share
  of one core and of ``os.cpu_count()`` cores;
* per key (``profile_pipeline.host_keys`` and the two waits below), CPU
  ms, wall ms and calls per image over the timed sweeps only, with the
  attributed total and what is left unattributed (launch glue, numpy,
  the interpreter, thread scheduling).

The JAX script wrapped ``jax.device_get``; the port's host waits are the
stage-end ``torch.cuda.Stream.synchronize`` (``runner.py`` ``_stage``) and
the read-back's ``torch.cuda.Event.synchronize`` (``ops/bits.py``
``readback``).  Both are called only on the card, and the read-back waits
run inside the ``*.wait`` keys, so neither counts in the attributed total
(their CPU is that of a thread spinning on the card).  Prints one JSON
line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import statistics
import tempfile
import time

import torch

from inklayer_tpu_torch.build import build_pipeline
from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.pipeline.runner import InkLayerPipeline
from inklayer_tpu_torch.profiling import (HostAccount, device_profile, emit,
                                          patches, sync,
                                          thread_clock_step_ms)
from inklayer_tpu_torch.runtime import compute_dtype, resolve_device
from inklayer_tpu_torch.scripts.profile_pipeline import (host_keys,
                                                         print_host,
                                                         sketch_png,
                                                         thread_kinds)

# the host's waits on the card: called only there, and left out of the
# attributed total
WAIT_KEYS = ("stream_sync", "readback_event_wait")


def sweep_keys(pipe, batch: int) -> list:
    return host_keys(pipe, batch=batch) + [
        (torch.cuda.Stream, "synchronize", "stream_sync", None),
        (torch.cuda.Event, "synchronize", "readback_event_wait", None)]


def analyze(pipe, paths, out: str, reps: int = 3, workers=None,
            batch: int = 1) -> dict:
    """The sweep of ``paths`` by ``pipe``: two warm sweeps, ``reps`` timed
    ones with every key timed, one traced sweep on the card."""
    n = len(paths)
    kw = dict(no_intermediate=True, inpaint=False, batch_size=batch,
              workers=workers)
    account = HostAccount()
    with patches(sweep_keys(pipe, batch), account):
        pipe.run_dir(paths, out, **kw)  # the kernel build, allocations
        pipe.run_dir(paths, out, **kw)  # steady caches
        account.reset()
        sync0 = pipe.sync_count
        walls, cpus = [], []
        for _ in range(reps):
            c0, t0 = time.process_time(), time.perf_counter()
            pipe.run_dir(paths, out, **kw)
            walls.append((time.perf_counter() - t0) * 1e3)
            cpus.append((time.process_time() - c0) * 1e3)
        # the timed sweeps only: the traced one would add to them
        host = account.table(per=n * reps, kind=thread_kinds(pipe))
        syncs = (pipe.sync_count - sync0) / (n * reps)
        trace = None
        if pipe.device.type == "cuda":
            trace = device_profile(
                lambda: (pipe.run_dir(paths, out, **kw), sync(pipe.device)),
                top=8)
    wall, cpu = statistics.median(walls), statistics.median(cpus)
    ncpu = os.cpu_count() or 1
    attributed = sum(h["cpu_ms"] for k, h in host.items()
                     if k not in WAIT_KEYS)
    busy = trace["busy_ms"] if trace else None
    return {
        "n": n, "reps": reps,
        "workers": workers or max(1, int(pipe.cfg.sweep_workers)),
        "batch": batch, "device_front": bool(pipe.cfg.device_front),
        "wall_ms_per_img": wall / n, "sketches_per_s": n / wall * 1e3,
        "busy_ms_per_img": None if trace is None else busy / n,
        "occupancy": None if trace is None else busy / wall,
        "ceiling_sketches_per_s": None if trace is None
        else n / busy * 1e3,
        "traced_wall_ms": None if trace is None else trace["wall_ms"],
        "traced_busy_ms": busy,
        "top_kernels": None if trace is None else trace["kernels"],
        "cpu_ms_per_img": cpu / n, "cpu_share_one_core": cpu / wall,
        "cpu_share_all_cores": cpu / (wall * ncpu), "cpu_count": ncpu,
        "syncs_per_img": syncs, "host": host,
        "thread_clock_step_ms": thread_clock_step_ms(),
        "attributed_cpu_ms_per_img": attributed,
        "unattributed_cpu_ms_per_img": cpu / n - attributed,
    }


def main(argv=None, pipe=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workers", type=int, default=None,
                    help="default: PipelineConfig.sweep_workers")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device-front", action="store_true",
                    help="PipelineConfig.device_front on")
    ap.add_argument("--img", default=None, help="a sketch (default: seeded)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if pipe is None:
        dev = resolve_device(args.device)
        cfg = dataclasses.replace(PipelineConfig(),
                                  device_front=args.device_front)
        pipe = build_pipeline(cfg, device=dev, dtype=compute_dtype(dev))
    elif pipe.cfg.device_front != args.device_front:
        pipe = InkLayerPipeline(pipe.detector, pipe.sam, pipe.depth,
                                dataclasses.replace(
                                    pipe.cfg,
                                    device_front=args.device_front))
    with tempfile.TemporaryDirectory(prefix="sweep_stalls_") as out:
        src = sketch_png(args.img, out)
        os.makedirs(os.path.join(out, "in"))
        paths = []
        for i in range(args.n):
            paths.append(os.path.join(out, "in", f"sketch_{i}.png"))
            shutil.copyfile(src, paths[-1])
        res = analyze(pipe, paths, out, args.reps, args.workers, args.batch)
    n = res["n"]
    print(f"sweep n={n} workers={res['workers']} batch={res['batch']} "
          f"device_front={res['device_front']}: "
          f"{res['wall_ms_per_img']:.1f} ms/img, "
          f"{res['sketches_per_s']:.3f} sketches/s [median of {args.reps}]")
    if res["busy_ms_per_img"] is not None:
        print(f"device busy {res['busy_ms_per_img']:.1f} ms/img -> "
              f"occupancy {res['occupancy']:.3f}, ceiling "
              f"{res['ceiling_sketches_per_s']:.3f} sketches/s")
    print(f"host CPU {res['cpu_ms_per_img']:.1f} ms/img = "
          f"{res['cpu_share_one_core']:.3f} of one core, "
          f"{res['cpu_share_all_cores']:.3f} of {res['cpu_count']}; "
          f"{res['syncs_per_img']:.2f} counted syncs/img")
    print(f"per key over the {args.reps} timed sweeps (the thread CPU clock "
          f"steps by {res['thread_clock_step_ms']:.3f} ms):")
    print_host(res["host"], "image")
    print(f"  attributed CPU {res['attributed_cpu_ms_per_img']:.1f} ms/img "
          f"(without {', '.join(WAIT_KEYS)}), unattributed "
          f"{res['unattributed_cpu_ms_per_img']:.1f}")
    for name, ms, calls in res["top_kernels"] or ():
        print(f"  {ms:9.3f} ms x{calls:5d}  {name[:100]}")
    return emit(res, pipe.device)


if __name__ == "__main__":
    main()
