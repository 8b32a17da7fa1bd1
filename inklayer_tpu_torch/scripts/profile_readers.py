"""Two readers of the card's busy time over one trace of the port's full
pipeline (``python -m inklayer_tpu_torch.bench``'s run, bf16, constant
weights, the seeded 750^2 sketch):

* the profiler's FunctionEvents (``prof.events()``, which builds a tree of
  every host event as well), and
* its raw Kineto results, as ``profiling.device_profile`` reads them.

For each of two traced runs it prints both readers' device event count,
busy ms and parse seconds, then one ``device_profile`` call end to end.

    python -m inklayer_tpu_torch.scripts.profile_readers      # on the card
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from inklayer_tpu_torch import bench
from inklayer_tpu_torch.build import build_pipeline
from inklayer_tpu_torch.config import PipelineConfig
from inklayer_tpu_torch.profiling import _union_us, device_profile


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    pipe = build_pipeline(PipelineConfig(), device="cuda",
                          dtype=torch.bfloat16)
    out = tempfile.mkdtemp(prefix="profile_readers_")
    src = os.path.join(out, "sketch.png")
    Image.fromarray(bench.seeded_sketch()).save(src)

    def run():
        bench._run(pipe, src, out)
        torch.cuda.synchronize()

    run()  # warm
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        t0 = time.perf_counter()
        raw = [(e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        t1 = time.perf_counter()
        fe = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == cuda]
        t2 = time.perf_counter()
        print(f"raw Kineto: {len(raw)} events, busy "
              f"{_union_us(raw) / 1e3:.3f} ms, parse {t1 - t0:.2f} s; "
              f"events(): {len(fe)} events, busy {_union_us(fe) / 1e3:.3f} "
              f"ms, parse {t2 - t1:.2f} s")
    t0 = time.perf_counter()
    res = device_profile(run)
    print(f"device_profile: {time.perf_counter() - t0:.2f} s in all, busy "
          f"{res['busy_ms']:.3f} ms, {res['device_ops']} device ops, wall "
          f"{res['wall_ms']:.1f} ms")


if __name__ == "__main__":
    main()
