#!/usr/bin/env python3
"""How whole ``torch.profiler`` traces of the card are, over a process's
life: one short traced call every 34 s, each held against what it
launched.

    python3 scripts/torch_trace_probe.py

``TRACES`` traces, one every ``EVERY_S`` s (~15 min).  Each opens, waits
``MARGIN_S`` s, launches ``LAUNCHES`` bf16 2048^2 matmuls, synchronises
the card, waits ``MARGIN_S`` s and closes.  From its raw Kineto results
it reads the kernels the card ran (against the launches made) and, for
each kernel, the lag of its start behind its
launch's start (the host's ``*LaunchKernel*`` call of the same
correlation id), on the profiler's clock.  A kernel cannot start before
its launch: a negative lag means the card's timestamps and the host's
disagree in that trace.

Prints one line per trace (the time since the start, the kernels
recorded of those launched, the lag's minimum and median in ms) and a JSON
object last, with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

TRACES = 27
EVERY_S = 34.0  # from one trace's start to the next
MARGIN_S = 2.0
LAUNCHES = 50


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def probe(x: torch.Tensor, launches: int, margin: float) -> dict:
    """{'kernels': recorded, 'lag_min_ms', 'lag_median_ms'} of one trace."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        for _ in range(launches):
            x @ x
        torch.cuda.synchronize()
        time.sleep(margin)
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != cuda and "LaunchKernel" in e.name()}
    kernels = [e for e in events if e.device_type() == cuda]
    lags = [(e.start_ns() - launch[e.correlation_id()]) / 1e6
            for e in kernels if e.correlation_id() in launch]
    return {"kernels": len(kernels),
            "lag_min_ms": min(lags) if lags else None,
            "lag_median_ms": statistics.median(lags) if lags else None}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_probe: needs a CUDA card")
    x = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    x @ x
    torch.cuda.synchronize()
    t0, rows = time.perf_counter(), []
    for i in range(TRACES):
        start = time.perf_counter()
        row = {"t_s": start - t0, **probe(x, LAUNCHES, MARGIN_S)}
        rows.append(row)
        print(f"t {row['t_s']:7.1f} s: {row['kernels']} of {LAUNCHES} "
              f"kernels recorded, lag ms min {row['lag_min_ms']} median "
              f"{row['lag_median_ms']}", flush=True)
        if i + 1 < TRACES:
            time.sleep(max(0.0, EVERY_S - (time.perf_counter() - start)))
    res = {"launches": LAUNCHES, "margin_s": MARGIN_S, "traces": rows,
           "incomplete": sum(r["kernels"] != LAUNCHES for r in rows),
           "card": card()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
