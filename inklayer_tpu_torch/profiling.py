"""Device time of one call, from a ``torch.profiler`` trace.

``device_profile(fn)`` runs ``fn()`` once with CPU and CUDA activity
tracing and returns the wall time, the time the card was busy (the union
of its kernel and copy intervals), the idle share of the wall time, and the
kernels that took the most device time.  The profiler's own overhead
inflates the wall time a little; take latencies from untraced runs and
shares from this one.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile


def _union_us(intervals) -> float:
    busy, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (end - start if end is not None else 0.0)


def device_profile(fn, top: int = 10) -> dict:
    """{'wall_ms', 'busy_ms', 'idle_share', 'device_ops', 'kernels':
    [(name, ms, calls)]} for one traced call of ``fn`` (which must
    synchronise the card before it returns); ``device_ops`` counts the
    kernels and copies the card ran."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _union_us((e.time_range.start, e.time_range.end) for e in events)
    per_name: dict = {}
    for e in events:
        ms, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                            calls + 1)
    kernels = sorted(((n, ms, c) for n, (ms, c) in per_name.items()),
                     key=lambda r: -r[1])[:top]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_ops": len(events),
            "kernels": kernels}
