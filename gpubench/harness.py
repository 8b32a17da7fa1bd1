"""One run of one cell: set-up, the measured window, the traced sub-window,
the metrics and the check against the reference.

The order is fixed:

1. set-up: the entry builds the system under test from the seed (weights
   made on the device) and sends the traffic's warm-up requests, which use
   every shape the window uses;
2. the window: one client sends request after request (a closed loop) for
   ``seconds``; a request is timed from its submission until its outputs
   are on the host; no request starts after the window's end;
3. with ``trace``: a traced sub-window of ``trace_requests`` more
   requests (:mod:`gpubench.trace`); the per-layer metrics read it;
4. the peak of device memory is read; the entry's ``follow``, where it
   has one, records on the same system what the check follows of the
   program's own state for the window's sampled requests (drawn from the
   seed by reservoir sampling over every completed request), outside the
   window; the system is freed, and the entry checks the sample against
   the reference.

The traffic's ``host_threads``, where given, sets the process's intra-op
threads: one client with few threads keeps the host's share steady.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from gpubench.manifest import Cell, Manifest
from gpubench.traffic import Traffic


def process_start_s() -> float:
    """This process's start on the ``time.time()`` clock (from
    ``/proc/self/stat`` and the boot time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])  # starttime, field 22
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Window:
    """What the measured window recorded."""

    seconds: float                 # the window's length as asked
    start: float                   # perf_counter at its start
    latencies_s: List[float] = field(default_factory=list)  # completed
    last_done: Optional[float] = None  # perf_counter of the last completion
    attempted: int = 0
    completed: int = 0
    units_done: int = 0            # units completed: the outputs' count

    @property
    def elapsed_s(self) -> float:
        """From the window's start to its last completion."""
        return (self.last_done - self.start) if self.last_done else 0.0


@dataclass
class Context:
    """What a metric's reader reads."""

    manifest: Manifest
    cell: Cell
    entry: object
    seed: int
    setup_s: float
    window: Window
    trace: object = None           # gpubench.trace.Trace, with --trace 1
    trace_requests: int = 0
    trace_units: int = 0
    card: dict = field(default_factory=dict)
    system: object = None          # the entry's system under test


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed % (1 << 63), 7])
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(call: Callable, traffic: Traffic, seconds: float,
               sample: Reservoir, first_request: int = 0) -> Window:
    """The closed loop: ``call(items)`` returns host outputs, one per unit
    of work (a sketch, a layer)."""
    win = Window(seconds=seconds, start=time.perf_counter())
    end = win.start + seconds
    r = first_request
    while True:
        t_sub = time.perf_counter()
        if t_sub >= end:
            break
        sketches = traffic.request(r)
        win.attempted += 1
        out = call(sketches)
        t_done = time.perf_counter()
        if t_done <= end:
            win.completed += 1
            win.units_done += len(out)
            win.latencies_s.append(t_done - t_sub)
            win.last_done = t_done
            sample.offer((r, out))
        r += 1
    return win


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(manifest: Manifest, cell: Cell, seed: int, seconds: float,
             trace: bool, device: torch.device, t_process: float,
             card: Optional[dict] = None) -> dict:
    """One run; returns the result's fields (the caller prints them)."""
    entry = manifest.entry(cell)
    mix = cell.traffic
    if "host_threads" in mix:
        torch.set_num_threads(int(mix["host_threads"]))
    traffic = Traffic(mix, seed)
    system = entry.build(cell, seed, device, traffic)
    for r in range(int(mix["warmup"])):
        entry.call(system, traffic.warmup(r))
    sync(device)
    setup_s = time.time() - t_process
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample = Reservoir(int(mix["check"]["requests"]), seed)
    win = run_window(lambda s: entry.call(system, s), traffic, seconds,
                     sample)
    ctx = Context(manifest=manifest, cell=cell, entry=entry, seed=seed,
                  setup_s=setup_s, window=win, card=card or {},
                  system=system)
    result_trace = None
    if trace:
        from gpubench import trace as tracing
        from inklayer_tpu_torch import _kernels

        n = int(mix["trace_requests"])
        first = win.attempted
        units = []

        def traced():
            units.clear()
            for r in range(first, first + n):
                units.append(len(entry.call(system, traffic.request(r))))
            sync(device)

        result_trace = tracing.trace(traced, _kernels.launch_counts)
        ctx.trace, ctx.trace_requests = result_trace, n
        ctx.trace_units = sum(units)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if hasattr(entry, "follow"):
        entry.follow(system, sample.items, traffic)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"]).read(ctx, m)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del system, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.judge(cell, seed, sample.items, traffic, device)
    result = {
        "correct": bool(win.completed) and all(
            c["value"] <= c["limit"] for c in checks.values()),
        "attempted": win.attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(peak)},
        "checks": checks,
    }
    if result_trace is not None:
        result["device"]["busy_s"] = result_trace.busy_s
        result["device"]["window_s"] = result_trace.window_s
        result["breakdown"] = {"device_ops": result_trace.top_ops(),
                               "idle_gaps": result_trace.idle_gaps()}
    return result
