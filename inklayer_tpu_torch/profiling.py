"""Device time of one call, from a ``torch.profiler`` trace, and the
card's identity.

``device_profile(fn)`` runs ``fn()`` once with CPU and CUDA activity
tracing and returns the wall time, the time the card was busy (the union
of its kernel and copy intervals), the idle share of the wall time, and the
kernels that took the most device time.  The profiler's own overhead
inflates the wall time a little; take latencies from untraced runs and
shares from this one.  A trace without device activity raises
:class:`NoDeviceActivity`: a busy time read from host threads would hide
the card.

``card_info(device)`` gives the card's name and power limit as
``nvidia-smi`` reports them, which every number measured on the card is
written beside.
"""

from __future__ import annotations

import platform
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


class NoDeviceActivity(RuntimeError):
    """The profiler recorded no kernel or copy on the card."""


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
    kernels and copies the card ran.  The device events are read from the
    profiler's raw Kineto results: ``prof.events()`` builds a tree of every
    host event too, which takes tens of seconds for a traced pipeline run
    and is not needed for device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    if not events:
        raise NoDeviceActivity("the profiler recorded no device activity")
    busy = _union_us((start, end) for _, start, end in events)
    per_name: dict = {}
    for name, start, end in events:
        ms, calls = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + (end - start) / 1e3, calls + 1)
    kernels = sorted(((n, ms, c) for n, (ms, c) in per_name.items()),
                     key=lambda r: -r[1])[:top]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_ops": len(events),
            "kernels": kernels}


def cpu_model(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The host CPU's model name: ``cpuinfo``'s model line (x86's 'model
    name', or an Arm host's 'Model name' / 'Hardware'); where the host
    hides it ('unknown'), its vendor, family and model numbers; else the
    machine's architecture."""
    found = {}
    try:
        with open(cpuinfo) as f:
            for line in f:  # the first processor's values
                key, sep, value = line.partition(":")
                if sep:
                    found.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    for key in ("model name", "Model name", "Hardware"):
        if found.get(key) not in (None, "", "unknown"):
            return found[key]
    if all(found.get(k) for k in ("vendor_id", "cpu family", "model")):
        return (f"{found['vendor_id']} family {found['cpu family']} "
                f"model {found['model']}")
    return platform.machine()


def card_info(device: torch.device):
    """(name, power limit in W) of the card as nvidia-smi reports them;
    on the CPU (the CPU's model, None)."""
    if device.type != "cuda":
        return cpu_model(), None
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        name, power = res.stdout.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(power.strip().split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(device), None
