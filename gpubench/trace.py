"""The traced sub-window: device events from ``torch.profiler``, held to
the program's launch counters, attributed to the harness's spans.

A trace may lose device events (on the H100 a fresh process once recorded
33 of 50 kernels), so the trace must hold, for each of the port's kernel
names in :data:`PORT_KERNEL_EVENTS`, exactly as many kernels as the port's
launch counters (``inklayer_tpu_torch._kernels.launch_counts``) say the
traced calls launched; an incomplete trace is taken again, up to
:data:`ATTEMPTS` times, and then the run fails.  The profiler keeps only
device events inside its window, so the window stays open
:data:`MARGIN_S` before and after the traced calls.

Spans are ``torch.profiler.record_function`` ranges the entry opens around
its calls into each layer (``gpubench/<layer>``).  A device event belongs
to the span in which the host launched it: its runtime launch event (the
same correlation id) started inside the span on the host's clock.
"""

from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

# (kernel-name pattern, {launch counter: kernels of that name per launch})
PORT_KERNEL_EVENTS = (
    (r"::attention_tile_kernel<", {"relpos_attention": 1,
                                   "flash_attention": 1}),
    (r"::gemm_bias_act_kernel<", {"mlp_gelu": 2}),  # fc1, fc2
    (r"::layernorm_kernel<", {"layernorm": 1}),
    (r"::ms_deform_attn_kernel<", {"ms_deform_attn": 1}),
    (r"::cc_local\b", {"connected_components": 1, "clean_components": 1}),
    (r"::cc_keep\b", {"clean_components": 1}),
    (r"::conv3x3_kernel<", {"conv3x3": 1}),
)
_PATTERNS = tuple((re.compile(p), per) for p, per in PORT_KERNEL_EVENTS)
ATTEMPTS = 3
MARGIN_S = 0.1
SPAN_PREFIX = "gpubench/"


class IncompleteTrace(RuntimeError):
    """A trace recorded another number of the port's kernels than the
    traced calls launched, or no device event at all."""


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float
    span: Optional[str]  # the harness span it was launched in, or None

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Trace:
    """What one traced sub-window recorded."""

    window_s: float          # host wall time of the traced calls
    events: List[DeviceEvent]
    spans: List[Tuple[str, float, float]]  # (name, start_us, end_us)
    launched: Dict[str, int]  # the port's launch counters, traced calls
    retraced: List[str] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_us((e.start_us, e.end_us) for e in self.events) / 1e6

    def kernel_us(self, pattern: str) -> Tuple[float, int]:
        """(summed device time in us, count) of events matching
        ``pattern``."""
        rx = re.compile(pattern)
        hits = [e.us for e in self.events if rx.search(e.name)]
        return sum(hits), len(hits)

    def span_us(self, span: str) -> float:
        """Summed device time of the events launched inside ``span``."""
        return sum(e.us for e in self.events if e.span == span)

    def top_ops(self, n: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for e in self.events:
            per[e.name] = per.get(e.name, 0.0) + e.us
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps between device activity inside the traced
        calls, each named by the innermost harness span open on the host
        at the gap's start (``host`` outside every span)."""
        ivs = sorted((e.start_us, e.end_us) for e in self.events)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        named = []
        for g0, g1 in gaps:
            inner = [(s1 - s0, name) for name, s0, s1 in self.spans
                     if s0 <= g0 < s1]
            label = min(inner)[1] if inner else "host"
            named.append([label, (g1 - g0) / 1e6])
        return sorted(named, key=lambda x: -x[1])[:n]


def union_us(intervals) -> float:
    busy, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (end - start if end is not None else 0.0)


def check_port_events(events: List[DeviceEvent],
                      launched: Dict[str, int]) -> None:
    """Raise :class:`IncompleteTrace` unless the traced kernels hold, per
    pattern of :data:`PORT_KERNEL_EVENTS`, the kernels ``launched`` says
    ran."""
    if not events:
        raise IncompleteTrace("the profiler recorded no device activity")
    wrong = []
    for rx, per_launch in _PATTERNS:
        want = sum(launched.get(k, 0) * n for k, n in per_launch.items())
        got = sum(1 for e in events if rx.search(e.name))
        if got != want:
            wrong.append(f"{rx.pattern} {got} traced, {want} launched")
    if wrong:
        raise IncompleteTrace("; ".join(wrong))


def _events(prof) -> Tuple[List[DeviceEvent], List[Tuple[str, float, float]]]:
    cuda = torch.autograd.DeviceType.CUDA
    raw = list(prof.profiler.kineto_results.events())
    spans, launches = [], {}
    for e in raw:
        if e.device_type() == cuda:
            continue
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], e.start_ns() / 1e3,
                          e.end_ns() / 1e3))
        elif name.startswith("cuda") or name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns() / 1e3
    events = []
    for e in raw:
        # the spans' own ranges on the device's timeline are no work
        if e.device_type() != cuda or e.name().startswith(SPAN_PREFIX):
            continue
        t_launch = launches.get(e.correlation_id())
        if t_launch is None:
            t_launch = launches.get(e.linked_correlation_id())
        span = None
        if t_launch is not None:
            inner = [(s1 - s0, n) for n, s0, s1 in spans
                     if s0 <= t_launch < s1]
            span = min(inner)[1] if inner else None
        events.append(DeviceEvent(e.name(), e.start_ns() / 1e3,
                                  e.end_ns() / 1e3, span))
    return events, spans


def trace(call: Callable[[], None], launch_counts: Callable[[], dict]
          ) -> Trace:
    """Trace ``call()`` (which must end with the device idle), held to the
    launch counters and retaken when incomplete."""
    from torch.profiler import ProfilerActivity, profile

    retraced = []
    for attempt in range(1, ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(MARGIN_S)
            before = launch_counts()
            t0 = time.perf_counter()
            call()
            window_s = time.perf_counter() - t0
            after = launch_counts()
            time.sleep(MARGIN_S)
        launched = {k: v - before.get(k, 0) for k, v in after.items()}
        events, spans = _events(prof)
        try:
            check_port_events(events, launched)
        except IncompleteTrace as e:
            if attempt == ATTEMPTS:
                raise
            retraced.append(str(e))
            print(f"[gpubench] trace {attempt} of {ATTEMPTS} discarded: {e}",
                  file=sys.stderr, flush=True)
            continue
        return Trace(window_s=window_s, events=events, spans=spans,
                     launched=launched, retraced=retraced)
    raise AssertionError("unreachable")
