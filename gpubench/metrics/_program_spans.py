"""The program's own spans (``inklayer_tpu_torch.spans``) in the traced
sub-window, shared by the readers of the metrics that read them.

:func:`records` calls ``spans.take()`` once per run and caches, on the
reader's context, the records that lie inside the final trace's
``gpubench/request`` spans and were opened on this (the harness's) thread:
the records of discarded retakes fall outside them.  A program without
that module, or whose spans recorded nothing there, gives no record, and
the readers then give no reading.

Times here are in microseconds on the host clock of the trace
(``time.time_ns`` is the profiler's host clock).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class Span:
    name: str
    id: int
    parent: int
    start_us: float
    end_us: float
    counts: Dict[str, int]


def requests_us(trace) -> List[Tuple[float, float]]:
    """The traced requests' host intervals, in order."""
    return sorted((s0, s1) for name, s0, s1 in trace.spans
                  if name == "request")


def inside(spans: list, requests: List[Tuple[float, float]],
           thread: Optional[int] = None) -> List[Span]:
    """The records (``spans.Record``) of ``thread`` that lie inside one of
    ``requests``, as :class:`Span` in microseconds."""
    out = []
    for r in spans:
        if thread is not None and r.thread != thread:
            continue
        s, e = r.start_ns / 1e3, r.end_ns / 1e3
        if any(r0 <= s and e <= r1 for r0, r1 in requests):
            out.append(Span(r.name, r.id, r.parent, s, e, dict(r.counts)))
    return out


def records(ctx) -> List[Span]:
    """The program's spans of the final traced requests (cached on
    ``ctx``)."""
    cached = getattr(ctx, "program_spans", None)
    if cached is not None:
        return cached
    found: List[Span] = []
    if ctx.trace is not None:
        try:
            from inklayer_tpu_torch import spans
        except ImportError:
            spans = None
        if spans is not None:
            found = inside(spans.take(), requests_us(ctx.trace),
                           threading.get_ident())
    ctx.program_spans = found
    return found


def union(intervals) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering ``intervals``."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a, b) -> List[Tuple[float, float]]:
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> List[Tuple[float, float]]:
    """``a`` less ``b``: sorted, disjoint interval lists."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out
