"""``idle_ms.<layer>.<cell>``: card-idle ms per sketch in the traced
sub-window that fell while the host was inside the program's ``<layer>``
(``detect``; ``segment``: ``segment.encode`` and ``segment.decode``;
``depth``), from the program's own spans (``inklayer_tpu_torch.spans``).

The idle time is the part of the traced requests (the union of the
``gpubench/request`` spans) in which no device event ran.  Each idle
stretch is split at the program's span boundaries, and each part goes to
the outermost layer span open on the host then, or to no layer; the three
layers and the rest sum to the idle time.

Idle time lies on the card's clock and spans on the host's, so the two
clocks are checked first, at the program's ``wait`` spans.  A wait on the
card returns just after the card finished what it waited for, the last of
which is a copy to the host (a ``.cpu()`` read, or a read-back's pinned
copy), so a wait's end lies on the card's clock within :data:`WAKE_US`
after a device-to-host copy ends and before the next device event starts.
The offset at which most waits (at least :data:`MIN_SUPPORT` of them) meet
that rule is the card clock's offset from the host's; where it is more
than :data:`TOLERANCE_US`, the device events are shifted back by it and
stderr says so; where no offset meets the rule, there is no reading and
stderr says why.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from gpubench.metrics._program_spans import (intersect, length, records,
                                             requests_us, subtract, union)

LAYERS = ("detect", "segment", "depth")
COPY_TO_HOST = re.compile(r"DtoH|Device -> (Pageable|Pinned)")
WAKE_US = 2000.0       # a wait's end after its last copy ends
SLACK_US = 50.0        # and the least it may seem to come before it
TOLERANCE_US = 500.0   # offsets up to this are left as they are
SEARCH_US = 100_000.0  # offsets searched, either way
MIN_SUPPORT = 1 / 3    # share of the waits that must meet the rule


def layer_of(name: str) -> Optional[str]:
    head = name.split(".", 1)[0]
    return head if head in LAYERS else None


def layer_intervals(spans) -> Dict[str, List[Tuple[float, float]]]:
    """{layer: the host intervals of its outermost spans}: spans of a
    layer with no layer span among their ancestors."""
    by_id = {s.id: s for s in spans}
    out: Dict[str, list] = {layer: [] for layer in LAYERS}
    for s in spans:
        layer = layer_of(s.name)
        if layer is None:
            continue
        p, nested = by_id.get(s.parent), False
        while p is not None:
            if layer_of(p.name) is not None:
                nested = True
                break
            p = by_id.get(p.parent)
        if not nested:
            out[layer].append((s.start_us, s.end_us))
    return {k: union(v) for k, v in out.items()}


def clock_offset_us(events, waits) -> Tuple[Optional[float], int]:
    """(the card clock's offset from the host's in us, the number of waits
    that meet the rule at it); (None, best number) where fewer than
    :data:`MIN_SUPPORT` of the waits meet it at any offset.  ``events``:
    (name, start_us, end_us) on the card's clock; ``waits``: (start_us,
    end_us) on the host's."""
    if not waits:
        return None, 0
    busy = union((s, e) for _, s, e in events)
    starts = np.asarray([s for s, _ in busy])
    stops = np.asarray([e for _, e in busy])
    copies = np.sort(np.asarray([e for name, _, e in events
                                 if COPY_TO_HOST.search(name)]))
    ends = np.asarray([w1 for _, w1 in waits])
    if not len(copies):
        return None, 0

    def met(offset: float) -> np.ndarray:
        x = ends + offset  # the waits' ends on the card's clock
        i = np.searchsorted(copies, x + SLACK_US, side="right") - 1
        c = copies[np.maximum(i, 0)]
        near = (i >= 0) & (x - c <= WAKE_US)
        # the card idle from the copy's end until x: the busy stretch that
        # holds the copy is the last to start before x, and it has ended
        k = np.searchsorted(starts, c, side="right") - 1
        j = np.searchsorted(starts, x + SLACK_US, side="right") - 1
        return near & (j == k) & (stops[np.maximum(k, 0)] <= x + SLACK_US)

    step = WAKE_US / 2
    grid = np.arange(-SEARCH_US, SEARCH_US + step, step)
    scores = np.asarray([met(o).sum() for o in grid])
    best = scores.max()
    if best < max(1, MIN_SUPPORT * len(waits)):
        return None, int(best)
    offset = grid[scores == best][np.argmin(np.abs(grid[scores == best]))]
    # a wait ends after its copy on any clock: the offset is at least each
    # matched wait's copy end less its end, and the largest of these is
    # the wait that woke soonest
    ok = met(offset)
    x = ends[ok] + offset
    i = np.searchsorted(copies, x + SLACK_US, side="right") - 1
    return float(np.max(copies[i] - ends[ok])), int(ok.sum())


def idle_by_layer(events, spans, requests) -> Tuple[Dict[str, float],
                                                    float, Optional[float]]:
    """({layer: idle us, and "other"}, total idle us, the card clock's
    offset found); the first two None where the clocks do not match."""
    waits = [(s.start_us, s.end_us) for s in spans if s.name == "wait"]
    offset, n = clock_offset_us(events, waits)
    if offset is None:
        print(f"[idle_ms] no reading: {n} of {len(waits)} waits meet the "
              "card-clock rule at any offset within "
              f"{SEARCH_US / 1e3:.0f} ms", file=sys.stderr)
        return None, None, None
    shift = offset if abs(offset) > TOLERANCE_US else 0.0
    print(f"[idle_ms] card clock offset {offset / 1e3:+.4f} ms from the "
          f"host's ({n} of {len(waits)} waits): device events "
          + ("shifted back" if shift else "left as they are"),
          file=sys.stderr)
    reqs = union(requests)
    busy = union((s - shift, e - shift) for _, s, e in events)
    idle = subtract(reqs, busy)
    total = length(idle)
    parts, rest = {}, idle
    for layer, ivs in layer_intervals(spans).items():
        parts[layer] = length(intersect(idle, ivs))
        rest = subtract(rest, ivs)
    parts["other"] = length(rest)
    return parts, total, offset


def read(ctx, metric):
    t = ctx.trace
    if t is None or not ctx.trace_units:
        return None
    cached = getattr(ctx, "program_idle", None)
    if cached is None:
        spans = records(ctx)
        if not spans:
            cached = ({}, None)
        else:
            events = [(e.name, e.start_us, e.end_us) for e in t.events]
            parts, _, offset = idle_by_layer(events, spans, requests_us(t))
            cached = (parts or {}, offset)
        ctx.program_idle = cached
    us = cached[0].get(metric["name"].split(".")[1])
    return None if us is None else us / 1e3 / ctx.trace_units
