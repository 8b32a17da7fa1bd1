"""The port's spans on the card: what they cost, the card clock's offset
from the host's, and where the card idles.

    python3 scripts/torch_span_report.py [--seed N] [--requests 3]
        [--reps 6] [--out span_report.json]

It builds the system of the benchmark cell ``default.models-b4``
(``gpubench``'s ``models`` entry: GroundingDINO, SAM ViT-H and
Depth-Anything-V2 at the published widths, seeded weights, groups of 4
sketches), warms it up, and prints one JSON line:

* ``off_ns_per_span``: a span's cost with no profiler (``with span(...)``
  less an empty loop, best of 5 runs of 200,000), on this host's CPU;
* ``on``: host ms per request under ``torch.profiler`` (CPU and CUDA
  activity), with the program's spans and with them patched out (the
  spans' profiler flag held False), ``--reps`` requests each, in turns;
* ``traced``: ``--requests`` requests traced as the cell traces them
  (``gpubench.trace``): the card clock's offset that ``idle_ms`` finds, the
  idle ms a sketch by layer and by the innermost program span open on
  the host, each span's host self ms and counts a request, the ten longest idle
  gaps, each with the innermost program span open on the host at its
  start (``breakdown.idle_gaps`` names only the harness's spans), and each
  ``wait`` span's distance from the last copy to the host before its end.

Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import timeit
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from gpubench import trace as tracing  # noqa: E402
from gpubench.manifest import Manifest  # noqa: E402
from gpubench.metrics import (_program_spans, decode_fill,  # noqa: E402
                              idle_ms)
from gpubench.run import card_info  # noqa: E402
from gpubench.traffic import Traffic  # noqa: E402
from inklayer_tpu_torch import _kernels, spans  # noqa: E402

CELL = "default.models-b4"


def off_ns_per_span(n: int = 200_000) -> float:
    g = {"span": spans.span}
    with_span = min(timeit.repeat("with span('x'): pass", globals=g,
                                  number=n, repeat=5))
    empty = min(timeit.repeat("pass", number=n, repeat=5))
    return (with_span - empty) / n * 1e9


class spans_patched_out:
    """While open, the program's spans see no profiler."""

    def __enter__(self):
        self.flag = spans._autograd_profiler
        spans._autograd_profiler = SimpleNamespace(_is_profiler_enabled=False)

    def __exit__(self, *exc):
        spans._autograd_profiler = self.flag


def on_cost(call, reps: int) -> dict:
    """Host ms per request under the profiler, spans on and patched out,
    in turns (on, off, off, on, ...)."""
    from torch.profiler import ProfilerActivity, profile

    ms = {"spans": [], "patched_out": []}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for i in range(reps):
            for side in (("spans", "patched_out") if i % 2 == 0
                         else ("patched_out", "spans")):
                t0 = time.perf_counter()
                if side == "spans":
                    call()
                else:
                    with spans_patched_out():
                        call()
                ms[side].append((time.perf_counter() - t0) * 1e3)
    spans.take()
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {"ms": ms, "median_ms": med,
            "cost_ms": med["spans"] - med["patched_out"]}


def innermost(recs, t_us: float):
    open_ = [s for s in recs if s.start_us <= t_us < s.end_us]
    return min(open_, key=lambda s: s.end_us - s.start_us).name \
        if open_ else "host"


def wait_residuals(events, recs, shift: float) -> list:
    """Per ``wait`` span: its parent, how long it waited (ms), and its end
    less the end of the last device-to-host copy before it on the
    corrected card clock (ms), with whether a device event started in
    between."""
    copies = sorted(e - shift for name, _, e in events
                    if idle_ms.COPY_TO_HOST.search(name))
    starts = sorted(s - shift for _, s, _ in events)
    by_id = {s.id: s for s in recs}
    out = []
    for w in recs:
        if w.name != "wait":
            continue
        before = [c for c in copies if c <= w.end_us + idle_ms.SLACK_US]
        c = before[-1] if before else None
        out.append({
            "in": by_id[w.parent].name if w.parent in by_id else None,
            "wait_ms": (w.end_us - w.start_us) / 1e3,
            "after_copy_ms": None if c is None else (w.end_us - c) / 1e3,
            "card_started_between": c is not None and any(
                c < s <= w.end_us for s in starts)})
    return out


def traced(call, n: int, sketches) -> dict:
    """``n`` requests made by ``call()``, traced; ``sketches()`` counts
    their sketches afterwards."""
    t = tracing.trace(call, _kernels.launch_counts)
    units = sketches()
    raw = spans.take()
    recs = _program_spans.inside(raw, _program_spans.requests_us(t))
    events = [(e.name, e.start_us, e.end_us) for e in t.events]
    parts, total, offset = idle_ms.idle_by_layer(
        events, recs, _program_spans.requests_us(t))
    shift = offset if offset is not None and \
        abs(offset) > idle_ms.TOLERANCE_US else 0.0
    busy = _program_spans.union((s - shift, e - shift) for _, s, e in events)
    gaps = _program_spans.subtract(
        _program_spans.union(_program_spans.requests_us(t)), busy)
    harness = t.spans
    by_span: dict = {}
    for g0, g1 in gaps:  # each idle stretch split at the span boundaries
        cuts = sorted({g0, g1} | {x for r in recs for x in (r.start_us,
                                                             r.end_us)
                                  if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            name = innermost(recs, a)
            by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e3 / units
    longest = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = [(s1 - s0, name) for name, s0, s1 in harness
                 if s0 <= g0 < s1]
        longest.append({"ms": (g1 - g0) / 1e3,
                        "program_span": innermost(recs, g0),
                        "harness_span": min(inner)[1] if inner else "host"})
    kept, own = {s.id for s in recs}, spans.self_ns(raw)
    self_ms: dict = {}
    counts: dict = {}
    for r in raw:
        if r.id in kept:
            self_ms[r.name] = self_ms.get(r.name, 0.0) + own[r.id] / 1e6 / n
            per = counts.setdefault(r.name, {})
            for k, v in r.counts.items():
                per[k] = per.get(k, 0) + v / n
    return {"requests": n, "sketches": units, "retraced": t.retraced,
            "clock_offset_ms": None if offset is None else offset / 1e3,
            "idle_ms_per_sketch": None if parts is None else
            {k: v / 1e3 / units for k, v in parts.items()},
            "idle_ms_total": None if total is None else total / 1e3,
            "busy_s": t.busy_s, "window_s": t.window_s,
            "longest_gaps": longest,
            "idle_ms_per_sketch_by_innermost_span": dict(sorted(
                by_span.items(), key=lambda kv: -kv[1])),
            "waits": wait_residuals(events, recs, shift),
            "self_ms_per_request": dict(sorted(self_ms.items(),
                                               key=lambda kv: -kv[1])),
            "counts_per_request": {k: v for k, v in counts.items() if v},
            "decode_fill": decode_fill.read(
                SimpleNamespace(trace=t, program_spans=recs), {})}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2147483999)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_span_report: needs a CUDA card")
    dev = torch.device("cuda", 0)
    m = Manifest()
    cell = m.cell(CELL)
    entry = m.entry(cell)
    torch.set_num_threads(int(cell.traffic.get("host_threads",
                                               torch.get_num_threads())))
    traffic = Traffic(cell.traffic, args.seed)
    system = entry.build(cell, args.seed, dev, traffic)
    for r in range(int(cell.traffic["warmup"])):
        entry.call(system, traffic.warmup(r))
    torch.cuda.synchronize()
    nxt = iter(range(10_000))

    def one():
        entry.call(system, traffic.request(next(nxt)))
        torch.cuda.synchronize()

    res = {"card": card_info(), "seed": args.seed,
           "off_ns_per_span": off_ns_per_span(),
           "on": on_cost(one, args.reps)}
    units = []

    def group():
        units.clear()
        for _ in range(args.requests):
            units.append(len(entry.call(system,
                                        traffic.request(next(nxt)))))
        torch.cuda.synchronize()

    res["traced"] = traced(group, args.requests, lambda: sum(units))
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
