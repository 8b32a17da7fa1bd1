"""The program's spans in a traced request of ``default.models-b4`` on the
card (marked ``gpu``; skips without one): every span lies inside the
request's ``gpubench/request`` span, and none reaches the device's
timeline."""

import pytest
import torch

from gpubench import trace as tracing
from gpubench.manifest import Manifest
from gpubench.metrics import _program_spans
from gpubench.traffic import Traffic

SEED = 2147483999


@pytest.mark.gpu
def test_program_spans_lie_inside_the_request(card):
    from inklayer_tpu_torch import _kernels, spans

    m = Manifest()
    cell = m.cell("default.models-b4")
    entry = m.entry(cell)
    traffic = Traffic(cell.traffic, SEED)
    system = entry.build(cell, SEED, card, traffic)
    entry.call(system, traffic.warmup(0))
    torch.cuda.synchronize()
    spans.take()

    def one():
        entry.call(system, traffic.request(0))
        torch.cuda.synchronize()

    t = tracing.trace(one, _kernels.launch_counts)
    recs = spans.take()
    requests = _program_spans.requests_us(t)
    assert len(requests) == 1
    inside = _program_spans.inside(recs, requests)
    # each attempt records the same spans; the discarded ones lie outside
    assert len(inside) * (1 + len(t.retraced)) == len(recs)
    names = {s.name for s in inside}
    assert {"upload", "detect", "segment.encode", "segment.decode", "depth",
            "wait"} <= names
    assert not [e.name for e in t.events if e.name.startswith(spans.PREFIX)]
