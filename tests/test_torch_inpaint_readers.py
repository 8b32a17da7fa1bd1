"""The inpainting cell's readers (``gpubench/metrics/loop_idle_ms.py``,
``glue_idle_ms.py``, ``step_device_ms.py``, ``bucket_fill.py`` and their
shared ``_inpaint_idle.py``) on synthetic traces and span records."""

import threading
from types import SimpleNamespace

import pytest

from gpubench.manifest import Manifest
from gpubench.metrics import (bucket_fill, glue_idle_ms, loop_idle_ms,
                              step_device_ms)
from gpubench.trace import DeviceEvent, Trace
from inklayer_tpu_torch import spans

T0 = 1.7e15  # us: an epoch time, as the profiler's clock gives
REQUEST_AT = (0.0, 23_700.0, 51_300.0)  # us after T0: not periodic

# one 10 ms request: (name, parent name, start, end, counts), us
HOST = [
    ("inpaint.assemble", None, 0, 3000, {}),
    ("inpaint.inpaint", None, 3000, 9500, {"layers": 3}),
    ("inpaint.prepost", "inpaint.inpaint", 3000, 3500, {}),
    ("wait", "inpaint.inpaint", 3500, 3600, {}),
    ("inpaint.encode", "inpaint.inpaint", 3600, 4200, {}),
    ("wait", "inpaint.encode", 4100, 4200, {}),
    ("inpaint.loop", "inpaint.inpaint", 4200, 7200,
     {"layers": 3, "slots": 4}),
    ("inpaint.step", "inpaint.loop", 4200, 4700, {"samples": 8}),
    ("inpaint.step", "inpaint.loop", 4700, 5200, {"samples": 8}),
    ("inpaint.step", "inpaint.loop", 5200, 5700, {"samples": 8}),
    ("wait", "inpaint.loop", 5700, 7200, {}),
    ("inpaint.decode", "inpaint.inpaint", 7200, 7800, {}),
    ("wait", "inpaint.decode", 7700, 7800, {}),
    ("wait", "inpaint.inpaint", 7800, 8000, {}),
    ("inpaint.prepost", "inpaint.inpaint", 8000, 9500, {}),
    ("inpaint.composite", None, 9500, 10000, {}),
]
# (name, start, end, the harness span it was launched in)
DEVICE = [("Memcpy HtoD (Pageable -> Device)", 3400, 3550, None),
          ("vae_encode", 3700, 4150, None),
          ("unet_a", 4300, 5000, "step"), ("unet_b", 5100, 7150, "step"),
          ("vae_decode", 7250, 7750, None),
          ("Memcpy DtoH (Device -> Pageable)", 7800, 7950, None)]
STEPS = [(4200, 4700), (4700, 5200), (5200, 5700)]
# card-idle us of one request inside the loop (4200-4300, 5000-5100,
# 7150-7200) and outside it (0-3400, 3550-3700, 4150-4200, 7200-7250,
# 7750-7800, 7950-10000), worked by hand
LOOP_IDLE_US = 100 + 100 + 50
GLUE_IDLE_US = 3400 + 150 + 50 + 50 + 50 + 2050


def scenario(shift_us: float = 0.0):
    """(ctx, records) of three requests, the device events ``shift_us``
    late on the card's clock."""
    thread = threading.get_ident()
    ids = iter(range(1, 10_000))
    recs, events, harness = [], [], []
    for at in REQUEST_AT:
        base = T0 + at
        by_name = {}
        for name, parent, s, e, counts in HOST:
            r = spans.Record(name, next(ids),
                             by_name[parent].id if parent else 0, thread,
                             int((base + s) * 1e3), int((base + e) * 1e3),
                             dict(counts))
            by_name.setdefault(name, r)
            recs.append(r)
        events += [DeviceEvent(n, base + s + shift_us, base + e + shift_us,
                               span) for n, s, e, span in DEVICE]
        harness.append(("request", base, base + 10_000))
        harness += [("step", base + s, base + e) for s, e in STEPS]
    trace = Trace(window_s=0.07, events=events, spans=harness, launched={})
    return SimpleNamespace(trace=trace, trace_units=3, trace_requests=3), recs


@pytest.fixture
def feed(monkeypatch):
    """feed(records): what the readers' ``spans.take()`` returns."""
    def put(records):
        monkeypatch.setattr(spans, "take", lambda: list(records))
    return put


@pytest.mark.parametrize("shift_ms", [0.0, 10.0, -10.0])
def test_idle_split_at_the_loop(feed, shift_ms):
    """Idle per step inside the loop and per sketch outside it, the card's
    clock checked at the sampler's waits (a planted 10 ms shift either way
    is taken back)."""
    ctx, recs = scenario(shift_ms * 1e3)
    feed(recs)
    assert loop_idle_ms.read(ctx, {}) == pytest.approx(
        LOOP_IDLE_US / 1e3 / 3, abs=1e-3)
    assert glue_idle_ms.read(ctx, {}) == pytest.approx(
        GLUE_IDLE_US / 1e3, abs=1e-3)


def test_no_reading_without_the_programs_spans(feed):
    ctx, recs = scenario()
    feed([r for r in recs if r.name != "inpaint.loop"])
    assert loop_idle_ms.read(ctx, {}) is None
    assert glue_idle_ms.read(ctx, {}) is None
    assert bucket_fill.read(ctx, {}) is None


def test_step_device_ms_and_bucket_fill(feed):
    ctx, recs = scenario()
    feed(recs)
    # the two kernels launched inside the steps: 700 + 2050 us a request
    assert step_device_ms.read(ctx, {}) == pytest.approx(2.75 / 3)
    assert bucket_fill.read(ctx, {}) == pytest.approx(0.75)
    ctx.trace.spans = [s for s in ctx.trace.spans if s[0] != "step"]
    assert step_device_ms.read(ctx, {}) is None


def test_readers_found_by_name():
    m = Manifest()
    for name in ("loop_idle_ms.inpaint", "glue_idle_ms.inpaint",
                 "step_device_ms.inpaint", "bucket_fill.inpaint",
                 "flash_attention_roofline.inpaint", "mfu.inpaint",
                 "idle_share.inpaint"):
        assert callable(m.reader(name).read)
