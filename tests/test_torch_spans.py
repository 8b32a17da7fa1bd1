"""The port's spans (``inklayer_tpu_torch/spans.py``) on the CPU: nothing
recorded while no profiler records, nesting and threads under
``torch.profiler``, the records on the profiler's clock, self time, the
bounded buffer, and the stage timer the runner and the inpainting stages
share."""

import statistics
import threading
import time
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from inklayer_tpu_torch import spans
from inklayer_tpu_torch.spans import span, take, timed


@pytest.fixture(autouse=True)
def empty_buffer():
    take()
    yield
    take()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(spans, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    with span("detect", images=4) as s:
        s.count(boxes=3)
        with span("wait"):
            pass

    @span("upload")
    def f():
        return 7

    assert f() == 7
    assert span("detect") is span("detect")  # one shared no-op a name
    assert take() == [] and opened == []


def test_nesting_parents_and_threads():
    done = threading.Event()

    def other():
        with span("depth"):
            with span("depth.forward"):
                pass
        done.set()

    with recording():
        with span("detect", images=2) as d:
            with span("detect.forward"):
                with span("wait"):
                    pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            d.count(boxes=5)
        with span("segment.decode", boxes=1, slots=64):
            pass
    assert done.is_set() and not t.is_alive()
    recs = {r.name: r for r in take()}
    me = threading.get_ident()
    assert recs["detect"].parent == 0
    assert recs["detect.forward"].parent == recs["detect"].id
    assert recs["wait"].parent == recs["detect.forward"].id
    assert recs["segment.decode"].parent == 0
    assert recs["detect"].counts == {"images": 2, "boxes": 5}
    assert recs["segment.decode"].counts == {"boxes": 1, "slots": 64}
    # the other thread's spans nest among themselves, not in "detect"
    assert recs["depth"].parent == 0 and recs["depth"].thread != me
    assert recs["depth.forward"].parent == recs["depth"].id
    assert {recs[n].thread for n in ("detect", "detect.forward", "wait",
                                     "segment.decode")} == {me}
    for r in recs.values():
        assert 0 < r.start_ns <= r.end_ns


def test_decorator_applied_off_records_when_on():
    @span("upload")
    def f(x):
        return x + 1

    assert f(1) == 2 and take() == []
    with recording():
        assert f(2) == 3
    (r,) = take()
    assert r.name == "upload" and r.counts == {}


def test_records_agree_with_the_profilers_events():
    """Each record's start and end lie within 50 us of its Kineto event
    (median over 20 spans, after one warm-up span)."""
    x = torch.ones(64)
    with recording() as prof:
        with span("warmup"):
            x = x + 1
        for i in range(20):
            with span(f"agree{i}"):
                x = x * 1.0001
                time.sleep(0.001)
    recs = {r.name: r for r in take()}
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)}
    d_start, d_end = [], []
    for i in range(20):
        r, e = recs[f"agree{i}"], kineto[spans.PREFIX + f"agree{i}"]
        d_start.append(abs(r.start_ns - e.start_ns()) / 1e3)
        d_end.append(abs(r.end_ns - e.end_ns()) / 1e3)
    assert statistics.median(d_start) < 50, d_start
    assert statistics.median(d_end) < 50, d_end


def test_self_time_is_duration_less_the_childrens_cover():
    R = spans.Record
    recs = [R("p", 1, 0, 1, 0, 100),
            R("a", 2, 1, 1, 10, 30), R("b", 3, 1, 1, 20, 50),  # overlap
            R("c", 4, 1, 1, 90, 120),  # runs past its parent's end
            R("g", 5, 2, 1, 12, 14),  # a grandchild: not the parent's
            R("q", 6, 0, 1, 200, 210)]
    got = spans.self_ns(recs)
    assert got[1] == 100 - (40 + 10)
    assert got[2] == 20 - 2 and got[5] == 2 and got[6] == 10


def test_buffer_stays_bounded(monkeypatch):
    assert spans._records.maxlen == spans.CAPACITY
    monkeypatch.setattr(spans, "_records", deque(maxlen=8))
    with recording():
        for i in range(20):
            with span(f"s{i}"):
                pass
    got = take()
    assert [r.name for r in got] == [f"s{i}" for i in range(12, 20)]
    assert take() == []


def test_timed_adds_seconds_and_waits_in_a_wait_span():
    times, synced = {}, []
    with recording():
        with timed("run.detect", times, sync=lambda: synced.append(1)):
            time.sleep(0.002)
        with timed("run.detect", times):
            pass
    assert synced == [1] and set(times) == {"detect"}
    assert times["detect"] >= 0.002
    recs = take()
    names = [r.name for r in recs]
    assert names.count("run.detect") == 2 and names.count("wait") == 1
    wait = next(r for r in recs if r.name == "wait")
    assert next(r for r in recs if r.id == wait.parent).name == "run.detect"
    # off: the times still add up, nothing is recorded
    with timed("run.segment", times, sync=lambda: synced.append(2)):
        pass
    assert synced == [1, 2] and "segment" in times and take() == []
