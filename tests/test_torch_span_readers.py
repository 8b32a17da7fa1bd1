"""The benchmark's readers of the program's spans (``gpubench/metrics/
idle_ms.py``, ``host_wait_ms.py``, ``decode_fill.py``,
``depth_graph_share.py`` and their shared ``_program_spans.py``) on
synthetic traces and span records, and ``decode_fill`` on a tiny SAM
decode on the CPU."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench.manifest import Manifest
from gpubench.metrics import _program_spans, decode_fill, host_wait_ms
from gpubench.metrics import depth_graph_share
from gpubench.metrics import idle_ms
from gpubench.trace import DeviceEvent, Trace
from inklayer_tpu_torch import spans
from inklayer_tpu_torch.config import SamConfig
from inklayer_tpu_torch.models.sam import Sam, SamPredictor

T0 = 1.7e15  # us: an epoch time, as the profiler's clock gives
UNITS = 12   # sketches in the synthetic trace
US = 1e-3 / UNITS  # 1 us a run, in ms a sketch: epoch ns in floats
REQUEST_AT = (0.0, 23_700.0, 51_300.0)  # us after T0: not periodic


def one_request(at: float, ids, thread: int):
    """(program records, device events, the request's host interval) of a
    10 ms request starting ``at`` us after T0 (see the layout below)."""
    host = [  # (name, parent name, start, end, counts)
        ("upload", None, 0, 500, {}),
        ("detect", None, 500, 4000, {"images": 4, "boxes": 9}),
        ("detect.forward", "detect", 600, 2500, {}),
        ("wait", "detect", 2550, 2820, {}),
        ("detect.threshold", "detect", 2820, 4000, {}),
        ("segment.encode", None, 4000, 6000, {"images": 4}),
        ("depth", None, 6000, 7000, {}),
        ("segment.decode", None, 7000, 9000, {"boxes": 5, "slots": 64}),
        ("wait", "segment.decode", 7900, 8420, {}),
    ]
    device = [("Memcpy HtoD (Pinned -> Device)", 100, 300),
              ("kernel_a", 600, 1500), ("kernel_b", 1700, 2600),
              ("Memcpy DtoH (Device -> Pageable)", 2600, 2800),
              ("vit", 4200, 5800), ("dinov2", 6100, 6400),
              ("dpt", 6600, 6900), ("decoder", 7100, 8300),
              ("Memcpy DtoH (Device -> Pageable)", 8300, 8400)]
    recs, by_name = [], {}
    for name, parent, s, e, counts in host:
        r = spans.Record(name, next(ids), by_name[parent].id if parent else 0,
                         thread, int((T0 + at + s) * 1e3),
                         int((T0 + at + e) * 1e3), dict(counts))
        by_name.setdefault(name, r)
        recs.append(r)
    events = [(n, T0 + at + s, T0 + at + e) for n, s, e in device]
    return recs, events, (T0 + at, T0 + at + 10_000)


# idle us of one request, by the layer open on the host (worked by hand)
IDLE_US = {"detect": 100 + 200 + 1200, "segment": 200 + 200 + 100 + 600,
           "depth": 100 + 200 + 100, "other": 100 + 200 + 1000}
WAIT_US = 270 + 520


def scenario(shift_us: float = 0.0, thread=None, copies=True):
    """(ctx, records) of three requests; the device events ``shift_us``
    late on the card's clock."""
    thread = threading.get_ident() if thread is None else thread
    ids, recs, events, reqs = iter(range(1, 10_000)), [], [], []
    for at in REQUEST_AT:
        r, e, q = one_request(at, ids, thread)
        recs += r
        events += e
        reqs.append(q)
    events = [DeviceEvent(n, s + shift_us, e + shift_us, None)
              for n, s, e in events
              if copies or "DtoH" not in n]
    trace = Trace(window_s=0.07, events=events,
                  spans=[("request", s, e) for s, e in reqs],
                  launched={})
    ctx = SimpleNamespace(trace=trace, trace_units=UNITS, trace_requests=3)
    return ctx, recs


@pytest.fixture
def feed(monkeypatch):
    """feed(records): what the readers' ``spans.take()`` returns."""
    def put(records):
        monkeypatch.setattr(spans, "take", lambda: list(records))
    return put


def read_all(ctx):
    out = {f"idle_ms.{layer}.b4": idle_ms.read(ctx, {"name":
                                                     f"idle_ms.{layer}.b4"})
           for layer in idle_ms.LAYERS}
    out["host_wait_ms.b4"] = host_wait_ms.read(ctx, {})
    out["decode_fill.b4"] = decode_fill.read(ctx, {})
    return out


def test_each_gap_is_split_over_the_spans_open_during_it(feed):
    ctx, recs = scenario()
    feed(recs)
    got = read_all(ctx)
    for layer in idle_ms.LAYERS:
        want = IDLE_US[layer] * len(REQUEST_AT) / 1e3 / UNITS
        assert got[f"idle_ms.{layer}.b4"] == pytest.approx(want, abs=US)
    assert got["host_wait_ms.b4"] == pytest.approx(
        WAIT_US * len(REQUEST_AT) / 1e3 / UNITS, abs=US)
    assert got["decode_fill.b4"] == pytest.approx(5 / 64)


def test_layers_and_the_rest_sum_to_the_idle_time(feed):
    ctx, recs = scenario()
    feed(recs)
    prog = _program_spans.records(ctx)
    events = [(e.name, e.start_us, e.end_us) for e in ctx.trace.events]
    parts, total, offset = idle_ms.idle_by_layer(
        events, prog, _program_spans.requests_us(ctx.trace))
    reqs = _program_spans.union(_program_spans.requests_us(ctx.trace))
    busy = _program_spans.union((s, e) for _, s, e in events)
    idle = _program_spans.length(reqs) - _program_spans.length(
        _program_spans.intersect(reqs, busy))
    assert sum(parts.values()) == pytest.approx(total, abs=1e-6)
    assert total == pytest.approx(idle, abs=1e-6)
    assert total == pytest.approx(sum(IDLE_US.values()) * len(REQUEST_AT),
                                  abs=1.0)
    assert parts["other"] == pytest.approx(IDLE_US["other"] * 3, abs=1.0)
    assert abs(offset) <= idle_ms.TOLERANCE_US


@pytest.mark.parametrize("shift_ms", [10.0, -10.0])
def test_planted_clock_shift_is_corrected(feed, shift_ms, capsys,
                                          monkeypatch):
    ctx, recs = scenario()
    feed(recs)
    want = read_all(ctx)
    ctx, recs = scenario(shift_us=shift_ms * 1e3)
    feed(recs)
    got = read_all(ctx)
    assert f"{shift_ms - 0.02:+.4f} ms" in capsys.readouterr().err
    for name, value in want.items():
        assert got[name] == pytest.approx(value, abs=0.01), name
    # left uncorrected, the shift would have moved the split
    monkeypatch.setattr(idle_ms, "TOLERANCE_US", 1e9)
    ctx, recs = scenario(shift_us=shift_ms * 1e3)
    feed(recs)
    raw = read_all(ctx)
    assert max(abs(raw[n] - want[n]) for n in want
               if n.startswith("idle_ms")) > 0.1


def test_no_reading_where_the_clocks_cannot_be_matched(feed, capsys):
    ctx, recs = scenario(shift_us=10e3, copies=False)
    feed(recs)
    got = read_all(ctx)
    assert all(got[f"idle_ms.{layer}.b4"] is None
               for layer in idle_ms.LAYERS)
    assert "no reading" in capsys.readouterr().err


@pytest.mark.parametrize("where", ["outside", "other_thread", "none"])
def test_no_reading_without_program_spans_in_the_requests(feed, where):
    if where == "outside":  # a discarded retake's records: an hour before
        ctx, recs = scenario()
        for r in recs:
            r.start_ns -= 3_600_000_000_000
            r.end_ns -= 3_600_000_000_000
    elif where == "other_thread":
        ctx, recs = scenario(thread=threading.get_ident() + 1)
    else:
        ctx, recs = scenario()
        recs = []
    feed(recs)
    assert all(v is None for v in read_all(ctx).values())


def test_the_buffer_is_taken_once_a_run(feed, monkeypatch):
    ctx, recs = scenario()
    calls = []
    monkeypatch.setattr(spans, "take", lambda: calls.append(1) or recs)
    read_all(ctx)
    read_all(ctx)
    assert calls == [1]


def test_the_manifest_finds_each_reader():
    m = Manifest()
    names = {e["name"]: e for e in m.data["per_layer"]}
    for name, mod in (("idle_ms.detect.b4", idle_ms),
                      ("idle_ms.segment.b4", idle_ms),
                      ("idle_ms.depth.b4", idle_ms),
                      ("host_wait_ms.b4", host_wait_ms),
                      ("decode_fill.b4", decode_fill)):
        assert names[name]["workloads"] == ["default.models-b4"]
        assert names[name]["moves"] == "sketches_per_s"
        assert m.reader(name).__file__ == mod.__file__


def test_decode_fill_of_a_tiny_sam_decode():
    """5 boxes decoded at the capacity 64 read 5/64."""
    torch.manual_seed(0)
    cfg = SamConfig(encoder_embed_dim=32, encoder_depth=2,
                    encoder_num_heads=2, encoder_global_attn_indexes=(1,),
                    encoder_window_size=4, image_size=64, patch_size=16,
                    prompt_embed_dim=32)
    pred = SamPredictor(Sam(cfg).eval(), box_capacity=64)
    image = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (48, 64, 3), np.uint8))
    boxes = np.asarray([[1, 2, 30, 40], [5, 5, 20, 20], [0, 0, 63, 47],
                        [10, 12, 50, 44], [30, 1, 60, 9]], float)
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns() / 1e3
        state = pred.compute_image_state(image)
        masks, iou = pred.predict_device_state(state, boxes)
        t1 = time.time_ns() / 1e3
    assert masks.shape == (5, 48, 64) and iou.shape == (5,)
    trace = Trace(window_s=(t1 - t0) / 1e6, events=[],
                  spans=[("request", t0, t1)], launched={})
    ctx = SimpleNamespace(trace=trace, trace_units=1, trace_requests=1)
    assert decode_fill.read(ctx, {}) == 5 / 64
    names = {s.name for s in _program_spans.records(ctx)}
    assert {"segment.encode", "segment.preprocess", "segment.vit",
            "segment.decode", "segment.prompts", "segment.decoder",
            "segment.resample", "wait"} <= names
    assert host_wait_ms.read(ctx, {}) > 0


@pytest.mark.parametrize("graphed,want", [((1, 1, 1), 1.0),
                                          ((0, 1, 1), 2 / 3),
                                          ((0, 0, 0), 0.0)])
def test_depth_graph_share_of_planted_spans(feed, graphed, want):
    """Each request's ``depth`` span counts ``graphed``; the share is their
    sum over the number of ``depth`` spans."""
    ctx, recs = scenario()
    for r, g in zip((r for r in recs if r.name == "depth"), graphed):
        r.counts["graphed"] = g
    feed(recs)
    assert depth_graph_share.read(ctx, {}) == pytest.approx(want)


def test_depth_graph_share_gives_no_reading_without_its_count(feed):
    """A program whose ``depth`` spans count no ``graphed`` (one that
    captures no graph), and a run without a trace, read nothing."""
    ctx, recs = scenario()
    feed(recs)
    assert depth_graph_share.read(ctx, {}) is None
    ctx, recs = scenario()
    for r in recs:
        r.counts["graphed"] = 1
    feed(recs)
    ctx.trace = None
    assert depth_graph_share.read(ctx, {}) is None


def test_the_manifest_finds_the_depth_graph_share():
    m = Manifest()
    entry = {e["name"]: e for e in m.data["per_layer"]}["depth_graph_share.b4"]
    assert entry["workloads"] == ["default.models-b4"]
    assert entry["moves"] == "sketches_per_s"
    assert (entry["layer"], entry["unit"], entry["better"]) == \
        ("models", "calls/call", "higher")
    assert m.reader("depth_graph_share.b4").__file__ == \
        depth_graph_share.__file__
