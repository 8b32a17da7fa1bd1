"""The port's spans: named ranges of host time on the profiler's clock.

``span(name, **counts)`` marks a piece of the program's work: a layer, a
stage, a wait on the card.  It is a context manager and a decorator::

    with span("segment.decode", boxes=n, slots=cap):
        ...

    @span("upload")
    def upload(...): ...

While a ``torch.profiler`` session records, a span does two things:

* it opens a record function ``inklayer/<name>``, which lands in the same
  Kineto trace as the device events, so any trace of the port
  (``profiling.device_profile``, a benchmark's traced window) shows it;
* it appends a :class:`Record` to a bounded buffer (:data:`CAPACITY`
  records, the oldest dropped first): its name, id, parent's id, thread,
  start and end in ns on the profiler's host clock (``time.time_ns``, read
  inside the record function) and its counts.  :func:`take` returns the
  buffer and empties it.

While nothing records, a span is one flag check that returns a shared
no-op context: no allocation and no record function.

The record function has the ``FUNCTION`` scope
(``torch._C._profiler._RecordFunctionFast``).  A user-scope
``torch.profiler.record_function`` would also put a ``gpu_user_annotation``
range on the card's timeline around the kernels launched inside it, which
a reader of the trace would count as device work.

The names in use:

* the layers of the model path: ``detect`` (children ``detect.preprocess``,
  ``detect.forward``, ``detect.threshold``), ``segment.encode``
  (``segment.preprocess``, ``segment.vit``), ``segment.decode``
  (``segment.prompts``, ``segment.decoder``, ``segment.resample``) and
  ``depth`` (``depth.preprocess``, ``depth.forward``, ``depth.resize``);
* ``upload`` (a host array to the card) and ``wait`` (the host blocked on
  the card: a read-back, a stage's synchronise);
* ``run.<stage>`` (the runner's stages), ``inpaint.<stage>`` (the
  inpainting stages and the diffusion pipelines' encode, loop, decode and
  pre/post-processing) and ``inpaint.step`` (one solver step).

Counts: ``images`` (``detect``, ``segment.encode``), ``boxes`` (detections
kept, on ``detect``; real prompts, on ``segment.decode``), ``slots`` (the
prompt capacity decoded, on ``segment.decode``), ``layers`` (on
``inpaint.inpaint``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

PREFIX = "inklayer/"
CAPACITY = 1 << 16


@dataclass
class Record:
    """One closed span; times in ns on the ``time.time_ns`` clock."""

    name: str
    id: int
    parent: int       # the enclosing span's id on this thread, 0 at the top
    thread: int       # threading.get_ident()
    start_ns: int = 0
    end_ns: int = 0
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


_records: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


def _open_ids() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _wrap(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


class _Span:
    __slots__ = ("record", "_rf")

    def __init__(self, name: str, counts: dict):
        self.record = Record(name, next(_ids), 0, threading.get_ident(),
                             counts=counts)

    def __enter__(self):
        rec, stack = self.record, _open_ids()
        rec.parent = stack[-1] if stack else 0
        self._rf = _RecordFunctionFast(PREFIX + rec.name)
        self._rf.__enter__()
        rec.start_ns = time.time_ns()
        stack.append(rec.id)
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        _open_ids().pop()
        _records.append(rec)
        return False

    def count(self, **counts) -> None:
        """Set counts known only inside the span."""
        self.record.counts.update(counts)

    def __call__(self, fn):
        return _wrap(self.record.name, fn)


class _Off:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass

    def __call__(self, fn):
        return _wrap(self.name, fn)


_off: Dict[str, _Off] = {}


def span(name: str, **counts):
    """A span named ``name`` with ``counts`` (see the module's docstring);
    a shared no-op while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        off = _off.get(name)
        if off is None:
            off = _off.setdefault(name, _Off(name))
        return off
    return _Span(name, counts)


@contextlib.contextmanager
def timed(name: str, times: dict, sync=None, **counts):
    """A span whose host seconds are added to ``times`` under the last
    part of ``name`` (``run.detect`` -> ``times["detect"]``); ``sync()``,
    where given, runs at its end inside a ``wait`` span and is timed with
    it."""
    t0 = time.perf_counter()
    with span(name, **counts) as s:
        yield s
        if sync is not None:
            with span("wait"):
                sync()
    key = name.rsplit(".", 1)[-1]
    times[key] = times.get(key, 0.0) + (time.perf_counter() - t0)


def take() -> List[Record]:
    """The buffered records, oldest first, and an empty buffer."""
    out = []
    while True:
        try:
            out.append(_records.popleft())
        except IndexError:
            return out


def self_ns(records: Iterable[Record]) -> Dict[int, int]:
    """{span id: its duration less the part of it its children cover}."""
    records = list(records)
    children: Dict[int, list] = {}
    for r in records:
        children.setdefault(r.parent, []).append(r)
    out = {}
    for r in records:
        covered, end = 0, r.start_ns
        for c in sorted(children.get(r.id, ()), key=lambda c: c.start_ns):
            s, e = max(c.start_ns, end), min(c.end_ns, r.end_ns)
            if e > s:
                covered += e - s
                end = e
        out[r.id] = r.ns - covered
    return out
