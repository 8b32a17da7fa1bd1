"""Device time of one call, from a ``torch.profiler`` trace, and the
card's identity.

``device_profile(fn)`` runs ``fn()`` once with CPU and CUDA activity
tracing and returns the wall time, the time the card was busy (the union
of its kernel and copy intervals), the idle share of the wall time, and the
kernels that took the most device time.  The profiler's own overhead
inflates the wall time a little; take latencies from untraced runs and
shares from this one.

A trace may lose device events: on the card a short trace late in a long
process has recorded none, and a fresh process once recorded 33 of 50.  So
every trace is held to the launch counters of ``_kernels``: it must hold
exactly as many of the port's kernels (:data:`PORT_KERNEL_EVENTS`) as the
traced call launched, or it raises :class:`IncompleteTrace`
(:class:`NoDeviceActivity` when it recorded nothing on the card).  An
incomplete trace is discarded and the call traced again, up to
:data:`TRACE_ATTEMPTS` times in all; each discarded trace is noted in
:data:`retraced`.  A call that launches none of the port's kernels is
held to nothing but a non-empty trace.  The trace stays open
:data:`TRACE_MARGIN_S` before and after the call: late in a long process
a ViT-H forward traced without it lost its first two blocks' kernels in
three traces running, as if the card's timestamps fell before the trace
opened (the profiler keeps only device events inside its window).

``card_info(device)`` gives the card's name and power limit as
``nvidia-smi`` reports them, which every number measured on the card is
written beside.

The diagnostic scripts (``inklayer_tpu_torch/scripts/profile_*``,
``analyze_sweep_stalls4``, ``ablate_gdino``) attribute time with three
more pieces: :class:`HostAccount` sums thread CPU, wall time and calls per
key; :func:`patch` times a function under a key by replacing it, while the
context is open, in the namespace where its caller looks it up; and
:func:`classify` sums the kernels of a trace into classes by kernel name.
:func:`device_profile_stages` traces each stage of a call on its own;
:func:`time_call` and :func:`top_kernels` time and trace a call that ends
in :func:`sync`.
"""

from __future__ import annotations

import contextlib
import json
import platform
import re
import subprocess
import sys
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

# H100 SXM data sheet, dense bf16 tensor-core rate at 700 W
PEAK_BF16 = 989e12


# (kernel-name pattern, {launch counter: kernels of that name per launch}):
# each wrapper's launch runs these kernels of the port on the card
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
_PORT_PATTERNS = tuple((re.compile(p), per) for p, per in PORT_KERNEL_EVENTS)
TRACE_ATTEMPTS = 3
TRACE_MARGIN_S = 0.1
retraced: list = []  # why each discarded trace was discarded


class IncompleteTrace(RuntimeError):
    """A trace recorded another number of the port's kernels than the
    traced call launched."""


class NoDeviceActivity(IncompleteTrace):
    """The profiler recorded no kernel or copy on the card."""


def check_port_events(per_name: dict, launched: dict) -> None:
    """Raise :class:`IncompleteTrace` unless the traced kernels
    ``per_name`` ({name: events}) hold, for each pattern of
    :data:`PORT_KERNEL_EVENTS`, the kernels that ``launched`` ({launch
    counter: launches during the traced call}) says ran."""
    wrong = []
    for pattern, per_launch in _PORT_PATTERNS:
        want = sum(launched.get(k, 0) * n for k, n in per_launch.items())
        got = sum(n for name, n in per_name.items() if pattern.search(name))
        if got != want:
            wrong.append(f"{pattern.pattern} {got} traced, {want} launched")
    if wrong:
        raise IncompleteTrace("; ".join(wrong))


def _launch_counts() -> dict:
    from inklayer_tpu_torch import _kernels

    return _kernels.launch_counts()


def _launched_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _launch_counts().items()}


def _attempts(trace_once):
    """``trace_once()``, traced again after an :class:`IncompleteTrace`, up
    to :data:`TRACE_ATTEMPTS` times in all."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        try:
            return trace_once()
        except IncompleteTrace as e:
            if attempt == TRACE_ATTEMPTS:
                raise
            retraced.append(str(e))
            print(f"[profiling] trace {attempt} of {TRACE_ATTEMPTS} "
                  f"discarded: {e}", file=sys.stderr, flush=True)


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


def _summary(prof, wall_us: float, top, launched: dict) -> dict:
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
    check_port_events({n: c for n, (_, c) in per_name.items()}, launched)
    kernels = sorted(((n, ms, c) for n, (ms, c) in per_name.items()),
                     key=lambda r: -r[1])
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_ops": len(events),
            "op_ms": sum(ms for _, ms, _ in kernels),
            "kernels": kernels[:top]}


def _trace():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_profile(fn, top=10) -> dict:
    """{'wall_ms', 'busy_ms', 'idle_share', 'device_ops', 'op_ms',
    'kernels': [(name, ms, calls)]} for one traced call of ``fn`` (which
    must synchronise the card before it returns); ``device_ops`` counts the
    kernels and copies the card ran, ``op_ms`` sums their durations (the
    device-op time, which counts overlapping ops twice, where ``busy_ms``
    is their union), ``kernels`` lists the ``top`` names with the most
    device time (all of them for ``top=None``).  The device events are read
    from the profiler's raw Kineto results: ``prof.events()`` builds a tree
    of every host event too, which takes tens of seconds for a traced
    pipeline run and is not needed for device time.  The card is
    synchronised before the trace opens, so it holds only ``fn``'s work;
    the trace is open :data:`TRACE_MARGIN_S` either side of the call
    (outside ``wall_ms``), and an incomplete one is taken again (see the
    module's docstring)."""
    def once():
        torch.cuda.synchronize()
        with _trace() as prof:
            time.sleep(TRACE_MARGIN_S)
            before = _launch_counts()
            t0 = time.perf_counter()
            fn()
            wall_us = (time.perf_counter() - t0) * 1e6
            launched = _launched_since(before)
            time.sleep(TRACE_MARGIN_S)
        return _summary(prof, wall_us, top, launched)

    return _attempts(once)


def device_profile_stages(fn, target, name: str, top=None) -> dict:
    """{stage key: :func:`device_profile`'s dict} for one call of ``fn``,
    split at the calls of ``target.<name>(key, ...)``: each time that
    method returns (it must synchronise the card, as
    ``ControlNetInpaintPipeline._add_time`` does), the trace of the stage
    that ended is closed under its key and a new one opened.  A key seen
    twice keeps its last stage; what runs after the last stage is not
    kept.  The method is put back when the call ends.  Each stage is held
    to the launches made in it; a call with an incomplete stage is traced
    again (see the module's docstring)."""
    original = getattr(target, name)

    def once():
        traces, state = {}, {}

        def start():
            state["prof"] = _trace()
            state["prof"].__enter__()
            time.sleep(TRACE_MARGIN_S)
            state["launches"] = _launch_counts()
            state["t0"] = time.perf_counter()

        def stop():
            wall_us = (time.perf_counter() - state["t0"]) * 1e6
            launched = _launched_since(state["launches"])
            time.sleep(TRACE_MARGIN_S)
            state["prof"].__exit__(None, None, None)
            return state.pop("prof"), wall_us, launched

        def split(key, *args, **kwargs):
            out = original(key, *args, **kwargs)
            traces[key] = stop()
            start()
            return out

        torch.cuda.synchronize()
        with _restoring(target, name, split):
            start()
            try:
                fn()
            finally:
                stop()
        return {key: _summary(prof, wall_us, top, launched)
                for key, (prof, wall_us, launched) in traces.items()}

    return _attempts(once)


def wall_ms(fn, calls: int) -> list:
    """Host-clock ms of each of ``calls`` calls of ``fn`` (which must
    synchronise the card before it returns)."""
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def sync(device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_call(call, calls: int, device) -> dict:
    """{'p50_ms': the median host time of ``calls`` calls of ``call``
    (which must synchronise the card), and on the card 'device_ms' and
    'traced_wall_ms': the busy and wall ms of one more, traced (None on
    the CPU)}."""
    import statistics

    row = {"p50_ms": statistics.median(wall_ms(call, calls)),
           "device_ms": None, "traced_wall_ms": None}
    if torch.device(device).type == "cuda":
        prof = device_profile(call)
        row["device_ms"], row["traced_wall_ms"] = (prof["busy_ms"],
                                                   prof["wall_ms"])
    return row


def top_kernels(call, iters: int, top: int, device) -> dict:
    """One first call, two warm, one timed; then ``iters`` calls in one
    trace on the card: {'first_s', 'warm_ms', and on the card
    'traced_wall_ms', 'busy_ms', 'op_ms', 'device_ops', 'kernels'}."""
    res = {"first_s": wall_ms(call, 1)[0] / 1e3}
    wall_ms(call, 2)
    res["warm_ms"] = wall_ms(call, 1)[0]
    res.update(traced_wall_ms=None, busy_ms=None, op_ms=None,
               device_ops=None, kernels=None)
    if torch.device(device).type == "cuda":
        prof = device_profile(lambda: [call() for _ in range(iters)], top)
        res.update(traced_wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                   op_ms=prof["op_ms"], device_ops=prof["device_ops"],
                   kernels=prof["kernels"])
    return res


def print_top(res: dict, iters: int) -> None:
    """:func:`top_kernels`' result, one kernel a line."""
    print(f"first call {res['first_s']:.2f} s, warm {res['warm_ms']:.2f} ms")
    if res["kernels"] is None:
        return
    print(f"device {res['op_ms']:.2f} ms of ops ({res['busy_ms']:.2f} ms "
          f"busy) in {res['device_ops']} ops over {iters} calls")
    print(f"  {'total ms':>9s} {'calls':>6s}  kernel")
    for name, ms, calls in res["kernels"]:
        print(f"  {ms:9.3f} {calls:6d}  {name[:100]}")


def counted_flops(fn, *modules) -> int:
    """FLOPs of one call of ``fn``, counted by ``torch.utils.flop_counter``
    over the plain versions (inside ``runtime.disable_kernels``: a ctypes
    kernel launch is invisible to the counter).  The counter counts
    products, convolutions and attention, not elementwise work.  The
    parameters of ``modules`` (the models ``fn`` runs) stop requiring grad
    for the call: the counter's module tracker hooks every module input
    that requires grad, and a parameter passed on as an input (a view of
    it, in inference mode) has no grad function to hook."""
    from torch.utils.flop_counter import FlopCounterMode

    from inklayer_tpu_torch.runtime import disable_kernels

    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    try:
        for p in params:
            p.requires_grad_(False)
        with FlopCounterMode(display=False) as counter, disable_kernels(), \
                torch.inference_mode():
            fn()
    finally:
        for p in params:
            p.requires_grad_(True)
    return counter.get_total_flops()


def thread_clock_step_ms(tries: int = 3) -> float:
    """The smallest step of ``time.thread_time`` seen over ``tries`` steps
    (the clock may tick far coarser than its nominal resolution: a key's
    CPU per call is then a count of ticks)."""
    steps = []
    for _ in range(tries):
        t0 = time.thread_time()
        t1 = t0
        while t1 == t0:
            t1 = time.thread_time()
        steps.append(t1 - t0)
    return min(steps) * 1e3


class HostAccount:
    """Per key: CPU seconds of the calling thread (``time.thread_time``),
    wall seconds and calls, summed under a lock (the run, the writer
    threads and the sweep's decode thread call the wrapped functions), and
    the threads each key ran on (port of the JAX package's
    ``scripts/analyze_sweep_stalls4.py`` ``Acct``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cpu = defaultdict(float)
        self.wall = defaultdict(float)
        self.calls = defaultdict(int)
        self.threads = defaultdict(set)

    def wrap(self, key: str, fn, wait_key=None):
        """``fn`` timed under ``key``; with ``wait_key``, the function that
        ``fn`` returns (a read-back's wait) is timed under that key."""
        def timed(*args, **kwargs):
            c0, w0 = time.thread_time(), time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                dc, dw = time.thread_time() - c0, time.perf_counter() - w0
                with self.lock:
                    self.cpu[key] += dc
                    self.wall[key] += dw
                    self.calls[key] += 1
                    self.threads[key].add(threading.get_ident())
            return out if wait_key is None else self.wrap(wait_key, out)

        return timed

    def reset(self) -> None:
        with self.lock:
            for d in (self.cpu, self.wall, self.calls, self.threads):
                d.clear()

    def table(self, per: float = 1.0, kind=None) -> dict:
        """{key: {'cpu_ms', 'wall_ms', 'calls', 'threads'}}, each number
        divided by ``per`` (runs or images); 'threads' names the kinds of
        thread the key ran on, ``kind(thread ident)``."""
        with self.lock:
            return {k: {"cpu_ms": self.cpu[k] * 1e3 / per,
                        "wall_ms": self.wall[k] * 1e3 / per,
                        "calls": self.calls[k] / per,
                        "threads": sorted({kind(t) if kind else str(t)
                                           for t in self.threads[k]})}
                    for k in self.calls}


@contextlib.contextmanager
def _restoring(target, name: str, replacement):
    own = name in vars(target)
    original = vars(target)[name] if own else None
    if isinstance(original, (staticmethod, classmethod)):
        raise TypeError(f"{name} is a {type(original).__name__}")
    setattr(target, name, replacement)
    try:
        yield
    finally:
        if own:
            setattr(target, name, original)
        else:  # an instance's method, looked up on its class
            delattr(target, name)


@contextlib.contextmanager
def patch(target, name: str, key: str, account: HostAccount, wait_key=None):
    """Time ``target.<name>`` under ``key`` in ``account`` while the
    context is open, then put the original object back.  ``target`` is the
    namespace where the CALLER looks the name up: a module that did ``from
    m import f`` holds its own binding of ``f``, so patching ``m`` would
    not reach it.  ``target`` may be a module, a class (a method of every
    instance) or an instance (its method only)."""
    with _restoring(target, name,
                    account.wrap(key, getattr(target, name), wait_key)):
        yield


@contextlib.contextmanager
def patches(specs, account: HostAccount):
    """:func:`patch` for each (target, name, key, wait key) of ``specs``."""
    with contextlib.ExitStack() as stack:
        for target, name, key, wait_key in specs:
            stack.enter_context(patch(target, name, key, account, wait_key))
        yield


# (class, kernel-name patterns), first match wins (case-insensitive
# regular expressions): the port's own kernels (csrc/*.cu), then the
# library kernels by the names cuDNN, cuBLAS and PyTorch give them
KERNEL_CLASSES = (
    ("port: attention (flash, relpos)", (r"attention_tile_kernel",)),
    ("port: MLP GEMM", (r"gemm_bias_act_kernel",)),
    ("port: LayerNorm", (r"\blayernorm_kernel",)),
    ("port: MSDA", (r"ms_deform_attn_kernel",)),
    ("port: components", (r"\bcc_(local|border|finish|keep)\b",)),
    ("port: conv3x3", (r"conv3x3",)),
    ("attention (SDPA)", (r"fmha", r"flash", r"attention")),
    ("GroupNorm", (r"group_?norm", r"RowwiseMoments",
                   r"ComputeFusedParams")),
    ("LayerNorm (PyTorch)", (r"layer_?norm",)),
    ("convolution (cuDNN)", (r"fprop", r"dgrad", r"wgrad", r"cudnn",
                             r"conv(?!ert)", r"implicit")),
    ("GEMM (cuBLAS/CUTLASS)", (r"gemm", r"gemv", r"nvjet", r"cutlass",
                               r"xmma", r"cublas", r"matmul")),
    ("copy/layout", (r"copy", r"memcpy", r"memset", r"cat_?array",
                     r"transpose", r"nchwtonhwc", r"nhwctonchw", r"index",
                     r"gather", r"scatter", r"permute", r"\bpad", r"roll")),
    ("reduction", (r"reduce", r"softmax", r"sum_", r"max_", r"argmax",
                   r"sort", r"topk", r"scan")),
    ("elementwise", (r"elementwise", r"vectorized", r"unrolled")),
)


def classify(kernels, table=KERNEL_CLASSES) -> list:
    """[(class, ms, calls, [top names])] from :func:`device_profile`'s
    (name, ms, calls) rows, most time first: each row goes to the first
    class one of whose patterns it matches, else to 'other', so that the
    classes add up to the rows' total (``op_ms`` when given every row).
    The three names with the most time in each class show what it holds."""
    compiled = [(cls, [re.compile(p, re.I) for p in pats])
                for cls, pats in table]
    acc: dict = {}
    for name, ms, calls in kernels:
        cls = next((c for c, pats in compiled
                    if any(p.search(name) for p in pats)), "other")
        row = acc.setdefault(cls, [0.0, 0, []])
        row[0] += ms
        row[1] += calls
        row[2].append((ms, name))
    return sorted(((c, ms, n, [nm for _, nm in sorted(names,
                                                       reverse=True)[:3]])
                   for c, (ms, n, names) in acc.items()),
                  key=lambda r: -r[1])


def print_classes(classes, op_ms: float) -> None:
    """:func:`classify`'s rows, one class a line, and their total beside
    the device-op time."""
    for cls, ms, calls, names in classes:
        print(f"  {ms:9.3f} ms x{calls:5d}  {cls:32s} "
              f"(e.g. {names[0][:60]})")
    print(f"  {sum(c[1] for c in classes):9.3f} ms in all classes, "
          f"{op_ms:.3f} ms of device-op time")


def emit(res: dict, device) -> dict:
    """``res`` with the card's name and power limit (:func:`card_info`),
    printed as one JSON line (a diagnostic script's last line)."""
    res["card"], res["power_limit_w"] = card_info(torch.device(device))
    print(json.dumps(res), flush=True)
    return res


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
