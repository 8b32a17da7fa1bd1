"""Build, load and count the hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with :mod:`ctypes` (no
PyTorch headers: the build takes seconds, not minutes).  Each source
compiles to an object in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links them.  The library lands in ``build/kernels/``
beside the package, named by a hash of the sources, so an edited ``.cu``
rebuilds and an unchanged tree reuses its build.

The build runs at the first kernel launch, never at import: importing the
package needs no toolchain.  Every C entry point returns the value of
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.

The launch path is short, because a wrapper's host time is the whole cost
of a small kernel.  Each launch entry point takes one pointer to a C struct
of its arguments: the wrapper passes pointers (``tensor.data_ptr()``), the
stream (:func:`stream`) and the sizes as plain Python numbers, which one
``struct.pack_into`` writes into a buffer bound to the entry point when the
library loads, and ctypes converts one address instead of a dozen
arguments.  The library is loaded as a ``PyDLL``, which keeps the GIL
through the call, so no other thread repacks the buffer while C reads it;
a lock per entry point keeps another thread from repacking it between the
pack and the call (the web app launches from several threads).
:func:`lib` returns the loaded library without a lock.

``LAUNCHES`` holds one plain integer per kernel.  Each wrapper adds one
where it launches its kernel and nowhere else (under a lock: concurrent
requests launch from several threads), so a run can show which kernels
its main path went through.  A kernel built in several instances
(the flash attention at head_dim 40, 64 and 80) also counts each instance
under ``"<kernel>/<instance>"``.  A CUDA graph capture runs nothing: inside
:func:`captured_launches` the capturing thread's launches are counted into
the dict it yields instead, and each replay of the graph adds that dict
back (:func:`add_launches`), so the counters keep saying what ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

KERNEL_NAMES = ("relpos_attention", "mlp_gelu", "layernorm", "ms_deform_attn",
                "clean_components", "connected_components", "flash_attention",
                "conv3x3")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()
_capturing = threading.local()  # .into: captured_launches' dict, per thread
build_seconds = None  # wall time of the build this process ran (None: reused)
build_log = {}  # source name -> nvcc's stderr (ptxas -v), from a verbose build

# launch entry point -> the C struct of its arguments, in the notation of
# the struct module with native alignment: P a pointer (0 for null), i an
# int, f a float
_ARGS = {
    # (q, k, v, rel_h, rel_w, out, BH, N, D, kh, kw, scale, stream)
    "ik_relpos_attention": "PPPPPPiiiiifP",
    # (a, w, bias, out, M, N, K, gelu, bn, grid, stream)
    "ik_linear_bias_act": "PPPPiiiiiiP",
    # (x, y, scale, bias, sum_out, out, rows, C, lanes, vpl, threads, eps,
    #  is_bf16, stream)
    "ik_layernorm": "PPPPPPiiiiifiP",
    # (value, loc, attn, out, B, S, Lq, heads, n_levels, n_points, is_bf16,
    #  8 level heights, 8 widths, 8 token offsets, stream)
    "ik_ms_deform_attn": "PPPP7i24iP",
    # (mask, labels, N, H, W, stream)
    "ik_connected_components": "PPiiiP",
    # (mask, out, labels, cells, N, H, W, min_area, min_aspect, stream)
    "ik_clean_components": "PPPPiiiifP",
    # (q, k, v, out, BH, N, D, scale, stream)
    "ik_flash_attention": "PPPPiiifP",
    # (x, w, out, partial, B, H, W, C, Cout, bh, bw, bn, splits, full, grid,
    #  stream)
    "ik_conv3x3": "PPPPiiiiiiiiiiiP",
}
# queries off the launch path: name -> (argtypes, restype)
_QUERIES = {
    # (D, rel) -> dynamic shared memory bytes of that attention instance
    "ik_attention_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    # (bn) -> dynamic shared memory bytes of that GEMM instance
    "ik_gemm_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    # (bn) -> dynamic shared memory bytes of that convolution instance
    "ik_conv_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "ik_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class _Entry:
    """A launch entry point: packs its arguments into the struct buffer
    bound to it and passes the buffer's address; returns the CUDA status."""

    __slots__ = ("_pack", "_buf", "_addr", "_fn", "_lock")

    def __init__(self, fn, fmt: str):
        layout = struct.Struct("@" + fmt)
        self._buf = ctypes.create_string_buffer(layout.size)
        self._addr = ctypes.addressof(self._buf)
        self._pack = layout.pack_into
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        self._lock = threading.Lock()

    def __call__(self, *args) -> int:
        with self._lock:
            self._pack(self._buf, 0, *args)
            return self._fn(self._addr)


class Library:
    """A loaded kernel library: the launch entry points of :data:`_ARGS`
    and the queries of :data:`_QUERIES` as attributes."""

    def __init__(self, path: str):
        handle = ctypes.PyDLL(path)
        for name, fmt in _ARGS.items():
            setattr(self, name, _Entry(getattr(handle, name), fmt))
        for name, (argtypes, restype) in _QUERIES.items():
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = argtypes, restype
            setattr(self, name, fn)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def count_launch(name: str, instance: str = "") -> None:
    into = getattr(_capturing, "into", None)
    if into is not None:  # this thread is capturing a graph: nothing ran
        into[name] = into.get(name, 0) + 1
        if instance:
            key = f"{name}/{instance}"
            into[key] = into.get(key, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1
        if instance:
            key = f"{name}/{instance}"
            LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """``with captured_launches() as counts:`` this thread's launches while
    open go into ``counts`` ({counter: launches}), not into
    :data:`LAUNCHES`: for a CUDA graph capture, which launches nothing
    until the graph is replayed.  Other threads count as usual."""
    outer = getattr(_capturing, "into", None)
    counts = _capturing.into = {}
    try:
        yield counts
    finally:
        _capturing.into = outer


def add_launches(counts: dict) -> None:
    """Add ``counts`` ({counter: launches}, instance keys included) to
    :data:`LAUNCHES`: one replay of a graph captured with
    :func:`captured_launches`."""
    with _count_lock:
        for key, n in counts.items():
            LAUNCHES[key] = LAUNCHES.get(key, 0) + n


def _sources(csrc_dir: str = CSRC_DIR):
    return sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))
                  + glob.glob(os.path.join(csrc_dir, "*.cuh")))


def _source_hash(csrc_dir: str = CSRC_DIR) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(csrc_dir):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def build(verbose: bool = False, csrc_dir: str = CSRC_DIR,
          build_dir: str = BUILD_DIR) -> str:
    """Compile the kernel library of ``csrc_dir`` if no build of these
    sources exists in ``build_dir``; returns its path.  ``verbose`` adds
    ``-Xptxas -v`` and keeps each source's compiler messages (registers,
    shared memory and spills per kernel) in :data:`build_log`."""
    global build_seconds
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir,
                        f"libinklayer_kernels_{_source_hash(csrc_dir)}.so")
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in _sources(csrc_dir) if p.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-I", csrc_dir, "-c", "-o", obj, src]
        jobs.append((os.path.basename(src), obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, objs = [], []
    for name, obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n{err}")
        elif verbose:
            build_log[name] = err
        objs.append(obj)
    if not errors:
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"nvcc link failed ({res.returncode}):\n"
                          f"{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def load(path: str) -> Library:
    """A built kernel library with its entry points bound."""
    return Library(path)


def lib() -> Library:
    """The loaded kernel library (built and loaded on first use, under a
    lock; afterwards a plain read)."""
    global _lib
    handle = _lib
    if handle is None:
        with _lock:
            if _lib is None:
                _lib = load(build())
            handle = _lib
    return handle


def check(status: int, name: str) -> None:
    if status != 0:
        msg = lib().ik_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({msg})")


def stream(device_index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device
    ``device_index`` (``tensor.get_device()``), as an int."""
    return torch._C._cuda_getCurrentRawStream(device_index)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
