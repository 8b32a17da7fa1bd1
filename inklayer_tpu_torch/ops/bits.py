"""Mask read-backs: bit-packed stacks, uint8 label maps of disjoint
stacks, and several results in one read-back (port of
:mod:`inklayer_tpu.ops.bits`).

On the card every read-back is a ``non_blocking`` copy into pinned host
memory, followed by a CUDA event recorded on the stream that produced the
data (the calling thread's current stream).  The ``*_readback`` functions
enqueue the copies and return a function that waits on that event only
(in a ``wait`` span, :mod:`inklayer_tpu_torch.spans`),
never on the device as a whole, and then returns the host arrays: the run
enqueues a stack's copy on its own thread, behind the work that made it,
and a writer thread waits for it without blocking on whatever the run
enqueues next.  On the CPU the same functions hand back the tensors'
memory.  ``masks_to_host``, ``disjoint_masks_to_host`` and
``batched_final_readback`` are the blocking forms the JAX package has;
:func:`to_host` is the blocking read of one tensor.
:func:`masks_to_device` is the upload: ``np.packbits`` rows, unpacked
where they land.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from inklayer_tpu_torch.spans import span

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits order, MSB first


def readback(tensors: Sequence[torch.Tensor]
             ) -> Callable[[], List[np.ndarray]]:
    """Start copying ``tensors`` to the host; the returned function waits
    for the copies and returns them as numpy arrays, in order."""
    if not any(t.is_cuda for t in tensors):
        host = [t.detach().contiguous() for t in tensors]
        return lambda: [t.numpy() for t in host]
    host = []
    for t in tensors:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host.append(buf)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))

    def wait() -> List[np.ndarray]:
        with span("wait"):
            done.synchronize()
        return [b.numpy() for b in host]

    return wait


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array: a blocking read, in a ``wait`` span."""
    with span("wait"):
        return t.cpu().numpy()


def pack_bits(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., ceil(W/8)) uint8, bit order of np.packbits
    (MSB first)."""
    w = masks.shape[-1]
    pad = (8 - w % 8) % 8
    m = masks.to(torch.uint8)
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    shaped = m.reshape(*m.shape[:-1], -1, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=m.device)
    return (shaped * weights).sum(-1, dtype=torch.uint8)


def unpack_bits_host(packed: np.ndarray, width: int) -> np.ndarray:
    """(..., ceil(W/8)) uint8 host array -> (..., W) bool."""
    return np.unpackbits(packed, axis=-1)[..., :width].astype(bool)


def masks_readback(masks: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start a packed read-back of (..., H, W) bool masks; the returned
    function waits and returns them as a host bool array."""
    if masks.numel() == 0:
        shape = tuple(masks.shape)
        return lambda: np.zeros(shape, bool)
    w = masks.shape[-1]
    wait = readback([pack_bits(masks)])
    return lambda: unpack_bits_host(wait()[0], w)


def masks_to_host(masks: torch.Tensor) -> np.ndarray:
    """Device (..., H, W) bool -> host bool via a packed transfer."""
    return masks_readback(masks)()


def _label_map_u8(masks: torch.Tensor):
    """(N, H, W) bool -> ((H, W) uint8 label map, 0 = background and i+1 =
    mask i; 0-dim bool: no pixel lies in two masks).  For a disjoint stack
    this is 1 byte per pixel against N/8 for the packed planes."""
    n = masks.shape[0]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=masks.device)
    lab = (masks * idx[:, None, None]).amax(0)
    ok = (masks.sum(0, dtype=torch.int32) <= 1).all()
    return lab.to(torch.uint8), ok


def _labels_to_masks(lab: np.ndarray, n: int) -> np.ndarray:
    return lab[None, :, :] == np.arange(1, n + 1, dtype=np.uint8)[:, None,
                                                                    None]


def disjoint_masks_to_host(masks: torch.Tensor) -> np.ndarray:
    """Device (N, H, W) bool DISJOINT masks -> host bool via one uint8
    label-map transfer; the packed transfer where the masks overlap or
    N > 255."""
    n = masks.shape[0]
    if n == 0:
        return np.zeros(tuple(masks.shape), bool)
    if n > 255:
        return masks_to_host(masks)
    lab, ok = readback(list(_label_map_u8(masks)))()
    if not bool(ok):
        return masks_to_host(masks)
    return _labels_to_masks(lab, n)


def final_readback(stacks: Sequence[torch.Tensor],
                   arrays: Sequence[torch.Tensor] = (),
                   with_labels: bool = False) -> Callable[[], tuple]:
    """Start ONE read-back of several DISJOINT mask stacks and extra
    tensors; the returned function waits and returns (list of (N, H, W)
    bool host stacks, list of host extras) and, with ``with_labels``, the
    per-stack uint8 label maps (0 = background, i+1 = stack[i]; None for
    empty, packed or overlapping stacks)."""
    reqs, payload = [], []
    for stk in stacks:
        n = stk.shape[0]
        if n == 0:
            reqs.append(("empty", tuple(stk.shape)))
        elif n > 255:
            reqs.append(("packed", stk.shape[-1]))
            payload.append(pack_bits(stk))
        else:
            reqs.append(("label", (n, stk)))
            payload.extend(_label_map_u8(stk))
    payload.extend(arrays)
    wait = readback(payload) if payload else (lambda: [])

    def finish():
        flat = wait()
        out, labels, i = [], [], 0
        for kind, meta in reqs:
            if kind == "empty":
                out.append(np.zeros(meta, bool))
                labels.append(None)
            elif kind == "packed":
                out.append(unpack_bits_host(flat[i], meta))
                labels.append(None)
                i += 1
            else:
                n, stk = meta
                lab, ok = flat[i], flat[i + 1]
                i += 2
                if bool(ok):
                    out.append(_labels_to_masks(lab, n))
                    labels.append(lab)
                else:  # an overlapping stack (none is by construction)
                    out.append(masks_to_host(stk))
                    labels.append(None)
        if with_labels:
            return out, list(flat[i:]), labels
        return out, list(flat[i:])

    return finish


def batched_final_readback(stacks, arrays=(), with_labels=False):
    """The blocking form of :func:`final_readback`."""
    return final_readback(stacks, arrays, with_labels)()


def masks_to_device(masks: np.ndarray, device) -> torch.Tensor:
    """Host (..., H, W) bool -> (..., H, W) bool on ``device`` through a
    packed upload (``np.packbits`` rows, 8 pixels a byte; any width), as
    :func:`inklayer_tpu.ops.bits.masks_to_device`."""
    masks = np.asarray(masks, bool)
    if masks.size == 0:
        return torch.zeros(masks.shape, dtype=torch.bool, device=device)
    w = masks.shape[-1]
    packed = torch.from_numpy(np.packbits(masks, axis=-1))
    if torch.device(device).type == "cuda":
        packed = packed.pin_memory()
    return unpack_bits(packed.to(device, non_blocking=True), w)


def unpack_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """(..., ceil(W/8)) uint8 -> (..., W) bool where ``packed`` lies (the
    inverse of :func:`pack_bits`)."""
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                           device=packed.device)
    bits = (packed[..., None] & weights) > 0
    return bits.reshape(*packed.shape[:-1], -1)[..., :width].contiguous()
