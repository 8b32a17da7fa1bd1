"""Where a kernel runs: the device rule of the port, and its one switch.

Every op that has a hand-written CUDA kernel decides by the tensor it is
given:

* a tensor on a CUDA device goes to the kernel, which launches or raises;
* a tensor on the CPU goes to the op's plain PyTorch version.

There is no fallback from a failed build or launch to the plain version,
and no fallback from a missing card to the CPU.

One switch overrides the rule: inside :func:`disable_kernels`, CUDA
tensors take the plain versions too.  It is the JAX package's own training
rule (``inklayer_tpu.runtime.disable_pallas``): the kernels are
forward-only and bf16-only, and a training step differentiates its
forward in float32.  :meth:`parallel.train.Trainer.train_step` enters
it, and the multi-rank dry run (``parallel/dryrun.py``), whose fp32 tiny
models are below the kernels' shapes, as the JAX dry run's CPU devices
run XLA.  It is never entered on a failure or a missing card.
"""

from __future__ import annotations

import contextlib

import torch

_disable_depth = 0
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def _refuse_dtensor(t) -> None:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        raise TypeError(
            f"a DTensor ({t.placements} over {t.device_mesh}) reached a "
            f"kernel op: ops take this rank's plain local tensors "
            f"(parallel/tp.py); a DTensor's data_ptr() is not the shard")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the op must launch its CUDA kernel for these tensors.

    All tensors must lie on one device type; anything but CUDA or CPU is
    refused, so no tensor silently takes the plain path on an accelerator
    the kernels were not written for.  A DTensor is refused on any device:
    the kernels read raw pointers, and the ops take local tensors."""
    for t in tensors:  # the launch path: no device objects
        if type(t) not in _PLAIN:
            _refuse_dtensor(t)
    for t in tensors:
        if not t.is_cuda:
            break
    else:
        return _disable_depth == 0
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(types)}")
    kind = types.pop()
    if kind == "cuda":
        return _disable_depth == 0
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device type {kind!r}")


@contextlib.contextmanager
def disable_kernels():
    """Run every op's plain version, on the card too, while the context is
    open (a counted depth: contexts nest).  For the train step only; see
    the module docstring."""
    global _disable_depth
    _disable_depth += 1
    try:
        yield
    finally:
        _disable_depth -= 1


def resolve_device(device) -> torch.device:
    """The device a model is built on (``build.build_pipeline``).  A CUDA
    device that does not exist raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return dev
