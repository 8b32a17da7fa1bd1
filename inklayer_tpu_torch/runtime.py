"""Where a kernel runs: the device rule of the port.

Every op that has a hand-written CUDA kernel decides by the tensor it is
given, never by a global switch:

* a tensor on a CUDA device goes to the kernel, which launches or raises;
* a tensor on the CPU goes to the op's plain PyTorch version.

There is no fallback from a failed build or launch to the plain version,
and no fallback from a missing card to the CPU.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the op must launch its CUDA kernel for these tensors.

    All tensors must lie on one device type; anything but CUDA or CPU is
    refused, so no tensor silently takes the plain path on an accelerator
    the kernels were not written for."""
    for t in tensors:  # the launch path: no device objects
        if not t.is_cuda:
            break
    else:
        return True
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(types)}")
    kind = types.pop()
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device type {kind!r}")


def resolve_device(device) -> torch.device:
    """The device a model is built on (``build.build_pipeline``).  A CUDA
    device that does not exist raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return dev
