"""The (dp, fsdp, tp) device mesh of the port (counterpart of
:mod:`inklayer_tpu.parallel.mesh`), one process per rank.

The JAX package runs one controller over every device of a mesh and lets
XLA insert the collectives.  The port runs one process per rank, launched
by ``torchrun`` (``python -m torch.distributed.run``) or by :func:`spawn`,
and names its collectives itself (``torch.distributed``):

  dp   — data parallel over images (each dp group takes its batch slice),
  fsdp — parameter sharding (FSDP2 ``fully_shard``, HSDP with dp),
  tp   — tensor parallel over attention heads and MLP hidden units.

:func:`init_distributed` joins the process group; :func:`make_mesh` builds
the ``DeviceMesh`` over all of its ranks.  A mesh must hold every rank: a
rank outside it would have no work (the JAX mesh may take the first devices
of a larger set).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")
# the rendezvous of ranks that :func:`spawn` starts (torchrun sets env://)
INIT_ENV = "INKLAYER_DIST_INIT"


def backend_for(device_type: str, world_size: int, device_count: int) -> str:
    """The process group's backend, by a fixed rule: ``nccl`` when every
    rank has a card of its own; ``gloo`` on the CPU and where ranks share
    a card.  NCCL refuses two ranks on one device; gloo carries the
    all-reduce of CUDA tensors there (chip_smoke phase 12 probes both)."""
    if device_type == "cuda" and world_size <= device_count:
        return "nccl"
    return "gloo"


def init_distributed(device: Optional[str] = None) -> torch.device:
    """Join the process group of this rank (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` from ``torchrun`` or :func:`spawn`) and return its
    device: ``cuda:{LOCAL_RANK % device_count}`` unless ``device`` is
    ``"cpu"``.  Idempotent.  Rank 0 prints the backend once."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA card (pass "
                               "device='cpu' to run the ranks on the CPU)")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend_for(dev.type, world, cards)
    dist.init_process_group(backend,
                            init_method=os.environ.get(INIT_ENV, "env://"),
                            rank=rank, world_size=world)
    if rank == 0:
        print(f"[mesh] {world} ranks on {dev.type}"
              f"{f' ({cards} cards)' if cards else ''}: backend {backend}",
              flush=True)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
              device_type: Optional[str] = None):
    """``init_device_mesh`` of shape (dp, fsdp, tp) over every rank, with
    ``mesh_dim_names`` ("dp", "fsdp", "tp"), on ``device_type`` (the
    ranks' tensors: "cuda" where a card exists unless given).  Raises the
    JAX message when the world is smaller, and also when it is larger."""
    need = dp * fsdp * tp
    have = world_size()
    if need > have:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {need} devices, "
                         f"have {have}")
    if need < have:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} holds {need} of {have} "
                         f"ranks: a rank outside the mesh has no work")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (dp, fsdp, tp),
                            mesh_dim_names=AXES)


def auto_mesh_shape(n: int) -> Tuple[int, int, int]:
    """The JAX package's default layout: tp is the first of 8, 4, 2 that
    divides n, dp the rest."""
    tp = next((c for c in (8, 4, 2) if n % c == 0 and c <= n), 1)
    return n // tp, 1, tp


def auto_mesh(n: Optional[int] = None, device_type: Optional[str] = None):
    return make_mesh(*auto_mesh_shape(world_size() if n is None else n),
                     device_type=device_type)


def mesh_shape(mesh) -> Tuple[int, int, int]:
    return tuple(mesh.size(i) for i in range(3))


def spawn(n: int, argv: Sequence[str], timeout: float,
          cpu: bool = True, env: Optional[dict] = None,
          cwd: Optional[str] = None) -> List[str]:
    """Run ``python argv`` as ``n`` ranks of one process group (a
    ``file://`` rendezvous in a fresh temporary directory, no port) and
    return each rank's standard output.  Every rank is killed when one
    fails or ``timeout`` seconds pass; either raises with the ranks'
    messages.  CPU ranks get ``OMP_NUM_THREADS=1``."""
    with tempfile.TemporaryDirectory(prefix="inklayer_ranks_") as tmp:
        base = dict(os.environ, **(env or {}))
        base[INIT_ENV] = "file://" + os.path.join(tmp, "rendezvous")
        base["WORLD_SIZE"] = str(n)
        if cpu:
            base["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        for rank in range(n):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log,
                stderr=subprocess.STDOUT, cwd=cwd, text=True,
                env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank))))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                failed = next((i for i, p in enumerate(procs)
                               if p.returncode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            else:
                failed = next((i for i, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        if failed is not None or any(p.returncode != 0 for p in procs):
            why = ("timed out after {:.0f} s".format(timeout)
                   if failed is None else f"rank {failed} failed")
            tail = "\n".join(f"--- rank {i} (exit {p.returncode}) ---\n"
                             f"{o[-4000:]}" for i, (p, o) in
                             enumerate(zip(procs, outs)))
            raise RuntimeError(f"{n} ranks of {' '.join(argv)}: {why}\n"
                               f"{tail}")
        return outs
