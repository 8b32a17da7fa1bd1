"""One rank of the mesh parity job of ``test_torch_mesh.py``: imports only
the port (no jax).  The test writes the inputs and the converted weights
under DIR; every rank runs the same work, and rank 0 writes the results:

* ``encode.npy``: the SAM encode over a (1, 1, 4) mesh (head-parallel);
* ``detect_{r}.npz``: rank r's rows of the GroundingDINO forward over a
  (4, 1, 1) mesh;
* ``{name}.npz`` for each train job of ``jobs.json``: the losses, the
  first step's gradients (clipped, whole) and grad norm, and the whole
  parameters after the last step;
* ``mesh_errors.json``: ``make_mesh`` on shapes that do not fill the
  world.

    python -m torch.distributed.run ... tests/torch_mesh_worker.py DIR
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from inklayer_tpu_torch.models.gdino import GroundingDINO  # noqa: E402
from inklayer_tpu_torch.models.sam import Sam  # noqa: E402
from inklayer_tpu_torch.parallel import dryrun  # noqa: E402
from inklayer_tpu_torch.parallel.mesh import (init_distributed,  # noqa: E402
                                              make_mesh)
from inklayer_tpu_torch.parallel.sharding import (apply_tp,  # noqa: E402
                                                  full_state_dict,
                                                  shard_batch, tp_group)
from inklayer_tpu_torch.parallel.tp import gather_tp  # noqa: E402
from inklayer_tpu_torch.parallel.train import Trainer, adamw  # noqa: E402
from inklayer_tpu_torch.scripts import train as cli  # noqa: E402


def load(path):
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def whole_grads(trainer) -> dict:
    """Every parameter's gradient, gathered over fsdp and tp (collective)."""
    layout = trainer.model.tp_layout
    tp = tp_group(trainer.mesh)
    out = {}
    for name, p in trainer.model.named_parameters():
        g = p.grad.full_tensor()
        if name in layout:
            g = gather_tp(g, *layout[name], tp)
        out[name] = g.numpy()
    return out


def train_job(root: str, job: dict, rank: int) -> None:
    args = cli.parse_args(["--task", job["task"], "--synthetic", "2",
                           "--image_size", str(job["size"])])
    cfg, size = cli.task_config(args)
    t = cli.make_task(job["task"], cfg, size, np.random.default_rng(0))
    t.model.load_state_dict(load(os.path.join(root, job["params"])),
                            strict=True)
    batch = {k: v.numpy() for k, v in
             load(os.path.join(root, job["batch"])).items()}
    trainer = Trainer(t.loss_fn, t.model, mesh=tuple(job["mesh"]),
                      optimizer=lambda ps: adamw(ps, job["lr"]),
                      max_grad_norm=1.0)
    losses, grads, norm = [], None, None
    for step in range(job["steps"]):
        losses.append(float(trainer.train_step(batch)))
        if step == 0:
            norm = float(trainer.grad_norm)
            grads = whole_grads(trainer)
    params = full_state_dict(trainer.model, trainer.mesh)
    if rank == 0:
        np.savez(os.path.join(root, f"{job['name']}.npz"),
                 losses=np.asarray(losses), grad_norm=np.asarray(norm),
                 **{f"grad/{k}": v for k, v in grads.items()},
                 **{f"param/{k}": v.numpy() for k, v in params.items()})


def main(root: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cpu")
    rank = torch.distributed.get_rank()
    with torch.no_grad():
        sam = Sam(dryrun.SAM_CFG)
        sam.load_state_dict(load(os.path.join(root, "sam.npz")))
        mesh = make_mesh(1, 1, 4, device_type="cpu")
        apply_tp(sam, mesh)
        x = torch.from_numpy(np.load(os.path.join(root, "x.npy")))
        out = sam.encode(x)
        if rank == 0:
            np.save(os.path.join(root, "encode.npy"), out.numpy())

        gdino = GroundingDINO(dryrun.GDINO_CFG)
        gdino.load_state_dict(load(os.path.join(root, "gdino.npz")))
        inputs = load(os.path.join(root, "detect_in.npz"))
        mine = shard_batch(inputs, make_mesh(4, 1, 1, device_type="cpu"))
        logits, boxes = gdino(*(mine[k] for k in ("image", "pad", "ids",
                                                  "attn", "pos")))
        np.savez(os.path.join(root, f"detect_{rank}.npz"),
                 logits=logits.numpy(), boxes=boxes.numpy())

    errors = {}
    for shape in ((1, 1, 2), (2, 1, 4)):
        try:
            make_mesh(*shape, device_type="cpu")
        except ValueError as e:
            errors["x".join(map(str, shape))] = str(e)
    if rank == 0:
        with open(os.path.join(root, "mesh_errors.json"), "w") as f:
            json.dump(errors, f)

    with open(os.path.join(root, "jobs.json")) as f:
        for job in json.load(f):
            train_job(root, job, rank)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
