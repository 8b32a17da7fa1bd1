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
  world;
* ``gdino_tp_single.npz``: the one-process GroundingDINO forward of
  ``GDINO_TP_CFG`` on 2 images; ``gdino_tp2_{r}.npz``: rank r's forward
  over (2, 1, 2) (its dp index's image, its rank's heads);
  ``gdino_tp4.npz``: the forward over (1, 1, 4); ``gdino_tp4_state.npz``:
  ``full_state_dict`` after the tp = 4 plan;
* ``sam_decoder_tp.npz``: the tiny SAM's box-prompted masks and IoU in
  one process and with its mask decoder over (2, 1, 2).

    python -m torch.distributed.run ... tests/torch_mesh_worker.py DIR
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from inklayer_tpu_torch.config import (BertConfig, GDinoConfig,  # noqa: E402
                                       SwinConfig)
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


# the dry run's tiny GroundingDINO with heads that tp = 4 splits, but for
# Swin's stages 0 (1 head: whole at tp = 2 and 4) and 1 (2 heads: whole at
# tp = 4)
GDINO_TP_CFG = dataclasses.replace(
    dryrun.GDINO_CFG, fusion_nheads=4,
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 4),
                    window_size=2),
    bert=BertConfig(vocab_size=30522, hidden_size=16, num_layers=1,
                    num_heads=4, intermediate_size=32))
GDINO_IN = ("image", "pad", "ids", "attn", "pos")
SAM_BOXES = np.asarray([[4.0, 6.0, 40.0, 30.0], [10.0, 2.0, 60.0, 62.0],
                        [0.0, 0.0, 20.0, 20.0]], np.float32)


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


def tp_jobs(root: str, rank: int) -> None:
    """The head-parallel plans: GroundingDINO over tp = 2 and 4, SAM's
    mask decoder over tp = 2, and the state dict gathered back."""
    state = load(os.path.join(root, "gdino_tp.npz"))
    inputs = load(os.path.join(root, "detect_tp_in.npz"))

    def model():
        m = GroundingDINO(GDINO_TP_CFG).eval()
        m.load_state_dict(state)
        return m

    single = model()(*(inputs[k] for k in GDINO_IN))
    if rank == 0:
        np.savez(os.path.join(root, "gdino_tp_single.npz"),
                 logits=single[0].numpy(), boxes=single[1].numpy())
    mesh = make_mesh(2, 1, 2, device_type="cpu")
    m = model()
    apply_tp(m, mesh)
    mine = shard_batch(inputs, mesh)
    logits, boxes = m(*(mine[k] for k in GDINO_IN))
    np.savez(os.path.join(root, f"gdino_tp2_{rank}.npz"), logits=logits,
             boxes=boxes, dp=mesh.get_local_rank("dp"),
             layout=sorted(m.tp_layout))
    mesh = make_mesh(1, 1, 4, device_type="cpu")
    m = model()
    apply_tp(m, mesh)
    logits, boxes = m(*(inputs[k] for k in GDINO_IN))
    sd = full_state_dict(m, mesh)
    if rank == 0:
        np.savez(os.path.join(root, "gdino_tp4.npz"), logits=logits,
                 boxes=boxes, layout=sorted(m.tp_layout))
        np.savez(os.path.join(root, "gdino_tp4_state.npz"),
                 **{k: v.numpy() for k, v in sd.items()})

    sam = Sam(dryrun.SAM_CFG).eval()
    sam.load_state_dict(load(os.path.join(root, "sam.npz")))
    x = torch.from_numpy(np.load(os.path.join(root, "x.npy"))[:1])
    boxes = torch.from_numpy(SAM_BOXES)
    ref = sam(x, boxes)
    layout = apply_tp(sam.mask_decoder, make_mesh(2, 1, 2,
                                                  device_type="cpu"))
    out = sam(x, boxes)
    if rank == 0:
        np.savez(os.path.join(root, "sam_decoder_tp.npz"),
                 single_masks=ref[0], single_iou=ref[1], masks=out[0],
                 iou=out[1], layout=sorted(layout))


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

    with torch.no_grad():
        tp_jobs(root, rank)

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
