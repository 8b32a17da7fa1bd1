"""The multi-rank dry run (counterpart of ``__graft_entry__.py``
``dryrun_multichip``).

    python -m inklayer_tpu_torch.parallel.dryrun 4 [--cpu]

:func:`dryrun_multichip` starts ``n`` ranks (:func:`mesh.spawn`: one
process each, a ``file://`` rendezvous, a bounded wait) on the card, or on
the CPU when asked.  Each rank builds the JAX dry run's tiny SAM and
GroundingDINO from one seed and holds three things to the single-process
result, which it computes itself first:

* a tp SAM encode (tp = 4 where 4 divides n, else 2), its dp slice of 2
  images;
* a dp = n GroundingDINO forward on n images, this rank's rows;
* one SAM train step (focal + dice + IoU loss on a batch of 4) over the
  JAX dry run's mesh (tp = 2, fsdp = 2 where they divide n, dp the rest):
  loss and gradient norm.

Everything runs in float32 with TF32 off.  The tiny models' head dims are
below what the kernels are built for, so the ranks run the plain versions
(:func:`runtime.disable_kernels`); chip_smoke phase 12 holds the kernels
on sharded models at full width.  Rank 0 prints ``dryrun_multichip OK:``
with the meshes.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Tuple

import numpy as np
import torch

from inklayer_tpu_torch.config import (BertConfig, GDinoConfig, SamConfig,
                                       SwinConfig)

# the JAX dry run's tiny configs (__graft_entry__.py:107-116, 168-178)
SAM_CFG = SamConfig(encoder_embed_dim=64, encoder_depth=2,
                    encoder_num_heads=4, encoder_global_attn_indexes=(1,),
                    encoder_window_size=2, image_size=64, patch_size=16,
                    prompt_embed_dim=32)
GDINO_CFG = GDinoConfig(
    hidden_dim=32, num_queries=12, enc_layers=1, dec_layers=1,
    dim_feedforward=64, nheads=4, enc_n_points=2, dec_n_points=2,
    max_text_len=16, fusion_embed_dim=64, fusion_nheads=2,
    text_enhancer_ffn=64,
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                    window_size=2),
    bert=BertConfig(vocab_size=30522, hidden_size=16, num_layers=1,
                    num_heads=2, intermediate_size=32),
    max_boxes=8)
CAPTION_IDS = np.asarray([[101, 4874, 1012, 102, 0, 0]], np.int64)
# sharded against single-process results (fp32; the JAX dry run's limits)
ATOL, RTOL = 2e-5, 1e-5
TRAIN_RTOL = 1e-5
TIMEOUT_S = 300.0


def train_mesh(n: int) -> Tuple[int, int, int]:
    """The JAX dry run's train mesh (__graft_entry__.py:120-123)."""
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % (tp * 2) == 0 else 1
    return n // (tp * fsdp), fsdp, tp


def tp_mesh(n: int) -> Tuple[int, int, int]:
    """The JAX dry run's inference tp (__graft_entry__.py:152-153), with
    dp the rest of the ranks (a mesh holds every rank)."""
    tp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return n // tp, 1, tp


def sam_loss(model, batch) -> torch.Tensor:
    """The JAX dry run's loss: per image, box-prompted SAM, focal + dice +
    IoU, averaged."""
    from inklayer_tpu_torch.parallel.train import sam_mask_loss

    losses = [sam_mask_loss(*_first(model(img[None], box[None])), tgt[None])
              for img, box, tgt in zip(batch["image"], batch["boxes"],
                                       batch["target"])]
    return torch.stack(losses).mean()


def _first(out):
    logits, iou = out
    return logits[:, 0], iou


def gdino_inputs(b: int, size: int, rng: np.random.Generator) -> list:
    from inklayer_tpu_torch.models.gdino.bert import subsentence_masks

    attn, pos = subsentence_masks(CAPTION_IDS)
    rep = lambda a: torch.from_numpy(np.repeat(a, b, axis=0))
    img = torch.from_numpy(rng.standard_normal((b, size, size, 3)).astype(
        np.float32))
    return [img, torch.zeros((b, size, size), dtype=torch.bool),
            rep(CAPTION_IDS), rep(attn), rep(pos)]


def _close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{what}: non-finite entries differ")
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if not torch.allclose(got[fin], want[fin], atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{what}: max abs error {err:.3g} (atol "
                             f"{ATOL}, rtol {RTOL})")
    return err


def _rank_main(n: int, device: str) -> None:
    import torch.distributed as dist

    from inklayer_tpu_torch.models.gdino import GroundingDINO
    from inklayer_tpu_torch.models.sam import Sam
    from inklayer_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from inklayer_tpu_torch.parallel.sharding import apply_tp, shard_batch
    from inklayer_tpu_torch.parallel.train import Trainer
    from inklayer_tpu_torch.runtime import disable_kernels

    dev = init_distributed(device)
    if dist.get_world_size() != n:
        raise ValueError(f"{dist.get_world_size()} ranks, asked for {n}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    sam = Sam(SAM_CFG).to(dev)
    torch.manual_seed(1)
    gdino = GroundingDINO(GDINO_CFG).to(dev)
    size = SAM_CFG.image_size
    x = torch.from_numpy(rng.standard_normal((2, size, size, 3)).astype(
        np.float32)).to(dev)

    with disable_kernels(), torch.no_grad():
        # tp SAM encode against this rank's single-process encode
        shape = tp_mesh(n)
        ref = sam.encode(x)
        mesh = make_mesh(*shape, device_type=dev.type)
        sharded = copy.deepcopy(sam)
        layout = apply_tp(sharded, mesh)
        if shape[2] > 1 and not layout:
            raise AssertionError("the tp axis partitioned nothing")
        mine = shard_batch({"x": x, "ref": ref}, mesh)
        enc_err = _close("tp SAM encode", sharded.encode(mine["x"]),
                         mine["ref"])
        del sharded

        # dp GroundingDINO against the rows of the batched forward
        inputs = [t.to(dev) for t in gdino_inputs(n, 64, rng)]
        ref_logits, ref_boxes = gdino(*inputs)
        mesh_dp = make_mesh(n, 1, 1, device_type=dev.type)
        mine = shard_batch(dict(enumerate(inputs + [ref_logits, ref_boxes])),
                           mesh_dp)
        logits, boxes = gdino(*(mine[i] for i in range(5)))
        det_err = max(_close("dp GDINO boxes", boxes, mine[6]),
                      _close("dp GDINO logits", logits, mine[5]))

    # one train step over the mesh against the single-process step
    batch = {"image": np.zeros((4, size, size, 3), np.float32),
             "boxes": np.tile(np.asarray([[4.0, 4.0, 40.0, 30.0]],
                                         np.float32), (4, 1)),
             "target": np.zeros((4, size // 4, size // 4), np.float32)}
    batch["target"][:, 2:8, 2:8] = 1.0
    single = Trainer(sam_loss, copy.deepcopy(sam), max_grad_norm=1.0)
    want = float(single.train_step(batch))
    want_norm = float(single.grad_norm)
    tshape = train_mesh(n)
    trainer = Trainer(sam_loss, sam, mesh=tshape, max_grad_norm=1.0)
    got = float(trainer.train_step(batch))
    got_norm = float(trainer.grad_norm)
    for what, g, w in (("loss", got, want), ("grad norm", got_norm,
                                             want_norm)):
        if not (np.isfinite(g) and abs(g - w) <= TRAIN_RTOL * abs(w)):
            raise AssertionError(f"train step over {tshape}: {what} {g!r}, "
                                 f"single process {w!r}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: {n} ranks on {dev.type}; train mesh "
              f"dp={tshape[0]} fsdp={tshape[1]} tp={tshape[2]}, loss "
              f"{got:.6f} (single process {want:.6f}), grad norm "
              f"{got_norm:.6g}; inference meshes: tp={shape[2]} (dp="
              f"{shape[0]}) SAM encode (max abs error {enc_err:.3g}) + "
              f"dp={n} GDINO detect ({det_err:.3g}) match single-process",
              flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n: int, device=None, timeout: float = TIMEOUT_S) -> str:
    """Run the dry run on ``n`` ranks (on the card unless ``device`` is
    "cpu") and return rank 0's ``dryrun_multichip OK`` line; raises when a
    rank fails or the ranks outlast ``timeout`` seconds."""
    from inklayer_tpu_torch.parallel.mesh import spawn

    import os

    import inklayer_tpu_torch

    cpu = device is not None and torch.device(device).type == "cpu"
    root = os.path.dirname(os.path.dirname(inklayer_tpu_torch.__file__))
    outs = spawn(n, ["-m", "inklayer_tpu_torch.parallel.dryrun", str(n),
                     "--worker"] + (["--cpu"] if cpu else []), timeout,
                 cpu=cpu, cwd=root)
    line = next(l for l in outs[0].splitlines()
                if l.startswith("dryrun_multichip OK"))
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)  # one rank of a started run
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.worker:
        _rank_main(args.n, device)
    else:
        dryrun_multichip(args.n, device)


if __name__ == "__main__":
    main(sys.argv[1:])
