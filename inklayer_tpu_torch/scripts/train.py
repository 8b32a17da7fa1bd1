"""Fine-tuning CLI of the PyTorch/CUDA port (port of the JAX package's
``scripts/train.py``): three task recipes, one card.

    python -m inklayer_tpu_torch.scripts.train --task sam --data DIR \
        --steps 100 --ckpt CKPT_DIR
    python -m inklayer_tpu_torch.scripts.train --task depth --synthetic 8 \
        --steps 3 --cpu
    torchrun --standalone --nproc_per_node 4 \
        -m inklayer_tpu_torch.scripts.train --task sam --data DIR \
        --batch 2 --dp 2 --tp 2 --ckpt CKPT_DIR

Same flags as the JAX CLI, plus ``--models_dir`` (the reference
checkpoints under the file names ``build.build_pipeline`` reads; a model
without one gets seeded placeholder params, as there).  It trains on the
card unless ``--cpu`` is given, in float32, on the plain PyTorch versions
of every op (:class:`parallel.train.Trainer`).  ``--dp``, ``--fsdp`` and
``--tp`` make a mesh of dp * fsdp * tp ranks, one process each, under
``torchrun`` (``WORLD_SIZE`` must be that product); ``--batch`` is the
global batch.  Rank 0 prints and writes; checkpoints hold the whole
model (``sharding.full_state_dict``), so a mesh's checkpoint resumes a
single process and the other way round; ``--resume`` loads before the
model is sharded.

Data layout (per sample): ``<name>.png`` image plus
  sam:   ``<name>_mask.png`` binary target + ``<name>_boxes.json``
         [[x1, y1, x2, y2]]
  depth: ``<name>_depth.npy`` float target (H x W)
  gdino: ``<name>_boxes.json`` normalized cxcywh boxes
``--synthetic N`` draws a random in-memory dataset instead, the JAX CLI's
numbers for the same ``--seed``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from inklayer_tpu_torch.config import (BertConfig, DepthConfig, GDinoConfig,
                                       SamConfig, SwinConfig)

# the JAX CLI's tiny GroundingDINO for --synthetic at --image_size <= 128
# (its tests' TINY config)
GDINO_TINY = GDinoConfig(
    hidden_dim=32, num_queries=12, enc_layers=2, dec_layers=2,
    dim_feedforward=64, nheads=4, enc_n_points=2, dec_n_points=2,
    max_text_len=16, fusion_embed_dim=64, fusion_nheads=2,
    text_enhancer_ffn=64,
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                    window_size=2),
    bert=BertConfig(vocab_size=30522, hidden_size=16, num_layers=2,
                    num_heads=2, intermediate_size=32),
    max_boxes=8, shape_buckets=((64, 64), (64, 96)), resize_short=64,
    resize_max=96)
# the caption "object." padded to 6 tokens
CAPTION_IDS = np.asarray([[101, 4874, 1012, 102, 0, 0]], np.int64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", choices=("sam", "depth", "gdino"), default="sam")
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of --data")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir (save every --ckpt_every)")
    p.add_argument("--ckpt_every", type=int, default=50)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--image_size", type=int, default=0,
                   help="override model image size (synthetic debug)")
    p.add_argument("--models_dir", type=str, default=None,
                   help="directory of reference checkpoints")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def task_config(args):
    """(model config, input size) of the JAX CLI for these flags."""
    tiny = bool(args.synthetic)
    if args.task == "sam":
        size = args.image_size or 1024
        if tiny and size <= 128:
            return SamConfig(image_size=size, encoder_embed_dim=32,
                             encoder_depth=2, encoder_num_heads=2,
                             encoder_global_attn_indexes=(1,),
                             encoder_window_size=2, prompt_embed_dim=32), size
        return SamConfig(image_size=size), size
    if args.task == "depth":
        size = args.image_size or 518
        if tiny and size <= 140:
            return DepthConfig(embed_dim=32, depth=4, num_heads=2,
                               features=16, out_channels=(16, 16, 32, 32),
                               intermediate_layers=(0, 1, 2, 3),
                               input_size=size), size
        return DepthConfig(), size
    size = args.image_size or 800
    return (GDINO_TINY if tiny and size <= 128 else GDinoConfig()), size


def sam_task(cfg: SamConfig, rng: np.random.Generator):
    """SAM box-prompted mask fine-tuning: model, loss, synthetic and file
    samples."""
    from inklayer_tpu_torch.models.sam import Sam
    from inklayer_tpu_torch.parallel.train import sam_mask_loss

    low = cfg.image_size // 4

    def synth(_):
        img = rng.standard_normal(
            (cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        box = np.asarray([4.0, 4.0, cfg.image_size * 0.6,
                          cfg.image_size * 0.5], np.float32)
        mask = np.zeros((low, low), np.float32)
        mask[2: low // 2, 2: low // 2] = 1
        return {"image": img, "boxes": box[None], "mask": mask[None]}

    def load(path):
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), np.float32)
        base = path.rsplit(".", 1)[0]
        mask = np.asarray(
            Image.open(f"{base}_mask.png").convert("L").resize((low, low)),
            np.float32)[None] / 255.0
        with open(f"{base}_boxes.json") as f:
            boxes = np.asarray(json.load(f), np.float32)[:1]
        return {"image": img, "boxes": boxes, "mask": mask}

    def loss_fn(model, batch):
        losses = []
        for img, boxes, target in zip(batch["image"], batch["boxes"],
                                      batch["mask"]):
            logits, iou = model(img[None], boxes)
            losses.append(sam_mask_loss(logits[:, 0], iou[:, 0], target))
        return torch.stack(losses).mean()

    return SimpleNamespace(name="sam", model=Sam(cfg), loss_fn=loss_fn,
                           synth=synth, load=load, seed_offset=1,
                           ckpt="sam_vit_h_4b8939.pth", ignore=())


def depth_task(cfg: DepthConfig, size: int, rng: np.random.Generator):
    """Depth fine-tuning with the SiLog loss."""
    from inklayer_tpu_torch.io import weights
    from inklayer_tpu_torch.models.depth import DepthAnythingV2
    from inklayer_tpu_torch.ops.image import resize
    from inklayer_tpu_torch.parallel.train import silog_loss

    def synth(_):
        img = rng.standard_normal((size, size, 3)).astype(np.float32)
        d = rng.random((size, size)).astype(np.float32) + 0.1
        return {"image": img, "depth": d}

    def load(path):
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB").resize(
            (size, size)), np.float32) / 255.0
        d = np.load(path.rsplit(".", 1)[0] + "_depth.npy")
        return {"image": img, "depth": d.astype(np.float32)}

    def loss_fn(model, batch):
        losses = []
        for img, target in zip(batch["image"], batch["depth"]):
            pred = model(img[None])[0]
            # jax.image.resize(..., "bilinear"), antialiased
            pred = resize(pred, tuple(target.shape), "bilinear")
            losses.append(silog_loss(F.relu(pred) + 1e-3, target,
                                     target > 0))
        return torch.stack(losses).mean()

    return SimpleNamespace(name="depth", model=DepthAnythingV2(cfg),
                           loss_fn=loss_fn, synth=synth, load=load,
                           seed_offset=2,
                           ckpt=f"depth_anything_v2_{cfg.encoder}.pth",
                           ignore=weights.DEPTH_IGNORE)


def gdino_task(cfg: GDinoConfig, size: int, rng: np.random.Generator):
    """GroundingDINO fine-tuning with the DINO set loss on the caption
    "object." (its positive map points at token 1)."""
    from inklayer_tpu_torch.io import weights
    from inklayer_tpu_torch.models.gdino import GroundingDINO
    from inklayer_tpu_torch.models.gdino.bert import subsentence_masks
    from inklayer_tpu_torch.parallel.detection_loss import detection_loss

    attn, pos = subsentence_masks(CAPTION_IDS)
    text = [torch.from_numpy(a) for a in (CAPTION_IDS, attn, pos)]

    def synth(_):
        img = rng.standard_normal((size, size, 3)).astype(np.float32)
        boxes = rng.random((4, 4)).astype(np.float32) * 0.4 + 0.2
        return {"image": img, "boxes": boxes}

    def load(path):
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB").resize(
            (size, size)), np.float32) / 255.0
        with open(path.rsplit(".", 1)[0] + "_boxes.json") as f:
            boxes = np.asarray(json.load(f), np.float32)
        return {"image": img, "boxes": boxes}

    def loss_fn(model, batch):
        dev = batch["image"].device
        ids, mask, position = (t.to(dev) for t in text)
        pad = torch.zeros((1, size, size), dtype=torch.bool, device=dev)
        losses = []
        for img, gt_boxes in zip(batch["image"], batch["boxes"]):
            logits, boxes = model(img[None], pad, ids, mask, position)
            m = gt_boxes.shape[0]
            pos_maps = torch.zeros((1, m, cfg.max_text_len), device=dev)
            pos_maps[..., 1] = 1.0
            valid = torch.ones((1, m), dtype=torch.bool, device=dev)
            total, _ = detection_loss(logits, boxes, gt_boxes[None],
                                      pos_maps, valid)
            losses.append(total)
        return torch.stack(losses).mean()

    return SimpleNamespace(name="gdino", model=GroundingDINO(cfg),
                           loss_fn=loss_fn, synth=synth, load=load,
                           seed_offset=0, ckpt="inklayer_gdino.pth",
                           ignore=weights.GDINO_IGNORE)


def make_task(task: str, cfg, size: int, rng: np.random.Generator):
    if task == "sam":
        return sam_task(cfg, rng)
    if task == "depth":
        return depth_task(cfg, size, rng)
    return gdino_task(cfg, size, rng)


def init_model(t, device, seed: int, models_dir=None):
    """The task's model with its reference checkpoint from ``models_dir``,
    or seeded placeholder params (``build.py``'s seeds), on ``device`` in
    float32."""
    from inklayer_tpu_torch.build import _ckpt, _params

    model = _params(t.model, t.name, _ckpt(models_dir, t.ckpt), models_dir,
                    seed + t.seed_offset, t.ignore)
    return model.to(device=device, dtype=torch.float32)


def batches(samples, batch: int):
    """Stacked batches of ``batch`` samples, cycling through the list."""
    i = 0
    while True:
        idx = [(i + j) % len(samples) for j in range(batch)]
        yield {k: np.stack([samples[j][k] for j in idx]) for k in samples[0]}
        i += batch


def load_samples(args, t):
    if args.synthetic:
        return [t.synth(i) for i in range(args.synthetic)]
    if not args.data:
        raise SystemExit("--data DIR or --synthetic N required")
    paths = sorted(glob.glob(os.path.join(args.data, "*.png")))
    paths = [p for p in paths if "_mask" not in p and "_depth" not in p]
    samples = [t.load(p) for p in paths]
    if not samples:
        raise SystemExit(f"no samples under {args.data}")
    return samples


def mesh_device(args):
    """(mesh shape, device, rank) of this process: a mesh of more than one
    rank must be the world ``torchrun`` launched."""
    from inklayer_tpu_torch.parallel.mesh import init_distributed
    from inklayer_tpu_torch.runtime import resolve_device

    shape = (args.dp, args.fsdp, args.tp)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if math.prod(shape) != world:
        raise ValueError(
            f"--dp {args.dp} --fsdp {args.fsdp} --tp {args.tp} is a mesh of "
            f"{math.prod(shape)} ranks, WORLD_SIZE is {world}: launch one "
            f"process per rank with torchrun --nproc_per_node "
            f"{math.prod(shape)} -m inklayer_tpu_torch.scripts.train ...")
    if world == 1:
        dev = torch.device("cpu") if args.cpu else resolve_device("cuda")
        return shape, dev, 0
    dev = init_distributed("cpu" if args.cpu else None)
    return shape, dev, int(os.environ["RANK"])


def main(argv=None):
    from inklayer_tpu_torch.io.checkpoint import load_params, save_params
    from inklayer_tpu_torch.parallel.sharding import full_state_dict
    from inklayer_tpu_torch.parallel.train import Trainer, adamw

    args = parse_args(argv)
    shape, device, rank = mesh_device(args)
    say = print if rank == 0 else (lambda *a, **k: None)
    rng = np.random.default_rng(args.seed)
    cfg, size = task_config(args)
    t = make_task(args.task, cfg, size, rng)
    model = init_model(t, device, args.seed, args.models_dir)
    samples = load_samples(args, t)

    if args.resume:
        load_params(args.resume, template=model)
        say(f"resumed from {args.resume}")

    trainer = Trainer(t.loss_fn, model, mesh=shape,
                      optimizer=lambda params: adamw(params, args.lr),
                      max_grad_norm=1.0)
    it = batches(samples, args.batch)
    t0 = time.time()
    for step in range(1, args.steps + 1):
        loss = trainer.train_step(next(it))
        if step == 1 or step % 10 == 0 or step == args.steps:
            say(f"step {step:5d}  loss {float(loss):.5f}  "
                f"({(time.time() - t0) / step:.2f}s/step)", flush=True)
        if args.ckpt and (step % args.ckpt_every == 0 or step == args.steps):
            sd = trainer.model.state_dict() if trainer.mesh is None else \
                full_state_dict(trainer.model, trainer.mesh)
            if rank == 0:
                save_params(sd, os.path.join(args.ckpt, f"step_{step}"))
    say("done.")
    return trainer


if __name__ == "__main__":
    import torch.distributed as dist

    main()
    if dist.is_initialized():
        dist.destroy_process_group()
