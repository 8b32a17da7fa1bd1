"""Fine-tuning (port of :mod:`inklayer_tpu.parallel.train`).

The losses of the three recipes (SAM box-prompted masks: focal + dice +
IoU-prediction MSE; depth: scale-invariant log) and :class:`Trainer`, one
process over the model's own device, or one process per rank of a
(dp, fsdp, tp) mesh (``parallel/mesh.py``, ``parallel/sharding.py``).
The step differentiates the plain PyTorch versions of every op (inside
:func:`runtime.disable_kernels`, as the JAX trainer traces under
``disable_pallas``): the hand-written kernels are forward-only and
bf16-only, and training runs in float32.

The JAX package's default optimizer is ``optax.adamw(1e-5)`` and its CLI
chains ``optax.clip_by_global_norm(1.0)`` in front; :func:`adamw` and
``Trainer(max_grad_norm=...)`` are their counterparts.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from inklayer_tpu_torch.runtime import disable_kernels


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss (SAM's mask loss component), mean over pixels."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return torch.mean(a_t * ((1 - p_t) ** gamma) * ce)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              eps: float = 1.0) -> torch.Tensor:
    p = torch.sigmoid(logits)
    num = 2 * torch.sum(p * targets, dim=(-2, -1)) + eps
    den = torch.sum(p, dim=(-2, -1)) + torch.sum(targets, dim=(-2, -1)) + eps
    return torch.mean(1 - num / den)


def sam_mask_loss(logits: torch.Tensor, iou_pred: torch.Tensor,
                  target_masks: torch.Tensor) -> torch.Tensor:
    """20:1 focal:dice + IoU-prediction MSE (SAM recipe)."""
    t = target_masks.float()
    fl = focal_loss(logits, t)
    dl = dice_loss(logits, t)
    pred_bin = (logits > 0).float()
    inter = torch.sum(pred_bin * t, dim=(-2, -1))
    union = torch.sum(pred_bin + t - pred_bin * t, dim=(-2, -1))
    true_iou = inter / torch.clamp(union, min=1.0)
    iou_l = torch.mean((iou_pred.reshape(true_iou.shape) - true_iou) ** 2)
    return 20.0 * fl + dl + iou_l


def silog_loss(pred_depth: torch.Tensor, target_depth: torch.Tensor,
               valid_mask: torch.Tensor, lam: float = 0.5,
               eps: float = 1e-6) -> torch.Tensor:
    """Scale-invariant log loss (the reference's metric-depth trainer
    recipe, Depth_Anything_V2/metric_depth/train.py) for depth
    fine-tuning."""
    d = torch.log(pred_depth + eps) - torch.log(target_depth + eps)
    m = valid_mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mean_sq = (d * d * m).sum() / n
    mean = (d * m).sum() / n
    return torch.sqrt(torch.clamp(mean_sq - lam * mean * mean, min=1e-12))


def adamw(params: Iterable[nn.Parameter], lr: float = 1e-5,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with optax's defaults: betas (0.9, 0.999), eps
    1e-8 outside the square root, weight decay 1e-4 (torch's default is
    0.01), decoupled and applied to the old parameter, as optax does."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        sq_sum=None) -> torch.Tensor:
    """``optax.clip_by_global_norm``: scale every gradient by max_norm /
    norm where the global norm is at least max_norm, else leave them.
    (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 and clips
    only above.)  Returns the norm before clipping, on the device.
    ``sq_sum(grads)`` replaces the plain sum of squares (a mesh's sum over
    its shards, :func:`mesh_sq_sum`)."""
    if sq_sum is None:
        total = sum(torch.sum(g.float() * g.float()) for g in grads)
    else:
        total = sq_sum(grads)
    norm = torch.sqrt(total)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_([_local(g) for g in grads], scale)
    return norm


def mesh_sq_sum(mesh, tp_sharded: Sequence[bool]) -> Callable:
    """The squared global norm of a mesh's gradients, each element counted
    once: every rank sums the squares of its local shards; the fsdp group
    adds its shards (dp ranks hold copies); the tp group adds the shards of
    the tp-sharded parameters (``tp_sharded[i]`` for gradient i), not of
    the tp-replicated ones."""
    def sq_sum(grads):
        dev = _local(grads[0]).device
        rep, tps = (torch.zeros((), device=dev) for _ in range(2))
        for g, split in zip(grads, tp_sharded):
            loc = _local(g).float()
            (tps if split else rep).add_(torch.sum(loc * loc))
        both = torch.stack([rep, tps])
        if mesh.size(1) > 1:
            dist.all_reduce(both, group=mesh.get_group("fsdp"))
        rep, tps = both[0], both[1].clone()
        if mesh.size(2) > 1:
            dist.all_reduce(tps, group=mesh.get_group("tp"))
        return rep + tps

    return sq_sum


class Trainer:
    """Train step over one model, in one process or on one rank of a mesh.

    ``loss_fn(model, batch) -> scalar tensor``; the batch is a dict of
    arrays or tensors (the global batch), moved to the model's device.
    ``optimizer`` defaults to :func:`adamw` (lr 1e-5) over every
    parameter; on a mesh it must be a factory ``f(params) -> optimizer``
    (or None): the optimizer is built over the sharded parameters.
    ``max_grad_norm`` clips the gradients first, as the CLI's
    ``optax.chain(clip_by_global_norm(1.0), ...)``.

    ``mesh`` is a ``DeviceMesh`` of ("dp", "fsdp", "tp") or its shape.  A
    shape of one device without a process group is the single-process
    path; any other builds :func:`mesh.make_mesh` over the process group
    (which raises when its size is not the world's) and shards the model
    with :func:`sharding.apply_mesh`.  Each step then runs this rank's dp
    slice of the batch (:func:`sharding.shard_batch`) and returns the
    loss's mean over the global batch."""

    def __init__(self, loss_fn: Callable, model: nn.Module, mesh=None,
                 optimizer=None, max_grad_norm: Optional[float] = None):
        from inklayer_tpu_torch.parallel import mesh as pmesh
        from inklayer_tpu_torch.parallel import sharding

        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            shape = tuple(mesh)
            mesh = None if math.prod(shape) == 1 and \
                not dist.is_initialized() else pmesh.make_mesh(
                    *shape, device_type=_local(next(
                        model.parameters())).device.type)
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.model = model
        self.max_grad_norm = max_grad_norm
        self.grad_norm: Optional[torch.Tensor] = None
        self._sq_sum = None
        if mesh is not None:
            if isinstance(optimizer, torch.optim.Optimizer):
                raise TypeError("on a mesh, pass an optimizer factory "
                                "f(params): the optimizer must hold the "
                                "sharded parameters")
            sharding.apply_mesh(model, mesh)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.device = _local(self.params[0]).device
        if optimizer is None:
            self.optimizer = adamw(self.params)
        elif isinstance(optimizer, torch.optim.Optimizer):
            self.optimizer = optimizer
        else:
            self.optimizer = optimizer(self.params)
        if mesh is not None:
            layout = getattr(model, "tp_layout", {})
            split = {id(p) for name, p in model.named_parameters()
                     if name in layout}
            self._sq_sum = mesh_sq_sum(mesh, [id(p) in split
                                              for p in self.params])

    def train_step(self, batch) -> torch.Tensor:
        """Forward, backward and update on the plain paths; returns the
        loss (the mean over the global batch) as a 0-dim tensor on the
        device (no host sync in one process)."""
        from inklayer_tpu_torch.parallel.sharding import shard_batch

        with disable_kernels():
            self.optimizer.zero_grad(set_to_none=True)
            if self.mesh is not None:
                batch = shard_batch(batch, self.mesh)
            batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                     for k, v in batch.items()}
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            for p in self.params:
                # optax updates every leaf: a parameter the loss does not
                # reach still takes its weight decay
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params]
            if self.max_grad_norm is not None:
                self.grad_norm = clip_by_global_norm(
                    grads, self.max_grad_norm, self._sq_sum)
            self.optimizer.step()
        loss = loss.detach()
        if self.mesh is not None and self.mesh.size(0) > 1:
            loss = loss.clone()  # the dp slices' means, averaged
            dist.all_reduce(loss, group=self.mesh.get_group("dp"))
            loss = loss / self.mesh.size(0)
        return loss
