"""Parameter and batch sharding over the (dp, fsdp, tp) mesh (counterpart of
:mod:`inklayer_tpu.parallel.sharding`).

:func:`spec_for_param` carries the JAX package's path rules over to the
port's parameter names: the name is mapped to its flax path (the map of
``params.jax_to_torch_state_dict``, read backwards) and the JAX regexes
decide.  A spec names a mesh axis or ``None`` per dimension of the torch
tensor.  A torch ``Linear.weight`` is (out, in) where a flax ``kernel`` is
(in, out), and a torch ``Conv2d.weight`` OIHW where flax is HWIO, so

  * column-parallel (``qkv``, ``fc1``, ``lin1``, ``value_proj`` ...):
    out over tp, in over fsdp: ("tp", "fsdp");
  * row-parallel (``proj``, ``fc2``, ``lin2``, ``out_proj`` ...):
    ("fsdp", "tp");
  * other >= 2-D parameters: fsdp on the flax layout's last axis (a
    Linear's dim 0, an embedding's last dim);
  * 1-D parameters: replicated.

:func:`param_sharding_rules` drops each axis that does not divide its
dimension, as the JAX rules do.  :func:`apply_mesh` (the JAX
``shard_params``) realises them in PyTorch's idiom:

  * tp: the modules that hold heads keep their rank's heads as plain local
    tensors (``shard_tp`` of SAM's encoder blocks and DINOv2's blocks,
    ``parallel/tp.py``); every other module stays whole on each tp rank
    (GroundingDINO's rules shard it over tp in the JAX package; the
    results are the same);
  * dp and fsdp: FSDP2 ``fully_shard`` on each block, then on the root,
    over the 2-D ("dp", "fsdp") sub-mesh (HSDP: replicated over dp,
    sharded over fsdp on the rule's fsdp dimension; where the rule has
    none, on dim 0, since ``fully_shard`` cannot leave a parameter whole).

:func:`shard_batch` gives this rank its dp slice of a global batch, the
JAX ``P("dp")``: the fsdp and tp ranks of one dp group take the same
samples.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from inklayer_tpu_torch.parallel.mesh import AXES, mesh_shape
from inklayer_tpu_torch.parallel.tp import TPGroup, gather_tp, prefixed

Spec = Tuple[Optional[str], ...]

# the JAX package's rules (inklayer_tpu/parallel/sharding.py:27-32), on
# flax paths 'a/b/kernel'
_COL_PAT = re.compile(
    r".*(qkv|attn_qkv|q_proj|k_proj|v_proj|sa_[qkv]|ca_text_[qkv]|fc1|lin(ear)?1|"
    r"intermediate_dense|value_proj|values_[vl]_proj|[vl]_proj)/kernel")
_ROW_PAT = re.compile(
    r".*(proj|attn_proj|out_proj|sa_out|ca_text_out|fc2|lin(ear)?2|"
    r"output_dense|output_proj|out_[vl]_proj)/kernel")

# torch name -> the part of its flax path the rules read
_TO_FLAX = (
    # SAM's two-way transformer MLP is flax layer0 / layer1 (no rule)
    (re.compile(r"(mask_decoder\.transformer\.layers\.\d+\.mlp\.)lin([12])"),
     lambda m: f"{m.group(1)}layer{int(m.group(2)) - 1}"),
    # GroundingDINO's packed q/k/v (flax sa_q, ca_text_q, q_proj ...)
    (re.compile(r"in_proj_weight$"), lambda m: "qkv.weight"),
    # BERT's dense layers (flax intermediate_dense, output_dense)
    (re.compile(r"(intermediate|output)\.dense"),
     lambda m: f"{m.group(1)}_dense"),
)

# torch dim i holds flax dim PERM[layout](ndim)[i] (the bridge's inverse
# transforms, params.py: linear w.T, conv (3, 2, 0, 1), convT (2, 3, 0, 1))
_PERM = {
    "linear": lambda n: (n - 1, n - 2, *range(n - 2)),
    "convT": lambda n: (2, 3, 0, 1),
    "id": lambda n: tuple(range(n)),
}


def _flax_path(name: str, layout: str) -> str:
    for rx, sub in _TO_FLAX:
        name = rx.sub(sub, name)
    if layout != "id" and name.endswith(".weight"):
        name = name[:-len(".weight")] + ".kernel"
    return name.replace(".", "/")


def _jax_spec(path: str, ndim: int) -> Spec:
    lead = (None,) * (ndim - 2)
    if _COL_PAT.match(path):
        return lead + ("fsdp", "tp")
    if _ROW_PAT.match(path):
        return lead + ("tp", "fsdp")
    return (None,) * (ndim - 1) + ("fsdp",)


def spec_for_param(name: str, ndim: int, layout: str = "linear") -> Spec:
    """The mesh axis of each dimension of parameter ``name``.  ``layout``
    is the tensor's layout against the flax leaf: "linear" for
    ``Linear`` / ``Conv`` weights, "convT" for ``ConvTranspose2d``,
    "id" for everything stored as flax stores it (embeddings, raw
    parameters)."""
    if ndim < 2:
        return (None,) * ndim
    spec = _jax_spec(_flax_path(name, layout), ndim)
    return tuple(spec[i] for i in _PERM[layout](ndim))


def param_layout(model: nn.Module, name: str) -> str:
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if leaf == "in_proj_weight":  # packed q/k/v rows, (3 C, C)
        return "linear"
    if leaf != "weight":
        return "id"
    if isinstance(mod, nn.ConvTranspose2d):
        return "convT"
    if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return "linear"
    return "id"


def param_sharding_rules(model: nn.Module, mesh) -> Dict[str, Spec]:
    """{parameter name: spec} of the whole (unsharded) model on ``mesh``
    (a ``DeviceMesh`` or its (dp, fsdp, tp) shape), each axis whose size
    does not divide its dimension dropped."""
    sizes = dict(zip(AXES, mesh if isinstance(mesh, tuple)
                     else mesh_shape(mesh)))
    out = {}
    for name, p in model.named_parameters():
        spec = spec_for_param(name, p.dim(), param_layout(model, name))
        out[name] = tuple(ax if ax is not None and p.shape[i] % sizes[ax] == 0
                          else None for i, ax in enumerate(spec))
    return out


def replicated(mesh) -> tuple:
    """The placements of a tensor whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def tp_group(mesh) -> TPGroup:
    return TPGroup(mesh.get_group("tp"), mesh.get_local_rank("tp"),
                   mesh.size(2))


def apply_tp(model: nn.Module, mesh) -> Dict[str, tuple]:
    """Head-parallel tp plan of every module that has one (``shard_tp``);
    returns {parameter name: (dim, groups)} of the tp-sharded ones, also
    kept as ``model.tp_layout``.  A no-op on a mesh with tp 1."""
    layout = {}
    if mesh.size(2) > 1:
        tp = tp_group(mesh)
        for name, mod in list(model.named_modules()):
            if hasattr(mod, "shard_tp"):
                layout.update(prefixed(name, mod.shard_tp(tp)))
    model.tp_layout = layout
    return layout


# the ModuleLists whose entries are a model's blocks (SAM and DINOv2
# "blocks", Swin "blocks", BERT "layer", the GroundingDINO transformer's
# "layers", "text_layers", "fusion_layers")
_BLOCK_LISTS = ("blocks", "layer", "layers", "text_layers", "fusion_layers")


def _blocks(model: nn.Module):
    """Each block once, deepest first (``fully_shard`` goes bottom-up).  A
    block is called as a module (FSDP2 gathers its parameters in its
    forward's hooks): containers without a forward of their own, such as
    Swin's stages, and single layers are not blocks."""
    seen, found = set(), []
    for name, mod in model.named_modules(remove_duplicate=False):
        if not isinstance(mod, nn.ModuleList) or \
                name.rpartition(".")[2] not in _BLOCK_LISTS:
            continue
        for sub in mod:
            if id(sub) not in seen and len(list(sub.children())) > 0 and \
                    type(sub).forward is not nn.Module.forward:
                seen.add(id(sub))
                found.append((name.count("."), sub))
    return [m for _, m in sorted(found, key=lambda t: -t[0])]


def apply_mesh(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model`` in place over ``mesh`` (the JAX ``shard_params``):
    the tp plan, then FSDP2 ``fully_shard`` on each block and on the root
    over the ("dp", "fsdp") sub-mesh.  The parameters become DTensors;
    build the optimizer after this call."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    rules = param_sharding_rules(model, mesh)
    apply_tp(model, mesh)
    by_param = {p: rules[name] for name, p in model.named_parameters()}

    def placement(p):
        spec = by_param.get(p, ())
        return Shard(spec.index("fsdp")) if "fsdp" in spec else Shard(0)

    sub = mesh["dp", "fsdp"]
    for block in _blocks(model):
        fully_shard(block, mesh=sub, shard_placement_fn=placement)
    fully_shard(model, mesh=sub, shard_placement_fn=placement)
    if dist.get_backend() == "gloo":  # gloo has no ReduceOp.AVG
        for mod in _blocks(model) + [model]:
            mod.set_force_sum_reduction_for_comms(True)
    return model


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's dp slice (axis 0) of every entry of a global batch."""
    dp, rank = mesh.size(0), mesh.get_local_rank("dp")
    out = {}
    for k, v in batch.items():
        if len(v) % dp:
            raise ValueError(f"batch entry {k!r} of {len(v)} samples does "
                             f"not split over dp={dp}")
        n = len(v) // dp
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def full_state_dict(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The whole model's ``state_dict`` on rank 0 (CPU tensors in the
    unsharded layout, the format of ``io/checkpoint.py``), ``{}`` on the
    other ranks; a collective call."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         get_model_state_dict)

    layout = getattr(model, "tp_layout", {})
    sd = get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True, cpu_offload=not layout))
    if layout:
        tp = tp_group(mesh)
        for name, (dim, groups) in layout.items():
            sd[name] = gather_tp(sd[name], dim, groups, tp)
        sd = {k: v.cpu() for k, v in sd.items()} if dist.get_rank() == 0 \
            else {}
    return sd
