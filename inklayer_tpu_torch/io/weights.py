"""Reference checkpoints -> the port's modules (port of the reader and the
key policy of :mod:`inklayer_tpu.io.weights`).

The port's modules carry the reference checkpoints' own key names
(``inklayer_tpu_torch.params`` proves it for every module), so loading a
file is: read it, unwrap and clean its keys as the JAX package does, drop
exactly the keys the JAX loader drops, and ``load_state_dict`` in fp32.
No rule table is needed.

* :func:`load_torch_state_dict` reads ``.pth`` / ``.bin`` files with
  ``torch.load(map_location="cpu", weights_only=True)`` (the JAX package
  unpickles with ``weights_only=False``; a file that needs another class
  raises, naming the file and ``torch.serialization.add_safe_globals``)
  and ``.safetensors`` files with :func:`read_safetensors` (no
  ``safetensors`` package: an 8-byte little-endian header length, a JSON
  header, then the raw buffers).  It unwraps a ``model`` / ``state_dict``
  / ``module`` entry and strips ``module.`` / ``model.`` prefixes.
* :func:`load_checkpoint` drops the keys of an ignore list (the JAX
  package's ``GDINO_IGNORE``, its depth ignores, ``DIFFUSION_IGNORE``, and
  the unused refinenet4 unit that its depth loader maps and then drops)
  and raises as the JAX loader does: ``KeyError`` for a key the module does
  not hold, ``KeyError`` for a parameter the file lacks, ``ValueError``
  for a shape that differs.

SAM's ``prompt_encoder.mask_downscaling.*`` (the mask-prompt convnet) is
held by the port's ``PromptEncoder``, so a SAM checkpoint loads strictly
with no ignore list.
"""

from __future__ import annotations

import json
import pickle
import re
import struct
from typing import Dict, Mapping, Sequence

import torch
from torch import nn

# the JAX package's ignore lists (inklayer_tpu/io/weights.py)
GDINO_IGNORE = [
    r"bert\.pooler\..*",
    # recomputed-constant buffers in the Swin checkpoint
    r"backbone\.0\..*relative_position_index",
    r"backbone\.0\..*attn_mask",
    r"bert\.embeddings\.position_ids",
    r"bbox_embed\.[1-9]\..*",  # shared copies of bbox_embed.0
    r"transformer\.decoder\.bbox_embed\..*",  # same shared object
    r"label_enc\..*",  # denoising-training embedding, unused at inference
]
DEPTH_IGNORE = [
    r"pretrained\.mask_token", r"pretrained\.register_tokens",
    # the reference's refinenet4 holds a skip unit it never runs (it gets no
    # skip input); the JAX loader maps these keys and drops them, as its
    # parameter tree (and the port's module) has no such unit
    r"depth_head\.scratch\.refinenet4\.resConfUnit1\..*",
]
DIFFUSION_IGNORE = [
    r"text_model\.embeddings\.position_ids",
    r".*\.num_batches_tracked",
    r"text_projection\..*",
]

# safetensors dtype names <-> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a ``.safetensors`` file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which the reader does not take")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        size = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: tensor {name} {shape} {info['dtype']} "
                             f"does not fit its offsets [{begin}, {end})")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                         offset=begin).reshape(shape)
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as a ``.safetensors`` file (CPU copies,
    contiguous, in name order)."""
    header, blobs, pos = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + len(raw)]}
        blobs.append(raw)
        pos += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data section starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def clean_state_dict(state_dict: Mapping) -> dict:
    """Strip 'module.' then 'model.' prefixes (GroundingDINO's
    util clean_state_dict)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("model."):
            k = k[len("model."):]
        out[k] = v
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """{key: CPU tensor} of a reference checkpoint, unwrapped and
    cleaned."""
    if path.endswith(".safetensors"):
        obj = read_safetensors(path)
    else:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise pickle.UnpicklingError(
                f"{path}: torch.load(weights_only=True) refused the file "
                f"(it pickles more than tensors); if its source is trusted, "
                f"allow the classes it names with "
                f"torch.serialization.add_safe_globals([...]): {e}") from e
    if isinstance(obj, dict):
        for key in ("model", "state_dict", "module"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in clean_state_dict(obj).items()}


def load_checkpoint(model: nn.Module, path: str,
                    ignore: Sequence[str] = ()) -> nn.Module:
    """Load the reference checkpoint at ``path`` into ``model`` (every
    value as fp32), after dropping the keys matching ``ignore``.  Raises
    on an unknown key, a missing parameter or a shape mismatch."""
    ignore_res = [re.compile(p + r"\Z") for p in ignore]
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if not any(r.match(k) for r in ignore_res)}
    want = model.state_dict()
    unknown = sorted(set(sd) - set(want))
    if unknown:
        raise KeyError(f"{path}: unconverted checkpoint keys: {unknown[:20]}"
                       f"{'...' if len(unknown) > 20 else ''}")
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"{path}: params missing from checkpoint: "
                       f"{missing[:20]}{'...' if len(missing) > 20 else ''}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{path}: shape mismatch at {k}: ckpt "
                             f"{tuple(v.shape)} vs model "
                             f"{tuple(want[k].shape)}")
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return model
