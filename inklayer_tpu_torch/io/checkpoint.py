"""Checkpoint save / load for the port's models (port of
:mod:`inklayer_tpu.io.checkpoint`).

Converted or fine-tuned parameters persist as ``path/params.safetensors``
(the port's own reader and writer, :mod:`io.weights`) with the config
beside them as ``path/config.json``: the JAX package's layout (``params``
plus ``config.json``) without orbax.  ``convert_and_cache`` converts a
reference checkpoint once and keys its cache on the source file's name,
size and modification time, as the JAX package does.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

from inklayer_tpu_torch.config import to_jsonable
from inklayer_tpu_torch.io.weights import read_safetensors, save_safetensors

PARAMS = "params.safetensors"


def save_params(model_or_state_dict: Union[nn.Module, Mapping], path: str,
                config=None) -> None:
    """Write the model's ``state_dict`` (or the given one) under ``path``,
    and the config dataclass beside it when given."""
    sd = model_or_state_dict.state_dict() \
        if isinstance(model_or_state_dict, nn.Module) else model_or_state_dict
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PARAMS + ".tmp")
    save_safetensors(sd, tmp)
    os.replace(tmp, os.path.join(path, PARAMS))  # no half-written file
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(to_jsonable(config), f, indent=2)


def load_params(path: str, template: Optional[nn.Module] = None):
    """The state dict saved under ``path`` (CPU tensors); with a
    ``template`` module, loaded into it (strict: names and shapes must
    match) and the module returned."""
    sd = read_safetensors(os.path.join(path, PARAMS))
    if template is None:
        return sd
    template.load_state_dict(sd, strict=True)
    return template


def convert_and_cache(torch_path: str, cache_dir: str,
                      loader: Callable[..., Dict[str, torch.Tensor]],
                      *loader_args):
    """``loader(torch_path, *loader_args)`` once; its state dict is cached
    under ``cache_dir`` keyed by the source file's basename, size and
    mtime, and read from there on later calls."""
    stat = os.stat(torch_path)
    key = f"{os.path.basename(torch_path)}-{stat.st_size}-{int(stat.st_mtime)}"
    cached = os.path.join(cache_dir, key)
    if os.path.exists(os.path.join(cached, PARAMS)):
        return load_params(cached)
    params = loader(torch_path, *loader_args)
    save_params(params, cached)
    return params
