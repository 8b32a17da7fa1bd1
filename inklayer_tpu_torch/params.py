"""Parameter bridge: JAX-package param trees -> PyTorch state dicts.

:mod:`inklayer_tpu.io.weights` converts reference PyTorch checkpoints to
flax trees with regex rules (``SAM_RULES``, ``GDINO_RULES``).  The port's
modules carry the reference checkpoint names, so the inverse of those rules
turns a JAX param tree into a ``state_dict`` the port loads with
``strict=True``.  Inverted here:

* each rule's flax path template becomes a regex whose groups take the
  torch pattern's group sub-patterns; the torch key is the pattern with its
  groups filled in, checked by running the forward rule on it;
* the ``linear`` (transpose), ``conv`` (HWIO -> OIHW) and ``convT``
  (spatial flip + (kh, kw, in, out) -> (in, out, kh, kw)) transforms;
* GDINO's split ``in_proj`` (``weights._split_in_proj``): the q/k/v Dense
  params are re-concatenated into ``in_proj_weight`` / ``in_proj_bias``;
* the SAM two-way MLP rename (``weights._mlp_layer_fixup``: torch
  ``lin1/lin2`` <-> flax ``layer0/layer1``).

``inklayer_tpu.io.weights`` imports only ``re`` and numpy at module level.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

_INVERSE_TRANSFORMS = {
    "linear": lambda w: w.T,
    "conv": lambda w: w.transpose(3, 2, 0, 1),
    "convT": lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1),
    "id": lambda w: w,
}

_SAM_TWO_WAY_MLP = re.compile(
    r"(mask_decoder/transformer/layers_\d+/mlp/)layer([01])/")
_IN_PROJ = [
    (re.compile(r"transformer/dec_layer_(\d+)/sa_([qkv])/(kernel|bias)"),
     "__special_dec_sa_in_proj_{}_{}"),
    (re.compile(r"transformer/dec_layer_(\d+)/ca_text_([qkv])/(kernel|bias)"),
     "__special_dec_ca_in_proj_{}_{}"),
    (re.compile(r"transformer/enc_text_(\d+)/([qkv])_proj/(kernel|bias)"),
     "__special_text_in_proj_{}_{}"),
]


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': np.ndarray}."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _top_level_groups(pattern: str):
    """Sub-patterns of the top-level capture groups of a rule's regex (the
    rule tables have no nested or non-capturing groups)."""
    groups, depth, start, i, in_class = [], 0, 0, 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            i += 2
            continue
        if in_class:
            in_class = ch != "]"
        elif ch == "[":
            in_class = True
        elif ch == "(":
            if depth == 0:
                start = i
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                groups.append((start, i + 1))
        i += 1
    return groups


class _InverseRule:
    def __init__(self, rule):
        self.rule = rule
        self.spans = _top_level_groups(rule.pattern)
        subs = [rule.pattern[a + 1:b - 1] for a, b in self.spans]
        parts, seen, pos = [], set(), 0
        tmpl = rule.path
        for m in re.finditer(r"\\g<(\d+)>|\\(\d)", tmpl):
            parts.append(re.escape(tmpl[pos:m.start()]))
            n = int(m.group(1) or m.group(2))
            if n in seen:
                parts.append(f"(?P=g{n})")
            else:
                parts.append(f"(?P<g{n}>{subs[n - 1]})")
                seen.add(n)
            pos = m.end()
        parts.append(re.escape(tmpl[pos:]))
        if seen != set(range(1, len(subs) + 1)):
            raise ValueError(f"rule {rule.pattern!r} is not invertible")
        self.re = re.compile("".join(parts) + r"\Z")

    def torch_key(self, path: str):
        m = self.re.match(path)
        if m is None:
            return None
        key, pos = [], 0
        for n, (a, b) in enumerate(self.spans, start=1):
            key.append(self.rule.pattern[pos:a])
            key.append(m.group(f"g{n}"))
            pos = b
        key.append(self.rule.pattern[pos:])
        key = re.sub(r"\\(.)", r"\1", "".join(key))
        hit = self.rule.apply(key)
        if hit is None or hit[0] != path:
            return None
        return key


def _join_in_proj(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Inverse of weights._split_in_proj: q/k/v Dense params -> packed
    torch in_proj (weight rows q, k, v)."""
    out, packs = {}, {}
    for path, val in flat.items():
        for rx, name in _IN_PROJ:
            m = rx.fullmatch(path)
            if m:
                layer, which, kind = m.groups()
                slot = name.format(layer,
                                   "weight" if kind == "kernel" else "bias")
                arr = val.T if kind == "kernel" else val
                packs.setdefault(slot, {})["qkv".index(which)] = arr
                break
        else:
            out[path] = val
    for slot, parts in packs.items():
        if sorted(parts) != [0, 1, 2]:
            raise KeyError(f"incomplete q/k/v set for {slot}")
        out[slot] = np.concatenate([parts[0], parts[1], parts[2]], axis=0)
    return out


def jax_to_torch_state_dict(flat_params: Mapping[str, np.ndarray],
                            rules: Sequence) -> Dict[str, torch.Tensor]:
    """{'a/b/c': array} flax params (paths below the 'params' collection)
    -> {torch checkpoint key: float32 tensor}.  Raises on a param no rule
    covers."""
    # flax layer0/layer1 <- the forward rule's 'layer10'/'layer20' (lin1/2)
    unfix = lambda m: f"{m.group(1)}layer{int(m.group(2)) + 1}0/"
    flat = {_SAM_TWO_WAY_MLP.sub(unfix, p): np.asarray(v)
            for p, v in flat_params.items()}
    flat = _join_in_proj(flat)
    inverse = [_InverseRule(r) for r in rules]
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for path, val in flat.items():
        for inv in inverse:
            key = inv.torch_key(path)
            if key is not None:
                arr = _INVERSE_TRANSFORMS[inv.rule.transform_name](val)
                out[key] = torch.from_numpy(
                    np.ascontiguousarray(arr, dtype=np.float32))
                break
        else:
            missing.append(path)
    if missing:
        raise KeyError(f"no rule for params: {missing[:20]}")
    return out
