"""Load a unit_tpu (flax) parameter tree into the port's modules.

``tree`` is the flax ``params`` dict with numpy leaves
(``jax.tree.map(np.asarray, params)``); this module itself needs no jax.
Module paths in the port follow the flax tree, so the mapping is by name:

    <path>/kernel (4-D, HWIO)   -> <path>.weight  (OIHW)
    <path>/kernel (2-D, [in,out]) -> <path>.weight ([out, in])
    <path>/bias                 -> <path>.bias
    <path>_bn/{weight,bias,mean,var} -> FrozenBN buffers of the same names
    embeddings                  -> the ``embeddings`` buffer

It is strict: every leaf is consumed, every parameter and buffer of the
model is set, and any shape mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": leaf}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _to_torch_name_and_value(path: str, leaf: np.ndarray):
    parts = path.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
        if leaf.ndim == 4:
            leaf = leaf.transpose(3, 2, 0, 1)
        elif leaf.ndim == 2:
            leaf = leaf.T
        else:
            raise ValueError(f"{path}: kernel of rank {leaf.ndim}")
    return ".".join(parts), leaf


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy every leaf of ``tree`` into ``model`` (in place); returns model."""
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    unset = set(targets)
    for path, leaf in flatten_tree(tree).items():
        name, value = _to_torch_name_and_value(path, leaf)
        if name not in targets:
            raise KeyError(f"flax leaf {path} has no counterpart {name} in the model")
        dst = targets[name]
        if tuple(dst.shape) != value.shape:
            raise ValueError(f"{path}: shape {value.shape} (after layout change) vs "
                             f"{tuple(dst.shape)} of {name}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
        unset.discard(name)
    if unset:
        raise KeyError(f"{len(unset)} model tensors not in the flax tree, e.g. "
                       f"{sorted(unset)[:5]}")
    return model
