"""Load a unit_tpu (flax) parameter tree into the port's modules.

``tree`` is the flax ``params`` dict with numpy leaves
(``jax.tree.map(np.asarray, params)``); this module itself needs no jax.
Module paths in the port follow the flax tree, so the mapping is by name:

    <path>/kernel (4-D, HWIO)   -> <path>.weight  (OIHW)
    deconv/kernel (4-D, HWIO)   -> deconv.weight  ([in, out, kh, kw], both
                                   spatial axes flipped: see below)
    <path>/kernel (2-D, [in,out]) -> <path>.weight ([out, in])
    <path>/bias                 -> <path>.bias
    <path>_bn/{weight,bias,mean,var} -> FrozenBN buffers of the same names
    embeddings                  -> the ``embeddings`` buffer

It is strict: every leaf is consumed, every parameter and buffer of the
model is set, and any shape mismatch raises.  ``flax_path`` and
``flax_leaves`` go the other way, so parameters, gradients and updated
parameters can be compared with unit_tpu's leaf by leaf.
``load_jax_train_state`` carries a whole unit_tpu train state across: the
parameters, the optax momentum trace and the step.

A transposed convolution (the mask head's ``deconv``) needs its own rule.
flax's ``ConvTranspose`` (``transpose_kernel=False``) correlates the
dilated input with its HWIO kernel as it stands; ``torch.nn.ConvTranspose2d``
scatters each input through its [in, out, kh, kw] weight, which is a
correlation with the kernel flipped in both spatial axes.  So the torch
weight is the flax kernel flipped in H and W and laid out [in, out, kh, kw];
the generic rule would give [out, in, kh, kw] unflipped: the wrong shape when
in != out and silently wrong values when in == out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


# flax module names of transposed convolutions
_TRANSPOSED = ("deconv",)


def _transposed(path: str) -> bool:
    parts = path.replace(".", "/").split("/")
    return len(parts) > 1 and parts[-2] in _TRANSPOSED


def _to_torch_name_and_value(path: str, leaf: np.ndarray):
    parts = path.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
        if leaf.ndim == 4 and _transposed(path):
            leaf = leaf[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf.ndim == 4:
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


def flax_path(name: str, value: torch.Tensor) -> str:
    """The flax path of a torch parameter or buffer name: ``a.b.weight`` of a
    conv or linear weight (2-D or 4-D) -> ``a/b/kernel``; anything else (a
    bias, a FrozenBN buffer) keeps its last part."""
    parts = name.split(".")
    if parts[-1] == "weight" and value.dim() in (2, 4):
        parts[-1] = "kernel"
    return "/".join(parts)


def to_flax_layout(value: np.ndarray, path: str = "") -> np.ndarray:
    """A torch weight in the flax layout: OIHW -> HWIO, [out, in] -> [in, out];
    the weight of a transposed convolution (``path`` names it: a flax path or
    a torch name) [in, out, kh, kw] -> HWIO flipped in both spatial axes."""
    if value.ndim == 4 and _transposed(path):
        return value.transpose(2, 3, 0, 1)[::-1, ::-1]
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    if value.ndim == 2:
        return value.T
    return value


def flax_leaves(model: nn.Module, grads: bool = False) -> Dict[str, Optional[np.ndarray]]:
    """{flax path: f32 numpy copy in the flax layout} of every parameter of
    ``model`` (its ``.grad`` with ``grads=True``, None where it has none)."""
    out: Dict[str, Optional[np.ndarray]] = {}
    for name, param in model.named_parameters():
        t = param.grad if grads else param
        out[flax_path(name, param)] = (
            None if t is None
            else np.array(to_flax_layout(t.detach().float().cpu().numpy(), name), copy=True))
    return out


def load_jax_train_state(state, params: Mapping, momentum: Optional[Mapping] = None,
                         step: int = 0):
    """Turn a unit_tpu train state into the port's, in place: ``params`` (the
    flax tree) into ``state.model``, ``momentum`` (optax's trace, a tree of
    the same structure; leaves of frozen parameters are ignored) into the SGD
    momentum buffers, and ``step`` into the state and the LR schedule.
    All leaves are numpy arrays.  Returns ``state``."""
    load_jax_params(state.model, params)
    optimizer, scheduler = state.solver.optimizer, state.solver.scheduler
    if momentum is not None:
        trace = flatten_tree(momentum)
        for name, param in state.model.named_parameters():
            if not param.requires_grad:
                continue
            path = flax_path(name, param)
            _, value = _to_torch_name_and_value(path, trace[path])
            if tuple(param.shape) != value.shape:
                raise ValueError(f"momentum {path}: shape {value.shape} vs {tuple(param.shape)}")
            optimizer.state[param]["momentum_buffer"] = torch.from_numpy(
                np.array(value, dtype=np.float32)).to(param.device)
    state.step = int(step)
    scheduler.last_epoch = int(step)
    for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(int(step))
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]
    return state
