"""Checkpointing: save/restore with resume, best-AP50 tracking, and torch
weight ingestion.

Port of unit_tpu/checkpoint/checkpointer.py.  A checkpoint is one
``torch.save`` of a plain dict (model tensors, the optimizer's momentum, the
scheduler's counters, the step and the best-AP info), written to a temporary
name and renamed, so a preempted write never leaves a half file under a
checkpoint's name; it is read back with ``weights_only=True`` (tensors and
plain containers only, no pickled code).  Layout under the output directory:

    step_<N>.pt          the newest ``max_to_keep`` periodic checkpoints
    best/model.pt        the eval-gated best snapshot
    best_info.json       {"AP50", "iteration"} of it, warm-started on resume

orbax's background write is not ported: ``save`` returns when the file is in
place and ``wait()`` is a no-op kept so the runner reads the same.  unit_tpu
keeps its best snapshot in the orbax directory ``best/model``, and the
fine-tune recipes name it so (``MODEL.WEIGHTS: <run>/best/model``):
``resolve_own_checkpoint`` maps that name to the port's ``best/model.pt``.

Under data parallelism every rank holds the same state and the same
evaluation results: rank 0 alone writes (checkpoints, the best snapshot and
its info), and every rank waits at a barrier after each write, so none reads
or moves on before the file is in place.  Every rank reads a checkpoint.

One format for every topology: under FSDP and TP (``parallel.mesh``) the
payload holds the whole model and the whole momentum, gathered from the
ranks' parts (a collective: every rank builds it, rank 0 writes it), keyed
as one process keys them (the optimizer's state by parameter index, in the
order of a model that nobody split).  A restore, a fine-tune warm start and
``load_torch_resnet`` give each rank its part of each whole tensor
(``mesh.load_full_``), so a file written by any topology loads into any
other.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..parallel import comm, mesh

FORMAT = "unit_tpu_torch/1"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
logger = logging.getLogger("unit_tpu_torch")


def state_payload(state, best_info: Optional[Mapping] = None) -> Dict[str, Any]:
    """The dict that goes to disk for a ``engine.train.TrainState``, as one
    process writes it: a split model's parameters and momentum are gathered
    whole (a collective: every rank calls it)."""
    optimizer = state.solver.optimizer
    opt = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    opt["state"] = {i: {k: mesh.full_tensor(v, params[i]) if torch.is_tensor(v) and v.dim()
                        else v for k, v in st.items()} for i, st in opt["state"].items()}
    return {"format": FORMAT, "step": int(state.step),
            "model": mesh.full_state_dict(state.model), "optimizer": opt,
            "scheduler": state.solver.scheduler.state_dict(), "best_info": dict(best_info or {})}


def load_payload(state, payload: Mapping[str, Any]) -> None:
    """Load a payload (``state_payload``'s, of any topology) into ``state``
    in place: each rank takes its part of each split tensor."""
    optimizer = state.solver.optimizer
    mesh.load_full_state_dict(state.model, payload["model"])
    opt = dict(payload["optimizer"])
    params = [p for group in optimizer.param_groups for p in group["params"]]
    opt["state"] = {int(i): {k: _part(v, params[int(i)]) for k, v in st.items()}
                    for i, st in opt["state"].items()}
    optimizer.load_state_dict(opt)
    state.solver.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])


def _part(value, param: torch.Tensor):
    """This rank's part of a whole optimizer-state tensor of ``param``, in
    ``param``'s kind (an FSDP shard's momentum is a DTensor like it)."""
    if not torch.is_tensor(value) or not value.dim():
        return value
    part = mesh.local_part(value.to(param.device), param).clone()
    if isinstance(param, DTensor):
        return DTensor.from_local(part, param.device_mesh, param.placements, run_check=False)
    return part


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def resolve_own_checkpoint(path: str) -> str:
    """``path``, or ``path + ".pt"`` where only that exists: the port's file
    behind a name spelled for unit_tpu's orbax layout (``<run>/best/model``).
    A path that names neither is returned as it is (the caller raises)."""
    if not os.path.exists(path) and os.path.isfile(path + ".pt"):
        return path + ".pt"
    return path


def read_checkpoint(path: str) -> Dict[str, Any]:
    """One of this package's checkpoint files (or the directory holding a
    ``model.pt``) as a dict of CPU tensors and plain values."""
    if os.path.isdir(path):
        path = os.path.join(path, "model.pt")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    return payload


class Checkpointer:
    """Periodic checkpoints with ``max_to_keep`` and best-metric tracking."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        if comm.is_main():
            os.makedirs(self.directory, exist_ok=True)
        comm.barrier()
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.directory, "best_info.json")
        self.best_info = self._load_best_info()

    def _load_best_info(self) -> Dict:
        # warm-start the best AP from disk, so a resumed run does not replace
        # a better snapshot with its first evaluation
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)
        return {"AP50": -1.0, "iteration": -1}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state, wait: bool = False) -> str:
        """Write ``state`` as the checkpoint of ``step`` and drop the oldest
        beyond ``max_to_keep``.  ``wait`` is accepted for unit_tpu's signature:
        the write is always complete on return, on every rank."""
        path = self._path(step)
        payload = state_payload(state, self.best_info)  # a collective on a split model
        if comm.is_main():
            _write(path, payload)
            if self.max_to_keep:
                for old in self.all_steps()[: -self.max_to_keep]:
                    os.remove(self._path(old))
        comm.barrier()
        return path

    def wait(self) -> None:
        """Nothing is written in the background."""

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, state=None):
        """Load the checkpoint of ``step`` (the latest by default) into
        ``state`` (its model, optimizer, scheduler and step, in place) and
        return it; without ``state`` return the payload dict; None when there
        is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = read_checkpoint(self._path(step))
        if state is None:
            return payload
        load_payload(state, payload)
        return state

    def maybe_save_best(self, step: int, ap50: float, state) -> bool:
        """Eval-gated best snapshot: kept only if ``ap50`` beats the best so far."""
        if ap50 <= self.best_info.get("AP50", -1.0):
            return False
        self.best_info = {"AP50": float(ap50), "iteration": int(step)}
        payload = state_payload(state, self.best_info)  # a collective on a split model
        if comm.is_main():
            with open(self._best_path, "w") as f:
                json.dump(self.best_info, f)
            best_dir = os.path.join(self.directory, "best")
            os.makedirs(best_dir, exist_ok=True)
            _write(os.path.join(best_dir, "model.pt"), payload)
        comm.barrier()
        return True


def merge_params_from_checkpoint(model: nn.Module, path: str) -> Tuple[nn.Module, int, List[str]]:
    """Warm-start ``model`` from one of this package's checkpoints (e.g. the
    ``best`` snapshot of a base-training run), tolerant of missing and new
    keys: tensors whose name and shape match are copied, everything else keeps
    its fresh initialisation (a fine-tune model's zero ``*_ft`` heads, which a
    base snapshot lacks: logged as skipped).  Returns (model, n_loaded, names
    of the checkpoint's tensors not loaded)."""
    src = read_checkpoint(path)["model"]
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    loaded, skipped = 0, []
    for name, value in src.items():
        dst = targets.get(name)
        if dst is None:
            skipped.append(name)
        elif mesh.full_shape(dst) != tuple(value.shape):
            skipped.append(f"{name} (shape {tuple(value.shape)} vs {mesh.full_shape(dst)})")
        else:
            mesh.load_full_(dst, value.to(dst.device))
            loaded += 1
    new = [name for name in targets if name not in src]
    if new:
        logger.info("skipped %d tensors that %s lacks, kept at their initialisation: %s",
                    len(new), path, new)
    return model, loaded, skipped


class PeriodicCheckpointerWithEval:
    """Training hook fusing periodic checkpoints with eval-gated best-model
    saves."""

    def __init__(
        self,
        checkpointer: Checkpointer,
        eval_fn: Optional[Callable[[Any], dict]] = None,
        eval_period: int = 0,
        checkpoint_period: int = 500,
        min_eval_period: int = 0,
    ):
        self.ckpt = checkpointer
        self.eval_fn = eval_fn
        self.eval_period = eval_period
        self.checkpoint_period = checkpoint_period
        self.min_eval_period = min_eval_period
        self.last_eval_results = None

    def __call__(self, step: int, metrics: dict, trainer):
        if self.checkpoint_period and step % self.checkpoint_period == 0:
            self.ckpt.save(step, trainer.state)
        if (
            self.eval_fn is not None
            and self.eval_period
            and step % self.eval_period == 0
            and step >= self.min_eval_period
        ):
            results = self.eval_fn(trainer.state)
            self.last_eval_results = results
            ap50 = results.get("bbox", {}).get("AP50", None)
            if ap50 is None:
                # multi-dataset shape {dataset: {"bbox": {...}}}: track the
                # first dataset's AP50
                for sub in results.values():
                    if isinstance(sub, dict) and "bbox" in sub:
                        ap50 = sub["bbox"].get("AP50", None)
                        break
            if ap50 is not None:
                self.ckpt.maybe_save_best(step, ap50, trainer.state)


# --------------------------------------------------------------------------- #
# Torch checkpoint ingestion (MSRA-C4 pickles / d2 state dicts -> the model)
# --------------------------------------------------------------------------- #

_NORM_SUFFIX = {
    "weight": ("", "weight"),
    "norm.weight": ("_bn", "weight"),
    "norm.bias": ("_bn", "bias"),
    "norm.running_mean": ("_bn", "mean"),
    "norm.running_var": ("_bn", "var"),
}


def d2_resnet_key_to_torch(key: str) -> Optional[str]:
    """Map a Detectron2 ResNet state-dict key to the name of a parameter or
    buffer of ``WSRCNN`` (the counterpart of ``d2_resnet_key_to_flax``).

    d2 naming: ``stem.conv1.{weight,norm.*}``, ``res{S}.{i}.conv{j}.*``,
    ``res{S}.{i}.shortcut.*``; MSRA-C4 pickles use ``backbone.`` /
    ``roi_heads.res5`` prefixes after d2's own converter.  A conv's norm
    statistics go to the sibling ``{conv}_bn`` FrozenBN; res5 maps into
    ``box_head``.
    """
    key = re.sub(r"^(backbone\.bottom_up\.|backbone\.)", "", key)
    m = re.match(r"stem\.conv1\.(.*)$", key)
    if m:
        parent, conv, rest = "backbone", "stem_conv1", m.group(1)
    else:
        m = re.match(r"res(\d)\.(\d+)\.(conv\d|shortcut)\.(.*)$", key)
        if m:
            stage, block, conv, rest = m.groups()
            parent = "box_head.res5" if int(stage) == 5 else f"backbone.res{stage}"
            parent = f"{parent}.block{block}"
        else:
            m = re.match(r"roi_heads\.res5\.(\d+)\.(conv\d|shortcut)\.(.*)$", key)
            if not m:
                return None
            block, conv, rest = m.groups()
            parent = f"box_head.res5.block{block}"
    suffix, leaf = _NORM_SUFFIX.get(rest, ("", rest))
    return f"{parent}.{conv}{suffix}.{leaf}"


def load_torch_resnet(model: nn.Module, state_dict: Mapping[str, Any],
                      load_res5_into: tuple = ("box_head",)
                      ) -> Tuple[nn.Module, int, List[str]]:
    """Copy d2/MSRA ResNet weights into ``model`` (in place).

    Conv weights are OIHW on both sides; norm statistics go to the sibling
    FrozenBN's buffers.  The res5 stage is copied into every head listed in
    ``load_res5_into`` ('box_head', 'weak_box_head') that the model has.
    Returns (model, tensors loaded, keys skipped), counted as unit_tpu's
    ``load_torch_resnet`` counts them.
    """
    targets = dict(model.named_parameters())
    targets.update(dict(model.named_buffers()))
    has_weak_head = any(n.startswith("weak_box_head.") for n in targets)
    loaded, skipped = 0, []
    for key, value in state_dict.items():
        value = torch.as_tensor(np.asarray(value))
        name = d2_resnet_key_to_torch(key)
        if name is None:
            skipped.append(key)
            continue
        names = [name]
        if name.startswith("box_head."):
            if "weak_box_head" in load_res5_into and has_weak_head:
                names.append("weak_" + name)
            if "box_head" not in load_res5_into:
                names = names[1:]
        for tgt in names:
            dst = targets.get(tgt)
            if dst is None:
                skipped.append(key)
            elif mesh.full_shape(dst) != tuple(value.shape):
                skipped.append(f"{key} (shape {tuple(value.shape)} vs {mesh.full_shape(dst)})")
            else:
                mesh.load_full_(dst, value.to(dst.device))
                loaded += 1
    return model, loaded, skipped
