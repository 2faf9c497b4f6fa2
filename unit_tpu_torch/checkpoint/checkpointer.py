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

Writes go on in the background, as orbax's do in unit_tpu: ``save`` (and
``maybe_save_best``) copies the payload's tensors into a host snapshot of its
own (pinned memory, through non-blocking copies from the card and one event
after them; clones on the CPU) and returns, so the step after it may change
the state in place; a writer thread waits on the event, writes the file and
then drops the oldest beyond ``max_to_keep``.  One write is in flight in a
process at a time, whichever ``Checkpointer`` started it: the next ``save``
joins it first, and so does every read of this module (``read_checkpoint``,
``resolve_own_checkpoint``, ``restore``, ``latest_step``, ``all_steps``).
``wait()`` joins it too, and a write that failed raises again at the next
``save`` or ``wait()``.  A reader in another process must see the writer's
``wait()`` return first.  unit_tpu keeps its best snapshot in the orbax
directory ``best/model``, and the fine-tune recipes name it so
(``MODEL.WEIGHTS: <run>/best/model``): ``resolve_own_checkpoint`` maps that
name to the port's ``best/model.pt``.

Under data parallelism every rank holds the same state and the same
evaluation results: rank 0 alone writes (checkpoints, the best snapshot and
its info), and every rank meets the others at a barrier in ``wait()`` (which
``restore``, ``latest_step`` and ``all_steps`` call) after a save, so none
reads a checkpoint before the file is in place.  Every rank reads a checkpoint.

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
import threading
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


def _map_tensors(fn: Callable, value):
    """``value`` (nested dicts, lists and tuples) with ``fn`` applied to each tensor."""
    if torch.is_tensor(value):
        return fn(value)
    if isinstance(value, dict):
        return {k: _map_tensors(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_map_tensors(fn, v) for v in value)
    return value


def _host_snapshot(payload: Dict[str, Any]):
    """(the payload with each tensor in host memory of its own, the CUDA event
    after the copies or None): the card's tensors go into pinned memory
    through non-blocking copies on its current stream, so they hold the
    values of the work queued before this call, and a CPU tensor is cloned;
    the caller may change the state in place once this returns."""
    on_card = False

    def copy(t: torch.Tensor) -> torch.Tensor:
        nonlocal on_card
        if not t.is_cuda:
            return t.clone()
        on_card = True
        return torch.empty_like(t, device="cpu", pin_memory=True).copy_(t, non_blocking=True)

    snapshot = _map_tensors(copy, payload)
    event = None
    if on_card:  # a process's state lives on its current card
        event = torch.cuda.Event()
        event.record()
    return snapshot, event


class _Writer:
    """The process's one background write: a thread, and the exception of a
    write that failed, raised again at the next ``join``."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def start(self, job: Callable[[], None]) -> None:
        self.join()

        def run():
            try:
                job()
            except BaseException as e:  # noqa: BLE001  (kept for the caller's next join)
                self.error = e

        self.thread = threading.Thread(target=run, name="checkpoint-writer")
        self.thread.start()

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        error, self.error = self.error, None
        if error is not None:
            raise RuntimeError(f"a background checkpoint write failed: {error!r}") from error


_WRITER = _Writer()


def wait_for_writes() -> None:
    """Join this process's background checkpoint write, if one is in flight,
    and raise the error of a write that failed."""
    _WRITER.join()


def resolve_own_checkpoint(path: str) -> str:
    """``path``, or ``path + ".pt"`` where only that exists: the port's file
    behind a name spelled for unit_tpu's orbax layout (``<run>/best/model``).
    A path that names neither is returned as it is (the caller raises)."""
    wait_for_writes()
    if not os.path.exists(path) and os.path.isfile(path + ".pt"):
        return path + ".pt"
    return path


def read_checkpoint(path: str) -> Dict[str, Any]:
    """One of this package's checkpoint files (or the directory holding a
    ``model.pt``) as a dict of CPU tensors and plain values (once this
    process's background write has landed)."""
    wait_for_writes()
    if os.path.isdir(path):
        path = os.path.join(path, "model.pt")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    return payload


class Checkpointer:
    """Periodic checkpoints with ``max_to_keep`` and best-metric tracking,
    written in the background (the module's docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        if comm.is_main():
            os.makedirs(self.directory, exist_ok=True)
        comm.barrier()
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.directory, "best_info.json")
        self.best_info = self._load_best_info()
        self._saved = False  # a save since the last wait(): the ranks meet there

    def _load_best_info(self) -> Dict:
        # warm-start the best AP from disk, so a resumed run does not replace
        # a better snapshot with its first evaluation
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)
        return {"AP50": -1.0, "iteration": -1}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def all_steps(self) -> List[int]:
        self.wait()
        return self._steps()

    def _start_write(self, path: str, state, prune: bool) -> None:
        """The payload (a collective on a split model), its host snapshot,
        and on rank 0 the write of it to ``path`` in the background (after
        the write in flight), then the pruning of old steps."""
        _WRITER.join()
        snapshot, event = _host_snapshot(state_payload(state, self.best_info))
        self._saved = True
        if not comm.is_main():
            return

        def job():
            if event is not None:
                event.synchronize()
            _write(path, snapshot)
            if prune and self.max_to_keep:
                for old in self._steps()[: -self.max_to_keep]:
                    os.remove(self._path(old))

        _WRITER.start(job)

    def save(self, step: int, state, wait: bool = False) -> str:
        """Start writing ``state`` as the checkpoint of ``step`` and return
        its path; the oldest beyond ``max_to_keep`` go once it is written.
        ``wait``: return once the file is in place on every rank (the
        preemption save)."""
        path = self._path(step)
        self._start_write(path, state, prune=True)
        if wait:
            self.wait()
        return path

    def wait(self) -> None:
        """Join the background write and, after a save, meet the other ranks,
        so every rank may read the file; a failed write raises here (after
        the barrier: no rank is left waiting)."""
        try:
            _WRITER.join()
        finally:
            if self._saved:
                self._saved = False
                comm.barrier()

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
        self.wait()
        payload = read_checkpoint(self._path(step))
        if state is None:
            return payload
        load_payload(state, payload)
        return state

    def maybe_save_best(self, step: int, ap50: float, state) -> bool:
        """Eval-gated best snapshot: kept only if ``ap50`` beats the best so
        far.  ``best_info.json`` is written at once, ``best/model.pt`` in the
        background after the write in flight (a previous best's among them)."""
        if ap50 <= self.best_info.get("AP50", -1.0):
            return False
        self.best_info = {"AP50": float(ap50), "iteration": int(step)}
        if comm.is_main():
            with open(self._best_path, "w") as f:
                json.dump(self.best_info, f)
            os.makedirs(os.path.join(self.directory, "best"), exist_ok=True)
        self._start_write(os.path.join(self.directory, "best", "model.pt"), state, prune=False)
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
    saves.  It takes a step's losses still in flight (``takes_lazy_metrics``)
    and reads none, but it drains the trainer's in-flight losses before it
    saves or evaluates: a non-finite loss raises before any checkpoint of the
    state it left is written."""

    takes_lazy_metrics = True

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
        save = bool(self.checkpoint_period) and step % self.checkpoint_period == 0
        evaluate = (self.eval_fn is not None and bool(self.eval_period)
                    and step % self.eval_period == 0 and step >= self.min_eval_period)
        if save or evaluate:
            trainer.drain()
        if save:
            self.ckpt.save(step, trainer.state)
        if evaluate:
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
