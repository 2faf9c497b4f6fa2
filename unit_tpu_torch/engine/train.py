"""Training engine: the train step and the trainer loop.

Port of unit_tpu/engine/train.py:38-191,579-814 for one device.  PyTorch
runs eagerly, so the step is a plain closure (zero_grad -> train_losses ->
sum -> backward -> clip -> SGD step -> LR step) and the trainer moves each
step's batches to the model's device (numpy arrays, or tensors in pinned
memory from a ``data.Prefetcher`` with ``pin_batch``).

What differs from unit_tpu, on purpose:
  * the randomness of step k is one ``torch.Generator`` on the device,
    seeded from (seed, k): the counterpart of ``jax.random.fold_in``;
  * the loss dict comes to the host once per step, as one stacked
    ``tolist()``, and every value is checked for NaN/Inf before any hook
    runs (unit_tpu defers that check past the hooks, so a checkpoint hook
    could save a corrupt state: fault R3 of the reference);
  * ``LazyMetrics``, the remote-TPU fetch pipelining, is not ported
    (ROADMAP Queue 1 item 29).
``GRAD_ACCUM`` > 1 (ROADMAP item 12's follow-up), the meta stream (item 23),
TRAIN_ONLY_WEAK (item 20) and mesh, FSDP, TP and pipeline parallelism (items
27 and 29) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..models.meta_arch import WSRCNN, _not_ported
from ..solver.build import Solver


@dataclasses.dataclass
class TrainState:
    """The training state: the parameters live in ``model``, the momentum in
    ``solver.optimizer``; ``step`` counts the updates done."""

    model: WSRCNN
    solver: Solver
    step: int = 0


def make_train_step(
    model: WSRCNN,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    clip: Optional[Callable[[], None]],
) -> Callable[..., Dict[str, torch.Tensor]]:
    """(strong, weak, generator) -> detached loss dict with ``total_loss``,
    after one update of ``model``'s parameters."""

    def step(strong, weak, generator) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        losses = model.train_losses(generator, strong, weak)
        total = torch.stack(list(losses.values())).sum()
        total.backward()
        if clip is not None:
            clip()
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step`` (fold_in's counterpart)."""
    return (int(seed) << 32) + int(step)


class TrainerBase:
    """The loop: pull a strong and a weak batch, take one step, check the
    losses, call the hooks.  ``optimizer`` is ``solver.build_optimizer``'s
    Solver (SGD, schedule and clipping: what unit_tpu's optax chain holds)."""

    def __init__(
        self,
        model: WSRCNN,
        optimizer: Solver,
        strong_iter: Optional[Iterator] = None,
        weak_iter: Optional[Iterator] = None,
        meta_iter: Optional[Iterator] = None,
        seed: int = 0,
        mesh=None,
        train_only_weak: bool = False,
        fsdp: bool = False,
        tp: bool = False,
        grad_accum: int = 1,
        pp: bool = False,
    ):
        if meta_iter is not None:
            raise _not_ported("the meta (support) stream", "ROADMAP Queue 1 item 23")
        if train_only_weak:
            raise _not_ported("TRAIN_ONLY_WEAK training", "ROADMAP Queue 1 item 20")
        if int(grad_accum) > 1:
            raise _not_ported("TPU.GRAD_ACCUM > 1", "ROADMAP Queue 1 item 12, follow-up")
        if mesh is not None or fsdp or tp or pp:
            raise _not_ported("mesh, FSDP, TP and pipeline parallelism",
                              "ROADMAP Queue 1 items 27 and 29")
        self.model = model
        self.optimizer = optimizer
        self.strong_iter = strong_iter
        self.weak_iter = weak_iter
        self.seed = int(seed)
        self.device = model.embeddings.device
        self.train_step = make_train_step(model, optimizer.optimizer, optimizer.scheduler,
                                          optimizer.clip)
        self.state: Optional[TrainState] = None
        self.stop_requested = False
        self.metrics_history: List[Dict[str, float]] = []

    def init_state(self) -> TrainState:
        """The state at step 0 (the model's current parameters)."""
        self.model.train()
        self.state = TrainState(model=self.model, solver=self.optimizer, step=0)
        return self.state

    def _to_device(self, batch):
        if batch is None:
            return None
        # a Prefetcher with data.loader.pin_batch hands out tensors in pinned
        # memory, from which the copy is asynchronous; numpy arrays (pageable)
        # are copied synchronously whatever the flag says
        return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
                .to(self.device, non_blocking=True) for k, v in batch.items()}

    def run_step(self) -> Dict[str, float]:
        assert self.state is not None, "call init_state() first"
        t0 = time.perf_counter()
        strong = next(self.strong_iter) if self.strong_iter is not None else None
        weak = next(self.weak_iter) if self.weak_iter is not None else None
        data_time = time.perf_counter() - t0
        generator = torch.Generator(device=self.device)
        generator.manual_seed(step_seed(self.seed, self.state.step))
        losses = self.train_step(self._to_device(strong), self._to_device(weak), generator)
        self.state.step += 1
        # one device-to-host fetch per step
        metrics = dict(zip(losses, torch.stack(list(losses.values())).tolist()))
        metrics["data_time"] = data_time
        if not all(np.isfinite(v) for v in metrics.values()):
            raise FloatingPointError(f"non-finite loss at iter {self.state.step}: {metrics}")
        self.metrics_history.append(metrics)
        return metrics

    def train(self, max_iter: int, hooks=()) -> TrainState:
        """Run until ``state.step`` reaches ``max_iter`` (a resumed state
        continues from its step); ``request_stop()`` exits after the current
        step.  Hooks are called as ``hook(step, metrics, trainer)``."""
        assert self.state is not None, "call init_state() first"
        self.stop_requested = False
        for _ in range(self.state.step, max_iter):
            if self.stop_requested:
                break
            metrics = self.run_step()
            for hook in hooks:
                hook(self.state.step, metrics, self)
        return self.state

    def request_stop(self):
        """Ask the loop to exit after the step in flight (safe from a signal
        handler or another thread)."""
        self.stop_requested = True

    def close(self):
        """Close the data iterators that can be closed (prefetch threads)."""
        for it in (self.strong_iter, self.weak_iter):
            if it is not None and hasattr(it, "close"):
                it.close()


class TrainerNoMeta(TrainerBase):
    """Base training: strong (box-labelled) and weak (image-labelled) streams."""
