"""Training engine: the train step and the trainer loop.

Port of unit_tpu/engine/train.py:38-191,579-849.  PyTorch runs eagerly, so
the step is a plain closure (zero_grad -> train_losses -> sum -> backward ->
all-reduce -> clip -> SGD step -> LR step) and the trainer moves each
step's batches to the model's device (numpy arrays, or tensors in pinned
memory from a ``data.Prefetcher`` with ``pin_batch``).  With
``TPU.GRAD_ACCUM`` = A > 1 a step takes A micro-batches of each stream that
share a canvas, backpropagates each one's total / A (one micro-batch's
activations live at a time), clips the summed gradient once and updates once;
the losses it reports are the means (unit_tpu's scan over micro-batches).
``Trainer``, the meta recipe's, adds a third stream: the support batch of
the visual attention head, one a step, shared by all micro-batches.

What differs from unit_tpu, on purpose:
  * the randomness of step k is one ``torch.Generator`` on the device,
    seeded from (seed, k): the counterpart of ``jax.random.fold_in``; a
    model with a VGG box head also gets a dropout generator of its own,
    seeded from the same step seed (``dropout_seed``, where unit_tpu folds 7
    into the step key), so that no other draw of the step moves;
  * a plain hook (a callable) sees only known, finite losses: before it
    runs, the trainer resolves every step still in flight and raises on a
    NaN/Inf (unit_tpu runs its hooks first and checks later, so a checkpoint
    hook could save a corrupt state: fault R3 of the reference).  Only a
    hook that declares ``takes_lazy_metrics`` gets a step's losses in
    flight, and each of the runner's own that saves or evaluates drains
    them first (``drain``).

The deferred loss fetch (unit_tpu's ``LazyMetrics``): ``run_step`` stacks
the step's losses on the device, starts their copy into pinned host memory
and records an event after it, and returns a ``LazyMetrics``; the host reads
the values when they are first asked for, or when ``metrics_pipeline_depth``
(8) later steps have been queued (the oldest first), or when ``train()``
ends.  So the host never waits for the step it has just queued, and the
device has the next step's work queued behind it.  A time a step is read
from the host clock therefore ends at a drain (``drain``): the clock around
one ``run_step`` no longer holds the device's time.

Data parallelism (unit_tpu's 1-D ``data`` mesh): inside a process group
(``parallel.launch``) every rank takes its share of the global batch, and
the step all-reduces the gradients once, after the last micro-batch and
before clipping, so every rank clips and applies the gradient of the global
batch, as unit_tpu's jitted mesh step does.  No ``DistributedDataParallel``:
the one coalesced all-reduce also covers the trainable tensors a step leaves
out of its graph (zero-filled first) and ``TPU.GRAD_ACCUM`` without
``no_sync``.  The losses that unit_tpu divides by a count over the global
batch do so here too (``parallel.comm.global_normalizer``).  The rank is
folded into the step's generator seeds (unit_tpu's pipeline step folds its
``axis_index`` into the key), and the loss vector is averaged over the ranks
when it is resolved, with the stop flag, in one all-reduce of the host copy
(over gloo, or a gloo group beside NCCL: no wait for the device): every rank
resolves the same steps in the same order, logs the global losses, raises on
a non-finite one and stops on the same step, at most
``metrics_pipeline_depth`` steps after a request on any rank.

FSDP and TP (unit_tpu's ``mesh`` with ``fsdp`` or ``tp``): the trainer takes
a ``parallel.mesh`` ``DeviceMesh`` and a model already split over it
(``mesh.fsdp_shard`` / ``mesh.tp_shard``, before its solver is built: the
optimizer holds the split parameters).  The step adapts to the parameters
it finds: FSDP's shards (DTensors) come out of backward reduce-scattered
and averaged over the data ranks, and under ``TPU.GRAD_ACCUM`` their sync
waits for the last micro-batch (``set_requires_gradient_sync``); TP's
slices are averaged over the mesh's data dim; every other gradient, the
losses and the global counts over the world (under TP the model ranks of a
data rank hold the same values, so this is the data ranks' mean, and the
ranks stay bit-identical).  Under TP the seeds and the training loaders'
shards read the DATA rank (``comm.data_rank`` of the mesh's model dim or of
TPU.TP), so the model ranks of one data rank see the same images and draw
the same samples.  Without a mesh ``fsdp`` and ``tp`` are ignored, as in unit_tpu.

Pipeline parallelism (unit_tpu's ``make_pipeline_train_step``, TPU.PP):
the trainer takes a ("data", "stage") mesh (``parallel.mesh.make_mesh_pp``)
and a whole model on every rank.  Stage ranks 0 .. S-2 run balanced groups
of backbone units, the last stage the RPN, the ROI heads and the losses;
the TPU.GRAD_ACCUM micro-batches go through as a GPipe
(``make_pipeline_train_step``).  The S stage ranks of a data rank read the
same batches (the loaders split over the data ranks), pair the strong and
weak groups on one canvas (``_next_pair``, unit_tpu's
``_next_stacked_pair``) and seed with the data rank r // S, so the step
equals the one-process accumulated step on the same micro-batches.  The
losses come from the last stage: summed over the stage ranks and averaged
over the data ranks when they are resolved.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from collections.abc import MutableMapping
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..models.box_heads import VGG_HEADS
from ..models.meta_arch import WSRCNN
from ..models.resnet import ResNetC4, num_units
from ..parallel import comm, spatial
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SPATIAL_AXIS, STAGE_AXIS, axis_size
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
    grad_accum: int = 1,
    train_only_weak: bool = False,
    mesh=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """(strong, weak, generator, meta=None, dropout=None) -> detached loss
    dict with ``total_loss``, after one update of ``model``'s parameters.
    ``dropout``: the VGG heads' dropout generator (None: no dropout).  With
    ``grad_accum`` A > 1 each of the first three arguments (and ``dropout``
    where given) is a list of A
    (the micro-batches and their generators; ``weak`` may be None): each
    micro-batch backpropagates its total / A, so the update uses the mean of
    their gradients, and the dict holds the mean of their losses (A = 1
    divides by one: exact).  ``meta``, the support batch (``Trainer``), is
    one for the step: every micro-batch reads it, as in unit_tpu.
    ``train_only_weak`` goes to ``train_losses`` (TrainerOnlyWeak).  In a
    process group the gradients are averaged over the data ranks before
    ``clip``: FSDP's by FSDP, TP's slices over the data dim of ``mesh``, the
    rest over the world (``parallel.mesh``).

    On a ``make_mesh_2d`` (data, spatial) ``mesh`` each rank's batches are
    its ``shard_batch_spatial`` part (its data rank's images, its band of
    their rows) and ``generator`` is seeded by its data rank (rank // S):
    the backbone runs on the bands and the rest of the step on the gathered
    map (``parallel.spatial``), every spatial rank of a data rank computing
    its losses whole; the world's mean of the gradients is then the data
    ranks' mean (S times each share over S times the ranks).  A ResNet-C4
    backbone and ``grad_accum`` 1 only."""
    accum = int(grad_accum)
    bands = None
    if mesh is not None and SPATIAL_AXIS in (mesh.mesh_dim_names or ()):
        if accum > 1:  # unit_tpu asserts grad_accum <= 1 here
            raise ValueError("grad accumulation + spatial mesh not supported: the 2-D "
                             f"(data x spatial) step takes GRAD_ACCUM 1, got {accum}")
        bands = spatial.bands_of(mesh)
    trainable = [p for group in optimizer.param_groups for p in group["params"]]
    fsdp = model if isinstance(model, FSDPModule) else None
    split = [p for p in trainable if hasattr(p, "tp_shard")]
    if split and mesh is None:
        raise ValueError("a model split by TP needs its mesh: make_train_step(mesh=...)")
    data_group = mesh.get_group(DATA_AXIS) if split else None
    whole = [p for p in trainable if not isinstance(p, DTensor) and not hasattr(p, "tp_shard")]

    def reduce(_grads):  # FSDP's shards are reduced by FSDP
        if split:  # TP's slices
            comm.all_reduce_mean_tensors([p.grad for p in split], data_group)
        comm.all_reduce_mean_tensors([p.grad for p in whole])  # one rank: nothing

    def step(strong, weak, generator, meta=None, dropout=None) -> Dict[str, torch.Tensor]:
        if accum == 1:
            strong, weak, generator, dropout = [strong], [weak], [generator], [dropout]
        optimizer.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for i, (s, w, g, d) in enumerate(zip(
                strong, weak if weak is not None else [None] * accum, generator,
                dropout if dropout is not None else [None] * accum, strict=True)):
            if fsdp is not None and accum > 1:  # reduce-scatter after the last one
                fsdp.set_requires_gradient_sync(i == accum - 1)
            with spatial.banded(bands):
                losses = model.train_losses(g, s, w, train_only_weak=train_only_weak,
                                            meta=meta, dropout_generator=d)
            _backward_micro(losses, accum, sums)
        _apply_update(trainable, reduce, clip, optimizer, scheduler)
        return {k: v / accum for k, v in sums.items()}

    return step


def _backward_micro(losses: Dict[str, torch.Tensor], accum: int,
                    sums: Dict[str, torch.Tensor]) -> None:
    """Backpropagate one micro-batch's total / ``accum`` and add its detached
    losses, ``total_loss`` among them, to ``sums``."""
    total = torch.stack(list(losses.values())).sum()
    (total / accum).backward()
    losses["total_loss"] = total
    for k, v in losses.items():
        sums[k] = sums[k] + v.detach() if k in sums else v.detach()


def _apply_update(trainable, reduce, clip, optimizer, scheduler) -> None:
    """The update both steps share: a zero gradient for a trainable tensor
    outside the step's graph (the weak detector in a strong-only step, the
    other stages' units: it still decays, as unit_tpu's zero gradient does;
    an FSDP shard's zeros are a DTensor like it), ``reduce(grads)`` over the
    ranks, then the clip, the SGD step and the schedule."""
    for p in trainable:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    reduce([p.grad for p in trainable])
    if clip is not None:
        clip()
    optimizer.step()
    scheduler.step()


def _balanced_unit_groups(costs, g):
    """Minimax contiguous partition of ``costs`` into ``g`` non-empty groups
    (unit_tpu train.py:194-223, the linear-partition DP): ``[(start, stop),
    ...]`` half-open ranges."""
    n = len(costs)
    if not 1 <= g <= n:
        raise ValueError(f"{g} groups of {n} units")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(g + 1)]
    cut = [[0] * (n + 1) for _ in range(g + 1)]
    best[0][0] = 0.0
    for k in range(1, g + 1):
        for i in range(k, n + 1):
            for j in range(k - 1, i):
                v = max(best[k - 1][j], prefix[i] - prefix[j])
                if v < best[k][i]:
                    best[k][i] = v
                    cut[k][i] = j
    bounds = [n]
    for k in range(g, 0, -1):
        bounds.append(cut[k][bounds[-1]])
    bounds.reverse()
    return [(bounds[t], bounds[t + 1]) for t in range(g)]


def _stage_segment(model: WSRCNN, units, n_units: int, remat: bool) -> Callable:
    """(strong, weak, feats) -> the map of a backbone stage's ``units``
    (start, stop): the whole backbone (``backbone_features``, every family)
    or a ResNet-C4 range (``backbone_segment``).  With ``remat`` the range
    runs under one ``torch.utils.checkpoint``, and the model's own
    (TPU.REMAT_BACKBONE) is skipped inside it: nested, the inner range
    would run a third time in backward (unit_tpu nests a second
    ``jax.checkpoint`` there)."""
    start, stop = units
    inner = False if remat else None

    def segment(strong, weak, feats):
        if start == 0 and stop == n_units:
            return model.backbone_features(strong, weak, remat=inner)
        return model.backbone_segment(strong, weak, feats, start, stop, remat=inner)

    if not remat:
        return segment
    return functools.partial(checkpoint, segment, use_reentrant=False, preserve_rng_state=False)


def make_pipeline_train_step(
    model: WSRCNN,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    clip: Optional[Callable[[], None]],
    mesh,
    n_micro: int,
    train_only_weak: bool = False,
    remat: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The GPipe step of one stage rank of the ("data", "stage") ``mesh``
    (unit_tpu train.py:226-467): (strong, weak, generator, meta=None,
    dropout=None) -> detached loss dict with ``total_loss``, after one
    update; each argument but ``meta`` a list of ``n_micro`` micro-batches
    (``weak`` may be None), as ``make_train_step`` takes them under
    accumulation.

    Stages 0 .. S-2 run ``_balanced_unit_groups`` of the ResNet-C4 units
    (costs 0.5 for the stem, 1 a bottleneck block); another backbone splits
    only at its end (S = 2, ``backbone_features``).  Stage 0 reads the
    images, every later stage the [B, h, w, C] map its neighbour hands on
    (``comm.send_map``; a header gives the shape once per canvas), and the
    last runs ``train_losses(backbone_feats=...)`` with ``generator[i]``,
    its global counts local (``comm.local_counts``).  Forward, each stage
    takes the micro-batches in order and hands each map on as it is made;
    the last stage backpropagates each micro-batch's total / M at once and
    sends the maps' gradients back after the last map has come, and the
    stages before it then backpropagate in order, so every link carries the
    forward maps before the gradients (no cycle, whichever backend).  With
    ``remat`` a backbone range keeps only its input and recomputes in
    backward (``torch.utils.checkpoint``: exact, the backbone draws nothing
    random), whatever TPU.REMAT_BACKBONE says, as in unit_tpu
    (``_stage_segment``); the last stage keeps each micro-batch's graph
    only until its backward, as a replay would draw other samples from its
    generators.
    Each rank's gradients are non-zero on its own units alone: they are
    summed over the world and divided by the data ranks (unit_tpu's psum
    over 'stage', pmean over 'data'), then clipped and applied on every
    rank, which all hold the whole model.  The losses are the last stage's
    micro-batch means; other stages return zeros under the same keys (agreed
    at the first step), for the trainer's sum over the world."""
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if STAGE_AXIS not in names:
        raise ValueError("pipeline step needs a 'stage' mesh axis")
    n_stage, n_data = axis_size(mesh, STAGE_AXIS), axis_size(mesh, DATA_AXIS)
    n_units = num_units(model.mc.depth) if isinstance(model.backbone, ResNetC4) else 1
    if not 2 <= n_stage <= n_units + 1:
        raise ValueError(f"pipeline stages must be in [2, {n_units + 1}] for this backbone, "
                         f"got {n_stage}")
    accum = int(n_micro)
    if accum < 2:
        raise ValueError("pipeline parallelism pipelines TPU.GRAD_ACCUM microbatches; "
                         "set GRAD_ACCUM >= 2")
    groups = _balanced_unit_groups([0.5] + [1.0] * (n_units - 1), n_stage - 1)
    stage = mesh.get_local_rank(STAGE_AXIS)
    last = stage == n_stage - 1
    ranks = torch.distributed.get_process_group_ranks(mesh.get_group(STAGE_AXIS))
    prev, nxt = (ranks[stage - 1] if stage > 0 else None), (None if last else ranks[stage + 1])
    device = model.embeddings.device
    trainable = [p for group in optimizer.param_groups for p in group["params"]]
    headers_in: Dict[tuple, tuple] = {}  # canvas -> (shape, dtype, requires_grad)
    headers_out: set = set()
    loss_keys: List[str] = []

    run_segment = None if last else _stage_segment(model, groups[stage], n_units, remat)

    def canvas(strong, weak):  # the micro-batch's key: the same on every stage rank
        return tuple(None if b is None else tuple(b["image"].shape) for b in (strong, weak))

    def receive(key):
        if key not in headers_in:
            headers_in[key] = comm.recv_header(prev, device)
        shape, dtype, wants_grad = headers_in[key]
        return comm.recv_map(shape, dtype, prev, device).requires_grad_(wants_grad)

    def hand_on(y, key, pending):
        if key not in headers_out:
            comm.send_header(y, nxt, y.requires_grad)
            headers_out.add(key)
        pending += comm.send_map(y.detach(), nxt)

    def backbone_stage(strong, weak):
        pending, ins, outs = [], [], []
        for s, w in zip(strong, weak):
            key = canvas(s, w)
            x = None if stage == 0 else receive(key)
            args = (s, w, None) if stage == 0 else (None, None, x)
            y = run_segment(*args)
            hand_on(y, key, pending)
            ins.append(x)
            outs.append(y)
        for x, y in zip(ins, outs):
            if y.requires_grad:
                y.backward(comm.recv_map(y.shape, y.dtype, nxt, device))
            if x is not None and x.requires_grad:
                pending += comm.send_map(torch.zeros_like(x) if x.grad is None else x.grad,
                                         prev)
        comm.wait_all(pending)
        return {}

    def heads_stage(strong, weak, generator, dropout):
        sums: Dict[str, torch.Tensor] = {}
        back = []
        for s, w, g, d in zip(strong, weak, generator, dropout):
            x = receive(canvas(s, w))
            with comm.local_counts():
                losses = model.train_losses(g, s, w, train_only_weak=train_only_weak,
                                            dropout_generator=d, backbone_feats=x)
            _backward_micro(losses, accum, sums)
            if x.requires_grad:
                back.append(torch.zeros_like(x) if x.grad is None else x.grad)
        pending = []
        for gx in back:  # after the last map: the link's maps before its gradients
            pending += comm.send_map(gx, prev)
        comm.wait_all(pending)
        return {k: v / accum for k, v in sums.items()}

    def step(strong, weak, generator, meta=None, dropout=None) -> Dict[str, torch.Tensor]:
        if meta is not None:
            raise ValueError("pipeline parallelism does not support the meta/support stream")
        weak = weak if weak is not None else [None] * accum
        optimizer.zero_grad(set_to_none=True)
        if last:
            losses = heads_stage(strong, weak, generator,
                                 dropout if dropout is not None else [None] * accum)
        else:
            losses = backbone_stage(strong, weak)
        if not loss_keys:  # the last stage's keys, in its order, on every rank
            loss_keys.extend(next(keys for keys in comm.gather_objects(
                list(losses) if last else None) if keys is not None))
        _apply_update(trainable, lambda grads: comm.all_reduce_mean_tensors(
            grads, divisor=n_data), clip, optimizer, scheduler)
        zero = torch.zeros((), device=device)
        return {k: losses.get(k, zero) for k in loss_keys}

    return step


def step_seed(seed: int, step: int, micro: int = 0, grad_accum: int = 1, rank: int = 0) -> int:
    """The generator seed of micro-batch ``micro`` of step ``step`` on data
    rank ``rank`` (fold_in's counterpart); without accumulation, on rank 0,
    (seed, step) alone.  Data ranks draw different samples for their
    different images; the model ranks of one data rank the same ones."""
    return (int(seed) << 32) + (int(rank) << 48) + int(step) * int(grad_accum) + int(micro)


def dropout_seed(seed: int) -> int:
    """The dropout generator's seed for a step seed (``step_seed``): 7 in its
    top byte, as unit_tpu folds 7 into the step key; another Philox stream
    than the sampling generator's."""
    return (int(seed) + (7 << 56)) % (1 << 64)


def _check_split(model, mesh, fsdp: bool) -> None:
    """Refuse a model that the mesh's mode has not split: its solver would
    hold the whole parameters."""
    if fsdp and not isinstance(model, FSDPModule):
        raise ValueError("fsdp: split the model with parallel.mesh.fsdp_shard(model, mesh) "
                         "before building its solver")
    if not fsdp and axis_size(mesh, MODEL_AXIS) > 1 and not any(
            hasattr(p, "tp_shard") for p in model.parameters()):
        raise ValueError("tp: split the model with parallel.mesh.tp_shard(model, mesh) "
                         "before building its solver")


class LazyMetrics(MutableMapping):
    """One step's losses and ``data_time``, read on the host when first
    needed (unit_tpu's ``LazyMetrics``): a mapping of floats, equal to the
    dict of them, that resolves on its first read (its trainer's older steps
    first, so every rank's all-reduces go in step order).  Resolution waits
    for the copy's event and raises ``FloatingPointError`` naming the step
    when a value is not finite.  Pickled, it is the dict of its values."""

    __slots__ = ("_trainer", "step", "_names", "_values", "_event", "_data_time", "_vals")

    def __init__(self, trainer, step: int, names, values: torch.Tensor, event,
                 data_time: float):
        self._trainer, self.step = trainer, int(step)
        self._names, self._values, self._event = list(names), values, event
        self._data_time = data_time
        self._vals: Optional[Dict[str, float]] = None

    @property
    def resolved(self) -> bool:
        return self._vals is not None

    def resolve(self) -> Dict[str, float]:
        """The values (the dict itself, resolved once)."""
        if self._vals is None:
            self._trainer._resolve_through(self)
        return self._vals

    def _settle(self, combine: Callable[[torch.Tensor], List[float]]) -> None:
        """Wait for the copy, read (``combine``: the ranks' combination)
        and check the values."""
        if self._event is not None:
            self._event.synchronize()
        vals = dict(zip(self._names, combine(self._values)))
        vals["data_time"] = self._data_time
        self._vals, self._values, self._event, self._trainer = vals, None, None, None
        if not all(np.isfinite(v) for v in vals.values()):
            raise FloatingPointError(f"non-finite loss at iter {self.step}: {vals}")

    def __getitem__(self, key):
        return self.resolve()[key]

    def __setitem__(self, key, value):
        self.resolve()[key] = value

    def __delitem__(self, key):
        del self.resolve()[key]

    def __iter__(self):
        return iter(self.resolve())

    def __len__(self):
        return len(self.resolve())

    def __reduce__(self):
        return dict, (dict(self.resolve()),)

    def __repr__(self):
        return repr(self._vals) if self._vals is not None else (
            f"LazyMetrics(step={self.step}, in flight)")


class TrainerBase:
    """The loop: pull a strong and a weak batch (and a support batch where
    there is a ``meta_iter``), take one step, check the losses, call the
    hooks.  ``optimizer`` is ``solver.build_optimizer``'s
    Solver (SGD, schedule and clipping: what unit_tpu's optax chain holds).
    ``metrics_pipeline_depth``: the steps whose losses may be in flight
    (0: each step's are read at its end)."""

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
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        # unit_tpu's refusals (train.py:613-624), in its order
        if fsdp and tp:
            raise ValueError("fsdp and tp are mutually exclusive sharding modes")
        if pp and (fsdp or tp):
            raise ValueError("pipeline parallelism does not compose with FSDP/TP")
        if pp and int(grad_accum) < 2:
            raise ValueError("pipeline parallelism pipelines the TPU.GRAD_ACCUM microbatches; "
                             "set TPU.GRAD_ACCUM >= 2")
        if pp and meta_iter is not None:
            raise ValueError("pipeline parallelism does not support the meta stream")
        if mesh is not None and SPATIAL_AXIS in (mesh.mesh_dim_names or ()):
            # unit_tpu's trainer shards only the batch there (train.py:742-745):
            # its spatial ranks would each run their data rank's whole step
            raise ValueError("the trainer does not run the 2-D (data x spatial) mesh: build "
                             "the step with engine.train.make_train_step(mesh=...) and give "
                             "each rank parallel.mesh.shard_batch_spatial(mesh, batch)")
        if mesh is not None and (fsdp or tp):
            _check_split(model, mesh, fsdp)
        self.mesh = mesh
        self.model = model
        self.optimizer = optimizer
        self.strong_iter = strong_iter
        self.weak_iter = weak_iter
        self.meta_iter = meta_iter
        self.seed = int(seed)
        self.pp = bool(pp)
        # the seeds fold the data rank (TP's model ranks of one share it, and
        # PP's stage ranks); the losses' combine and the stop request span
        # the world
        if self.pp:
            model_ranks = axis_size(mesh, STAGE_AXIS) if mesh is not None else 1
        else:
            model_ranks = axis_size(mesh, MODEL_AXIS) if mesh is not None and tp else 1
        self.rank, self.world = comm.data_rank(model_ranks), comm.world()
        # the losses are averaged over the world, or under PP (where only the
        # last stage has them) summed over the stage ranks, averaged over the
        # data ranks
        self._loss_ranks = comm.data_world(model_ranks) if self.pp else self.world
        self.grad_accum = int(grad_accum)
        # micro-batches waiting for A of their canvas, per stream and canvas
        self._accum_buf: Dict[str, Dict[tuple, list]] = {"strong": {}, "weak": {}}
        self.device = model.embeddings.device
        # train-mode dropout for the VGG fc heads alone, as unit_tpu's step
        self.dropout = model.mc.box_head_name in VGG_HEADS
        self.train_only_weak = bool(train_only_weak)
        if self.pp:
            self.train_step = make_pipeline_train_step(
                model, optimizer.optimizer, optimizer.scheduler, optimizer.clip, mesh,
                self.grad_accum, self.train_only_weak)
            self._stage = mesh.get_local_rank(STAGE_AXIS)
            self._last_stage = self._stage == axis_size(mesh, STAGE_AXIS) - 1
        else:
            self.train_step = make_train_step(model, optimizer.optimizer, optimizer.scheduler,
                                              optimizer.clip, self.grad_accum,
                                              self.train_only_weak, mesh=mesh)
        self.state: Optional[TrainState] = None
        self.stop_requested = False
        self._stop_agreed = False  # a stop request of some rank, seen by all (world > 1)
        self.metrics_history: List[LazyMetrics] = []
        # unit_tpu's bounded queue of steps whose losses are in flight
        self.metrics_pipeline_depth = 8
        self._inflight: "deque[LazyMetrics]" = deque()
        # the losses' all-reduce runs on the host copies: the default group
        # under gloo, a gloo group of the same ranks beside NCCL
        self._host_group = comm.host_group() if self.world > 1 else None

    def init_state(self) -> TrainState:
        """The state at step 0 (the model's current parameters; in a process
        group rank 0's, broadcast to every rank)."""
        self.model.train()
        comm.broadcast_module(self.model)
        self.state = TrainState(model=self.model, solver=self.optimizer, step=0)
        return self.state

    def _to_device(self, batch, host_keys=()):
        """``batch`` as tensors on the model's device, but for ``host_keys``,
        which stay on the host."""
        if batch is None:
            return None
        # a Prefetcher with data.loader.pin_batch hands out tensors in pinned
        # memory, from which the copy is asynchronous; numpy arrays (pageable)
        # are copied synchronously whatever the flag says.  Every dtype is
        # kept: uint8 images (TPU.HOST_TRANSFER_UINT8) go up as uint8, and
        # WSRCNN.preprocess casts them to f32 on the device
        host = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                for k, v in batch.items()}
        out = {k: v if k in host_keys else v.to(self.device, non_blocking=True)
               for k, v in host.items()}
        if "labels" in host:  # the PCL losses read the classes present from the host
            out["labels_host"] = host["labels"]
        return out

    def _next_group(self, it, buffers) -> list:
        """Pull micro-batches until ``grad_accum`` of them share one canvas (the
        same image shape); batches of another canvas wait in ``buffers`` for a
        later group (unit_tpu's ``_next_stacked``, unstacked).  With A = 1,
        the next batch."""
        while True:
            batch = next(it)
            group = buffers.setdefault(tuple(batch["image"].shape), [])
            group.append(batch)
            if len(group) == self.grad_accum:
                return buffers.pop(tuple(batch["image"].shape))

    def _next_pair(self):
        """Under PP, the strong and the weak group drawn together until one
        canvas holds ``grad_accum`` batches of each (unit_tpu's
        ``_next_stacked_pair``, unstacked, in its order): the first stage's
        fused pass needs both on one canvas.  Batches of other canvases wait
        in the buffers."""
        sb, wb = self._accum_buf["strong"], self._accum_buf["weak"]
        a = self.grad_accum

        def ready():
            for k_s, v_s in sb.items():
                if len(v_s) < a:
                    continue
                for k_w, v_w in wb.items():
                    if len(v_w) >= a and k_s[1:3] == k_w[1:3]:  # the same (H, W)
                        return k_s, k_w
            return None

        while (keys := ready()) is None:
            for it, buf in ((self.strong_iter, sb), (self.weak_iter, wb)):
                batch = next(it)
                buf.setdefault(tuple(batch["image"].shape), []).append(batch)
        k_s, k_w = keys
        group_s, sb[k_s] = sb[k_s][:a], sb[k_s][a:]
        group_w, wb[k_w] = wb[k_w][:a], wb[k_w][a:]
        return group_s, group_w

    def _stage_batch(self, batch):
        """Under PP, what this stage reads of a micro-batch: the images on the
        device at the first stage, everything else on the device and the
        images on the host (for their shape) at the last, and nothing on the
        device in between (the shapes key the hand-off)."""
        if self._stage == 0:
            return self._to_device({"image": batch["image"]})
        return self._to_device(batch, ("image",) if self._last_stage else tuple(batch))

    def _generator(self, micro: int, dropout: bool = False) -> torch.Generator:
        """The sampling generator of micro-batch ``micro`` of this step, or
        with ``dropout`` its dropout generator."""
        seed = step_seed(self.seed, self.state.step, micro, self.grad_accum, self.rank)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(dropout_seed(seed) if dropout else seed)
        return generator

    def run_step(self) -> LazyMetrics:
        """One step; its losses as a ``LazyMetrics``, in flight until read or
        until ``metrics_pipeline_depth`` later steps (``drain``)."""
        assert self.state is not None, "call init_state() first"
        t0 = time.perf_counter()
        if self.pp and self.strong_iter is not None and self.weak_iter is not None:
            strong, weak = self._next_pair()
        else:
            strong, weak = (
                None if it is None else self._next_group(it, self._accum_buf[name])
                for name, it in (("strong", self.strong_iter), ("weak", self.weak_iter)))
        # one support batch a step, shared by the micro-batches
        meta = None if self.meta_iter is None else next(self.meta_iter)
        data_time = time.perf_counter() - t0
        move = self._stage_batch if self.pp else self._to_device
        strong, weak = (None if group is None else [move(b) for b in group]
                        for group in (strong, weak))
        meta = self._to_device(meta)  # pinned by the runner's Prefetcher: asynchronous
        # the draws are the last stage's alone under PP
        draws = not self.pp or self._last_stage
        generators = [self._generator(i) if draws else None for i in range(self.grad_accum)]
        dropouts = ([self._generator(i, dropout=True) for i in range(self.grad_accum)]
                    if self.dropout and draws else None)
        if self.grad_accum == 1:  # make_train_step's arguments without accumulation
            strong, weak, generators = strong and strong[0], weak and weak[0], generators[0]
            dropouts = dropouts and dropouts[0]
        losses = self.train_step(strong, weak, generators, meta, dropouts)
        self.state.step += 1
        values, event = torch.stack(list(losses.values())), None
        if values.is_cuda:  # the copy starts now; the host reads it later
            host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            values, event = host.copy_(values, non_blocking=True), torch.cuda.Event()
            event.record()
        metrics = LazyMetrics(self, self.state.step, losses, values, event, data_time)
        self._inflight.append(metrics)
        self.metrics_history.append(metrics)
        while len(self._inflight) > self.metrics_pipeline_depth:
            self._settle(self._inflight.popleft())
        return metrics

    def _combine(self, values: torch.Tensor) -> List[float]:
        """A step's host loss vector as floats: in a process group the ranks'
        mean, and whether any rank was asked to stop, from one all-reduce of
        the host copies.  Under TP the model ranks of a data rank hold the
        same losses, so the world's mean is the data ranks' mean; under PP
        the stages before the last hold zeros, so the sum over the world
        divided by the data ranks is theirs."""
        if self.world == 1:
            return values.tolist()
        values = comm.all_reduce_sum(torch.cat(
            [values.float(), values.new_full((1,), float(self.stop_requested), dtype=torch.float32)]),
            self._host_group).div_(self._loss_ranks).tolist()
        self._stop_agreed = values.pop() > 0
        return values

    def _settle(self, metrics: LazyMetrics) -> None:
        metrics._settle(self._combine)

    def _resolve_through(self, metrics: LazyMetrics) -> None:
        """Resolve the steps in flight, oldest first, up to ``metrics``."""
        while not metrics.resolved:  # (a step dropped after a failure: itself)
            self._settle(self._inflight.popleft() if self._inflight else metrics)

    def drain(self) -> None:
        """Resolve every step whose losses are in flight, oldest first: a
        ``FloatingPointError`` names the first non-finite one."""
        while self._inflight:
            self._settle(self._inflight.popleft())

    def train(self, max_iter: int, hooks=()) -> TrainState:
        """Run until ``state.step`` reaches ``max_iter`` (a resumed state
        continues from its step); ``request_stop()`` exits after the current
        step (in a process group, on the step where every rank has seen it).
        Hooks are called as ``hook(step, metrics, trainer)``: a hook with a
        true ``takes_lazy_metrics`` attribute gets the step's ``LazyMetrics``
        in flight, any other is called after ``drain()``.  The losses still
        in flight are resolved before this returns; after an exception they
        are dropped."""
        assert self.state is not None, "call init_state() first"
        self.stop_requested = self._stop_agreed = False
        finished = False
        try:
            for _ in range(self.state.step, max_iter):
                # in a process group the ranks stop together, on the request
                # that the last resolution's all-reduce carried
                if self._stop_agreed if self.world > 1 else self.stop_requested:
                    break
                metrics = self.run_step()
                for hook in hooks:
                    if not getattr(hook, "takes_lazy_metrics", False):
                        self.drain()
                    hook(self.state.step, metrics, self)
            finished = True
        finally:
            try:
                if finished:
                    self.drain()
            finally:  # after a failure the later steps go unread
                self._inflight.clear()
        if self.world > 1:
            self.stop_requested = self._stop_agreed
        return self.state

    def request_stop(self):
        """Ask the loop to exit after the step in flight (safe from a signal
        handler or another thread)."""
        self.stop_requested = True

    def close(self):
        """Close the data iterators that can be closed (prefetch threads)."""
        for it in (self.strong_iter, self.weak_iter, self.meta_iter):
            if it is not None and hasattr(it, "close"):
                it.close()


class TrainerNoMeta(TrainerBase):
    """Base training: strong (box-labelled) and weak (image-labelled) streams."""


class Trainer(TrainerBase):
    """The meta recipe's trainer: strong, weak and support streams; the
    support batch feeds the visual attention head's prototypes and rank
    losses each step (unit_tpu train.py:816-819)."""


class TrainerFineTune(TrainerBase):
    """k-shot fine-tuning: the strong stream only (unit_tpu train.py:822-827)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("weak_iter", None)
        super().__init__(*args, **kwargs)


class TrainerOnlyWeak(TrainerBase):
    """Weak-branch-only training: the RPN on the strong stream, the weak
    branch on the weak one, nothing else (unit_tpu train.py:830-835)."""

    def __init__(self, *args, **kwargs):
        kwargs["train_only_weak"] = True
        super().__init__(*args, **kwargs)


class TrainerOnlyWeakFineTune(TrainerBase):
    """The classifier datasets, with their boxes, as the strong stream and no
    weak stream (unit_tpu train.py:838-849); the runner builds that stream
    with ``data.loader.build_classifier_strong_loader``."""

    def __init__(self, *args, **kwargs):
        kwargs["weak_iter"] = None
        super().__init__(*args, **kwargs)
