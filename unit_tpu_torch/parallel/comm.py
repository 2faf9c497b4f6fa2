"""Rank queries and collectives over the default process group or a given one.

Port of unit_tpu/parallel/comm.py (the cross-host gather of the evaluators)
and of what unit_tpu's jitted mesh step does implicitly: the gradient
all-reduce, and the counts over the global batch that some losses divide by.
Every function works without a process group, as the identity of one rank,
so single-process code calls them unconditionally.

The data rank: which share of the images a rank reads.  Under tensor
parallelism over M model ranks (``parallel.mesh.make_mesh_tp``) rank r sits
at (r // M, r % M), so ``data_rank(M)`` is r // M and the M model ranks of
one data rank read the same images; without it M is 1 and the data rank is
the rank.  The caller passes M (the loaders TPU.TP, the trainer its mesh's
model dim): nothing here remembers a mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world() -> int:
    return dist.get_world_size() if _active() else 1


def group_size(group) -> int:
    """The ranks of ``group`` (None: the world)."""
    return world() if group is None else dist.get_world_size(group)


def data_world(model_ranks: int = 1) -> int:
    """The data ranks when ``model_ranks`` ranks share each one's images
    (TPU.TP; 1: every rank its own); they must divide the world."""
    n = world()
    if n % model_ranks:
        raise ValueError(f"the {n} ranks are not divisible by TPU.TP={model_ranks}")
    return n // model_ranks


def data_rank(model_ranks: int = 1) -> int:
    """This rank's data rank when ``model_ranks`` neighbouring ranks share
    each one's images: rank r at (r // M, r % M)."""
    data_world(model_ranks)
    return rank() // model_ranks


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world() > 1:
        if dist.get_backend() == "nccl":  # on this rank's card, not a guessed one
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of ``group`` (None: the world), in place
    (``t`` itself is returned); one rank: ``t``."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks of ``group`` (None: the world), in place; one
    rank: ``t`` untouched.  Summed and divided by their count."""
    n = group_size(group)
    if n > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)
    return t


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[tuple, List[torch.Tensor]]:
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


def _coalesced(tensors: Iterable[torch.Tensor], collective) -> None:
    """Apply ``collective`` (in place, on one flat tensor) to ``tensors`` with
    one call per dtype and device: few large messages, not one a tensor."""
    for group in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        for t, chunk in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(chunk.view(t.shape))


def all_reduce_mean_tensors(tensors: List[torch.Tensor], group=None) -> None:
    """Each tensor of ``tensors`` replaced by its mean over the ranks of
    ``group`` (None: the world), in place, coalesced (the train step's
    gradient all-reduce).  One rank: nothing."""
    if group_size(group) > 1:
        _coalesced(tensors, lambda flat: all_reduce_mean(flat, group))


def is_split(t: torch.Tensor) -> bool:
    """Whether ``t`` is one rank's part of a larger tensor: an FSDP shard (a
    DTensor) or a tensor-parallel slice (``parallel.tensor``)."""
    return isinstance(t, DTensor) or hasattr(t, "tp_shard")


def broadcast_module(module: nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank, in place, so that
    the ranks start from one state.  The parts of split tensors stay (each
    rank holds its own; ``parallel.mesh`` broadcasts before it splits).  One
    rank: nothing."""
    if world() > 1:
        with torch.no_grad():
            _coalesced([t for t in list(module.parameters()) + list(module.buffers())
                        if not is_split(t)],
                       lambda flat: dist.broadcast(flat, src=0))


def gather_objects(obj: Any) -> List[Any]:
    """One entry a rank, in rank order, on every rank (``all_gather_object``:
    pickled, so only for objects this program made).  One process: ``[obj]``."""
    n = world()
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj)
    return out


def global_normalizer(count: torch.Tensor) -> torch.Tensor:
    """The divisor of a loss that unit_tpu normalises by a count over the
    GLOBAL batch (valid ROIs, foreground ROIs), given this rank's ``count``.

    Every rank's gradient is averaged over the data ranks, so a rank's loss
    ``sum_rank / (N_global / data_world)`` averages to ``sum_all /
    N_global``: the loss of the whole batch.  The sum and the count run over
    the world: under TP the M model ranks of a data rank count the same
    images, so the world's sum is M * N_global and its size M * data_world,
    whose quotient is the same.  One rank: ``count.clamp_min(1)``.  A
    collective: every rank must call it, in the same order."""
    count = count.detach().to(torch.float32)
    n = world()
    if n == 1:
        return count.clamp_min(1.0)
    total = all_reduce_sum(count.clone())
    return total.clamp_min(1.0) / n
