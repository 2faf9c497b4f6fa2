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
model dim): nothing here remembers a mesh.  Under pipeline parallelism
(``parallel.mesh.make_mesh_pp``) the S stage ranks of a data rank are the
neighbours r // S * S .. + S - 1, and ``data_rank(S)`` is r // S as well.

The pipeline's hand-off (``send_map`` / ``recv_map``) moves one tensor
between neighbouring stage ranks.  Over NCCL the device tensor goes as it
is; over gloo a CUDA tensor is staged through pinned host memory here
(gloo's point-to-point ops take host memory).  Inside a pipeline's last
stage (``local_counts``) ``global_normalizer`` counts this rank's batch
alone: the stage ranks before it never reach that call.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterable, List, Optional

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


_HOST_GROUP: List[Any] = []  # [the default group it was made in, the gloo group]


def host_group():
    """The group for collectives on host tensors over the whole world: None
    (the default group) where that is gloo, else a gloo group of the same
    ranks, made at the first call in a process group (a collective: every
    rank makes it)."""
    if dist.get_backend() == "gloo":
        return None
    if not _HOST_GROUP or _HOST_GROUP[0] is not dist.group.WORLD:
        _HOST_GROUP[:] = [dist.group.WORLD, dist.new_group(backend="gloo")]
    return _HOST_GROUP[1]


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


def all_reduce_mean_tensors(tensors: List[torch.Tensor], group=None,
                            divisor: Optional[int] = None) -> None:
    """Each tensor of ``tensors`` replaced by its sum over the ranks of
    ``group`` (None: the world) divided by ``divisor`` (None: their count,
    the mean), in place, coalesced (the train step's gradient all-reduce;
    the pipeline step's divides by the data ranks alone: the stage ranks'
    parts summed, the data ranks averaged).  One rank: nothing."""
    n = group_size(group)
    if n > 1:
        _coalesced(tensors, lambda flat: all_reduce_sum(flat, group).div_(divisor or n))


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


_LOCAL_COUNTS = contextvars.ContextVar("local_counts", default=False)


@contextlib.contextmanager
def local_counts():
    """Within the block ``global_normalizer`` counts this rank's batch and
    makes no collective: a pipeline's last stage, which alone computes the
    losses, on its local micro-batch, as unit_tpu's pipeline step does
    inside ``shard_map``."""
    token = _LOCAL_COUNTS.set(True)
    try:
        yield
    finally:
        _LOCAL_COUNTS.reset(token)


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
    if n == 1 or _LOCAL_COUNTS.get():
        return count.clamp_min(1.0)
    total = all_reduce_sum(count.clone())
    return total.clamp_min(1.0) / n


# ----------------------------------------------------------- the hand-off
def _through_host(device: torch.device) -> bool:
    """Whether a tensor on ``device`` must be staged through the host: a
    card's, over gloo."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def send_map(t: torch.Tensor, dst: int) -> List[Any]:
    """Start sending ``t`` (contiguous) to rank ``dst``; returns what
    ``wait_all`` must wait for (the request and the buffer it reads).  Over
    gloo a CUDA tensor is first copied to pinned host memory (which waits
    for the kernels that made it)."""
    if _through_host(t.device):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return [(dist.isend(t, dst), t)]


def recv_map(shape, dtype: torch.dtype, src: int, device: torch.device) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` that rank ``src`` sends, on
    ``device`` (over gloo to a card: received in pinned host memory, then
    copied up asynchronously)."""
    if _through_host(device):
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(host, src)
        return host.to(device, non_blocking=True)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, src)
    return out


def wait_all(pending: List[Any]) -> None:
    """Wait for the sends ``send_map`` started (and keep their buffers alive
    until then)."""
    for work, _ in pending:
        work.wait()
    pending.clear()


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def send_header(t: torch.Tensor, dst: int, requires_grad: bool) -> None:
    """Tell rank ``dst`` the shape (4-D) and dtype of a map to come, and
    whether a gradient for it is wanted back."""
    header = torch.tensor([*t.shape, _DTYPES.index(t.dtype), int(requires_grad)],
                          dtype=torch.int64)
    if dist.get_backend() == "nccl":
        header = header.to(t.device)
    dist.send(header, dst)


def recv_header(src: int, device: Optional[torch.device] = None):
    """(shape, dtype, requires_grad) that ``send_header`` of rank ``src`` sent."""
    header = torch.empty(6, dtype=torch.int64)
    if dist.get_backend() == "nccl":
        header = header.to(device)
    dist.recv(header, src)
    values = header.tolist()
    return tuple(values[:4]), _DTYPES[values[4]], bool(values[5])
