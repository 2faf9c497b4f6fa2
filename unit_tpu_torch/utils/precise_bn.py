"""PreciseBN: refresh the FrozenBN statistics over N data batches.

Port of unit_tpu/utils/precise_bn.py (the d2 PreciseBN hook the reference
exposes, engine/defaults.py:304-311).  The backbone (``WSRCNN.features``, to
res4) runs over ``num_iters`` batches while every FrozenBN captures the mean
and variance of its input (``models.resnet.input_stats``); the per-batch
statistics are averaged and written into each module's ``mean``/``var`` once,
at the end.  Layer k's statistics read the activations that layers < k make
with their old buffers, as in unit_tpu.  The Res5 heads do not run, so their
buffers stay as they were; nothing else of the model changes.

The average follows unit_tpu to the rounding: the per-batch statistics come
in the activations' dtype and are summed in it (in bf16 each addition rounds,
as ``np.add`` of two bf16 arrays does), then divided by the count in f32.  In
f32 that is the plain mean; in bf16 it loses precision as the count grows
(ROADMAP, faults of the reference, R8).

Under data parallelism each rank averages the batches of its own shard and
the ranks' averages are then averaged (one coalesced all-reduce, in f32), so
every rank installs the same statistics.  unit_tpu's mesh gets global
statistics from its sharded forward; its hook then installs them in every
process.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from ..models.resnet import FrozenBN
from ..parallel import comm

Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def collect_bn_stats(model: nn.Module, images: torch.Tensor) -> Stats:
    """One batch's FrozenBN input statistics, {module name: (mean, var)}, of
    every FrozenBN that ``model.features(images)`` runs."""
    bns = {name: m for name, m in model.named_modules() if isinstance(m, FrozenBN)}
    for m in bns.values():
        m.batch_stats = []
    try:
        with torch.no_grad():
            model.features(images)
        return {name: m.batch_stats[0] for name, m in bns.items() if m.batch_stats}
    finally:
        for m in bns.values():
            m.batch_stats = None


def precise_bn(model: nn.Module, batches: Iterator, num_iters: int = 200) -> nn.Module:
    """Replace the backbone's FrozenBN mean/var by their averages over up to
    ``num_iters`` batches ({"image": [B, H, W, 3] f32 BGR, ...}) of
    ``batches``, in place; returns ``model``.  No batch: nothing changes
    (under data parallelism every rank must have batches: the average is a
    collective)."""
    device = model.embeddings.device
    acc, n = None, 0
    for _ in range(num_iters):
        try:
            batch = next(batches)
        except StopIteration:
            break
        images = torch.as_tensor(batch["image"], dtype=torch.float32).to(device,
                                                                          non_blocking=True)
        stats = collect_bn_stats(model, images)
        acc = stats if acc is None else {
            k: (acc[k][0] + mean, acc[k][1] + var) for k, (mean, var) in stats.items()}
        n += 1
    if n == 0:
        return model
    modules = dict(model.named_modules())
    stats = [s.float() / n for pair in acc.values() for s in pair]
    comm.all_reduce_mean_tensors(stats)  # one rank: unchanged
    with torch.no_grad():
        for k, name in enumerate(acc):
            modules[name].mean.copy_(stats[2 * k])
            modules[name].var.copy_(stats[2 * k + 1])
    return model
