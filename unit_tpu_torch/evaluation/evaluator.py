"""Inference loop: run a model over a test loader and feed an evaluator.

Port of unit_tpu/evaluation/evaluator.py:21-142: warmup-aware timing,
progress logging, the evaluator's process/evaluate protocol.
Detections come back as padded arrays; boxes are rescaled from network-input
to original-image coordinates here.

One batch stays in flight.  Right after batch k is dispatched, its four
output fields are packed into one [B, D, 7] f32 tensor on the device and one
asynchronous copy into pinned host memory is enqueued behind it (under
MODEL.MASK_ON a second one beside it for the [B, D, M, M] masks), with one
event.  The host then handles batch k - 1 (event wait, rescale, evaluator)
while the device works on batch k: one host sync per batch.  On the CPU the
tensors are read directly.

``inference_loop`` is the loop itself, over a batch -> Detections call:
the test-time augmentation runs it directly, since its predict call takes
the whole batch (the canonical image and its variants).
``inference_on_dataset`` binds it to an (images, image_sizes) predict call,
and ``inference_on_dataset_meta``, the meta models' loop, binds the support
prototypes to that call and delegates there.

Under data parallelism each rank runs its shard of the test set (the test
loaders read ``[rank::world]``, and the runner feeds the evaluator the GT of
that shard); before scoring, the ranks' evaluators are gathered and merged
in rank order (``merge_gathered``, unit_tpu :96-104), so every rank scores
the whole set and gets the same results.  Under FSDP and TP the runner
predicts on a whole replica of the model (no collective in predict, so
unequal shards cannot hang), and every rank, a model rank too, evaluates
its own shard as data-parallel ranks do.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel import comm

logger = logging.getLogger("unit_tpu_torch")


def _start_fetch(det):
    """Detections -> (host tensor [B, D, 7], host masks [B, D, M, M] or None,
    event or None): boxes, score, class and valid in one device-to-host copy
    (classes and flags are exact in f32), the masks in a second."""
    packed = torch.cat([
        det.boxes.float(), det.scores.float().unsqueeze(-1),
        det.classes.float().unsqueeze(-1), det.valid.float().unsqueeze(-1),
    ], dim=-1)
    masks = None if det.masks is None else det.masks.float()
    if not packed.is_cuda:
        return packed, masks, None

    def fetch(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    host, host_masks = fetch(packed), None if masks is None else fetch(masks)
    event = torch.cuda.Event()
    event.record()
    return host, host_masks, event


def inference_on_dataset(
    predict_fn: Callable,          # (images, image_sizes[, boxes, valid]) -> Detections
    loader: Iterator,              # yields test batches from build_test_loader
    evaluator,                     # PascalVOCEvaluator-like
    total_images: Optional[int] = None,
    warmup: int = 1,
) -> dict:
    """``inference_loop`` over a test loader's batches; a batch with
    precomputed proposals passes them on (``proposals``, ``proposals_valid``)."""
    def run_batch(batch):
        extra = ((batch["proposals"], batch["proposals_valid"]) if "proposals" in batch
                 else ())
        return predict_fn(batch["image"], batch["image_size"], *extra)

    return inference_loop(run_batch, loader, evaluator, total_images, warmup)


def inference_loop(
    run_batch: Callable,           # a loader's batch -> Detections [B, D]
    loader: Iterator,
    evaluator,
    total_images: Optional[int] = None,
    warmup: int = 1,
) -> dict:
    """Run ``run_batch`` over ``loader`` and feed ``evaluator``: boxes are
    divided by each batch's ``scale`` and clipped to its ``orig_size``.  A
    TTA batch (``build_tta_test_loader``) goes through it whole, as in
    unit_tpu runner.py:467-484; the evaluator then gets no masks."""
    # NOTE: no evaluator.reset() here: callers (engine/runner.py eval_fn) feed
    # GT records before handing the evaluator over
    num_done = 0
    t_start = None
    timed_base = 0
    total_time = 0.0

    def collect(batch, host, host_masks, event):
        nonlocal num_done
        if event is not None:
            event.synchronize()
        out = host.numpy()
        masks = None if host_masks is None else host_masks.numpy()
        for i, image_id in enumerate(batch["image_id"]):
            if image_id is None:  # padding of the final partial batch
                continue
            scale = batch["scale"][i]
            oh, ow = batch["orig_size"][i]
            b = out[i, :, :4] / scale
            b[:, 0::2] = np.clip(b[:, 0::2], 0, ow)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, oh)
            extra = {} if masks is None else {"masks": masks[i]}
            evaluator.process(image_id, b, out[i, :, 4], out[i, :, 5].astype(np.int32),
                              out[i, :, 6] > 0, **extra)
            num_done += 1

    pending = None
    if warmup <= 0:  # no warmup exclusion: time everything
        t_start = time.perf_counter()
    for batch_idx, batch in enumerate(loader):
        fetch = _start_fetch(run_batch(batch))
        if pending is not None:
            collect(*pending)
            if batch_idx == warmup:
                # the clock starts after the warmup batch (its collect
                # absorbed the kernels' build and cuDNN's algorithm search)
                t_start = time.perf_counter()
                timed_base = num_done
        pending = (batch,) + fetch
        if total_images and batch_idx % 50 == 0 and t_start is not None:
            total_time = time.perf_counter() - t_start
            per_img = total_time / max(num_done - timed_base, 1)
            logger.info("inference %d/%d (%.4f s/img, ETA %.0fs)", num_done, total_images,
                        per_img, per_img * (total_images - num_done))
    if pending is not None:
        collect(*pending)
    if t_start is not None:
        total_time = time.perf_counter() - t_start
    results = merge_gathered(evaluator).evaluate()
    if t_start is not None and num_done > timed_base:
        results["inference_seconds_per_image"] = total_time / (num_done - timed_base)
    return results


def merge_gathered(evaluator):
    """The evaluator of the whole test set: every rank's evaluator (its GT
    and predictions), gathered and merged in rank order (``merge_from``), the
    same on every rank.  One process: ``evaluator`` itself."""
    gathered = comm.gather_objects(evaluator)
    if len(gathered) == 1:
        return evaluator
    merged = gathered[0]
    for other in gathered[1:]:
        merged.merge_from(other)
    return merged


def inference_on_dataset_meta(
    predict_fn: Callable,          # (attention, images, image_sizes) -> Detections
    loader: Iterator,
    attention,                     # the support prototypes (compute_meta_attention)
    evaluator,
    total_images: Optional[int] = None,
    warmup: int = 1,
) -> dict:
    """The meta models' evaluation loop (unit_tpu evaluator.py:112-142):
    the prototypes, computed once before the evaluation, are bound as the
    predict call's first argument, and the loop is ``inference_on_dataset``'s.

    The attention is dead at inference, by the reference's own code: its meta
    ROI heads derive the visual similarity from the weak detector's
    posteriors, and the attention-driven branch is commented out
    (docs/DEVIATIONS.md, the meta-head row).  So the results equal those of
    ``inference_on_dataset`` and do not depend on ``attention``."""
    def bound(images, image_sizes, *proposals):
        return predict_fn(attention, images, image_sizes, *proposals)

    return inference_on_dataset(bound, loader, evaluator, total_images, warmup)
