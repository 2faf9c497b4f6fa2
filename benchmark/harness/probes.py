"""What the harness records around its calls into the program: the time
each ``next()`` on a loader stream takes and what it hands over, the
records each of the first batches holds, and, in a
traced run, ranges and byte counts at the boundary of two ops the program
calls by module attribute (the FrozenBN epilogue, ROIAlign).  Nothing of
the program is changed: the wrappers are put on module attributes for the
traced steps and taken off after them."""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch

from counts import bytes as cbytes

RANGE_PREFIX = "unit:"  # the program's own range prefix (utils/profiling.annotate)


class FeedProbe:
    """An iterator around a loader stream: the host seconds of each
    ``next()``, each batch's content sizes, and copies of the first ``keep``
    batches (for the reference)."""

    def __init__(self, it, keep: int = 0):
        self.it = it
        self.keep = keep
        self.waits: List[float] = []
        self.sizes: List[np.ndarray] = []
        self.shapes: List[tuple] = []
        self.kept: List[dict] = []

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        batch = next(self.it)
        self.waits.append(time.perf_counter() - t)
        self.sizes.append(np.asarray(batch["image_size"]).copy())
        self.shapes.append(tuple(batch["image"].shape))
        if len(self.kept) < self.keep:
            self.kept.append({k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
                              for k, v in batch.items()})
        return batch

    def close(self):
        if hasattr(self.it, "close"):
            self.it.close()


class EmitProbe:
    """Which records make up the first ``keep`` batches of each loader
    stream: the image ids of the samples of every batch a ``StreamLoader``
    emits, by the stream's keys, while installed (the loader's thread emits
    them in the order the trainer takes them)."""

    def __init__(self, keep: int):
        self.keep = keep
        self.ids = {"strong": [], "weak": []}
        self._undo = None

    def install(self) -> "EmitProbe":
        from unit_tpu_torch.data import loader

        orig = loader.StreamLoader._emit
        probe = self

        def _emit(self, batch):
            got = probe.ids["strong" if "gt_boxes" in self.keys else "weak"]
            if len(got) < probe.keep:
                got.append([str(s["image_id"]) for s in batch])
            return orig(self, batch)

        loader.StreamLoader._emit = _emit
        self._undo = lambda: setattr(loader.StreamLoader, "_emit", orig)
        return self

    def remove(self) -> None:
        if self._undo is not None:
            self._undo()
            self._undo = None


class OpProbe:
    """Ranges ``unit:k4`` and ``unit:roi_align`` around the program's
    FrozenBN epilogue and ROIAlign calls, with the bytes each must move
    (``counts.bytes``), while installed."""

    def __init__(self):
        self.bytes = {"k4": 0, "k2": 0}
        self._undo: List[Callable[[], None]] = []

    def _patch(self, module, name: str, wrapper_for) -> None:
        orig = getattr(module, name)
        setattr(module, name, wrapper_for(orig))
        self._undo.append(lambda: setattr(module, name, orig))

    def install(self) -> "OpProbe":
        from unit_tpu_torch.models import resnet
        from unit_tpu_torch.ops import roi_align

        def bn_act_wrapper(orig):
            def bn_act(x, scale, shift, residual=None, relu=True, impl="auto"):
                grad = torch.is_grad_enabled()
                needs_dx = grad and x.requires_grad
                needs_dres = grad and residual is not None and residual.requires_grad
                n = cbytes.bn_act_forward_bytes(x.shape, x.element_size(), residual is not None)
                if needs_dx or needs_dres:
                    n += cbytes.bn_act_backward_bytes(x.shape, x.element_size(), relu,
                                                      needs_dx, needs_dres)
                self.bytes["k4"] += n
                with torch.profiler.record_function(RANGE_PREFIX + "k4"):
                    return orig(x, scale, shift, residual, relu, impl)
            return bn_act

        def roi_align_wrapper(orig):
            def roi_align_batched(features, rois, output_size=14, spatial_scale=1.0 / 16.0,
                                  sampling_ratio=2, impl="auto", aligned=True):
                with torch.profiler.record_function(RANGE_PREFIX + "roi_align"):
                    out = orig(features, rois, output_size, spatial_scale, sampling_ratio,
                               impl, aligned)
                if torch.is_grad_enabled() and features.requires_grad:
                    self.bytes["k2"] += cbytes.roi_align_backward_bytes(
                        out.shape, out.element_size(), features.shape,
                        features.element_size())
                return out
            return roi_align_batched

        self._patch(resnet, "bn_act", bn_act_wrapper)
        self._patch(roi_align, "roi_align_batched", roi_align_wrapper)
        return self

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()
