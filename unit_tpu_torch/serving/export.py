"""Serialized inference artifacts via ``torch.export`` (twin of
unit_tpu/serving/export.py, which writes StableHLO).

The predict path of a model is exported as one program per test-canvas
orientation (the test-time loader buckets portrait and landscape), at one
fixed batch, with the weights as the program's own state: serving needs the
artifact file and this package's operators, and no config, model code or
checkpoint.  A model that reads precomputed proposals (MODEL.LOAD_PROPOSALS
with DATASETS.PROPOSAL_FILES_TEST) is exported with two more inputs, the
proposals [b, K, 4] f32 and their valid flags [b, K] bool.

The kernels of the path are registered operators (``ops.library``): an
exported program calls K1, K3 and K4 by name, and they dispatch on the
device of their inputs at run time.  A program exported on the card runs on
the card; ``load_exported`` refuses to load one where there is no card.
"""

from __future__ import annotations

import io
import json
import os
import pickle
from typing import Dict, Optional, Sequence

import torch

from ..data.transforms import TransformConfig
from ..engine.predict import upload_image
from ..structures.instances import Detections

FORMAT_VERSION = 1


def _canvas_orientations(cfg, orientations: str = "both"):
    """The test canvases (h, w): landscape then portrait, or the one asked
    for (``orientations`` in {"both", "landscape", "portrait"})."""
    t = TransformConfig.test_from_cfg(cfg)
    lo, hi = sorted(t.canvas)
    if lo == hi:
        return [(lo, hi)]
    return {"both": [(lo, hi), (hi, lo)], "landscape": [(lo, hi)],
            "portrait": [(hi, lo)]}[orientations]


class FlatPredict(torch.nn.Module):
    """``WSRCNN.predict`` (``predict_weak_only`` for a WeakRCNN model) without
    autograd, returning a plain dict: what ``torch.export`` traces (the twin
    of unit_tpu's ``make_flat_predict`` closure).  The model is the module's
    child, so its weights become the program's state."""

    def __init__(self, model):
        super().__init__()
        self.model = model.eval()
        self.weak_only = model.mc.meta_architecture == "WeakRCNN"

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor,
                proposal_boxes: Optional[torch.Tensor] = None,
                proposal_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            if self.weak_only:
                det = self.model.predict_weak_only(images, image_sizes)
            else:
                det = self.model.predict(images, image_sizes, proposal_boxes, proposal_valid)
        out = {"boxes": det.boxes, "scores": det.scores, "classes": det.classes,
               "valid": det.valid}
        if det.masks is not None:
            out["masks"] = det.masks
        return out


def export_predict(
    cfg,
    model,
    path: str,
    class_names: Optional[Sequence[str]] = None,
    with_proposals: Optional[bool] = None,
    batch_size: int = 1,
    orientations: str = "both",
) -> Dict[str, object]:
    """Export the predict path for every canvas orientation (or the one of
    ``orientations``, "landscape" or "portrait", for a request stream known
    to hold only that one) to ``path`` on the model's device, at batch
    ``batch_size`` (the micro-batcher pads every group to it).  Returns the
    artifact's metadata dict."""
    if with_proposals is None:
        with_proposals = bool(cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TEST)
    if with_proposals and model.mc.meta_architecture == "WeakRCNN":
        raise ValueError("a WeakRCNN model predicts from its RPN and takes no proposals")
    if cfg.TPU.FOLD_BN_AT_EVAL:
        # a program is forward-only: FrozenBN folds into the convolutions once
        from ..utils.bn_fold import fold_frozen_bn

        model = fold_frozen_bn(model)
    device = model.embeddings.device
    flat = FlatPredict(model)
    b = int(batch_size)
    capacity = int(cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST or 128)
    blobs = {}
    for ch, cw in _canvas_orientations(cfg, orientations):
        args = [torch.zeros((b, ch, cw, 3), device=device),
                torch.full((b, 2), float(min(ch, cw)), device=device)]
        if with_proposals:
            args += [torch.zeros((b, capacity, 4), device=device),
                     torch.zeros((b, capacity), dtype=torch.bool, device=device)]
        program = torch.export.export(flat, tuple(args), strict=False)
        program.example_inputs = None  # zeros of the input shapes: 49 MiB at batch 4
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[f"{ch}x{cw}"] = buf.getvalue()

    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "min_size_test": int(cfg.INPUT.MIN_SIZE_TEST),
        "max_size_test": int(cfg.INPUT.MAX_SIZE_TEST),
        "canvases": sorted(blobs),
        "num_classes": int(cfg.MODEL.ROI_HEADS.NUM_CLASSES),
        "class_names": list(class_names) if class_names else None,
        "with_proposals": bool(with_proposals),
        "batch_size": b,
        "proposal_capacity": capacity if with_proposals else 0,
        "size_divisibility": int(cfg.TPU.SIZE_DIVISIBILITY),
        "max_gt": int(cfg.TPU.MAX_GT_BOXES),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"meta": meta, "blobs": blobs}, f, protocol=4)
    os.replace(tmp, path)
    return meta


class ExportedPredictor:
    """A loaded artifact: calls the program of the input's canvas on the
    artifact's device, under ``torch.inference_mode``."""

    def __init__(self, meta: dict, programs: Dict[str, torch.nn.Module]):
        self.meta = meta
        self._programs = programs
        self.device = torch.device(meta["platforms"][0])

    def __call__(self, image, image_size, *proposals) -> Detections:
        """image [b, Hc, Wc, 3] (f32, or uint8: uploaded as such and cast on
        the device), image_size [b, 2][, proposal_boxes [b, K, 4],
        proposal_valid [b, K]] (numpy arrays or tensors) -> Detections on the
        artifact's device."""
        key = f"{image.shape[1]}x{image.shape[2]}"
        program = self._programs.get(key)
        if program is None:
            raise ValueError(f"no exported program for canvas {key}; artifact has "
                             f"{sorted(self._programs)}")
        with torch.inference_mode():
            args = [upload_image(image, self.device),
                    torch.as_tensor(image_size, dtype=torch.float32).to(self.device)]
            args += [torch.as_tensor(p).to(self.device) for p in proposals]
            out = program(*args)
        return Detections(boxes=out["boxes"], scores=out["scores"], classes=out["classes"],
                          valid=out["valid"], masks=out.get("masks"))


def _read(path: str) -> dict:
    # an artifact is a pickle this package wrote: load only trusted files
    with open(path, "rb") as f:
        return pickle.load(f)


def load_exported(path: str) -> ExportedPredictor:
    """Load an artifact of ``export_predict``.  Raises for another format
    version, and for an artifact exported on the card where there is none."""
    from ..ops import library  # noqa: F401  (registers the operators the programs call)

    payload = _read(path)
    meta = payload["meta"]
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact version {meta.get('format_version')}")
    if meta["platforms"][0] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported on the card and runs there: no CUDA device "
                           "here (export on the CPU for a CPU artifact)")
    programs = {key: torch.export.load(io.BytesIO(blob)).module()
                for key, blob in payload["blobs"].items()}
    return ExportedPredictor(meta, programs)


def describe(path: str) -> str:
    return json.dumps(_read(path)["meta"], indent=2)
