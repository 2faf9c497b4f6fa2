"""The predict entry point (port of unit_tpu/engine/train.py:470-503).

PyTorch runs eagerly, so there is nothing to compile: the function moves the
batch to the model's device and runs ``WSRCNN.predict`` without autograd, or
``WSRCNN.predict_weak_only`` for a ``WeakRCNN`` model (the weak detector
alone scores).  The server and the run loop's evaluation both predict
through it; ``make_tta_predict_fn`` is its twin for a TTA batch
(``WSRCNN.predict_tta``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.meta_arch import WSRCNN
from ..structures.instances import Detections


def make_predict_fn(model: WSRCNN) -> Callable[[np.ndarray, np.ndarray], Detections]:
    """(images [B, H, W, 3] f32 BGR, image_sizes [B, 2]) -> Detections on the
    model's device.  Inputs may be numpy arrays or tensors."""
    device = model.embeddings.device
    model.eval()
    predict = (model.predict_weak_only if model.mc.meta_architecture == "WeakRCNN"
               else model.predict)

    def predict_fn(images, image_sizes) -> Detections:
        with torch.inference_mode():
            imgs = torch.as_tensor(images, dtype=torch.float32).to(device, non_blocking=True)
            sizes = torch.as_tensor(image_sizes, dtype=torch.float32).to(device)
            return predict(imgs, sizes)

    return predict_fn


def make_tta_predict_fn(model: WSRCNN, tta_topk: int = 0) -> Callable[[dict], Detections]:
    """A TTA batch of ``data.loader.build_tta_test_loader`` -> Detections
    [1, D] in the canonical frame on the model's device, through
    ``WSRCNN.predict_tta`` (``tta_topk``: TPU.TTA_PROPOSAL_TOPK)."""
    device = model.embeddings.device
    model.eval()

    def upload(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device, non_blocking=True)

    def predict_fn(batch) -> Detections:
        with torch.inference_mode():
            variants = [{"image": upload(v["image"]), "image_size": upload(v["image_size"]),
                         "scale": float(v["scale"]), "flip": bool(v["flip"])}
                        for v in batch["variants"]]
            return model.predict_tta(upload(batch["image"]), upload(batch["image_size"]),
                                     variants, tta_topk=tta_topk)

    return predict_fn
