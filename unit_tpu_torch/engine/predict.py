"""The predict entry point (port of unit_tpu/engine/train.py:470-503).

PyTorch runs eagerly, so there is nothing to compile: the function moves the
batch to the model's device and runs ``WSRCNN.predict`` without autograd, or
``WSRCNN.predict_weak_only`` for a ``WeakRCNN`` model (the weak detector
alone scores).  The server and the run loop's evaluation both predict
through it; ``make_tta_predict_fn`` is its twin for a TTA batch
(``WSRCNN.predict_tta``).  Both take precomputed proposals where the batch
has them (MODEL.LOAD_PROPOSALS): then the RPN does not run.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.meta_arch import WSRCNN
from ..structures.instances import Detections


def upload_image(images, device: torch.device) -> torch.Tensor:
    """Images (numpy or a tensor) -> f32 on ``device``.  uint8 images (the
    uint8 wire, TPU.HOST_TRANSFER_UINT8) are uploaded as uint8 and cast on
    the device: a quarter of the bytes, the same values."""
    x = torch.as_tensor(images)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
    return x.to(device, non_blocking=True).to(torch.float32)


def make_predict_fn(model: WSRCNN) -> Callable[..., Detections]:
    """(images [B, H, W, 3] BGR, f32 or uint8, image_sizes [B, 2][, proposal_boxes
    [B, P, 4], proposal_valid [B, P]]) -> Detections on the model's device.
    Inputs may be numpy arrays or tensors.  A WeakRCNN model takes no
    proposals, as in unit_tpu."""
    device = model.embeddings.device
    model.eval()
    predict = (model.predict_weak_only if model.mc.meta_architecture == "WeakRCNN"
               else model.predict)

    def predict_fn(images, image_sizes, *proposals) -> Detections:
        with torch.inference_mode():
            imgs = upload_image(images, device)
            sizes = torch.as_tensor(image_sizes, dtype=torch.float32).to(device)
            return predict(imgs, sizes, *(torch.as_tensor(p).to(device) for p in proposals))

    return predict_fn


def make_tta_predict_fn(model: WSRCNN, tta_topk: int = 0) -> Callable[[dict], Detections]:
    """A TTA batch of ``data.loader.build_tta_test_loader`` -> Detections
    [1, D] in the canonical frame on the model's device, through
    ``WSRCNN.predict_tta`` (``tta_topk``: TPU.TTA_PROPOSAL_TOPK), with the
    batch's proposals where it has them."""
    device = model.embeddings.device
    model.eval()

    def upload(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device, non_blocking=True)

    def predict_fn(batch) -> Detections:
        with torch.inference_mode():
            variants = [{"image": upload(v["image"]), "image_size": upload(v["image_size"]),
                         "scale": float(v["scale"]), "flip": bool(v["flip"])}
                        for v in batch["variants"]]
            proposals = {}
            if "proposals" in batch:
                proposals = {"proposal_boxes": upload(batch["proposals"]),
                             "proposal_valid": torch.as_tensor(batch["proposals_valid"]
                                                               ).to(device)}
            return model.predict_tta(upload(batch["image"]), upload(batch["image_size"]),
                                     variants, tta_topk=tta_topk, **proposals)

    return predict_fn
