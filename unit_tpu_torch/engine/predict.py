"""The predict entry point (port of unit_tpu/engine/train.py:470-503).

PyTorch runs eagerly, so there is nothing to compile: the function moves the
batch to the model's device and runs ``WSRCNN.predict`` without autograd.
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

    def predict_fn(images, image_sizes) -> Detections:
        with torch.inference_mode():
            imgs = torch.as_tensor(images, dtype=torch.float32).to(device, non_blocking=True)
            sizes = torch.as_tensor(image_sizes, dtype=torch.float32).to(device)
            return model.predict(imgs, sizes)

    return predict_fn
