"""The frozen GloVe class-name table (port of unit_tpu/checkpoint/checkpointer.py:288-297)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_glove_embeddings(model: nn.Module, npz_path: str) -> nn.Module:
    """Install ``npz_path``'s ``embeddings`` [80, 300] into ``model.embeddings``."""
    emb = np.load(npz_path)["embeddings"]
    if tuple(model.embeddings.shape) != emb.shape:
        raise ValueError(f"embeddings {emb.shape} vs model {tuple(model.embeddings.shape)}")
    with torch.no_grad():
        model.embeddings.copy_(torch.from_numpy(emb.astype(np.float32)))
    return model
