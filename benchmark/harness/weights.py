"""The cell's weights, made from the seed on the device by the reference.

Every parameter is drawn from one standard normal tensor of all their
elements (one call of a ``torch.Generator`` on the card), scaled leaf by
leaf (``wsod.param_specs``): lecun normal (1 / sqrt(fan-in)) for every
convolution and dense layer, the weak detector's streams among them, so
that their logits are of order one over the calibrated features (the
recipe's 0.01 would leave every weak score of a random model within a few
hundredths of the next, and OICR's pseudo-labels would flip on any
rounding); 0.01 for the RPN head, 0.001 for the box-delta and mask
predictors and zero for the supervised classifier delta and every bias, as
the recipe has them.

The frozen batch norms then take the per-channel mean and variance of their
own inputs over one float32 forward pass of the reference on a seeded
natural image (``wsod.calibrate``: without it a random ResNet proposes
nothing).  The GloVe class table is the repository's file, which the
program reads too."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .common import ROOT

GLOVE = os.path.join(ROOT, "data", "embeddings", "glove_mean.npz")


def make_state(ref, config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict both sides load."""
    from . import devkit

    r = ref.Recipe(config)
    state = ref.make_state(r, seed, device, np.load(GLOVE)["embeddings"].astype(np.float32))
    rgb = devkit.natural_image(np.random.RandomState((seed + 100) % 2**32), 375, 500)
    image = torch.as_tensor(np.ascontiguousarray(rgb[:, :, ::-1]), dtype=torch.float32,
                            device=device)[None]
    ref.calibrate(r, state, image)
    return state
