"""Fixed-shape instance containers.

Port of unit_tpu/structures/instances.py:18-92: every field is a padded
tensor with a leading static capacity (after an optional batch dimension)
plus a boolean ``valid`` mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class GTInstances:
    """Padded ground truth: boxes [..., G, 4] XYXY in canvas coordinates;
    classes [..., G] int64 in [0, C) (padded entries arbitrary); valid
    [..., G] bool."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class SampledProposals:
    """Proposals after IoU matching and subsampling (training): boxes
    [..., S, 4]; gt_classes [..., S] int64 in [0, C] (C is background);
    gt_boxes [..., S, 4] matched GT box; valid [..., S] bool (slot is real);
    is_fg [..., S] bool; gt_index [..., S] int64 matched GT slot."""

    boxes: torch.Tensor
    gt_classes: torch.Tensor
    gt_boxes: torch.Tensor
    valid: torch.Tensor
    is_fg: torch.Tensor
    gt_index: torch.Tensor


@dataclasses.dataclass
class Proposals:
    """boxes [..., P, 4] XYXY; objectness [..., P] (descending where valid);
    valid [..., P] bool."""

    boxes: torch.Tensor
    objectness: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class Detections:
    """boxes [..., D, 4]; scores [..., D]; classes [..., D] int64;
    valid [..., D] bool; masks [..., D, M, M] f32 mask probabilities in each
    box's frame (under MODEL.MASK_ON, else None)."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None


def stack_fields(items, cls):
    """Stack per-image containers of one type into a batched one (a field
    that is None in the first is None in the result)."""
    return cls(**{f.name: None if getattr(items[0], f.name) is None
                  else torch.stack([getattr(x, f.name) for x in items])
                  for f in dataclasses.fields(cls)})
