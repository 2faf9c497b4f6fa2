"""Fixed-shape instance containers.

Port of unit_tpu/structures/instances.py:41-92: every field is a padded
tensor with a leading static capacity (after an optional batch dimension)
plus a boolean ``valid`` mask.
"""

from __future__ import annotations

import dataclasses
import torch


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
    valid [..., D] bool."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


def stack_fields(items, cls):
    """Stack per-image containers of one type into a batched one."""
    return cls(**{f.name: torch.stack([getattr(x, f.name) for x in items])
                  for f in dataclasses.fields(cls)})
