"""Box geometry and padded instance containers (port of unit_tpu.structures)."""

from . import boxes
from .instances import Detections, Proposals

__all__ = ["boxes", "Detections", "Proposals"]
