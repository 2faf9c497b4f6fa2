"""Box geometry and padded instance containers (port of unit_tpu.structures)."""

from . import boxes
from .instances import Detections, GTInstances, Proposals, SampledProposals

__all__ = ["boxes", "Detections", "GTInstances", "Proposals", "SampledProposals"]
