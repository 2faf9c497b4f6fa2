"""The port's config surface: unit_tpu.config, shared as it is.

unit_tpu.config imports no jax (only PyYAML, for the recipe files), so the
two packages read the same YAML recipes into the same CfgNode.
"""

from unit_tpu.config import CfgNode, get_cfg, validate_registry_names

__all__ = ["CfgNode", "get_cfg", "validate_registry_names"]
