"""The port's config surface: its own CfgNode, defaults and validation.

Copies of unit_tpu/config/{node,defaults,validate}.py (PyYAML only), so the
two packages read the same YAML recipes into equal trees while the port
imports nothing of unit_tpu.  tests/test_torch_config.py holds them equal.
"""

from .node import CfgNode
from .defaults import get_cfg, add_config
from .validate import validate_registry_names

__all__ = ["CfgNode", "get_cfg", "add_config", "validate_registry_names"]
