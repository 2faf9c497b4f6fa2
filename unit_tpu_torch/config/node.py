"""Minimal yacs-compatible config tree (the port's own copy of
unit_tpu/config/node.py; unit_tpu_torch imports nothing of unit_tpu).

The reference drives everything through a yacs ``CfgNode`` (Detectron2 ``get_cfg()``
extended by the reference repo's configs/default_config.py:4-106) with ``_BASE_`` YAML
inheritance, dotted CLI overrides via ``merge_from_list`` and freezing.  This module
re-implements the small subset of yacs used there so that the reference's YAML files
work unchanged against this stack without a yacs dependency.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import yaml

_VALID_SCALARS = (int, float, bool, str, type(None))

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """A dict with attribute access, freezing, YAML merge, and dotted-key overrides."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._to_node(v)

    @classmethod
    def _to_node(cls, v):
        if isinstance(v, dict) and not isinstance(v, CfgNode):
            return cls(v)
        if isinstance(v, list):
            return [cls._to_node(x) for x in v]
        return v

    # -- attribute access ------------------------------------------------------
    def __getattr__(self, name: str):
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set '{name}' on an immutable CfgNode")
        self[name] = self._to_node(value)

    def __setitem__(self, name, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set '{name}' on an immutable CfgNode")
        super().__setitem__(name, value)

    # -- immutability ----------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, flag: bool):
        self.__dict__[CfgNode.IMMUTABLE] = flag
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    # -- merging ---------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode"):
        _merge_a_into_b(other, self)

    def merge_from_file(self, filename: str, allow_unsafe: bool = True):
        cfg = _load_yaml_with_base(filename)
        _merge_a_into_b(cfg, self)

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                assert p in node, f"Non-existent config key: {key}"
                node = node[p]
            leaf = parts[-1]
            assert leaf in node, f"Non-existent config key: {key}"
            node[leaf] = _decode_value(value, node[leaf], key)

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), default_flow_style=None)


def _to_plain(node):
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
    return node


def _decode_value(value: str, old: Any, key: str):
    """Parse a CLI string override into the type of the existing value."""
    if not isinstance(value, str):
        parsed = value
    else:
        import ast

        # yacs semantics: strings that parse as Python literals are coerced,
        # anything else stays a string.
        try:
            parsed = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            parsed = value
    if old is None or parsed is None:
        return parsed
    if isinstance(old, tuple) and isinstance(parsed, list):
        return tuple(parsed)
    if isinstance(old, list) and isinstance(parsed, tuple):
        return list(parsed)
    if isinstance(old, bool) and not isinstance(parsed, bool) and isinstance(parsed, int):
        return bool(parsed)
    if isinstance(old, float) and isinstance(parsed, int):
        return float(parsed)
    if type(old) is not type(parsed) and not isinstance(old, CfgNode):
        raise ValueError(
            f"Type mismatch ({type(old).__name__} vs {type(parsed).__name__}) for key {key}"
        )
    return parsed


def _merge_a_into_b(a: Dict, b: CfgNode, prefix: str = ""):
    for k, v in a.items():
        full_key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            if k not in b or not isinstance(b[k], CfgNode):
                dict.__setitem__(b, k, CfgNode())
            _merge_a_into_b(v, b[k], full_key)
        else:
            if k in b:
                v = _decode_value(v, b[k], full_key)
            elif isinstance(v, str):
                v = _decode_value(v, None, full_key)
            dict.__setitem__(b, k, CfgNode._to_node(v))


def _decode_strings(node):
    """Recursively literal-eval string leaves (yacs semantics): '(1, 2)' -> tuple."""
    if isinstance(node, dict):
        return {k: (_decode_strings(v) if k != BASE_KEY else v) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_strings(v) for v in node]
    if isinstance(node, str):
        return _decode_value(node, None, "<yaml>")
    return node


def _load_yaml_with_base(filename: str) -> Dict:
    """Load a YAML file, recursively resolving ``_BASE_`` inheritance.

    Mirrors the Detectron2 behavior the reference configs rely on
    (e.g. the reference repo's configs/VOC/VOC-RCNN-101-C4-split1.yaml:1).
    """
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f) or {}
    cfg = _decode_strings(cfg)
    base = cfg.pop(BASE_KEY, None)
    cfg.pop("VERSION", None)
    if base is not None:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        base_cfg = _load_yaml_with_base(base)
        node = CfgNode(base_cfg)
        _merge_a_into_b(cfg, node)
        return _to_plain(node)
    return cfg
