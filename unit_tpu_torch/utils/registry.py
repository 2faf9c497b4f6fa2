"""Name -> callable registries (port of unit_tpu/utils/registry.py).

The reference builds its components by name from the config through
detectron2 registries; ``BACKBONE_REGISTRY`` (models/backbones.py) and
``BOX_HEAD_REGISTRY`` (models/box_heads.py) are this package's, so a user
can add a backbone or a box head with ``@BACKBONE_REGISTRY.register()`` and
select it by MODEL.BACKBONE.NAME.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    """A registry mapping names to objects (classes or factory functions)."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in '{self._name}' registry!"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, *, name: Optional[str] = None):
        """Use as a decorator (``@registry.register()``, or with ``name=``) or
        call it (``registry.register(obj, name=...)``).  The name defaults to
        the object's ``__name__``; ``name=""`` registers the empty name (the
        config defaults' placeholder box head), where unit_tpu falls back to
        ``__name__``."""
        if obj is None:

            def deco(func_or_class):
                self._do_register(func_or_class.__name__ if name is None else name,
                                  func_or_class)
                return func_or_class

            return deco
        self._do_register(obj.__name__ if name is None else name, obj)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()
