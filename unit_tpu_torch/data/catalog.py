"""Dataset and metadata catalogs (Detectron2-style registration by name; the
port's copy of unit_tpu/data/catalog.py, with registries of its own).

The reference registers every dataset split by string name and looks it up from
config (SURVEY.md §2.4).  Records are d2-style dicts:
``{"file_name", "image_id", "height", "width",
   "annotations": [{"category_id", "bbox" (XYXY abs)}]}``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}
        self._cache: Dict[str, List[dict]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]], overwrite: bool = False):
        if name in self._registry and not overwrite:
            raise KeyError(f"Dataset '{name}' already registered")
        self._registry[name] = fn
        self._cache.pop(name, None)

    def get(self, name: str) -> List[dict]:
        if name not in self._cache:
            if name not in self._registry:
                raise KeyError(
                    f"Dataset '{name}' not registered. Available: {sorted(self._registry)}"
                )
            self._cache[name] = self._registry[name]()
        return self._cache[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def list(self):
        return sorted(self._registry)

    def clear(self):
        self._registry.clear()
        self._cache.clear()


class _Metadata:
    def __init__(self, name: str):
        self.name = name

    def set(self, **kwargs) -> "_Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._store:
            self._store[name] = _Metadata(name)
        return self._store[name]

    def clear(self):
        self._store.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
