"""A tiny name -> object registry (copy of paddlemix_tpu/utils/registry.py,
kept here so that the port imports nothing of the JAX package)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Any] = {}

    def register(self, key: Optional[str] = None) -> Callable:
        def deco(obj):
            k = key or getattr(obj, "__name__", None)
            if k is None:
                raise ValueError(f"cannot infer registry key for {obj!r}")
            if k in self._store and self._store[k] is not obj:
                raise KeyError(f"duplicate key {k!r} in registry {self.name!r}")
            self._store[k] = obj
            return obj

        return deco

    def add(self, key: str, obj: Any) -> None:
        self._store[key] = obj

    def get(self, key: str) -> Any:
        if key not in self._store:
            known = ", ".join(sorted(self._store))
            raise KeyError(f"{key!r} not found in registry {self.name!r}; known: {known}")
        return self._store[key]

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def __iter__(self) -> Iterator[str]:
        return iter(self._store)

    def keys(self):
        return self._store.keys()

    def items(self):
        return self._store.items()
