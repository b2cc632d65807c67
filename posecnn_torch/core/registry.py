"""Name → factory registries (counterpart of `posecnn_tpu/core/registry.py`).

The CLIs build a model or a dataset reader from the name a config or a
flag gives: `MODELS` is filled by `posecnn_torch.models`, `DATASETS` by
`posecnn_torch.data.datasets`, each when it is imported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Registry:
    def __init__(self, kind: str):
        self._kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, factory: Callable[..., Any] | None = None):
        """Register `factory` under `name`; without one, a decorator."""
        if factory is not None:
            self._entries[name] = factory
            return factory

        def deco(fn):
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            raise KeyError(f"unknown {self._kind} '{name}'; known: {sorted(self._entries)}")
        return self._entries[name]

    def create(self, name: str, *args, **kwargs) -> Any:
        return self.get(name)(*args, **kwargs)

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


MODELS = Registry("model")
DATASETS = Registry("dataset")
