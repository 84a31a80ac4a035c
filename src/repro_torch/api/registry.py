"""Tiny name → object registries backing the `repro_torch.api` surface.

One class serves both the strategy and the pool-backend registries; the
only behavior beyond a dict is a helpful error that lists what *is*
registered (misspelled strategy names are the most common user error).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


class Registry:
    """Case-sensitive name → object map."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str, obj: Any) -> Any:
        if name in self._items:
            raise ValueError(f"{self.kind} {name!r} already registered")
        self._items[name] = obj
        return obj

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{', '.join(self.names()) or '(none)'}") from None

    def names(self) -> List[str]:
        return sorted(self._items)

    def items(self) -> List[Tuple[str, Any]]:
        return sorted(self._items.items())
