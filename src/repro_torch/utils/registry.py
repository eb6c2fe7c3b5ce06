"""Tiny name->factory registry used for archs, optimizers, attention impls."""
from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(fn: T) -> T:
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} registration: {name}")
            self._entries[name] = fn
            return fn

        return deco

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} '{name}'. known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def names(self):
        return sorted(self._entries)
