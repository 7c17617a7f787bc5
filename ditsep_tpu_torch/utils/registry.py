"""Name -> object registries (the port's copy of ditsep_tpu.utils.registry)."""
from __future__ import annotations

from typing import Any, Callable, Dict, TypeVar

T = TypeVar("T")


class Registry:
    """A simple name -> class/function registry.

    >>> MyRegistry = Registry("thing")
    >>> @MyRegistry.register("foo")
    ... class Foo: pass
    >>> MyRegistry.get_by_name("foo") is Foo
    True
    """

    def __init__(self, managed_thing: str):
        self.managed_thing = managed_thing
        self._registry: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def inner(thing: T) -> T:
            if name in self._registry:
                raise ValueError(
                    f"{self.managed_thing} '{name}' is already registered")
            self._registry[name] = thing
            return thing

        return inner

    def get_by_name(self, name: str) -> Any:
        if name not in self._registry:
            raise ValueError(
                f"No {self.managed_thing} registered under the name '{name}'. "
                f"Available: {sorted(self._registry)}")
        return self._registry[name]

    def get_all_names(self):
        return sorted(self._registry)

    def __contains__(self, name: str) -> bool:
        return name in self._registry
