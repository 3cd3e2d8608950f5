"""A package's re-exported names, resolved from their submodules on first
access (PEP 562), so that importing a package imports none of them.

The JAX package's ``__init__`` modules import their re-exports eagerly.  The
port's resolve them lazily: ``control`` and ``metrics`` load no torch, and
an eager ``exporter`` would load it (its device sources do) for every
import of the torch-free ``exporter.native`` or ``exporter.podresources``.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Callable


def lazy_exports(package: str, table: dict[str, str]) -> Callable[[str], Any]:
    """The ``__getattr__`` of ``package``: each name of ``table`` comes from
    the submodule ``table[name]`` and is then bound in the package."""

    def __getattr__(name: str) -> Any:
        submodule = table.get(name)
        if submodule is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{package}.{submodule}"), name)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__
