"""Lazy exports of the port's packages: each package exports the names the
JAX package's counterpart exports, each imported from its submodule on
first use, so importing a package loads none of its submodules."""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def lazy_exports(exports: Dict[str, str]) -> Callable:
    """A module ``__getattr__`` resolving ``exports`` ({name: module});
    any other name raises AttributeError."""
    def __getattr__(name):
        module = exports.get(name)
        if module is None:
            raise AttributeError(name)
        return getattr(importlib.import_module(module), name)

    return __getattr__
