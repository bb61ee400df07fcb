"""Lazy exports of the port's packages: each package exports the names the
JAX package's counterpart exports, each imported from its submodule on
first use, so importing a package loads none of its submodules."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable

#: what every name that needs more than one card raises
MULTI_CARD_ITEM = "ROADMAP A.12 (more than one card)"


def lazy_exports(exports: Dict[str, str],
                 multi_card: Iterable[str] = ()) -> Callable:
    """A module ``__getattr__`` resolving ``exports`` ({name: module}) and
    raising NotImplementedError naming A.12 for ``multi_card`` names;
    any other name raises AttributeError."""
    multi_card = frozenset(multi_card)

    def __getattr__(name):
        if name in multi_card:
            raise NotImplementedError(
                f"{name} is not ported yet ({MULTI_CARD_ITEM})")
        module = exports.get(name)
        if module is None:
            raise AttributeError(name)
        return getattr(importlib.import_module(module), name)

    return __getattr__
