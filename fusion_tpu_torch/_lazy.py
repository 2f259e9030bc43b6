"""Lazy re-exports for the subpackages' ``__init__`` modules (PEP 562):
a name resolves on first use by importing the module that defines it, so
importing a subpackage stays cheap, as the JAX package's eager imports are
not."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, names: dict[str, str]):
    """``(__getattr__, __all__)`` for ``package``: each name of ``names``
    (name → module, relative to ``package``; a name mapped to ``""`` is
    itself a submodule) resolves from its module; any other raises
    ``AttributeError``, so ``from package import submodule`` still imports
    the submodule."""

    def __getattr__(name):
        if name not in names:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        if not names[name]:
            return importlib.import_module(f"{package}.{name}")
        return getattr(importlib.import_module(f"{package}.{names[name]}"), name)

    return __getattr__, list(names)
