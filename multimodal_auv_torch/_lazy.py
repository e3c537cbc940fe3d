"""Lazy public names for the port's packages: importing a package loads
none of its modules (so builds no kernel) until one of its names is used."""
import importlib


def lazy_exports(package: str, exports: dict):
    """``(__all__, __getattr__)`` for ``package``: each name of ``exports``
    is imported on first use from the module it maps to."""

    def __getattr__(name):
        if name in exports:
            return getattr(importlib.import_module(exports[name]), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return list(exports), __getattr__
