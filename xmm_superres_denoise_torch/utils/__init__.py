"""Lazy exports, as the JAX package's `utils` has them: importing the
package loads neither matplotlib nor the profiling helpers."""

from typing import Any

_EXPORTS = {
    "ImageLogger": "imagelogger",
    "setup_logging": "logging",
    "annotate": "profiling",
    "flops_estimate": "profiling",
    "trace": "profiling",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:  # PEP 562
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
