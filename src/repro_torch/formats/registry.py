"""Format registry: name -> GraphFormat class (a port of
``repro.formats.registry``, with its error messages).

Formats register themselves at import time (`register` on each class);
``repro_torch.formats`` imports every built-in layout, so `available`
is complete after ``import repro_torch.formats``.
"""
from __future__ import annotations

from repro_torch.formats.base import GraphFormat

_REGISTRY: dict[str, type[GraphFormat]] = {}


def register(cls: type[GraphFormat]) -> type[GraphFormat]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name:
        raise ValueError(f"{cls.__name__} needs a non-empty `name`")
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise ValueError(f"format {name!r} already registered "
                         f"({_REGISTRY[name].__name__})")
    _REGISTRY[name] = cls
    return cls


def get(name: str) -> type[GraphFormat]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown graph format {name!r}; "
                       f"available: {available()}") from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build(graph, name: str = "auto", **kwargs) -> GraphFormat:
    """Build a named format from an EdgeList, Csr or format instance;
    ``name="auto"`` asks the autotuner (`autotune.build`)."""
    if name == "auto":
        from repro_torch.formats import autotune
        return autotune.build(graph, **kwargs)
    return get(name).from_graph(graph, **kwargs)
