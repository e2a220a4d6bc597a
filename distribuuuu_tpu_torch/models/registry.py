"""Name -> factory model registry (the port's copy of ``models/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict

from torch import nn

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


def register_model(name: str):
    def deco(fn: Callable[..., nn.Module]):
        if name in _REGISTRY:
            raise ValueError(f"Duplicate model registration: {name}")
        _REGISTRY[name] = fn
        return fn

    return deco


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(arch: str, **kwargs) -> nn.Module:
    """Instantiate a registered architecture; unknown names raise with the list."""
    try:
        factory = _REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"Unknown MODEL.ARCH {arch!r}. Available: {', '.join(list_models())}"
        ) from None
    return factory(**kwargs)
