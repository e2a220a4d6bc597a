"""Name -> factory model registry (the port's copy of ``models/registry.py``)."""

from __future__ import annotations

import inspect
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


def build_model(arch: str, *, im_size: int | None = None, **kwargs) -> nn.Module:
    """Instantiate a registered architecture; unknown names raise with the list.

    ``im_size`` (the crop the model will see) goes to the factories that
    size state by it (botnet50's position tables) and is ignored by the rest.
    """
    try:
        factory = _REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"Unknown MODEL.ARCH {arch!r}. Available: {', '.join(list_models())}"
        ) from None
    if im_size is not None and "im_size" in inspect.signature(factory).parameters:
        kwargs["im_size"] = im_size
    return factory(**kwargs)
