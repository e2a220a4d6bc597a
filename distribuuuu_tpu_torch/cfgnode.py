"""A minimal, dependency-free yacs-style config tree.

The port's own copy of ``distribuuuu_tpu/cfgnode.py``: the subset of
`yacs.config.CfgNode` behavior the framework needs, without depending on yacs:

- attribute-style access to a nested dict of config values
- `merge_from_file` / `merge_from_other_cfg` / `merge_from_list` with
  type-checked overrides (new keys are rejected; value types must match,
  with ``None`` permissive on either side and int->float promotion)
- `freeze()` / `defrost()` immutability toggles (recursive)
- `clone()` deep copy and `dump()` to sorted YAML
"""

from __future__ import annotations

import copy
from ast import literal_eval
from typing import Any

import yaml

class CfgNode(dict):
    """Nested attribute dict with yacs-like merge/freeze semantics."""

    _IMMUTABLE = "__cfg_immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        self.__dict__[CfgNode._IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._convert(v)

    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return CfgNode(value)
        return value

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        self._check_mutable(name)
        super().__setitem__(name, self._convert(value))

    def _check_mutable(self, name: str) -> None:
        if self.__dict__.get(CfgNode._IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to set {name!r} on an immutable CfgNode; call defrost() first"
            )

    # -- immutability -----------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__.get(CfgNode._IMMUTABLE, False)

    def _set_immutable(self, flag: bool) -> None:
        self.__dict__[CfgNode._IMMUTABLE] = flag
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- cloning / dumping ------------------------------------------------
    def clone(self) -> "CfgNode":
        node = CfgNode(self._to_dict())
        return node

    def _to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v._to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self, stream=None, **kwargs) -> str | None:
        kwargs.setdefault("default_flow_style", None)
        return yaml.safe_dump(self._to_dict(), stream=stream, **kwargs)

    @classmethod
    def load_cfg(cls, stream) -> "CfgNode":
        loaded = yaml.safe_load(stream)
        if loaded is None:
            loaded = {}
        if not isinstance(loaded, dict):
            raise TypeError(f"Config stream must contain a mapping, got {type(loaded)}")
        return cls(loaded)

    # -- merging ----------------------------------------------------------
    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename, "r") as f:
            other = CfgNode.load_cfg(f)
        self.merge_from_other_cfg(other)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_list(self, cfg_list: list[str]) -> None:
        if len(cfg_list) % 2 != 0:
            raise ValueError(f"Override list must have even length: {cfg_list}")
        for full_key, raw_value in zip(cfg_list[0::2], cfg_list[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node or not isinstance(node[sub], CfgNode):
                    raise KeyError(f"Non-existent config section: {full_key}")
                node = node[sub]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {full_key}")
            value = _decode_value(raw_value)
            node[leaf] = _coerce_value(value, node[leaf], full_key)


def _decode_value(raw: Any) -> Any:
    """Parse a CLI string into a Python literal (yacs semantics)."""
    if not isinstance(raw, str):
        return raw
    try:
        return literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _coerce_value(new: Any, old: Any, full_key: str) -> Any:
    """Type-check an override; permit None on either side, int->float, list<->tuple."""
    if old is None or new is None:
        return new
    if isinstance(old, type(new)) and not (
        isinstance(new, bool) is not isinstance(old, bool)
    ):
        return new
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if type(old) is type(new):
        return new
    raise ValueError(
        f"Type mismatch for key {full_key}: cannot override "
        f"{type(old).__name__} with {type(new).__name__} ({new!r})"
    )


def _merge_into(src: CfgNode, dst: CfgNode, key_path: list[str]) -> None:
    for k, v in src.items():
        full_key = ".".join(key_path + [k])
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full_key}")
        if isinstance(dst[k], CfgNode):
            if not isinstance(v, CfgNode):
                raise ValueError(f"Cannot replace config section {full_key} with a value")
            _merge_into(v, dst[k], key_path + [k])
        else:
            dst[k] = _coerce_value(v, dst[k], full_key)
