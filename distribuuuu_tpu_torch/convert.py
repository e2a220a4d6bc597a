"""Carry weights into the port.

- :func:`from_jax_variables` maps the JAX package's ``{"params",
  "batch_stats"}`` (nested dicts of numpy arrays) to the port's state_dict:
  HWIO -> OIHW convs, ``[in, out]`` -> ``[out, in]`` linears, ``layerS_I`` ->
  ``layerS.I``, ``ds_conv``/``ds_bn`` -> ``downsample.0``/``downsample.1``;
  for botnet50 the reference's Sequential numbering, with the position
  tables carried verbatim. The port's own copy of the ResNet and BoTNet
  parts of ``distribuuuu_tpu.convert``'s ``export_state_dict``.
- :func:`load_weights` reads a torch ``.pt``/``.pth`` state_dict in
  torchvision naming.
- :func:`botnet50_trunk_from_resnet50` and :func:`merge_pretrained`: the
  reference's ``botnet50(pretrained=True)``, a resnet50's stem and stages
  1-3 under botnet50's numbering over a fresh botnet50.
- :func:`moe_from_jax` takes the JAX package's switch-MoE parameters and
  returns what one rank of the port's ``switch_moe`` holds.

Orbax directories cannot be read without JAX: a weights directory written
by the JAX package reaches the port through ``export_state_dict`` and
``torch.save``, run where JAX is installed.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from distribuuuu_tpu_torch.models.registry import list_models


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _resnet_module_name(mod: list[str]) -> str:
    parts = []
    for p in mod:
        m = re.fullmatch(r"(layer\d+)_(\d+)", p)
        if m:
            parts += [m.group(1), m.group(2)]
        elif p == "ds_conv":
            parts += ["downsample", "0"]
        elif p == "ds_bn":
            parts += ["downsample", "1"]
        else:
            parts.append(p)
    return ".".join(parts)


# BoTBlock submodules -> slots of the reference's shortcut / net Sequentials
_BOT_SLOTS = {
    "sc_conv": "shortcut.0",
    "sc_bn": "shortcut.1",
    "conv_in": "net.0",
    "bn_in": "net.1",
    "bn_mid": "net.5",
    "conv_out": "net.7",
    "bn_out": "net.8",
}
_BOT_TOP = {"conv1": "0", "bn1": "1", "fc": "10"}


def _botnet_module_name(mod: list[str]) -> str:
    """The reference's Sequential numbering: 0 conv1, 1 bn1, 4-6 layer1-3,
    7.net.{i} the BoTBlocks, 10 fc."""
    head = mod[0]
    if head in _BOT_TOP:
        return _BOT_TOP[head]
    m = re.fullmatch(r"layer(\d+)_(\d+)", head)
    if m:
        rest = _resnet_module_name(mod[1:])
        return f"{int(m.group(1)) + 3}.{m.group(2)}" + (f".{rest}" if rest else "")
    b = re.fullmatch(r"bot_(\d+)", head)
    if not b:
        raise KeyError(f"unmapped botnet module path {mod}")
    prefix = f"7.net.{b.group(1)}"
    if mod[1] == "mhsa":  # to_qk, to_v or pos_emb
        return ".".join([prefix, "net.3", *mod[2:]])
    return f"{prefix}.{_BOT_SLOTS[mod[1]]}"


# leaves stored verbatim on both sides (BoTNet's position tables)
_RAW_LEAVES = {"rel_height", "rel_width", "height", "width"}


def from_jax_variables(variables: Mapping, arch: str) -> dict[str, torch.Tensor]:
    """The port's state_dict for ``arch`` from JAX ``{"params", "batch_stats"}``."""
    if arch not in list_models():
        raise KeyError(f"{arch!r} is not a model of the port; it has: {', '.join(list_models())}")
    module_name = _botnet_module_name if arch == "botnet50" else _resnet_module_name
    sd: dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})):
            val = np.array(leaf, dtype=np.float32)  # a writable copy
            prefix, leaf_name = module_name(list(path[:-1])), path[-1]
            if leaf_name in _RAW_LEAVES:
                key = f"{prefix}.{leaf_name}"
            elif col == "batch_stats":
                key, val = f"{prefix}.running_{'mean' if leaf_name == 'mean' else 'var'}", val
            elif leaf_name == "kernel":
                key = f"{prefix}.weight"
                val = np.transpose(val, (3, 2, 0, 1)) if val.ndim == 4 else val.T
            elif leaf_name == "scale":
                key = f"{prefix}.weight"
            elif leaf_name == "bias":
                key = f"{prefix}.bias"
            else:
                raise KeyError(f"unmapped leaf {'/'.join(path)} for {arch}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """A torchvision-layout state_dict from a ``.pt``/``.pth`` file.

    Loaded with ``weights_only=True`` (no arbitrary unpickling). A
    ``{"state_dict": ...}`` wrapper and ``module.`` prefixes are unwrapped,
    and torchvision's ``num_batches_tracked`` buffers are dropped: the
    port's BN has none. A directory (an Orbax checkpoint of the JAX package)
    raises a ValueError that names the export route.
    """
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package, which the port "
            "cannot read without JAX. Export it where JAX is installed: "
            "distribuuuu_tpu.convert.export_state_dict(variables, arch), then torch.save the "
            "result to a .pt file and serve that"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), Mapping):
        sd = sd["state_dict"]
    return {
        k.removeprefix("module."): v
        for k, v in sd.items()
        if not k.endswith(".num_batches_tracked")
    }


# torchvision resnet50 trunk -> botnet50's Sequential slots
_BOT_TRUNK = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6"}


def botnet50_trunk_from_resnet50(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The reference's ``botnet50(pretrained=True)``: a torchvision/reference
    resnet50 state_dict's trunk (conv1, bn1, layer1-3) renamed onto botnet50's
    numbering (``0``, ``1``, ``4``-``6``), as float32 copies. The BoTStack and
    the classifier are not in it: lay it over a fresh botnet50's state_dict
    with :func:`merge_pretrained`. A ``{"state_dict": ...}`` wrapper and
    ``module.`` prefixes are unwrapped, ``num_batches_tracked`` dropped."""
    if isinstance(state_dict.get("state_dict"), Mapping):
        state_dict = state_dict["state_dict"]
    out = {}
    for key, val in state_dict.items():
        key = key.removeprefix("module.")
        head, _, rest = key.partition(".")
        if head in _BOT_TRUNK and not key.endswith(".num_batches_tracked"):
            out[f"{_BOT_TRUNK[head]}.{rest}"] = torch.tensor(np.asarray(val, dtype=np.float32))
    if not out:
        raise ValueError("state_dict has no resnet50 trunk keys (conv1/bn1/layer1-3): expected "
                         f"a torchvision/reference resnet50 checkpoint, got keys like "
                         f"{sorted(state_dict)[:3]}")
    return out


def merge_pretrained(state_dict: Mapping[str, torch.Tensor],
                     partial: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``state_dict`` with the entries of ``partial`` laid over it. Every key
    of ``partial`` must be in ``state_dict`` with the same shape."""
    out = dict(state_dict)
    for key, val in partial.items():
        if key not in out or tuple(out[key].shape) != tuple(val.shape):
            raise KeyError(f"{key} {tuple(val.shape)} does not match the model's "
                           f"{tuple(out[key].shape) if key in out else 'missing key'}")
        out[key] = val
    return out


def moe_from_jax(params: Mapping, rank: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``(gate [D, E], {name: rank's expert leaf})`` from the JAX switch-MoE
    layout ``{"gate": [D, E], "experts": {"w": [E, D, H], "v": [E, H, D]}}``
    (numpy arrays; the layout of the dry run, the tutorial and the JAX tests).
    The gate is replicated on every rank; each expert leaf is its row
    ``rank``. Leaves keep their layout (``expert_fn`` computes ``h @ w`` on
    both sides), as float32 copies."""
    experts = params["experts"]
    n_experts = {np.shape(v)[0] for v in experts.values()}
    if len(n_experts) != 1 or not 0 <= rank < next(iter(n_experts)):
        raise ValueError(f"rank {rank} is not an expert of leaves shaped "
                         f"{ {k: np.shape(v) for k, v in experts.items()} }")
    gate = torch.from_numpy(np.array(params["gate"], dtype=np.float32))
    return gate, {k: torch.from_numpy(np.array(v[rank], dtype=np.float32))
                  for k, v in experts.items()}
