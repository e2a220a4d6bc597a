"""Carry weights into the port.

- :func:`from_jax_variables` maps the JAX package's ``{"params",
  "batch_stats"}`` (nested dicts of numpy arrays) to the port's state_dict:
  HWIO -> OIHW convs, ``[in, out]`` -> ``[out, in]`` linears, ``layerS_I`` ->
  ``layerS.I``, ``ds_conv``/``ds_bn`` -> ``downsample.0``/``downsample.1``;
  for botnet50 the reference's Sequential numbering, with the position
  tables carried verbatim; torchvision naming for DenseNet and ViT, timm's
  for EfficientNet and RegNet. The port's own copy of
  ``distribuuuu_tpu.convert``'s ``export_state_dict``: both give the same
  keys and values, so a JAX export loads into the port with ``strict=True``.
  MAE, which JAX does not export, keeps JAX's module names (its blocks as
  ``blocks.{i}`` in ViT's block naming).
- :func:`load_weights` reads a torch ``.pt``/``.pth`` state_dict in
  torchvision naming (DenseNet's pre-1.0 keys, ``norm.1``, remapped).
- :func:`botnet50_trunk_from_resnet50` and :func:`merge_pretrained`: the
  reference's ``botnet50(pretrained=True)``, a resnet50's stem and stages
  1-3 under botnet50's numbering over a fresh botnet50.
- :func:`moe_from_jax` takes the JAX package's switch-MoE parameters and
  returns what one rank of the port's ``switch_moe`` holds.
- :func:`golden_inputs`: the JAX package's fixture inputs (the int8
  quality gate's, for float wire).
- ``python -m distribuuuu_tpu_torch.convert --arch A --src <torchvision
  .pth> --dst DIR [--from-resnet50]`` provisions ``MODEL.PRETRAINED``: the
  file checked against the built model with ``strict=True``, written to
  DIR as the port's checkpoint (``checkpoint.pt`` and its manifest).

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


def _densenet_module_name(mod: list[str]) -> str:
    """torchvision's ``features.denseblock{B}.denselayer{L}``,
    ``features.transition{B}.{norm, conv}``, ``features.{conv0, norm0,
    norm5}``, ``classifier``."""
    parts = []
    for p in mod:
        m = re.fullmatch(r"block(\d+)_layer(\d+)", p)
        t = re.fullmatch(r"trans(\d+)_(norm|conv)", p)
        if m:
            parts += [f"features.denseblock{m.group(1)}", f"denselayer{m.group(2)}"]
        elif t:
            parts.append(f"features.transition{t.group(1)}.{t.group(2)}")
        elif p in ("conv0", "norm0", "norm5"):
            parts.append(f"features.{p}")
        else:
            parts.append(p)
    return ".".join(parts)


# MBConv submodules -> timm's names: the first stage's depthwise-separable
# block, the others' inverted residual
_EFF_DS = {"dw_conv": "conv_dw", "dw_bn": "bn1", "project_conv": "conv_pw", "project_bn": "bn2"}
_EFF_IR = {"expand_conv": "conv_pw", "expand_bn": "bn1", "dw_conv": "conv_dw", "dw_bn": "bn2",
           "project_conv": "conv_pwl", "project_bn": "bn3"}
_EFF_TOP = {"stem_conv": "conv_stem", "stem_bn": "bn1", "head_conv": "conv_head",
            "head_bn": "bn2", "classifier": "classifier"}


def _efficientnet_module_name(mod: list[str]) -> str:
    if mod[0] in _EFF_TOP:
        return _EFF_TOP[mod[0]]
    m = re.fullmatch(r"stage(\d+)_block(\d+)", mod[0])
    if not m:
        raise KeyError(f"unmapped efficientnet module path {mod}")
    prefix = f"blocks.{int(m.group(1)) - 1}.{int(m.group(2)) - 1}"
    if mod[1] == "se":
        return f"{prefix}.se.conv_{'reduce' if mod[2] == 'reduce' else 'expand'}"
    return f"{prefix}.{(_EFF_DS if m.group(1) == '1' else _EFF_IR)[mod[1]]}"


_REGNET_TOP = {"stem_conv": "stem.conv", "stem_bn": "stem.bn", "head_fc": "head.fc"}


def _regnet_module_name(mod: list[str]) -> str:
    if mod[0] in _REGNET_TOP:
        return _REGNET_TOP[mod[0]]
    m = re.fullmatch(r"stage(\d+)_block(\d+)", mod[0])
    if not m:
        raise KeyError(f"unmapped regnet module path {mod}")
    prefix = f"s{m.group(1)}.b{m.group(2)}"
    inner = mod[1]
    if inner == "se":
        return f"{prefix}.se.fc{'1' if mod[2] == 'reduce' else '2'}"
    if inner in ("sc_conv", "sc_bn"):
        return f"{prefix}.downsample.{inner[3:]}"
    c = re.fullmatch(r"(conv|bn)(\d)", inner)
    if not c:
        raise KeyError(f"unmapped regnet module path {mod}")
    return f"{prefix}.conv{c.group(2)}.{c.group(1)}"


def _family_module_name(arch: str):
    if arch == "botnet50":
        return _botnet_module_name
    for family, fn in (("densenet", _densenet_module_name),
                       ("efficientnet", _efficientnet_module_name),
                       ("regnet", _regnet_module_name)):
        if arch.startswith(family):
            return fn
    return _resnet_module_name


def _w_or_b(leaf_name, val):
    """A Dense leaf: kernel ``[in, out]`` -> weight ``[out, in]``, or the bias;
    a LayerNorm's scale -> weight."""
    if leaf_name == "kernel":
        return "weight", val.T
    return ("weight" if leaf_name == "scale" else "bias"), val


def _encoder_block_keys(p: str, mod: list[str], leaf_name: str, val) -> tuple[str, np.ndarray]:
    """One leaf of a JAX ``EncoderBlock`` (``ln1``, ``attn/{qkv, proj}``,
    ``ln2``, ``fc1``, ``fc2``) under the port's block ``p``: the qkv and
    out-projection leaves are whole-key renames, not module paths."""
    name, v = _w_or_b(leaf_name, val)
    if mod[0] in ("ln1", "ln2"):
        return f"{p}.ln_{mod[0][-1]}.{name}", v
    if mod[0] == "attn":
        inner = f"in_proj_{name}" if mod[1] == "qkv" else f"out_proj.{name}"
        return f"{p}.self_attention.{inner}", v
    return f"{p}.mlp.linear_{mod[0][-1]}.{name}", v  # fc1 / fc2


def _patch_embed(leaf_name, val):  # the patch conv: HWIO -> OIHW
    return ("weight", np.transpose(val, (3, 2, 0, 1))) if leaf_name == "kernel" else ("bias", val)


def _vit_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """torchvision's ``vit_b_16`` keys from JAX ViT params."""
    sd: dict[str, np.ndarray] = {}
    for path, leaf in _flatten(variables.get("params", {})):
        val = np.array(leaf, dtype=np.float32)
        mod, leaf_name = list(path[:-1]), path[-1]
        if not mod:
            sd["class_token" if leaf_name == "cls_token" else "encoder.pos_embedding"] = val
        elif mod[0] == "patch_embed":
            name, v = _patch_embed(leaf_name, val)
            sd[f"conv_proj.{name}"] = v
        elif mod[0] in ("ln_f", "head"):
            name, v = _w_or_b(leaf_name, val)
            sd[f"{'encoder.ln' if mod[0] == 'ln_f' else 'heads.head'}.{name}"] = v
        else:
            p = f"encoder.layers.encoder_layer_{int(mod[0].removeprefix('block'))}"
            k, v = _encoder_block_keys(p, mod[1:], leaf_name, val)
            sd[k] = v
    return sd


def _mae_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """The port's MAE keys from JAX ``MAEViT`` params: JAX's names
    (``patch_embed``, ``mask_token``, ``pos_embed``, ``ln_f``, ``dec_fc``,
    ``dec_pred``), ``block{i}`` as ``blocks.{i}`` in ViT's block naming."""
    sd: dict[str, np.ndarray] = {}
    for path, leaf in _flatten(variables.get("params", {})):
        val = np.array(leaf, dtype=np.float32)
        mod, leaf_name = list(path[:-1]), path[-1]
        if not mod:  # mask_token, pos_embed
            sd[leaf_name] = val
        elif mod[0] == "patch_embed":
            name, v = _patch_embed(leaf_name, val)
            sd[f"patch_embed.{name}"] = v
        elif mod[0] in ("ln_f", "dec_fc", "dec_pred"):
            name, v = _w_or_b(leaf_name, val)
            sd[f"{mod[0]}.{name}"] = v
        else:
            k, v = _encoder_block_keys(f"blocks.{int(mod[0].removeprefix('block'))}", mod[1:],
                                       leaf_name, val)
            sd[k] = v
    return sd


# leaves stored verbatim on both sides (BoTNet's position tables)
_RAW_LEAVES = {"rel_height", "rel_width", "height", "width"}


def from_jax_variables(variables: Mapping, arch: str) -> dict[str, torch.Tensor]:
    """The port's state_dict for ``arch`` from JAX ``{"params", "batch_stats"}``."""
    if arch not in list_models():
        raise KeyError(f"{arch!r} is not a model of the port; it has: {', '.join(list_models())}")
    for family, keys in (("vit", _vit_state_dict), ("mae_", _mae_state_dict)):
        if arch.startswith(family):
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in keys(variables).items()}
    module_name = _family_module_name(arch)
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


def golden_inputs(n: int, size: int, seed: int = 0) -> np.ndarray:
    """The JAX package's fixture inputs (``distribuuuu_tpu.convert.golden_inputs``):
    seeded standard-normal ``(n, s, s, 3)`` float32, post-normalization
    scale. Deterministic across platforms (PCG64)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, size, size, 3), dtype=np.float32)


# DenseNet's pre-1.0 keys: ``denselayer1.norm.1.weight`` -> ``denselayer1.norm1.weight``
_DENSENET_LEGACY = re.compile(r"^(.*denselayer\d+\.(?:norm|relu|conv))\.([12])\.(.*)$")


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """A torchvision-layout state_dict from a ``.pt``/``.pth`` file.

    Loaded with ``weights_only=True`` (no arbitrary unpickling). A
    ``{"state_dict": ...}`` wrapper and ``module.`` prefixes are unwrapped,
    torchvision's ``num_batches_tracked`` buffers are dropped (the port's
    BN has none), and DenseNet's legacy ``norm.1``-style keys renamed. A
    directory (an Orbax checkpoint of the JAX package) raises a ValueError
    that names the export route.
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
        _DENSENET_LEGACY.sub(r"\1\2.\3", k.removeprefix("module.")): v
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


def provision(arch: str, src: str, dst: str, *, from_resnet50: bool = False,
              num_classes: int = 1000) -> dict[str, torch.Tensor]:
    """Write ``MODEL.PRETRAINED``'s directory ``dst`` for ``arch`` from the
    torchvision-layout file ``src`` (:func:`load_weights`): the weights
    loaded into ``arch`` built for ``num_classes`` (and a 224^2 crop, which
    sizes BoTNet's and ViT's position tables) with ``strict=True``, then
    saved as the port's checkpoint (``checkpoint.pt``
    with the model alone, and its manifest). ``from_resnet50`` (botnet50
    only): ``src`` is a resnet50, whose trunk
    (:func:`botnet50_trunk_from_resnet50`) is laid over botnet50's
    initialisers drawn from seed 0 (:func:`merge_pretrained`), the
    reference's ``botnet50(pretrained=True)``. Returns the state_dict
    written."""
    from distribuuuu_tpu_torch import checkpoint
    from distribuuuu_tpu_torch.models import build_model, layers

    if from_resnet50 and arch != "botnet50":
        raise ValueError("--from-resnet50 only applies to --arch botnet50")
    model = build_model(arch, num_classes=num_classes, im_size=224)
    sd = load_weights(src)
    if from_resnet50:
        init = layers.init_weights(model, torch.Generator().manual_seed(0)).state_dict()
        sd = merge_pretrained(init, botnet50_trunk_from_resnet50(sd))
    model.load_state_dict(sd, strict=True)
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    checkpoint._write(dst, {"epoch": -1, "model": out, "best_acc1": 0.0})
    return out


def main(argv: list[str] | None = None) -> int:
    """``python -m distribuuuu_tpu_torch.convert --arch A --src <.pth> --dst DIR``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m distribuuuu_tpu_torch.convert",
        description="Provision MODEL.PRETRAINED: a torchvision-layout .pth -> the port's "
                    "checkpoint directory ($DTPU_PRETRAINED_DIR/<arch>)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--src", required=True, help="torch .pth/.pt state_dict (torchvision names)")
    ap.add_argument("--dst", required=True, help="output directory (checkpoint.pt + manifest)")
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--from-resnet50", action="store_true",
                    help="botnet50 only: the trunk from a resnet50 file, the BoTStack and fc "
                         "at the seeded init (the reference's botnet50(pretrained=True))")
    args = ap.parse_args(argv)
    sd = provision(args.arch, args.src, args.dst, from_resnet50=args.from_resnet50,
                   num_classes=args.num_classes)
    print(f"converted {args.src} ({args.arch}, {len(sd)} tensors) -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
