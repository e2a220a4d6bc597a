"""RegNetX / RegNetY (counterpart of ``models/regnet.py``), timm naming.

Widths and depths from the quantized linear rule (the JAX package's
:func:`generate_regnet_widths` and :func:`adjust_widths_groups`, copied
here). Stem 3x3/2 conv (32) -> BN -> ReLU; each block 1x1 -> 3x3 group conv
(stride 2 in a stage's first block) -> [SE] -> 1x1, BN after each conv,
ReLU after the first two, a projection shortcut (1x1 conv + BN) where the
shape changes, then ``relu(bn3 + shortcut)``; the f32 head. RegNetY adds
the SE gate (ReLU, width ``round(0.25 * w_in)`` of the block's input).

Every BN runs through K1: ``bn1`` (and ``bn2`` of an X block) write their
conv's input in the compute dtype alone; a Y block's ``bn2`` writes the BN
boundary, which the SE gate multiplies; ``bn3`` is K1's residual mode,
writing what the next block reads (:func:`link_handoffs`); the shortcut's
BN runs without ReLU, as in the port's ``Bottleneck``.

Module names follow timm (``stem.conv``, ``s1.b1.conv1.conv``,
``s1.b1.se.fc1``, ``s1.b1.downsample.bn``, ``head.fc``): the keys
``distribuuuu_tpu.convert.export_state_dict(v, "regnety_160")`` emits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    BatchNorm,
    RematUnit,
    SqueezeExcite,
    bn_epilogue,
    boundary,
    classifier_head,
    conv,
    link_handoffs,
    set_remat,
)
from distribuuuu_tpu_torch.models.registry import register_model


def generate_regnet_widths(wa: float, w0: int, wm: float, depth: int, q: int = 8):
    """Per-stage (widths, depths) from the quantized linear parameterization."""
    ws_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    ws = w0 * np.power(wm, ks)
    ws = (np.round(ws / q) * q).astype(int)
    widths, depths = np.unique(ws, return_counts=True)
    order = np.argsort(widths)
    return widths[order].tolist(), depths[order].tolist()


def adjust_widths_groups(widths: Sequence[int], group_w: int):
    """Make each width divisible by its group width (bottleneck ratio 1)."""
    gs = [min(group_w, w) for w in widths]
    ws = [int(round(w / g) * g) for w, g in zip(widths, gs)]
    return ws, gs


class ConvBN(nn.Module):
    """A conv and its BN under timm's names (``conv``, ``bn``), applied
    through K1 with :func:`bn_epilogue`'s options."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, *, dtype, bn_dtype):
        super().__init__()
        self.conv = conv(in_ch, out_ch, kernel, stride, groups=groups, dtype=dtype)
        self.bn = BatchNorm(out_ch, bn_dtype=bn_dtype)

    def forward(self, x, identity=None, **kw):
        return bn_epilogue(self.conv(x), self.bn, identity, **kw)


class RegNetBlock(RematUnit):
    """X/Y bottleneck block, ratio 1 (the remat unit under ``remat``)."""

    def __init__(self, w_in: int, width: int, stride: int, group_width: int, se_ratio: float,
                 *, dtype, bn_dtype):
        super().__init__()
        kw = dict(dtype=dtype, bn_dtype=bn_dtype)
        self.conv1 = ConvBN(w_in, width, 1, **kw)
        self.conv2 = ConvBN(width, width, 3, stride, groups=width // group_width, **kw)
        self.se = (SqueezeExcite(width, max(1, int(round(w_in * se_ratio))), F.relu, dtype=dtype,
                                 names=("fc1", "fc2")) if se_ratio > 0 else None)
        self.conv3 = ConvBN(width, width, 1, **kw)
        self.downsample = (ConvBN(w_in, width, 1, stride, **kw)
                           if stride != 1 or w_in != width else None)
        self.compute_dtype = dtype
        self.handoff: dict = {}  # the K1 mode of bn3 (link_handoffs)

    @property
    def projects(self) -> bool:
        return self.downsample is not None

    def forward(self, x):
        to_conv = dict(cast_to=self.compute_dtype, keep_boundary=False)
        h = self.conv1(x, **to_conv)
        if self.se is None:
            h = self.conv2(h, **to_conv)
        else:  # the gate multiplies the BN boundary, as JAX's x * sigmoid(s)
            h = self.se(self.conv2(h))
        shortcut = boundary(x) if self.downsample is None else self.downsample(x, relu=False)
        return self.conv3(h, shortcut, **self.handoff)


class RegNet(nn.Module):
    """``stem``, stages ``s1..sN`` of blocks ``b1..bD``, ``head.fc``."""

    def __init__(self, wa: float, w0: int, wm: float, depth: int, group_width: int,
                 se_ratio: float = 0.0, num_classes: int = 1000, dtype=torch.bfloat16,
                 bn_dtype=torch.float32, remat: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, bn_dtype=bn_dtype)
        widths, depths = generate_regnet_widths(wa, w0, wm, depth)
        widths, groups = adjust_widths_groups(widths, group_width)
        self.stem = ConvBN(3, 32, 3, 2, **kw)
        w_in, blocks = 32, []
        for si, (w, d, g) in enumerate(zip(widths, depths, groups)):
            stage = nn.Module()
            for i in range(d):
                block = RegNetBlock(w_in, w, 2 if i == 0 else 1, g, se_ratio, **kw)
                stage.add_module(f"b{i + 1}", block)
                blocks.append(block)
                w_in = w
            self.add_module(f"s{si + 1}", stage)
        self.head = nn.Module()
        self.head.fc = nn.Linear(w_in, num_classes)
        self.blocks = blocks  # a plain list: the modules are registered in their stages
        self.stem_handoff = link_handoffs(blocks, dtype)
        set_remat(self, remat)

    def forward(self, x):
        """``x``: NHWC images (float); returns ``[N, num_classes]`` float32 logits."""
        x = self.stem(x.permute(0, 3, 1, 2), **self.stem_handoff)
        for block in self.blocks:
            x = block(x)
        return classifier_head(x, self.head.fc)


@register_model("regnetx_160")
def regnetx_160(**kw):
    """RegNetX-16GF (timm naming)."""
    return RegNet(wa=55.59, w0=216, wm=2.1, depth=22, group_width=128, **kw)


@register_model("regnety_040")
def regnety_040(**kw):
    """RegNetY-4GF."""
    return RegNet(wa=31.41, w0=96, wm=2.24, depth=22, group_width=64, se_ratio=0.25, **kw)


@register_model("regnety_160")
def regnety_160(**kw):
    """RegNetY-16GF."""
    return RegNet(wa=106.23, w0=200, wm=2.48, depth=18, group_width=112, se_ratio=0.25, **kw)


@register_model("regnety_320")
def regnety_320(**kw):
    """RegNetY-32GF."""
    return RegNet(wa=115.89, w0=232, wm=2.53, depth=20, group_width=232, se_ratio=0.25, **kw)
