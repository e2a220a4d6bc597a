"""ResNet family (counterpart of ``models/resnet.py``), torchvision module naming.

v1.5: the stride of a Bottleneck sits on its 3x3 conv. The stem is a
7x7/2 conv -> BN -> ReLU -> 3x3/2 max-pool (implicit -inf padding, as
``nn.max_pool``). Every BN runs through K1: the stem ``bn1`` and each
block's ``bn1/bn2/bn3`` fused with the residual add and ReLU
(:func:`bn_epilogue`), the downsample BN alone, as in JAX. ``bn1``/``bn2``
write the next conv's input in the compute dtype; ``bn3`` and the stem write
what the next block reads (:func:`link_handoffs`).
Module names follow torchvision (``layer1.0.conv1``, ``layer1.0.downsample.0/1``,
``fc``), so torchvision-layout state_dicts load directly.

The public model takes NHWC images, like the JAX package; inside, the
permuted view is NCHW-logical and channels-last in memory.
"""

from __future__ import annotations

import torch
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    BatchNorm,
    RematUnit,
    bn_epilogue,
    boundary,
    classifier_head,
    conv,
    link_handoffs,
    max_pool,
    set_remat,
    to_conv,
)
from distribuuuu_tpu_torch.models.registry import register_model


class BasicBlock(RematUnit):
    """3x3 + 3x3 residual block (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False, groups=1, base_width=64,
                 *, dtype, bn_dtype, zero_init_residual=False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm(planes, bn_dtype=bn_dtype)
        self.conv2 = conv(planes, planes, 3, dtype=dtype)
        self.bn2 = BatchNorm(planes, bn_dtype=bn_dtype, zero_scale=zero_init_residual)
        self.downsample = (
            nn.Sequential(conv(inplanes, planes, 1, stride, dtype=dtype),
                          BatchNorm(planes, bn_dtype=bn_dtype))
            if downsample else None
        )
        self.compute_dtype = dtype
        self.handoff: dict = {}  # the K1 mode of bn2 (link_handoffs)
        self.to_conv = to_conv(dtype)  # bn1's

    @property
    def projects(self) -> bool:
        return self.downsample is not None

    def forward(self, x):
        out = bn_epilogue(self.conv1(x), self.bn1, **self.to_conv)
        out = self.conv2(out)
        identity = boundary(x) if self.downsample is None else self.downsample(x)
        return bn_epilogue(out, self.bn2, identity, **self.handoff)


class Bottleneck(RematUnit):
    """1x1 -> 3x3(stride, groups) -> 1x1 block (expansion 4)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False, groups=1, base_width=64,
                 *, dtype, bn_dtype, zero_init_residual=False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = conv(inplanes, width, 1, dtype=dtype)
        self.bn1 = BatchNorm(width, bn_dtype=bn_dtype)
        self.conv2 = conv(width, width, 3, stride, groups=groups, dtype=dtype)
        self.bn2 = BatchNorm(width, bn_dtype=bn_dtype)
        self.conv3 = conv(width, out, 1, dtype=dtype)
        self.bn3 = BatchNorm(out, bn_dtype=bn_dtype, zero_scale=zero_init_residual)
        self.downsample = (
            nn.Sequential(conv(inplanes, out, 1, stride, dtype=dtype),
                          BatchNorm(out, bn_dtype=bn_dtype))
            if downsample else None
        )
        self.compute_dtype = dtype
        self.handoff: dict = {}  # the K1 mode of bn3 (link_handoffs)
        self.to_conv = to_conv(dtype)  # bn1's and bn2's

    @property
    def projects(self) -> bool:
        return self.downsample is not None

    def forward(self, x):
        out = bn_epilogue(self.conv1(x), self.bn1, **self.to_conv)
        out = bn_epilogue(self.conv2(out), self.bn2, **self.to_conv)
        out = self.conv3(out)
        identity = boundary(x) if self.downsample is None else self.downsample(x)
        return bn_epilogue(out, self.bn3, identity, **self.handoff)


def resnet_stages(block, stage_sizes, groups=1, width_per_group=64, *, dtype, bn_dtype,
                  zero_init_residual=False):
    """The residual stages with v1.5 stride placement (``resnet_stages`` of
    the JAX package): a list of ``nn.Sequential`` and their output width.
    Shared by ResNet and BoTNet's trunk. ``zero_init_residual`` starts each
    block's last BN scale at zero."""
    stages, inplanes = [], 64
    for stage, num_blocks in enumerate(stage_sizes):
        planes = 64 * 2**stage
        blocks = []
        for i in range(num_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            downsample = stride != 1 or inplanes != planes * block.expansion
            blocks.append(block(inplanes, planes, stride, downsample, groups,
                                width_per_group, dtype=dtype, bn_dtype=bn_dtype,
                                zero_init_residual=zero_init_residual))
            inplanes = planes * block.expansion
        stages.append(nn.Sequential(*blocks))
    return stages, inplanes


class ResNet(nn.Module):
    """Stem -> 4 stages -> global average pool -> fc.

    ``stem_s2d`` (``MODEL.STEM_S2D``) is accepted as the JAX family accepts
    it, and changes nothing: the JAX space-to-depth stem computes the 7x7/2
    conv's function bitwise, and here cuDNN runs that conv as it is. The
    other families refuse the option. ``remat``: each block is recomputed in
    the backward (``layers.set_remat``), the stem is not, as in JAX."""

    def __init__(self, block, stage_sizes, num_classes=1000, groups=1, width_per_group=64,
                 dtype=torch.bfloat16, bn_dtype=torch.float32, zero_init_residual=False,
                 stem_s2d=False, remat=False):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, padding=3, dtype=dtype)
        self.bn1 = BatchNorm(64, bn_dtype=bn_dtype)
        stages, inplanes = resnet_stages(block, stage_sizes, groups, width_per_group,
                                         dtype=dtype, bn_dtype=bn_dtype,
                                         zero_init_residual=zero_init_residual)
        for stage, layer in enumerate(stages):
            self.add_module(f"layer{stage + 1}", layer)
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)
        self.compute_dtype = dtype
        self.link_handoffs()
        set_remat(self, remat)

    def link_handoffs(self, boundaries: bool = False) -> None:
        """Each BN's K1 mode (``layers.link_handoffs``); ``boundaries``: the
        BN boundary alone everywhere (``layers.boundary_handoffs``)."""
        blocks = [b for stage in range(self.num_stages) for b in getattr(self, f"layer{stage + 1}")]
        self.stem_handoff = link_handoffs(blocks, self.compute_dtype, boundaries=boundaries)

    def forward(self, x):
        """``x``: NHWC images (float); returns ``[N, num_classes]`` float32 logits."""
        x = x.permute(0, 3, 1, 2)  # a view: NCHW-logical, channels-last in memory
        x = max_pool(bn_epilogue(self.conv1(x), self.bn1, **self.stem_handoff))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return classifier_head(x, self.fc)


@register_model("resnet18")
def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


@register_model("resnet34")
def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


@register_model("resnet50")
def resnet50(**kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], **kw)


@register_model("resnet101")
def resnet101(**kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], **kw)


@register_model("resnet152")
def resnet152(**kw):
    return ResNet(Bottleneck, [3, 8, 36, 3], **kw)


@register_model("resnext50_32x4d")
def resnext50_32x4d(**kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], groups=32, width_per_group=4, **kw)


@register_model("resnext101_32x8d")
def resnext101_32x8d(**kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], groups=32, width_per_group=8, **kw)


@register_model("wide_resnet50_2")
def wide_resnet50_2(**kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], width_per_group=128, **kw)


@register_model("wide_resnet101_2")
def wide_resnet101_2(**kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], width_per_group=128, **kw)
