"""DenseNet-BC family (counterpart of ``models/densenet.py``), torchvision naming.

Stem 7x7/2 conv -> BN -> ReLU -> 3x3/2 max-pool (-inf padding); dense
blocks of BN -> ReLU -> 1x1 (``bn_size * k``) -> BN -> ReLU -> 3x3 (``k``)
layers, each concatenating its ``k`` new features onto its input;
transitions BN -> ReLU -> 1x1 (half the features) -> 2x2/2 average pool;
BN -> ReLU -> the f32 head.

Every BN runs through K1 (121 per DenseNet-121 forward): the stem's writes
the BN boundary (what the first block concatenates onto), the head's the
boundary the f32 head reads, and every other writes its conv's input in the
compute dtype alone. As in JAX, the concatenation is in the dtype of the
block's input (``new.astype(x.dtype)``): the BN dtype in the first block,
the compute dtype after a transition (its conv's output), so with f32
boundaries the first block's ``norm1`` reads f32 and the later blocks' read
bf16. Under ``remat`` each dense layer is recomputed in the backward, as
JAX's ``maybe_remat(DenseLayer)``.

Module names follow torchvision (``features.conv0``,
``features.denseblock1.denselayer1.norm1``, ``features.transition1.conv``,
``features.norm5``, ``classifier``): the keys
``distribuuuu_tpu.convert.export_state_dict(v, "densenet121")`` emits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    BatchNorm,
    RematUnit,
    bn_epilogue,
    classifier_head,
    conv,
    max_pool,
    set_remat,
)
from distribuuuu_tpu_torch.models.registry import register_model


class DenseLayer(RematUnit):
    """BN -> ReLU -> 1x1 -> BN -> ReLU -> 3x3: ``growth_rate`` new features."""

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int, *, dtype, bn_dtype):
        super().__init__()
        self.norm1 = BatchNorm(in_ch, bn_dtype=bn_dtype)
        self.conv1 = conv(in_ch, bn_size * growth_rate, 1, dtype=dtype)
        self.norm2 = BatchNorm(bn_size * growth_rate, bn_dtype=bn_dtype)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        to_conv = dict(cast_to=self.compute_dtype, keep_boundary=False)
        h = bn_epilogue(x, self.norm1, **to_conv)
        h = bn_epilogue(self.conv1(h), self.norm2, **to_conv)
        return self.conv2(h)


class DenseBlock(nn.Module):
    """``denselayer1..L``, each concatenating its output onto its input."""

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x).to(x.dtype)], dim=1)
        return x


class Transition(nn.Module):
    """BN -> ReLU -> 1x1 conv -> 2x2/2 average pool."""

    def __init__(self, in_ch: int, out_ch: int, *, dtype, bn_dtype):
        super().__init__()
        self.norm = BatchNorm(in_ch, bn_dtype=bn_dtype)
        self.conv = conv(in_ch, out_ch, 1, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        h = bn_epilogue(x, self.norm, cast_to=self.compute_dtype, keep_boundary=False)
        return F.avg_pool2d(self.conv(h), 2, 2)


class DenseNet(nn.Module):
    """DenseNet-BC: ``features`` (stem, blocks, transitions, ``norm5``) and
    the ``classifier``."""

    def __init__(self, growth_rate: int, block_config, num_init_features: int,
                 num_classes: int = 1000, bn_size: int = 4, dtype=torch.bfloat16,
                 bn_dtype=torch.float32, remat: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, bn_dtype=bn_dtype)
        self.features = nn.Module()
        f = self.features
        f.add_module("conv0", conv(3, num_init_features, 7, 2, padding=3, dtype=dtype))
        f.add_module("norm0", BatchNorm(num_init_features, bn_dtype=bn_dtype))
        width = num_init_features
        for bi, num_layers in enumerate(block_config):
            block = DenseBlock()
            for li in range(num_layers):
                block.add_module(f"denselayer{li + 1}",
                                 DenseLayer(width + li * growth_rate, growth_rate, bn_size, **kw))
            f.add_module(f"denseblock{bi + 1}", block)
            width += num_layers * growth_rate
            if bi != len(block_config) - 1:
                f.add_module(f"transition{bi + 1}", Transition(width, width // 2, **kw))
                width //= 2
        f.add_module("norm5", BatchNorm(width, bn_dtype=bn_dtype))
        self.classifier = nn.Linear(width, num_classes)
        self.num_blocks = len(block_config)
        set_remat(self, remat)

    def forward(self, x):
        """``x``: NHWC images (float); returns ``[N, num_classes]`` float32 logits."""
        f = self.features._modules
        x = x.permute(0, 3, 1, 2)  # a view: NCHW-logical, channels-last in memory
        x = max_pool(bn_epilogue(f["conv0"](x), f["norm0"]))
        for bi in range(self.num_blocks):
            x = f[f"denseblock{bi + 1}"](x)
            if bi != self.num_blocks - 1:
                x = f[f"transition{bi + 1}"](x)
        return classifier_head(bn_epilogue(x, f["norm5"]), self.classifier)


@register_model("densenet121")
def densenet121(**kw):
    return DenseNet(32, (6, 12, 24, 16), 64, **kw)


@register_model("densenet161")
def densenet161(**kw):
    return DenseNet(48, (6, 12, 36, 24), 96, **kw)


@register_model("densenet169")
def densenet169(**kw):
    return DenseNet(32, (6, 12, 32, 32), 64, **kw)


@register_model("densenet201")
def densenet201(**kw):
    return DenseNet(32, (6, 12, 48, 32), 64, **kw)
