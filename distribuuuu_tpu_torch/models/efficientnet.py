"""EfficientNet-B0/B1 (counterpart of ``models/efficientnet.py``), timm naming.

Stem 3x3/2 conv -> BN -> SiLU; MBConv blocks (1x1 expand -> BN -> SiLU, a
depthwise kxk conv with symmetric padding -> BN -> SiLU, the SE gate with
SiLU at ``int(0.25 * in_ch)``, 1x1 project -> BN, and where stride is 1 and
the width unchanged, stochastic depth and the residual add in the BN
dtype); head 1x1 conv (1280) -> BN -> SiLU -> f32 mean -> dropout 0.2 ->
f32 linear. Stochastic depth grows linearly to ``drop_path_rate`` over the
blocks. Both draw from the generator the trainer hands the model each
step (``layers.RandomMask.generator``), never from a global stream.

Every BN runs through K1 (49 per B0 forward) without ReLU: SiLU follows
as its own op (:func:`layers.bn_silu`; the JAX kernel has no SiLU mode
either). A residual block's ``project_bn`` is K1's residual mode (``bn(h)
+ x``, as JAX adds in the BN dtype) unless a drop-path mask lies between
them (training with a rate above 0).

Module names follow timm (``conv_stem``, ``bn1``, ``blocks.{s}.{b}``: the
first stage's ``conv_dw, bn1, se, conv_pw, bn2``, the others' ``conv_pw,
bn1, conv_dw, bn2, se, conv_pwl, bn3``; ``conv_head``, ``bn2``,
``classifier``): the keys ``distribuuuu_tpu.convert.export_state_dict(v,
"efficientnet_b0")`` emits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    BatchNorm,
    DropPath,
    Dropout,
    RematUnit,
    SqueezeExcite,
    bn_epilogue,
    bn_silu,
    conv,
    set_remat,
)
from distribuuuu_tpu_torch.models.registry import register_model

# (expand_ratio, kernel, stride, out_channels, repeats) of B0; other members
# scale them with the compound coefficients
_B0_STAGES = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]


def _round_filters(ch: int, width_coef: float, divisor: int = 8) -> int:
    """Compound width scaling with the paper's divisor-snapping rule."""
    if width_coef == 1.0:
        return ch
    v = ch * width_coef
    new = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new < 0.9 * v:  # never round down below 90%
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_coef: float) -> int:
    return int(math.ceil(depth_coef * repeats))


class MBConv(RematUnit):
    """Mobile inverted bottleneck with SE and stochastic depth (the remat
    unit under ``remat``: its drop-path mask is replayed in the recompute)."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, kernel: int, stride: int,
                 se_ratio: float, drop_path: float, *, dtype, bn_dtype):
        super().__init__()
        mid = in_ch * expand_ratio
        self.expands = expand_ratio != 1
        if self.expands:
            self.conv_pw = conv(in_ch, mid, 1, dtype=dtype)
            self.bn1 = BatchNorm(mid, bn_dtype=bn_dtype)
            self.names = ("conv_dw", "bn2", "conv_pwl", "bn3")
        else:  # timm's depthwise-separable block (the first stage)
            self.names = ("conv_dw", "bn1", "conv_pw", "bn2")
        dw, dw_bn, pw, pw_bn = self.names
        self.add_module(dw, conv(mid, mid, kernel, stride, groups=mid, dtype=dtype))
        self.add_module(dw_bn, BatchNorm(mid, bn_dtype=bn_dtype))
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)), F.silu, dtype=dtype)
        self.add_module(pw, conv(mid, out_ch, 1, dtype=dtype))
        self.add_module(pw_bn, BatchNorm(out_ch, bn_dtype=bn_dtype))
        self.residual = stride == 1 and in_ch == out_ch
        self.drop_path = DropPath(drop_path) if self.residual else None

    def forward(self, x):
        m = self._modules
        dw, dw_bn, pw, pw_bn = self.names
        h = bn_silu(self.conv_pw(x), self.bn1) if self.expands else x
        h = self.se(bn_silu(m[dw](h), m[dw_bn]))
        h = m[pw](h)
        if not self.residual:
            return m[pw_bn](h)
        if self.drop_path.active:
            return self.drop_path(m[pw_bn](h)) + x
        return bn_epilogue(h, m[pw_bn], x, relu=False)


class EfficientNet(nn.Module):
    """The EfficientNet trunk for compound coefficients ``(width_coef,
    depth_coef)``: B0 is (1.0, 1.0); the resolution lives in the config."""

    def __init__(self, num_classes: int = 1000, dropout: float = 0.2,
                 drop_path_rate: float = 0.2, width_coef: float = 1.0, depth_coef: float = 1.0,
                 dtype=torch.bfloat16, bn_dtype=torch.float32, remat: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, bn_dtype=bn_dtype)
        stem = _round_filters(32, width_coef)
        self.conv_stem = conv(3, stem, 3, 2, dtype=dtype)
        self.bn1 = BatchNorm(stem, bn_dtype=bn_dtype)
        stages = [(e, k, s, _round_filters(c, width_coef), _round_repeats(r, depth_coef))
                  for (e, k, s, c, r) in _B0_STAGES]
        total = sum(r for *_, r in stages)
        self.blocks = nn.ModuleList()
        w_in, bidx = stem, 0
        for e, k, s, c, r in stages:
            stage = nn.ModuleList()
            for i in range(r):
                stage.append(MBConv(w_in, c, e, k, s if i == 0 else 1, 0.25,
                                    drop_path_rate * bidx / total, **kw))
                w_in, bidx = c, bidx + 1
            self.blocks.append(stage)
        head = _round_filters(1280, width_coef)
        self.conv_head = conv(w_in, head, 1, dtype=dtype)
        self.bn2 = BatchNorm(head, bn_dtype=bn_dtype)
        self.dropout = Dropout(dropout)
        self.classifier = nn.Linear(head, num_classes)
        set_remat(self, remat)

    def forward(self, x):
        """``x``: NHWC images (float); returns ``[N, num_classes]`` float32 logits."""
        x = bn_silu(self.conv_stem(x.permute(0, 3, 1, 2)), self.bn1)
        for stage in self.blocks:
            for block in stage:
                x = block(x)
        x = bn_silu(self.conv_head(x), self.bn2)
        x = self.dropout(x.mean((2, 3), dtype=torch.float32))
        return F.linear(x, self.classifier.weight.float(), self.classifier.bias.float())


@register_model("efficientnet_b0")
def efficientnet_b0(**kw):
    return EfficientNet(**kw)


@register_model("efficientnet_b1")
def efficientnet_b1(**kw):
    """B1: depth x1.1, width x1.0; its config trains at TRAIN.IM_SIZE 240."""
    return EfficientNet(width_coef=1.0, depth_coef=1.1, **kw)
