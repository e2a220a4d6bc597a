"""Shared building blocks of the port's zoo (counterpart of ``models/layers.py``).

Serving numerics, as the JAX engine runs them:

- convs and linears keep float32 parameters and compute in the model's
  ``dtype`` (bfloat16 for serving): input and weight are cast, the output
  stays in that dtype;
- BatchNorm folds its running stats to ``mean`` and ``mul = rsqrt(var +
  eps) * scale`` and emits ``bn_dtype`` (float32 for serving), so every
  epilogue takes the conv's bf16 output and emits f32, and residuals are f32;
- the head is an f32 mean over H and W followed by an f32 linear.

Tensors are NCHW-logical and stored channels-last, so C is contiguous.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.ops.epilogue import epilogue_reference, fused_conv_epilogue


class Conv2d(nn.Conv2d):
    """Bias-free conv with explicit symmetric padding, computed in ``dtype``."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, *, padding, groups, dtype):
        super().__init__(in_ch, out_ch, kernel, stride, padding, groups=groups, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.conv2d(
            x.to(self.compute_dtype), self.weight.to(self.compute_dtype), None,
            self.stride, self.padding, self.dilation, self.groups,
        )


def conv(in_ch, out_ch, kernel, stride=1, *, padding=None, groups=1, dtype=torch.bfloat16):
    """``layers.conv``: padding defaults to ``(kernel - 1) // 2`` on both sides."""
    if padding is None:
        padding = (kernel - 1) // 2
    return Conv2d(in_ch, out_ch, kernel, stride, padding=padding, groups=groups, dtype=dtype)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm: ``weight``/``bias`` and ``running_mean``/``running_var``.

    It registers no ``num_batches_tracked``, so the JAX package's
    ``export_state_dict`` output loads with ``strict=True``. Called as a
    module it is a plain BN (the downsample path); :func:`bn_epilogue` runs
    it fused with the residual add and ReLU.
    """

    def __init__(self, channels: int, *, bn_dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.bn_dtype = bn_dtype
        self.eps = eps

    def affine(self):
        """``(mean, mul, bias)`` in flax's order: rsqrt first, then the scale
        multiply (the association changes bits)."""
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return self.running_mean, mul, self.bias

    def forward(self, x):
        # flax's _normalize order, as the plain epilogue computes it
        return epilogue_reference(x, *self.affine(), relu=False, bn_dtype=self.bn_dtype)


def bn_epilogue(x, bn: BatchNorm, identity=None, *, relu: bool = True):
    """BN -> (+``identity``) -> ReLU through the fused epilogue kernel."""
    mean, mul, bias = bn.affine()
    return fused_conv_epilogue(x, mean, mul, bias, identity, relu=relu, bn_dtype=bn.bn_dtype)


def classifier_head(x, fc: nn.Linear):
    """Global average pool over H and W in float32, then a float32 linear."""
    x = x.float().mean(dim=(2, 3))
    return F.linear(x, fc.weight.float(), fc.bias.float())
