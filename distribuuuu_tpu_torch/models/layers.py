"""Shared building blocks of the port's zoo (counterpart of ``models/layers.py``).

Serving numerics, as the JAX engine runs them:

- convs and linears keep float32 parameters and compute in the model's
  ``dtype`` (bfloat16 for serving): input and weight are cast, the output
  stays in that dtype;
- BatchNorm folds its running stats to ``mean`` and ``mul = rsqrt(var +
  eps) * scale`` and emits ``bn_dtype`` (float32 for serving), so every
  epilogue takes the conv's bf16 output and emits f32, and residuals are f32;
- the head is an f32 mean over H and W followed by an f32 linear.

Every BN runs through K1, which also writes the next conv's input in the
compute dtype from the same pass (``cast_to``), so no activation is cast
in a pass of its own: where only convs read a result, K1 writes it in the
compute dtype alone; where a residual or the head reads it too, K1 writes
both as a :class:`Pair`. Each block's ``handoff`` and ``to_conv`` (set by
:func:`link_handoffs`) say which its BNs write. Every BN call is a call of
its module and the head calls its ``fc``, so module hooks see them; the
int8 path (``quant/ptq.py``) hooks and swaps them, with every K1 writing
the BN boundary (:func:`boundary_handoffs`), the value JAX's convs quantize.

Training (``model.train()``): each BN takes float32 batch statistics of
its input, flax ``nn.BatchNorm``'s way (the fast variance ``max(0, E[x^2]
- E[x]^2)``; under SyncBN ``[mean, E[x^2]]`` averaged over the process
group in one all-reduce), updates its running statistics in place with
flax's momentum 0.9 on the biased variance, and hands K1 the folded
affine; gradients reach the statistics through autograd on those ops, and
K1's own backward is a kernel (``ops/epilogue.py``). ``bn_dtype`` is then
the model's compute dtype unless the config says otherwise.

The rest of the zoo's pieces: :class:`SqueezeExcite` (RegNetY,
EfficientNet), :func:`bn_silu` (K1 without ReLU, then SiLU), and the
random masks :class:`DropPath` and :class:`Dropout`, which draw only from
a generator handed to them (the trainer reseeds one each micro-step;
:func:`set_generator` hands one to a whole model). :func:`init_weights` draws every family's JAX
initialisers from one generator.

Remat (``MODEL.REMAT``, the JAX package's ``maybe_remat``): each family's
block is a :class:`RematUnit`, which :func:`set_remat` switches to
``torch.utils.checkpoint`` (non-reentrant): its forward keeps only its
inputs, and the backward recomputes it. The recompute is the same function
as the forward, bit for bit: BN uses the recomputed batch statistics but
leaves the running ones as the forward left them (:func:`recomputing`), as
``nn.remat`` mutates ``batch_stats`` once; the dropout and drop-path
generators are replayed from their state at the forward; a :class:`Pair`
goes in and out whole. On the card the recompute launches K1 (and BoTNet's
attention) a second time, the backward kernels once.

Tensors are NCHW-logical and stored channels-last, so C is contiguous.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distribuuuu_tpu_torch.ops.epilogue import fused_conv_epilogue


class Pair(NamedTuple):
    """One activation in both forms its readers take, from one K1 pass:
    ``boundary`` in the BN dtype (a residual's identity, the head) and
    ``cast`` in the compute dtype (the next convs' input)."""

    boundary: torch.Tensor
    cast: torch.Tensor


class Conv2d(nn.Conv2d):
    """Bias-free conv with explicit symmetric padding, computed in ``dtype``.
    A :class:`Pair` gives its ``cast``; any other input is cast here (the
    stem's image, or an input already in ``dtype``, which costs nothing)."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, *, padding, groups, dtype):
        super().__init__(in_ch, out_ch, kernel, stride, padding, groups=groups, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        if isinstance(x, Pair):
            x = x.cast
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
    """BatchNorm through K1: ``weight``/``bias`` and ``running_mean``/``running_var``.

    It registers no ``num_batches_tracked``, so the JAX package's
    ``export_state_dict`` output loads with ``strict=True``. Called as a
    module it is BN alone, no ReLU, in ``bn_dtype`` (the downsample path);
    :func:`bn_epilogue` runs it fused with the residual add and ReLU. Both
    go through K1. In eval mode it folds the running statistics; in train
    mode the batch's (module docstring). ``momentum`` is flax's: ``running
    = momentum * running + (1 - momentum) * batch``. ``sync_group``: the
    process group SyncBN averages over (None: this process's batch alone).
    ``zero_scale`` starts ``weight`` at zero (a block's last BN under
    zero-init-residual).
    """

    def __init__(self, channels: int, *, bn_dtype=torch.float32, eps: float = 1e-5,
                 momentum: float = 0.9, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.bn_dtype = bn_dtype
        self.eps = eps
        self.momentum = momentum
        self.zero_scale = zero_scale
        self.sync_group = None

    def batch_stats(self, x):
        """f32 ``(mean, var)`` of ``x`` over all but the channel axis, as
        flax's ``_compute_stats``: ``var = max(0, E[x^2] - E[x]^2)``, with
        ``[E[x], E[x^2]]`` averaged over ``sync_group`` when it is set."""
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        xf = x.float()
        stats = torch.stack([xf.mean(dims), xf.square().mean(dims)])
        if self.sync_group is not None:
            from torch.distributed.nn.functional import all_reduce

            stats = all_reduce(stats, group=self.sync_group) / dist.get_world_size(self.sync_group)
        mean, mean2 = stats
        return mean, torch.clamp_min(mean2 - mean * mean, 0.0)

    def affine(self, x=None):
        """``(mean, mul, bias)`` in flax's order: rsqrt first, then the scale
        multiply (the association changes bits). Eval mode: the running
        statistics. Train mode: the statistics of ``x``, and the running
        ones updated in place, except in a remat unit's recompute
        (:func:`recomputing`), which updated them in its forward already.
        Under SyncBN the recompute all-reduces the statistics again: every
        rank recomputes its units in the same order (the backward's), so
        the collectives pair up as in the forward."""
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return self.running_mean, mul, self.bias
        mean, var = self.batch_stats(x)
        if not recomputing():
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return mean, torch.rsqrt(var + self.eps) * self.weight, self.bias

    def forward(self, x, identity=None, *, relu: bool = False, cast_to=None,
                keep_boundary: bool = True):
        """BN (-> + ``identity`` -> ReLU) through K1, in the modes of
        :func:`bn_epilogue`; called bare, BN alone in the BN dtype."""
        out = fused_conv_epilogue(x, *self.affine(x), identity, relu=relu, bn_dtype=self.bn_dtype,
                                  cast_to=cast_to, keep_boundary=keep_boundary)
        return Pair(*out) if isinstance(out, tuple) else out


def bn_epilogue(x, bn: BatchNorm, identity=None, *, relu: bool = True, cast_to=None,
                keep_boundary: bool = True):
    """BN -> (+``identity``) -> ReLU through K1. With ``cast_to`` the result
    comes in that dtype too: as a :class:`Pair` when ``keep_boundary``, else
    the cast tensor alone. A call of the module ``bn``, so its hooks see it
    (the int8 path's calibration, ``quant/ptq.py``)."""
    return bn(x, identity, relu=relu, cast_to=cast_to, keep_boundary=keep_boundary)


def boundary(x):
    """The BN-dtype form of a block input (its identity)."""
    return x.boundary if isinstance(x, Pair) else x


def max_pool(x):
    """The stem's 3x3/2 max-pool (implicit -inf padding) on each form of a
    :class:`Pair`: rounding is monotone, so the pooled bf16 equals the
    pooled f32 rounded to bf16."""
    if isinstance(x, Pair):
        return Pair(*(F.max_pool2d(t, 3, 2, 1) for t in x))
    return F.max_pool2d(x, 3, 2, 1)


def to_conv(dtype, boundaries: bool = False) -> dict:
    """The K1 mode of a BN that only convs read: the compute dtype alone, or
    with ``boundaries`` the BN boundary alone (:func:`link_handoffs`)."""
    return {} if boundaries else dict(cast_to=dtype, keep_boundary=False)


def link_handoffs(blocks, dtype, *, boundaries: bool = False) -> dict:
    """Set each block's ``handoff``, the K1 mode of its last BN, from what
    reads its output: the next block's convs read ``dtype``; the next
    block's identity (when it has no projection shortcut) and, after the
    last block, the f32 head read the BN boundary; and each block's
    ``to_conv``, the mode of its BNs that only convs read. Returns the
    stem's. With ``boundaries`` every one writes the BN boundary alone: the
    int8 path's convs quantize the BN dtype's value, as JAX's do
    (``quant/ptq.py``), and a conv casts it itself on the fp path, to the
    same bits K1's cast writes."""
    for block, nxt in zip(blocks, [*blocks[1:], None]):
        block.to_conv = to_conv(dtype, boundaries)
        block.handoff = ({} if nxt is None or boundaries
                         else dict(cast_to=dtype, keep_boundary=not nxt.projects))
    return {} if boundaries else dict(cast_to=dtype, keep_boundary=not blocks[0].projects)


def link_boundaries(model: nn.Module, enabled: bool = True) -> None:
    """``model.link_handoffs(boundaries=enabled)``: with ``enabled`` every K1
    of ``model`` writes the BN boundary alone. The fp forward's output is
    bitwise unchanged. A model without ``link_handoffs`` keeps its modes."""
    if hasattr(model, "link_handoffs"):
        model.link_handoffs(boundaries=enabled)


@contextlib.contextmanager
def boundary_handoffs(model: nn.Module):
    """:func:`link_boundaries` inside the context, then back."""
    link_boundaries(model, True)
    try:
        yield model
    finally:
        link_boundaries(model, False)


def classifier_head(x, fc: nn.Linear):
    """Global average pool over H and W in float32, then ``fc`` (a float32
    linear, or the int8 path's quantized one)."""
    return fc(x.float().mean(dim=(2, 3)))


def bn_silu(x, bn: BatchNorm):
    """BN without ReLU through K1 (the BN dtype), then SiLU: EfficientNet's
    ``nn.silu(bn(x))``. K1 has no SiLU mode, as the JAX kernel has none."""
    return F.silu(bn(x))


class SqueezeExcite(nn.Module):
    """The SE gate (``layers.SqueezeExcite``): an f32 mean over H and W cast
    back to the input's dtype, a 1x1 reduce conv with bias, ``act``, a 1x1
    expand conv with bias (both in the compute dtype), then ``x *
    sigmoid(s)`` in the promoted dtype (f32 where the gated tensor is the
    f32 BN boundary). ``names``: the two convs' names (timm's
    ``conv_reduce``/``conv_expand`` in EfficientNet, ``fc1``/``fc2`` in
    RegNet). The 1x1 convs on a 1x1 map run as linears over ``[N, C]``;
    their weights keep the conv shape ``[out, in, 1, 1]``."""

    def __init__(self, channels: int, se_dim: int, act, *, dtype,
                 names=("conv_reduce", "conv_expand")):
        super().__init__()
        self.names = names
        self.add_module(names[0], nn.Conv2d(channels, se_dim, 1))
        self.add_module(names[1], nn.Conv2d(se_dim, channels, 1))
        self.act = act
        self.compute_dtype = dtype

    def _linear(self, s, conv: nn.Conv2d):
        dt = self.compute_dtype
        return F.linear(s.to(dt), conv.weight.flatten(1).to(dt), conv.bias.to(dt))

    def forward(self, x):
        reduce, expand = (self._modules[n] for n in self.names)
        s = x.mean((2, 3), dtype=torch.float32).to(x.dtype)
        s = self._linear(self.act(self._linear(s, reduce)), expand)
        return x * torch.sigmoid(s)[:, :, None, None]

    def init_params(self, generator: torch.Generator) -> None:
        """flax ``nn.Conv``'s defaults: ``lecun_normal`` kernels (a normal
        cut at +-2 std, rescaled to std ``sqrt(1 / fan_in)``, as the variance
        scaling initialisers do) and zero biases."""
        for conv in self.children():
            trunc_normal_(conv.weight, 1.0 / math.sqrt(conv.in_channels) / _TRUNC_STD, generator)
            conv.bias.zero_()


class RandomMask(nn.Module):
    """A layer that draws a mask in training from ``generator``, which the
    trainer sets before every forward (``TrainState.masks``); it raises
    without one rather than draw from a global stream. ``rate`` is the
    share dropped; the kept values are scaled by ``1 / (1 - rate)`` in the
    input's dtype, as flax's ``jnp.where(mask, h / keep, 0)``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    @property
    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def mask_shape(self, x) -> tuple:
        raise NotImplementedError

    def forward(self, x):
        if not self.active:
            return x
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}(rate={self.rate}) in training needs a "
                               f"generator: set one with layers.set_generator")
        keep = 1.0 - self.rate
        mask = torch.rand(self.mask_shape(x), device=x.device, generator=self.generator) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class DropPath(RandomMask):
    """Stochastic depth: one draw a sample (EfficientNet's MBConv)."""

    def mask_shape(self, x) -> tuple:
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class Dropout(RandomMask):
    """Dropout: one draw an element (flax ``nn.Dropout``)."""

    def mask_shape(self, x) -> tuple:
        return tuple(x.shape)


def set_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Hand ``generator`` to every :class:`RandomMask` of ``model``."""
    for m in model.modules():
        if isinstance(m, RandomMask):
            m.generator = generator


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside a remat unit's recompute (the backward
    runs it, on autograd's thread for the device)."""
    return getattr(_RECOMPUTE, "depth", 0) > 0


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode BNs inside the context normalize with their batch
    statistics and leave the running ones as they are, as in a remat unit's
    recompute: the QAT distillation's teacher forward, whose statistics the
    JAX trainer throws away."""
    _RECOMPUTE.depth = getattr(_RECOMPUTE, "depth", 0) + 1
    try:
        yield
    finally:
        _RECOMPUTE.depth -= 1


class _Replay:
    """The two contexts of one checkpointed call (``checkpoint``'s
    ``context_fn``): the forward's records the state of every generator the
    unit's active masks draw from; the recompute's marks the thread as
    recomputing and sets those generators back to that state, then restores
    what they held. ``checkpoint``'s own ``preserve_rng_state`` covers only
    the default CPU and CUDA generators."""

    def __init__(self, unit: nn.Module):
        gens = {id(m.generator): m.generator for m in unit.modules()
                if isinstance(m, RandomMask) and m.active and m.generator is not None}
        self.gens = list(gens.values())
        self.states: list = []

    @contextlib.contextmanager
    def forward(self):
        self.states = [g.get_state() for g in self.gens]
        yield

    @contextlib.contextmanager
    def recompute(self):
        held = [g.get_state() for g in self.gens]
        for g, s in zip(self.gens, self.states):
            g.set_state(s)
        _RECOMPUTE.depth = getattr(_RECOMPUTE, "depth", 0) + 1
        try:
            yield
        finally:
            _RECOMPUTE.depth -= 1
            for g, s in zip(self.gens, held):
                g.set_state(s)

    def contexts(self):
        return self.forward(), self.recompute()


class RematUnit(nn.Module):
    """A block the JAX package wraps in ``nn.remat`` under ``MODEL.REMAT``.
    With ``remat`` set (:func:`set_remat`) and gradients enabled, a call
    runs through ``torch.utils.checkpoint`` (non-reentrant): the module's
    forward, hooks included, is run again in the backward. Its arguments
    and result may be tensors or :class:`Pair` tuples."""

    remat = False

    def __call__(self, *args):
        if not (self.remat and torch.is_grad_enabled()):
            return super().__call__(*args)
        return checkpoint(super().__call__, *args, use_reentrant=False,
                          context_fn=_Replay(self).contexts)


def set_remat(model: nn.Module, enabled: bool) -> nn.Module:
    """Switch every :class:`RematUnit` of ``model`` to recompute (``enabled``)
    or not. A model with no such unit cannot be checkpointed: enabling
    raises. Returns ``model``."""
    units = [m for m in model.modules() if isinstance(m, RematUnit)]
    if enabled and not units:
        raise ValueError(f"MODEL.REMAT: {type(model).__name__} has no block to recompute")
    for u in units:
        u.remat = bool(enabled)
    return model


# std of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax's ``truncated_normal(std)``: N(0, std) cut at +-2 std, so the
    result's own std is ``0.8796 * std``. (torch's ``trunc_normal_`` takes
    its bounds in absolute units: they are passed here.)"""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``xavier_uniform`` on a ``[out, in]`` weight: U(+-sqrt(6 /
    (fan_in + fan_out)))."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    return t.uniform_(-bound, bound, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX zoo's initialisers, drawn from ``generator`` in module order:
    convs kaiming-normal fan-out ``N(0, 2 / (out * kh * kw))``, linears
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` with a zero bias, BN scale one
    (zero under ``zero_scale``) and bias zero, running statistics zero and
    one, BoTNet's position tables ``N(0, dim_head^-0.5)`` (a module's
    ``init_tables``). A module with ``init_params`` draws its whole subtree
    itself (the SE gate's ``lecun_normal`` convs, ViT's initialisers).
    Returns ``model``."""
    with torch.no_grad():
        _init(model, generator)
    return model


def _init(m: nn.Module, generator: torch.Generator) -> None:
    if hasattr(m, "init_params"):
        m.init_params(generator)
        return
    if isinstance(m, nn.Conv2d):
        fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
        m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
    elif isinstance(m, nn.Linear):
        bound = 1.0 / math.sqrt(m.in_features)
        m.weight.uniform_(-bound, bound, generator=generator)
        m.bias.zero_()
    elif isinstance(m, BatchNorm):
        m.weight.fill_(0.0 if m.zero_scale else 1.0)
        m.bias.zero_()
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
    elif hasattr(m, "init_tables"):
        m.init_tables(generator)
    for child in m.children():
        _init(child, generator)
