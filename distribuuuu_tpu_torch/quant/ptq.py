"""Post-training int8 quantization of the port's zoo (counterpart of
``distribuuuu_tpu/quant/ptq.py``).

The same recipe and, from the same weights, the same numbers as JAX's:
per-output-channel symmetric int8 weights, per-tensor activation scales
from a calibration pass, each BatchNorm that consumes a conv's output
directly folded into that conv's dequant (after a numeric check that the
fold changes nothing), and int8 x int8 -> int32 products.

Where JAX intercepts every ``nn.Conv``/``nn.Dense`` call, the port uses
module hooks and module swaps:

1. **Calibration** (:func:`calibrate`). Forward pre-hooks on every
   ``nn.Conv2d`` and ``nn.Linear`` record the amax of the input, and forward
   hooks the output's identity; a pre-hook on every ``layers.BatchNorm``
   marks it foldable when its input is a site's output. The zoo's BNs run
   through K1 as module calls (``layers.bn_epilogue``) and the head calls
   its ``fc`` (``layers.classifier_head``), so the hooks see every site and
   BN. The model runs under ``layers.boundary_handoffs``: every K1 writes
   the BN boundary, the value JAX's conv receives and quantizes (not K1's
   bf16 cast of it), and the fp output is bitwise unchanged.
2. **Quantization** (:func:`quantize`): numpy, term for term as JAX's.
3. **The int8 forward** (:meth:`Int8Model.apply`, or the module that
   :func:`prune_variables` leaves). Each site becomes a :class:`QuantConv2d`
   or :class:`QuantLinear`, each folded BN a :class:`FoldedBatchNorm`. A
   folded site returns its int32 accumulator and the BN's K1 dequantizes it
   in its int32 input mode (``ops/epilogue.py``) with mean 0, the site's
   scale and the folded bias, then adds the residual and applies the ReLU,
   as JAX's dequant, cast and the block's own add and ReLU do. An unfolded
   site dequantizes in eager ops, in its own output dtype, as JAX does.

The int8 products (:func:`int8_conv2d`, :func:`int8_linear`): on the CPU
(and on the meta device) the plain version, a float64 conv or matmul of the
int8 values, exact below 2^53; on the card an int8 im2col and
``torch._int_mm`` (cuBLASLt's int8 GEMM with int32 accumulation), K padded
to a multiple of 8 and M to 17 rows or more with zeros (exact). Both are
exact integer arithmetic, so they are equal. The card's route takes
ungrouped convs; a grouped one (ResNeXt) raises there.

Models: the site table equals JAX's for those whose BNs can hand their
boundaries to the convs (``link_handoffs``) and whose every conv and linear
is a module call: the ResNet family and DenseNet (:func:`supported`). The
serving engine refuses the others (BoTNet's attention projections,
EfficientNet's and RegNetY's SE convs are functional calls the hooks do not
see, ROADMAP item 8c).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.models import layers


@dataclass
class _BNFold:
    """A BatchNorm directly consuming a quantized site's output."""

    path: str
    epsilon: float


@dataclass
class CalibrationSite:
    """One quantizable conv/linear call site discovered during calibration.
    ``path`` is the module's name in the model; ``in_dtype`` the dtype of
    the value it quantizes (the BN boundary's, under the calibration's
    handoffs)."""

    kind: str  # 'conv' | 'dense'
    path: str
    amax: float
    out_dtype: torch.dtype = torch.float32
    # the site's own output dtype, never overwritten by a foldable BN's
    raw_out_dtype: torch.dtype = torch.float32
    in_dtype: torch.dtype = torch.float32
    # conv statics: (kh, kw), (sh, sw), [(lo, hi), (lo, hi)]
    kernel: tuple | None = None
    strides: tuple | None = None
    padding: list | None = None
    groups: int = 1
    bn: _BNFold | None = None


def _conv_site(path: str, module: nn.Conv2d, amax: float) -> CalibrationSite | None:
    """The site of a conv whose config is representable, else None."""
    if (module.padding_mode != "zeros" or isinstance(module.padding, str)
            or any(int(d) != 1 for d in module.dilation)):
        return None
    return CalibrationSite(kind="conv", path=path, amax=amax, kernel=tuple(module.kernel_size),
                           strides=tuple(module.stride),
                           padding=[(int(p), int(p)) for p in module.padding],
                           groups=int(module.groups))


def supported(model: nn.Module) -> bool:
    """Whether the port's int8 path quantizes ``model`` as JAX's does."""
    return hasattr(model, "link_handoffs")


def _site_input(x):
    """The value a site quantizes: a :class:`layers.Pair`'s BN-dtype form."""
    return x.boundary if isinstance(x, layers.Pair) else x


def _amax(x: torch.Tensor) -> float:
    return float(x.detach().float().abs().max()) if x.numel() else 0.0


def _is_site(m: nn.Module) -> bool:
    return isinstance(m, (nn.Conv2d, nn.Linear))


@contextlib.contextmanager
def _hooks(model: nn.Module, *, site_pre=None, site_post=None, bn_pre=None):
    """Hooks on every site (before and after) and every BatchNorm (before)."""
    handles = []
    for m in model.modules():
        if _is_site(m):
            if site_pre is not None:
                handles.append(m.register_forward_pre_hook(site_pre))
            if site_post is not None:
                handles.append(m.register_forward_hook(site_post))
        elif isinstance(m, layers.BatchNorm) and bn_pre is not None:
            handles.append(m.register_forward_pre_hook(bn_pre))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _swap(model: nn.Module, modules: dict[str, nn.Module]) -> dict[str, nn.Module]:
    """Put each ``modules[name]`` in ``model`` at ``name``; returns what was there."""
    old = {}
    for name, new in modules.items():
        parent, _, leaf = name.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        old[name] = owner.get_submodule(leaf)
        setattr(owner, leaf, new)
    return old


@contextlib.contextmanager
def _swapped(model: nn.Module, modules: dict[str, nn.Module]):
    old = _swap(model, modules)
    try:
        yield model
    finally:
        _swap(model, old)


def calibrate(
    model: nn.Module,
    batches: Iterable[torch.Tensor],
    *,
    apply_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> dict[str, CalibrationSite]:
    """Run calibration batches through the fp model (eval mode); return the
    site table, keyed by module name.

    ``apply_fn`` overrides the default ``model(x)`` when the serve path
    wraps the forward (on-device normalization before the model). The
    structure pass on the first batch compares object identity between a
    site's output and a BatchNorm's input, as JAX's does, and ends with
    :func:`_verify_folds` on that batch.
    """
    if apply_fn is None:
        apply_fn = model
    names = {id(m): n for n, m in model.named_modules()}
    sites: dict[str, CalibrationSite] = {}
    first_batch = None
    with layers.boundary_handoffs(model), torch.no_grad():
        for batch_index, batch in enumerate(batches):
            first = batch_index == 0
            if first:
                first_batch = batch
            produced: dict[int, str] = {}  # id(site output) -> site key
            hold: list = []  # keep outputs alive so ids can't be recycled mid-pass

            def site_pre(mod, args, first=first):
                key, x = names[id(mod)], _site_input(args[0])
                amax = _amax(x)
                site = sites.get(key)
                if site is None and first:
                    site = (_conv_site(key, mod, amax) if isinstance(mod, nn.Conv2d)
                            else CalibrationSite(kind="dense", path=key, amax=amax))
                    if site is not None:
                        site.in_dtype = x.dtype
                        sites[key] = site
                elif site is not None:
                    site.amax = max(site.amax, amax)

            def site_post(mod, args, out, first=first, produced=produced, hold=hold):
                site = sites.get(names[id(mod)])
                if site is not None and first:
                    site.out_dtype = site.raw_out_dtype = out.dtype
                    produced[id(out)] = site.path
                    hold.append(out)

            def bn_pre(mod, args, first=first, produced=produced):
                if not first or mod.training:
                    return
                src = produced.get(id(args[0]))
                if src is not None and sites[src].bn is None:
                    # this BN consumes the site's output directly: foldable. The
                    # site's boundary dtype becomes the BN's (the folded path
                    # must emit what downstream saw before).
                    sites[src].bn = _BNFold(path=names[id(mod)], epsilon=float(mod.eps))
                    sites[src].out_dtype = mod.bn_dtype

            with _hooks(model, site_pre=site_pre, site_post=site_post, bn_pre=bn_pre):
                apply_fn(batch)
        if first_batch is not None:
            _verify_folds(model, first_batch, sites, apply_fn, names)
    return sites


def _bn_affine(model: nn.Module, fold: _BNFold) -> tuple[np.ndarray, np.ndarray]:
    """The folded BN's ``gamma / sqrt(var + eps)`` and shift, numpy f32 as JAX's."""
    bn = model.get_submodule(fold.path)
    p = {k: getattr(bn, k).detach().float().cpu().numpy()
         for k in ("weight", "bias", "running_mean", "running_var")}
    gfac = p["weight"] / np.sqrt(p["running_var"] + fold.epsilon)
    return gfac, p["bias"] - p["running_mean"] * gfac


def _channel_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (like.dim() - 2))


def _verify_folds(model, batch, sites, apply_fn, names) -> None:
    """Reject folds whose site output has a consumer the hooks can't see.

    One fp forward with the fold applied in fp (the BN's affine on the
    site's output, the BN itself an identity affine through K1, which still
    adds the residual and applies the ReLU) must reproduce the plain fp
    forward; any divergence unfolds every BN (they stay fp ops)."""
    folded = {key: s for key, s in sites.items() if s.bn is not None}
    if not folded:
        return

    affines = {key: _bn_affine(model, s.bn) for key, s in folded.items()}

    def fold_post(mod, args, out):
        key = names[id(mod)]
        if key not in folded:
            return None
        gfac, shift = (_channel_view(torch.from_numpy(a).to(out.device), out)
                       for a in affines[key])
        return (out.float() * gfac + shift).to(folded[key].out_dtype)

    identities = {}
    for site in folded.values():
        bn = model.get_submodule(site.bn.path)
        one = torch.ones_like(bn.running_var)
        identities[site.bn.path] = FoldedBatchNorm(one, torch.zeros_like(one), bn.bn_dtype)
    with _swapped(model, identities), _hooks(model, site_post=fold_post):
        fold_out = apply_fn(batch).float()
    plain_out = apply_fn(batch).float()
    diff = float((fold_out - plain_out).abs().max())
    scale = float(plain_out.abs().max())
    if diff > 1e-2 * max(scale, 1.0):
        logger.warning(
            f"quant: BN folding rejected — the fold transformation changes "
            f"the fp output (max|Δ| {diff:.3e} vs activation scale "
            f"{scale:.3e}), so some branch consumes a pre-BN conv output "
            f"the module hook cannot see. The {len(folded)} adjacent BN(s) "
            f"stay fp ops; quantization proceeds without folding"
        )
        for site in folded.values():
            site.bn = None
            site.out_dtype = site.raw_out_dtype


def quantize_weight(w) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: ``(w_q int8, scale f32 [out])``.

    The output channel is axis 0, as in a torch conv weight (OIHW) and a
    linear's ``[out, in]`` (JAX's takes the trailing axis of HWIO and
    ``[in, out]``: the same numbers, transposed). All-zero channels get
    scale 1."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    axes = tuple(range(1, w.ndim))
    scale = np.max(np.abs(w), axis=axes) / 127.0
    scale = np.where(scale > 0.0, scale, 1.0).astype(np.float32)
    w_q = np.clip(np.rint(w / scale.reshape((-1,) + (1,) * (w.ndim - 1))), -127, 127)
    return w_q.astype(np.int8), scale


def quantize(model: nn.Module, sites: dict[str, CalibrationSite]) -> tuple["Int8Model", dict]:
    """Quantize the calibrated sites: ``(Int8Model, qparams)``.

    Per site: per-channel symmetric int8 weights; the per-tensor activation
    scale folded into the per-channel dequant scale; a foldable BatchNorm's
    γ/√(var+ε) multiplied in and its shift landed in the bias. ``qparams``
    maps site key → ``{w_q, scale, bias, act_scale}`` tensors on the
    weights' device (``w_q`` in the torch weight's layout)."""
    qparams: dict[str, dict[str, torch.Tensor]] = {}
    folded = set()
    for key, site in sites.items():
        mod = model.get_submodule(key)
        w_q, w_scale = quantize_weight(mod.weight)
        out = w_scale.shape[0]
        bias = (mod.bias.detach().float().cpu().numpy() if mod.bias is not None
                else np.zeros(out, np.float32))
        scale = w_scale
        if site.bn is not None:
            gfac, shift = _bn_affine(model, site.bn)
            bias = bias * gfac + shift
            scale = scale * gfac
            folded.add(site.bn.path)
        act_scale = np.float32(max(site.amax, 1e-8) / 127.0)
        dev = mod.weight.device
        qparams[key] = {
            "w_q": torch.from_numpy(w_q).to(dev),
            "scale": torch.from_numpy(np.asarray(scale * act_scale, np.float32)).to(dev),
            "bias": torch.from_numpy(np.asarray(bias, np.float32)).to(dev),
            "act_scale": torch.tensor(act_scale, dtype=torch.float32, device=dev),
        }
    return Int8Model(sites=dict(sites), folded=frozenset(folded)), qparams


# ---- the int8 forward --------------------------------------------------------


def quantize_activation(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """JAX's ``clip(round(x / act_scale), -127, 127).astype(int8)`` (round
    half to even), in ``x``'s memory layout."""
    return torch.clamp(torch.round(x.float() / act_scale), -127, 127).to(torch.int8)


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, out_dtype):
    """An unfolded site's ``(acc.astype(f32) * scale + bias).astype(out_dtype)``."""
    y = acc.float() * _channel_view(scale, acc) + _channel_view(bias, acc)
    return y.to(out_dtype)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """A site's int8 weight as the GEMM's ``[O8, K8]`` (rows: output
    channels; a conv's columns in (kh, kw, in) order, the im2col's), both
    padded with zeros to multiples of 8."""
    o = w_q.shape[0]
    mat = w_q.permute(0, 2, 3, 1).reshape(o, -1) if w_q.dim() == 4 else w_q
    k = mat.shape[1]
    return F.pad(mat, (0, _ceil8(k) - k, 0, _ceil8(o) - o)).contiguous()


def _int_mm(cols: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """``cols [M, K8] @ w_mat[O8, K8].T`` in int32 on the card, M padded to
    17 rows or more (``torch._int_mm`` takes M > 16)."""
    m = cols.shape[0]
    if m <= 16:
        cols = F.pad(cols, (0, 0, 0, 17 - m))
    return torch._int_mm(cols, w_mat.t())[:m]


def _check_int8(xq, w_mat, route: str) -> None:
    if xq.dtype != torch.int8 or w_mat.dtype != torch.int8:
        raise TypeError(f"{route} takes int8 tensors, got {xq.dtype} and {w_mat.dtype}")
    if xq.device != w_mat.device:
        raise ValueError(f"{route}: activation on {xq.device}, weights on {w_mat.device}")
    if xq.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"{route} runs on cuda, cpu or meta tensors, got {xq.device}")


def int8_conv2d_reference(xq, w_mat, out_channels: int, kernel, stride, padding,
                          groups: int = 1):
    """:func:`int8_conv2d`'s plain version, on any device: the float64 conv
    of the int8 values, exact while every sum stays below 2^53."""
    _check_int8(xq, w_mat, "int8_conv2d_reference")
    (kh, kw), c = kernel, xq.shape[1]
    wt = w_mat[:out_channels, :kh * kw * (c // groups)].reshape(out_channels, kh, kw, c // groups)
    acc = F.conv2d(xq.double(), wt.permute(0, 3, 1, 2).double(), None, tuple(stride),
                   tuple(padding), 1, groups)
    return acc.to(torch.int32).contiguous(memory_format=torch.channels_last)


def int8_linear_reference(xq, w_mat, out_features: int):
    """:func:`int8_linear`'s plain version, on any device: the float64
    matmul of the int8 values (exact)."""
    _check_int8(xq, w_mat, "int8_linear_reference")
    return (xq.double() @ w_mat[:out_features, :xq.shape[1]].double().t()).to(torch.int32)


def int8_conv2d(xq, w_mat, out_channels: int, kernel, stride, padding, groups: int = 1):
    """The int32 accumulator ``[N, O, Ho, Wo]`` (channels-last) of the conv of
    int8 ``xq`` (NCHW) with the int8 weight ``w_mat`` (:func:`int8_matrix`),
    symmetric zero ``padding`` ``(ph, pw)``. CPU and meta: the plain version
    (:func:`int8_conv2d_reference`); card: the im2col and ``torch._int_mm``,
    ungrouped convs only."""
    _check_int8(xq, w_mat, "int8_conv2d")
    if xq.device.type != "cuda":
        return int8_conv2d_reference(xq, w_mat, out_channels, kernel, stride, padding, groups)
    if groups != 1:
        raise NotImplementedError(f"int8_conv2d on the card takes ungrouped convs, got groups "
                                  f"{groups}")
    return _int8_conv2d_gemm(xq, w_mat, out_channels, kernel, stride, padding)


def _int8_conv2d_gemm(xq, w_mat, out_channels: int, kernel, stride, padding):
    """The card's route of :func:`int8_conv2d`: the int8 im2col in (kh, kw,
    in) order, written once into the K-padded matrix (a 1x1 conv without
    padding reads the activation as it lies), then ``torch._int_mm``."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    n, c, h, w = xq.shape
    k = kh * kw * c
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    m, k8 = n * ho * wo, w_mat.shape[1]
    x = xq.permute(0, 2, 3, 1)  # NHWC: a view of a channels-last tensor
    if kh == kw == 1 and ph == pw == 0 and k8 == k:
        cols = x[:, ::sh, ::sw].reshape(m, k)
    else:
        patches = F.pad(x, (0, 0, pw, pw, ph, ph)).unfold(1, kh, sh).unfold(2, kw, sw)
        cols = (xq.new_zeros((m, k8)) if k8 != k else xq.new_empty((m, k8)))
        cols[:, :k].view(n, ho, wo, kh, kw, c).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    acc = _int_mm(cols, w_mat)
    if acc.shape[1] != out_channels:
        acc = acc[:, :out_channels].contiguous()
    return acc.view(n, ho, wo, out_channels).permute(0, 3, 1, 2)


def int8_linear(xq, w_mat, out_features: int):
    """The int32 accumulator ``[N, O]`` of int8 ``xq [N, in]`` times the
    int8 weight ``w_mat`` (:func:`int8_matrix`). CPU and meta: the plain
    version (:func:`int8_linear_reference`); card: ``torch._int_mm``."""
    _check_int8(xq, w_mat, "int8_linear")
    if xq.device.type != "cuda":
        return int8_linear_reference(xq, w_mat, out_features)
    k, k8 = xq.shape[1], w_mat.shape[1]
    cols = F.pad(xq, (0, k8 - k)) if k8 != k else xq.contiguous()
    return _int_mm(cols, w_mat)[:, :out_features]


class _Int8Site(nn.Module):
    """A quantized site's tensors: the GEMM's int8 weight (:func:`int8_matrix`),
    the per-channel dequant ``scale`` and ``bias`` and the activation scale.
    A ``folded`` site returns its int32 accumulator (the
    :class:`FoldedBatchNorm` after it dequantizes it in K1); any other
    dequantizes in eager ops, in the site's output dtype."""

    def __init__(self, site: CalibrationSite, q: dict):
        super().__init__()
        self.register_buffer("w_mat", int8_matrix(q["w_q"]))
        for name in ("scale", "bias", "act_scale"):
            self.register_buffer(name, q[name])
        self.out_channels = int(q["w_q"].shape[0])
        self.folded = site.bn is not None
        self.out_dtype = site.out_dtype

    def finish(self, acc):
        return acc if self.folded else dequantize(acc, self.scale, self.bias, self.out_dtype)


class QuantConv2d(_Int8Site):
    """A quantized conv site: quantize the input (its BN-dtype value), the
    int8 conv with int32 accumulation, then :meth:`_Int8Site.finish`."""

    def __init__(self, site: CalibrationSite, q: dict):
        super().__init__(site, q)
        self.kernel, self.stride, self.groups = site.kernel, site.strides, site.groups
        self.padding = tuple(lo for lo, _ in site.padding)

    def forward(self, x):
        xq = quantize_activation(_site_input(x), self.act_scale)
        return self.finish(int8_conv2d(xq, self.w_mat, self.out_channels, self.kernel,
                                       self.stride, self.padding, self.groups))


class QuantLinear(_Int8Site):
    """A quantized linear site (the head's ``fc``): quantize, the int8
    product with int32 accumulation, then :meth:`_Int8Site.finish`."""

    def forward(self, x):
        xq = quantize_activation(_site_input(x), self.act_scale)
        return self.finish(int8_linear(xq, self.w_mat, self.out_channels))


class FoldedBatchNorm(nn.Module):
    """A BN folded into the dequant of the site before it: K1 (a
    ``layers.BatchNorm``'s forward, every mode) with mean 0, ``mul`` the
    site's per-channel dequant scale and ``bias`` the folded shift, reading
    the site's int32 accumulator. With ``mul`` 1 and ``bias`` 0 it is the
    identity BN of the fold check."""

    def __init__(self, mul: torch.Tensor, bias: torch.Tensor, bn_dtype):
        super().__init__()
        self.register_buffer("mean", torch.zeros_like(mul))
        self.register_buffer("mul", mul)
        self.register_buffer("bias", bias)
        self.bn_dtype = bn_dtype

    def affine(self, x=None):
        return self.mean, self.mul, self.bias

    forward = layers.BatchNorm.forward


@dataclass
class Int8Model:
    """The static half of a quantized model: the site table and the folded
    BN set. The tensors live in ``qparams`` (:func:`quantize`)."""

    sites: dict[str, CalibrationSite]
    folded: frozenset = field(default_factory=frozenset)

    @property
    def n_quantized(self) -> int:
        return len(self.sites)

    def int8_modules(self, model: nn.Module, qparams: dict) -> dict[str, nn.Module]:
        """The int8 forward's modules by name: each site's
        :class:`QuantConv2d`/:class:`QuantLinear`, each folded BN's
        :class:`FoldedBatchNorm`."""
        out: dict[str, nn.Module] = {}
        for key, site in self.sites.items():
            q = qparams[key]
            out[key] = (QuantConv2d if site.kind == "conv" else QuantLinear)(site, q)
            if site.bn is not None:
                bn = model.get_submodule(site.bn.path)
                out[site.bn.path] = FoldedBatchNorm(q["scale"], q["bias"], bn.bn_dtype)
        return out

    def apply(self, model: nn.Module, qparams: dict, x: torch.Tensor, *,
              apply_fn: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
        """The int8 forward of ``model`` (left as it was): its sites and
        folded BNs swapped for the int8 modules for this call."""
        if apply_fn is None:
            apply_fn = model
        with (layers.boundary_handoffs(model),
              _swapped(model, self.int8_modules(model, qparams)), torch.no_grad()):
            return apply_fn(x)


def prune_variables(model: nn.Module, qmodel: Int8Model, qparams: dict) -> nn.Module:
    """Make ``model`` the int8 model for good and free what its forward no
    longer reads (JAX's ``prune_variables``): every site and folded BN is
    replaced by its int8 module, so their fp weights and statistics go;
    everything else (unfolded BNs) stays. Every K1 writes the BN boundary
    from then on. Returns ``model``."""
    layers.link_boundaries(model, True)
    _swap(model, qmodel.int8_modules(model, qparams))
    return model
