"""Quantization-aware training: int8/fp8 fake-quant with a straight-through
estimator (counterpart of ``distribuuuu_tpu/quant/qat.py``).

The rescue path of the int8 serving gate: a short fine-tune whose forward
runs every conv and linear on the serving grid, so the weights move to a
quantization-robust minimum, after which ``quant/ptq.py`` hosts the model
unchanged. The arithmetic is JAX's, term for term:

- **Fake-quant values** (:func:`quantize_values`): int8 is
  ``clip(round(x / scale), -127, 127) * scale`` (round half to even); fp8
  a clip at +-448 and a round trip through ``torch.float8_e4m3fn``.
  Activations per tensor on the scale calibration recorded (``amax / 127``
  or ``amax / 448``); weights per output channel on their live amax, axis 0
  of the OIHW conv and ``[out, in]`` linear weights (JAX's trailing axis of
  HWIO and ``[in, out]``), with no gradient through the scale and scale 1
  for an all-zero channel.
- **Straight-through estimator** (:func:`_ste`): ``x + (q - x).detach()``.
- **Interception** (:meth:`QATModel.intercept`): where JAX's interceptor
  replaces each calibrated ``nn.Conv``/``nn.Dense`` call, each site module
  of the port (the same site table ``ptq.calibrate`` builds) gets its
  ``forward`` overridden on the instance for the context: the fake-quantized
  input times the fake-quantized float32 master weight, in float32, plus the
  bias, cast to the site's own output dtype (JAX's ``raw_out_dtype``). The
  modules and their parameters stay where they are, so a ``TrainState``'s
  flat-buffer views keep working. The BNs stay live module calls through K1
  (and their backward through K1-bwd), under ``layers.boundary_handoffs``:
  every K1 writes the BN boundary alone, the value JAX's conv quantizes.
  TF32 (cuDNN's and cuBLAS's) is off inside the context (and in its
  backward), as JAX pins ``preferred_element_type=float32``: a TF32 product
  keeps 10 bits of each grid value ``k * scale``. The scales are divided by
  as 0-dim device tensors (:func:`_scalar`), as the serving quantizer's
  are, so a value lands on the same grid step in training and in serving.
  :func:`site_product_errors` holds each site's product against the int8
  accumulator of the serving path.

Models: the ResNet family and DenseNet (``ptq.supported``); the others
raise naming ROADMAP item 8c, as the serving engine does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models import layers
from distribuuuu_tpu_torch.quant.ptq import CalibrationSite, _site_input, calibrate, supported

QAT_MODES = ("int8", "fp8")

# symmetric grid maxima: int8's +-127 (PTQ's grid, zero-point free), fp8
# e4m3fn's +-448 finite range
_GRID_MAX = {"int8": 127.0, "fp8": 448.0}


def _check_mode(mode: str) -> str:
    if mode not in QAT_MODES:
        raise ValueError(f"QAT mode must be one of {QAT_MODES}, got {mode!r}")
    return mode


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device. A division
    by it is a true division on the card, as the serving quantizer's by its
    scale buffer is; a Python scalar there divides as a multiply by its
    reciprocal, which moves values on a rounding edge to the other grid
    step."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_values(x32: torch.Tensor, scale, mode: str) -> torch.Tensor:
    """``x32 / scale`` rounded onto the mode's grid, back in float32."""
    scale = _scalar(scale, x32)
    if mode == "int8":
        return torch.clamp(torch.round(x32 / scale), -127.0, 127.0) * scale
    q = torch.clamp(x32 / scale, -_GRID_MAX["fp8"], _GRID_MAX["fp8"])
    return q.to(torch.float8_e4m3fn).to(torch.float32) * scale


def _ste(x32: torch.Tensor, q32: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward ``q``, backward identity."""
    return x32 + (q32 - x32).detach()


def fake_quant_act(x: torch.Tensor, act_scale, mode: str) -> torch.Tensor:
    """Per-tensor fake-quant on the calibrated activation scale."""
    x32 = x.float()
    return _ste(x32, quantize_values(x32, act_scale, mode))


def fake_quant_weight(w: torch.Tensor, mode: str) -> torch.Tensor:
    """Per-output-channel (axis 0) fake-quant on the weight's live amax."""
    w32 = w.float()
    amax = w32.detach().abs().amax(dim=tuple(range(1, w32.dim())), keepdim=True)
    scale = torch.where(amax > 0.0, amax / _scalar(_GRID_MAX[mode], amax), torch.ones_like(amax))
    return _ste(w32, quantize_values(w32, scale, mode))


def _tf32() -> tuple[bool, bool]:
    """cuDNN's and cuBLAS's TF32 switches, in that order."""
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _set_tf32(conv: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = conv
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def _tf32_as(conv: bool, matmul: bool):
    prior = _tf32()
    _set_tf32(conv, matmul)
    try:
        yield
    finally:
        _set_tf32(*prior)


@dataclass
class QATModel:
    """The static half of a fake-quantized model: the site table (module
    name -> ``ptq.CalibrationSite``) and the mode."""

    sites: dict[str, CalibrationSite]
    mode: str = "int8"
    _bypassed: bool = field(default=False, repr=False)
    _outer_tf32: tuple[bool, bool] = field(default=(True, False), repr=False)

    @property
    def n_sites(self) -> int:
        return len(self.sites)

    def act_scale(self, site: CalibrationSite) -> float:
        return max(site.amax, 1e-8) / _GRID_MAX[self.mode]

    def _site_forward(self, site: CalibrationSite, mod: nn.Module, plain: Callable):
        scale, mode, on_device = self.act_scale(site), self.mode, {}

        def forward(x):
            if self._bypassed:
                return plain(x)
            x = _site_input(x)
            if x.device not in on_device:  # one fill a device, not one a call
                on_device[x.device] = _scalar(scale, x)
            xq = fake_quant_act(x, on_device[x.device], mode)
            w = fake_quant_weight(mod.weight, mode)
            if site.kind == "conv":
                acc = F.conv2d(xq, w, None, mod.stride, mod.padding, mod.dilation, mod.groups)
            else:
                acc = F.linear(xq, w)
            if mod.bias is not None:
                bias = mod.bias.float()
                acc = acc + (bias.view(1, -1, 1, 1) if acc.dim() == 4 else bias)
            return acc.to(site.raw_out_dtype)

        return forward

    @contextlib.contextmanager
    def intercept(self, model: nn.Module):
        """``model``'s forward (and backward) on the fake-quant grid inside
        the context; everything as it was after it."""
        mods = {key: model.get_submodule(key) for key in self.sites}
        self._outer_tf32 = _tf32()
        with layers.boundary_handoffs(model), _tf32_as(False, False):
            for key, mod in mods.items():
                plain = type(mod).forward.__get__(mod)
                mod.forward = self._site_forward(self.sites[key], mod, plain)
            try:
                yield model
            finally:
                for mod in mods.values():
                    del mod.forward

    @contextlib.contextmanager
    def bypass(self):
        """Inside :meth:`intercept`, the plain forward (the distillation's
        teacher), with the TF32 settings as they were outside."""
        self._bypassed = True
        try:
            with _tf32_as(*self._outer_tf32):
                yield
        finally:
            self._bypassed = False

    def apply(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """The fake-quant forward of ``model`` on NHWC ``x``, in the mode
        ``model`` is in (train mode updates the BN statistics over the
        fake-quant activations, as JAX's with ``mutable=["batch_stats"]``)."""
        with self.intercept(model):
            return model(x)


def check_supported(model: nn.Module, arch: str) -> None:
    """Raise for an arch the fake-quant interception does not cover."""
    if not supported(model):
        raise NotImplementedError(
            f"QUANT.QAT takes the ResNet family and DenseNet; {arch} is not ported to the "
            f"quantized path yet (ROADMAP Queue 1 item 8c)")


def calibrate_qat(model: nn.Module, batches: Iterable[torch.Tensor], *, mode: str = "int8",
                  arch: str = "") -> QATModel:
    """PTQ calibration -> a :class:`QATModel` on the same site table.

    The mode is checked first, then the arch. The calibration forwards run
    in eval mode (no statistics update, no dropout draw, no gradient) and
    ``model`` goes back to the mode it was in; its tensors are untouched.
    ``batches`` are NHWC float tensors on the model's device."""
    mode = _check_mode(mode)
    check_supported(model, arch or type(model).__name__)
    was_training = model.training
    model.eval()
    try:
        sites = calibrate(model, batches)
    finally:
        model.train(was_training)
    return QATModel(sites=dict(sites), mode=mode)


def site_product_errors(qat: QATModel, fp_model: nn.Module, int8_model: nn.Module,
                        inputs: dict[str, torch.Tensor]) -> dict[str, float]:
    """The fake-quant products against the serving path's, site by site.

    At each site, on ``inputs[site]`` (the value the int8 forward gave it):
    the fake-quant product (the site module of ``fp_model`` called inside
    :meth:`QATModel.intercept`, so with TF32 as the training forward has it)
    against the int8 accumulator (``int8_model``'s module, after
    ``ptq.prune_variables``) times the activation and weight scales, plus
    the bias. Returns, per site, the largest ``|difference| / sum|terms|``
    over its elements, ``sum|terms|`` being the int8 product of ``|x_q|``
    and ``|w_q|`` times the scales (plus ``|bias|``): float32 accumulation
    leaves a few units of 2**-24 of it, a TF32 product about 2**-11 of each
    term, a wrong scale its own error."""
    from distribuuuu_tpu_torch.quant import ptq

    worst = {}
    with torch.no_grad(), qat.intercept(fp_model):
        for key, site in qat.sites.items():
            mod, qmod, x = fp_model.get_submodule(key), int8_model.get_submodule(key), inputs[key]
            y = mod(x).float()
            xq = ptq.quantize_activation(x, qmod.act_scale)
            w_q, w_scale = ptq.quantize_weight(mod.weight)
            w_q = torch.from_numpy(w_q).to(x.device)
            view = (1, -1, 1, 1) if site.kind == "conv" else (1, -1)
            scales = (qmod.act_scale * torch.from_numpy(w_scale).to(x.device)).view(view)

            def product(a, w):
                m = ptq.int8_matrix(w)
                if site.kind == "conv":
                    return ptq.int8_conv2d(a, m, w.shape[0], qmod.kernel, qmod.stride,
                                           qmod.padding, qmod.groups)
                return ptq.int8_linear(a, m, w.shape[0])

            acc = product(xq, w_q).float() * scales
            terms = product(xq.abs(), w_q.abs()).float() * scales
            if mod.bias is not None:
                acc = acc + mod.bias.float().view(view)
                terms = terms + mod.bias.float().abs().view(view)
            worst[key] = float(((y - acc).abs() / terms.clamp_min(1e-30)).max())
    return worst
