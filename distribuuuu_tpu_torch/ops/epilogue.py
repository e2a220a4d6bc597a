"""Fused conv epilogue: BN-apply -> cast -> (+residual) -> ReLU in one pass.

The port's counterpart of ``distribuuuu_tpu/ops/epilogue.py``. On a CUDA
tensor, :func:`fused_conv_epilogue` launches the hand-written Hopper kernel
in ``csrc/epilogue.cu`` (it replaces the Pallas ``_epilogue_kernel``); on a
CPU tensor it computes :func:`epilogue_reference`, the plain PyTorch
version. There is no other route: a CUDA tensor the kernel does not take
raises, and nothing falls back.

Layout: ``x`` is a conv output, NCHW-logical and stored channels-last (or a
2-D ``[R, C]`` tensor), so C is the contiguous axis and the kernel reads a
dense ``[R, C]`` view without a copy. The wrapper checks that and raises
otherwise; it never calls ``.contiguous()``.

Forward only: serving needs no backward. The training slice adds an
``autograd.Function`` around it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Launches of the CUDA kernel since the last reset. chip_smoke.py zeroes it
# before driving the serving path and reads it after, to show the path went
# through the kernel.
LAUNCHES = 0
_count_lock = threading.Lock()

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def epilogue_reference(x, mean, mul, bias, identity=None, *, relu=True, bn_dtype):
    """The epilogue as separate eager ops, term for term as
    ``distribuuuu_tpu.ops.epilogue.oracle_epilogue``: subtract, multiply,
    add (all in f32 by promotion against the f32 vectors), cast to
    ``bn_dtype``, add the residual in the promoted dtype, ReLU."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = x - mean.view(shape)
    y = y * mul.view(shape)
    y = y + bias.view(shape)
    y = y.to(bn_dtype)
    if identity is not None:
        y = y + identity
    if relu:
        y = torch.relu(y)
    return y


def _dense_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` (4-D or 2-D) is a dense ``[R, C]`` block with C contiguous."""
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    return t.is_contiguous()


def _check(x, mean, mul, bias, identity, bn_dtype) -> None:
    if x.dim() not in (2, 4):
        raise ValueError(f"x must be 4-D NCHW or 2-D [R, C], got {tuple(x.shape)}")
    if x.dtype not in _DT_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if bn_dtype not in _DT_CODE:
        raise TypeError(f"bn_dtype must be torch.float32 or torch.bfloat16, got {bn_dtype}")
    c = x.shape[1]
    for name, v in (("mean", mean), ("mul", mul), ("bias", bias)):
        if v.dtype != torch.float32 or v.shape != (c,) or v.device != x.device:
            raise ValueError(
                f"{name} must be float32 [{c}] on {x.device}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}"
            )
    if identity is not None:
        if identity.shape != x.shape or identity.device != x.device:
            raise ValueError(
                f"identity {tuple(identity.shape)} on {identity.device} does not "
                f"match x {tuple(x.shape)} on {x.device}"
            )
        if identity.dtype not in _DT_CODE:
            raise TypeError(f"identity must be float32 or bfloat16, got {identity.dtype}")


def fused_conv_epilogue(x, mean, mul, bias, identity=None, *, relu=True, bn_dtype):
    """BN-apply -> (+residual) -> ReLU over a conv output.

    ``mean``, ``mul = rsqrt(var + eps) * scale`` and ``bias`` are the
    per-channel f32 affine the BN folds to; ``identity`` is the optional
    residual. The output dtype is ``bn_dtype``, or its promotion with the
    residual's dtype. A CPU tensor gets :func:`epilogue_reference`; a CUDA
    tensor launches the kernel.
    """
    _check(x, mean, mul, bias, identity, bn_dtype)
    if x.device.type == "cpu":
        return epilogue_reference(x, mean, mul, bias, identity, relu=relu, bn_dtype=bn_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_epilogue runs on cuda or cpu tensors, got {x.device}")
    for name, t in (("x", x), ("identity", identity)):
        if t is not None and not _dense_rows(t):
            raise ValueError(
                f"{name} must be channels-last contiguous for the CUDA kernel "
                f"(shape {tuple(t.shape)}, strides {t.stride()})"
            )
    for name, v in (("mean", mean), ("mul", mul), ("bias", bias)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    out_dtype = bn_dtype if identity is None else torch.promote_types(bn_dtype, identity.dtype)
    memory_format = torch.channels_last if x.dim() == 4 else torch.contiguous_format
    out = torch.empty_like(x, dtype=out_dtype, memory_format=memory_format)
    n = x.numel()
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dtpu_epilogue_launch(
            x.data_ptr(), _DT_CODE[x.dtype],
            mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
            None if identity is None else identity.data_ptr(),
            -1 if identity is None else _DT_CODE[identity.dtype],
            out.data_ptr(), _DT_CODE[bn_dtype], n, x.shape[1], int(bool(relu)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"epilogue kernel launch failed: cudaError {err}")
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out


def _library() -> ctypes.CDLL:
    from distribuuuu_tpu_torch.ops import _build

    lib, _ = _build.load("epilogue")
    fn = lib.dtpu_epilogue_launch
    if fn.argtypes is None:  # without them ctypes passes pointers as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, p, i, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return lib
