"""Fused conv epilogue: BN-apply -> cast -> (+residual) -> ReLU in one pass.

The port's counterpart of ``distribuuuu_tpu/ops/epilogue.py``. On a CUDA
tensor, :func:`fused_conv_epilogue` launches the hand-written Hopper kernel
in ``csrc/epilogue.cu`` (it replaces the Pallas ``_epilogue_kernel``); on a
CPU tensor it computes :func:`epilogue_reference`, the plain PyTorch
version. There is no other route: a CUDA tensor the kernel does not take
raises, and nothing falls back.

Three modes, by ``cast_to`` and ``keep_boundary``:

- (a) ``cast_to=None``: one output in the BN dtype (promoted with the
  residual's), the boundary a residual or the head reads;
- (b) ``cast_to=dt, keep_boundary=False``: one output in ``dt``, bitwise
  ``epilogue_reference(...).to(dt)``: the next conv's input when only convs
  read the result;
- (c) ``cast_to=dt, keep_boundary=True``: both, ``(boundary, cast)``, from
  one pass.

Where ``dt`` is already the output dtype (an f32 model, or bf16 BN), one
tensor serves both roles: (b) returns it and (c) returns it twice.

Layout: ``x`` is a conv output, NCHW-logical and stored channels-last (or a
2-D ``[R, C]`` tensor), so C is the contiguous axis and the kernel reads a
dense ``[R, C]`` view without a copy. The wrapper checks that and raises
otherwise; it never calls ``.contiguous()``. The kernel's vector route takes
C % 8 == 0 and 16-byte-aligned tensors; anything else dense goes to its
scalar route.

Forward only: serving needs no backward. The training slice adds an
``autograd.Function`` around it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Launches of the CUDA kernel since the last reset (both routes), and of its
# scalar route alone. chip_smoke.py zeroes them before driving the serving
# path and reads them after, to show the path went through the kernel.
LAUNCHES = 0
SCALAR_LAUNCHES = 0
_count_lock = threading.Lock()

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def epilogue_reference(x, mean, mul, bias, identity=None, *, relu=True, bn_dtype,
                       cast_to=None, keep_boundary=True):
    """The epilogue as separate eager ops, term for term as
    ``distribuuuu_tpu.ops.epilogue.oracle_epilogue``: subtract, multiply,
    add (all in f32 by promotion against the f32 vectors), cast to
    ``bn_dtype``, add the residual in the promoted dtype, ReLU; then, in
    modes (b) and (c), the cast to ``cast_to``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = x - mean.view(shape)
    y = y * mul.view(shape)
    y = y + bias.view(shape)
    y = y.to(bn_dtype)
    if identity is not None:
        y = y + identity
    if relu:
        y = torch.relu(y)
    if cast_to is None:
        return y
    cast = y.to(cast_to)
    return (y, cast) if keep_boundary else cast


def _dense_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` (4-D or 2-D) is a dense ``[R, C]`` block with C contiguous."""
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    return t.is_contiguous()


def _check(x, mean, mul, bias, identity, bn_dtype, cast_to) -> None:
    if x.dim() not in (2, 4):
        raise ValueError(f"x must be 4-D NCHW or 2-D [R, C], got {tuple(x.shape)}")
    if x.dtype not in _DT_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if bn_dtype not in _DT_CODE:
        raise TypeError(f"bn_dtype must be torch.float32 or torch.bfloat16, got {bn_dtype}")
    if cast_to is not None and cast_to not in _DT_CODE:
        raise TypeError(f"cast_to must be None, torch.float32 or torch.bfloat16, got {cast_to}")
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


def fused_conv_epilogue(x, mean, mul, bias, identity=None, *, relu=True, bn_dtype,
                        cast_to=None, keep_boundary=True):
    """BN-apply -> (+residual) -> ReLU over a conv output, in mode (a), (b)
    or (c) (module docstring).

    ``mean``, ``mul = rsqrt(var + eps) * scale`` and ``bias`` are the
    per-channel f32 affine the BN folds to; ``identity`` is the optional
    residual. The boundary's dtype is ``bn_dtype``, or its promotion with
    the residual's dtype. A CPU tensor gets :func:`epilogue_reference`; a
    CUDA tensor launches the kernel.
    """
    _check(x, mean, mul, bias, identity, bn_dtype, cast_to)
    kw = dict(relu=relu, bn_dtype=bn_dtype, cast_to=cast_to, keep_boundary=keep_boundary)
    if x.device.type == "cpu":
        return epilogue_reference(x, mean, mul, bias, identity, **kw)
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
    cast_dtype = None if cast_to == out_dtype else cast_to  # a second output, if any
    memory_format = torch.channels_last if x.dim() == 4 else torch.contiguous_format
    out = (torch.empty_like(x, dtype=out_dtype, memory_format=memory_format)
           if cast_dtype is None or keep_boundary else None)
    cast = (None if cast_dtype is None
            else torch.empty_like(x, dtype=cast_dtype, memory_format=memory_format))
    c = x.shape[1]
    if x.numel():
        tensors = [t for t in (x, mean, mul, bias, identity, out, cast) if t is not None]
        vec = c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.dtpu_epilogue_launch(
                x.data_ptr(), _DT_CODE[x.dtype],
                mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
                None if identity is None else identity.data_ptr(),
                -1 if identity is None else _DT_CODE[identity.dtype],
                None if out is None else out.data_ptr(),
                None if cast is None else cast.data_ptr(),
                -1 if cast is None else _DT_CODE[cast_dtype],
                _DT_CODE[bn_dtype], x.numel() // c, c, int(bool(relu)), int(vec),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"epilogue kernel launch failed: cudaError {err}")
        global LAUNCHES, SCALAR_LAUNCHES
        with _count_lock:
            LAUNCHES += 1
            SCALAR_LAUNCHES += not vec
    if cast_to is None:
        return out
    if cast is None:  # cast_to is the output dtype: one tensor in both roles
        return (out, out) if keep_boundary else out
    return (out, cast) if keep_boundary else cast


def _library() -> ctypes.CDLL:
    from distribuuuu_tpu_torch.ops import _build

    lib, _ = _build.load("epilogue")
    fn = lib.dtpu_epilogue_launch
    if fn.argtypes is None:  # without them ctypes passes pointers as 32-bit ints
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, p, p, i, i, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
