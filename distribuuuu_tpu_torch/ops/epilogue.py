"""Fused conv epilogue: BN-apply -> cast -> (+residual) -> ReLU in one pass.

The port's counterpart of ``distribuuuu_tpu/ops/epilogue.py``. On a CUDA
tensor, :func:`fused_conv_epilogue` launches the hand-written Hopper kernel
in ``csrc/epilogue.cu`` (it replaces the Pallas ``_epilogue_kernel``); on a
CPU tensor it computes :func:`epilogue_reference`, the plain PyTorch
version (so does a meta tensor, which has shapes only: the step's FLOP
count, ``obs/flops.py``, runs on it and launches nothing). There is no other route: a CUDA tensor the kernel does not take
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

The int32 input mode (the int8 path, ``quant/ptq.py``): ``x`` may be a
quantized conv's int32 accumulator, which K1 reads directly. With ``mean``
0, ``mul`` the per-channel dequant scale and ``bias`` the folded BN's shift,
``(x - 0) * mul + bias`` is JAX's dequant ``acc.astype(f32) * scale +
bias`` term for term (int32 -> f32 rounds to nearest in both), then the
cast to the BN dtype, the residual and the ReLU as in every mode. Such a
call has no gradient.

Layout: ``x`` is a conv output, NCHW-logical and stored channels-last (or a
2-D ``[R, C]`` tensor), so C is the contiguous axis and the kernel reads a
dense ``[R, C]`` view without a copy. The wrapper checks that and raises
otherwise; it never calls ``.contiguous()``. The kernel's vector route takes
C % 8 == 0 and 16-byte-aligned tensors; anything else dense goes to its
scalar route.

Training: when an input needs a gradient on a CUDA tensor, the call is a
``torch.autograd.Function`` whose backward is a kernel too, K1-bwd in the
same file (:func:`fused_conv_epilogue_backward`; it stands in for the XLA
recompute in the JAX ``custom_vjp``). It recomputes the pre-ReLU value from
the saved ``x``, residual and affine, writes ``d_x`` and ``d_identity`` and
sums ``d_mean``, ``d_mul``, ``d_bias`` per channel in a fixed order. On a
CPU tensor the call is :func:`epilogue_reference` and autograd runs through
its ops; :func:`epilogue_backward_reference` is that, the backward's plain
version. Nothing needs a gradient (serving): a plain call, as before.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Launches of the CUDA kernel since the last reset (both routes), and of its
# scalar route alone, and of its int32 input mode alone. chip_smoke.py zeroes
# them before driving the serving path and reads them after, to show the path
# went through the kernel.
LAUNCHES = 0
SCALAR_LAUNCHES = 0
INT32_LAUNCHES = 0
# the same for the backward kernel, K1-bwd
BWD_LAUNCHES = 0
BWD_SCALAR_LAUNCHES = 0
_count_lock = threading.Lock()

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_X_DT_CODE = {**_DT_CODE, torch.int32: 2}  # x alone may be an int32 accumulator


def epilogue_reference(x, mean, mul, bias, identity=None, *, relu=True, bn_dtype,
                       cast_to=None, keep_boundary=True):
    """The epilogue as separate eager ops, term for term as
    ``distribuuuu_tpu.ops.epilogue.oracle_epilogue``: subtract, multiply,
    add (all in f32 by promotion against the f32 vectors; an int32 ``x``
    is converted to f32 by the subtraction), cast to ``bn_dtype``, add the
    residual in the promoted dtype, ReLU; then, in modes (b) and (c), the
    cast to ``cast_to``."""
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


def epilogue_backward_reference(x, mean, mul, bias, identity, g_out, g_cast=None, *, relu=True,
                                bn_dtype, cast_to=None, keep_boundary=True):
    """K1's backward as autograd through :func:`epilogue_reference`:
    ``(d_x, d_mean, d_mul, d_bias, d_identity)`` (``d_identity`` None
    without a residual). ``g_out`` is the gradient of the boundary (modes a
    and c), ``g_cast`` that of the cast output (modes b and c); either may
    be None in mode c."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_()
               for t in (x, mean, mul, bias, identity)]
        out = epilogue_reference(*ins, relu=relu, bn_dtype=bn_dtype, cast_to=cast_to,
                                 keep_boundary=keep_boundary)
        if cast_to is None:
            pairs = [(out, g_out)]
        elif not keep_boundary:
            pairs = [(out, g_cast)]
        else:
            pairs = [(out[0], g_out), (out[1], g_cast)]
        pairs = [(o, g) for o, g in pairs if g is not None]
        leaves = [t for t in ins if t is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return (*grads[:4], grads[4] if identity is not None else None)


def _dense_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` (4-D or 2-D) is a dense ``[R, C]`` block with C contiguous."""
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    return t.is_contiguous()


def _check(x, mean, mul, bias, identity, bn_dtype, cast_to) -> None:
    if x.dim() not in (2, 4):
        raise ValueError(f"x must be 4-D NCHW or 2-D [R, C], got {tuple(x.shape)}")
    if x.dtype not in _X_DT_CODE:
        raise TypeError(f"x must be float32, bfloat16 or an int32 accumulator, got {x.dtype}")
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
    CUDA tensor launches the kernel, inside an autograd Function whose
    backward is K1-bwd when an input needs a gradient.
    """
    _check(x, mean, mul, bias, identity, bn_dtype, cast_to)
    if x.device.type in ("cpu", "meta"):
        return epilogue_reference(x, mean, mul, bias, identity, relu=relu, bn_dtype=bn_dtype,
                                  cast_to=cast_to, keep_boundary=keep_boundary)
    _check_cuda(x, mean, mul, bias, identity)
    out_dtype = _out_dtype(bn_dtype, identity)
    cast_dtype = None if cast_to == out_dtype else cast_to  # a second output, if any
    kw = dict(relu=bool(relu), bn_dtype=bn_dtype, cast_to=cast_dtype,
              keep_boundary=keep_boundary or cast_dtype is None)
    ins = (x, mean, mul, bias, identity)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ins):
        if x.dtype not in _DT_CODE:
            raise TypeError("K1's int32 input mode has no backward: call it without gradients")
        res = _Epilogue.apply(*ins, kw)
    else:
        res = _epilogue_cuda(*ins, **kw)
    if cast_to is not None and cast_dtype is None:  # one tensor in both roles
        return (res, res) if keep_boundary else res
    return res


def fused_conv_epilogue_backward(x, mean, mul, bias, identity, g_out, g_cast=None, *, relu=True,
                                 bn_dtype, cast_to=None, keep_boundary=True,
                                 need_identity=True):
    """K1's backward: ``(d_x, d_mean, d_mul, d_bias, d_identity)`` for the
    forward call with these arguments, from the gradient ``g_out`` of its
    boundary and ``g_cast`` of its cast output (either may be None in mode
    c; mode b passes ``g_cast``; two gradients add as autograd adds them,
    also where the two outputs are one tensor). ``d_identity``
    is None without a residual or without ``need_identity``. A CPU tensor
    gets :func:`epilogue_backward_reference`; a CUDA tensor launches K1-bwd.
    """
    _check(x, mean, mul, bias, identity, bn_dtype, cast_to)
    if x.dtype not in _DT_CODE:
        raise TypeError(f"K1's backward takes a float32 or bfloat16 x, got {x.dtype}")
    kw = dict(relu=relu, bn_dtype=bn_dtype, cast_to=cast_to, keep_boundary=keep_boundary)
    if x.device.type in ("cpu", "meta"):
        out = epilogue_backward_reference(x, mean, mul, bias, identity, g_out, g_cast, **kw)
        return out if need_identity else (*out[:4], None)
    _check_cuda(x, mean, mul, bias, identity)
    if cast_to is None:
        g_cast = None
    return _epilogue_bwd_cuda(x, mean, mul, bias, identity, g_out, g_cast, relu=bool(relu),
                              bn_dtype=bn_dtype, cast_to=cast_to,
                              need_identity=need_identity and identity is not None)


def _out_dtype(bn_dtype, identity):
    return bn_dtype if identity is None else torch.promote_types(bn_dtype, identity.dtype)


def _check_cuda(x, mean, mul, bias, identity) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_epilogue runs on cuda, cpu or meta tensors, got {x.device}")
    for name, t in (("x", x), ("identity", identity)):
        if t is not None and not _dense_rows(t):
            raise ValueError(
                f"{name} must be channels-last contiguous for the CUDA kernel "
                f"(shape {tuple(t.shape)}, strides {t.stride()})"
            )
    for name, v in (("mean", mean), ("mul", mul), ("bias", bias)):
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _epilogue_cuda(x, mean, mul, bias, identity, *, relu, bn_dtype, cast_to, keep_boundary):
    """K1 on checked CUDA tensors; ``cast_to`` is None or a dtype other than
    the boundary's. Returns the boundary, the cast, or ``(boundary, cast)``."""
    out_dtype = _out_dtype(bn_dtype, identity)
    memory_format = torch.channels_last if x.dim() == 4 else torch.contiguous_format
    out = (torch.empty_like(x, dtype=out_dtype, memory_format=memory_format)
           if cast_to is None or keep_boundary else None)
    cast = (None if cast_to is None
            else torch.empty_like(x, dtype=cast_to, memory_format=memory_format))
    c = x.shape[1]
    if x.numel():
        tensors = [t for t in (x, mean, mul, bias, identity, out, cast) if t is not None]
        vec = c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.dtpu_epilogue_launch(
                x.data_ptr(), _X_DT_CODE[x.dtype],
                mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
                None if identity is None else identity.data_ptr(),
                -1 if identity is None else _DT_CODE[identity.dtype],
                None if out is None else out.data_ptr(),
                None if cast is None else cast.data_ptr(),
                -1 if cast is None else _DT_CODE[cast_to],
                _DT_CODE[bn_dtype], x.numel() // c, c, int(relu), int(vec),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"epilogue kernel launch failed: cudaError {err}")
        global LAUNCHES, SCALAR_LAUNCHES, INT32_LAUNCHES
        with _count_lock:
            LAUNCHES += 1
            SCALAR_LAUNCHES += not vec
            INT32_LAUNCHES += x.dtype == torch.int32
    if cast is None:
        return out
    return (out, cast) if keep_boundary else cast


# K1-bwd's grid (csrc/epilogue.cu, dtpu_epilogue_bwd_launch): a block of 256
# threads covers up to 32 8-channel groups, the rest of its threads are row
# lanes; two blocks resident an SM, two waves of them, each thread at least 4 rows
_BWD_THREADS = 256
_BWD_GROUPS_PER_BLOCK = 32
_sms: dict[int, int] = {}


def _bwd_grid(rows: int, c: int, device) -> tuple[int, int]:
    """(8-channel groups per block, row blocks) of K1-bwd for ``[rows, c]``."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    groups = -(-c // 8)
    gpb = min(groups, _BWD_GROUPS_PER_BLOCK)
    lanes = _BWD_THREADS // gpb
    tiles = -(-groups // gpb)
    blocks = min(-(-rows // (4 * lanes)), max(1, 4 * _sms[device.index] // tiles))
    return gpb, max(1, blocks)


def _dense(g, like):
    """``g`` as a dense ``[R, C]`` block in ``like``'s layout (autograd may
    hand K1-bwd a gradient in another layout, such as the head's)."""
    if g is None or _dense_rows(g):
        return g
    return g.contiguous(memory_format=torch.channels_last if like.dim() == 4
                        else torch.contiguous_format)


def _epilogue_bwd_cuda(x, mean, mul, bias, identity, g_out, g_cast, *, relu, bn_dtype, cast_to,
                       need_identity):
    """K1-bwd on checked CUDA tensors: ``(d_x, d_mean, d_mul, d_bias,
    d_identity or None)``; ``cast_to`` is ``g_cast``'s dtype (the kernel
    rounds ``g_cast`` to the boundary's dtype and adds it to ``g_out``)."""
    out_dtype = _out_dtype(bn_dtype, identity)
    g_out, g_cast = _dense(g_out, x), _dense(g_cast, x)
    for name, g, dt in (("g_out", g_out, out_dtype), ("g_cast", g_cast, cast_to)):
        if g is not None and (g.shape != x.shape or g.dtype != dt or g.device != x.device):
            raise ValueError(f"{name} must be {dt} {tuple(x.shape)} on {x.device}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
    memory_format = torch.channels_last if x.dim() == 4 else torch.contiguous_format
    d_x = torch.empty_like(x, memory_format=memory_format)
    d_res = torch.empty_like(identity, memory_format=memory_format) if need_identity else None
    c = x.shape[1]
    rows = x.numel() // c
    d_stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
    if (g_out is None and g_cast is None) or not x.numel():
        d_stats.zero_()
        return d_x.zero_(), *d_stats, None if d_res is None else d_res.zero_()
    gpb, blocks = _bwd_grid(rows, c, x.device)
    partials = torch.empty(blocks * 3 * c, dtype=torch.float32, device=x.device)
    tensors = [t for t in (x, mean, mul, bias, identity, g_out, g_cast, d_x, d_res)
               if t is not None]
    vec = c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.dtpu_epilogue_bwd_launch(
            x.data_ptr(), _DT_CODE[x.dtype], mean.data_ptr(), mul.data_ptr(),
            bias.data_ptr(), None if identity is None else identity.data_ptr(),
            -1 if identity is None else _DT_CODE[identity.dtype], int(identity is not None),
            None if g_out is None else g_out.data_ptr(), _DT_CODE[out_dtype],
            None if g_cast is None else g_cast.data_ptr(),
            -1 if g_cast is None else _DT_CODE[cast_to], _DT_CODE[bn_dtype], int(relu),
            d_x.data_ptr(), None if d_res is None else d_res.data_ptr(),
            partials.data_ptr(), d_stats.data_ptr(), rows, c, gpb, blocks, int(vec),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"epilogue backward kernel launch failed: cudaError {err}")
    global BWD_LAUNCHES, BWD_SCALAR_LAUNCHES
    with _count_lock:
        BWD_LAUNCHES += 1
        BWD_SCALAR_LAUNCHES += not vec
    return d_x, *d_stats, d_res


class _Epilogue(torch.autograd.Function):
    """K1 forward, K1-bwd backward (CUDA tensors only). ``kw`` as
    :func:`_epilogue_cuda` takes it."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias, identity, kw):
        ctx.set_materialize_grads(False)
        ctx.kw = kw
        ctx.save_for_backward(x, mean, mul, bias, identity)
        return _epilogue_cuda(x, mean, mul, bias, identity, **kw)

    @staticmethod
    def backward(ctx, *grads):
        x, mean, mul, bias, identity = ctx.saved_tensors
        kw = ctx.kw
        if kw["cast_to"] is None:
            g_out, g_cast = grads[0], None
        elif not kw["keep_boundary"]:
            g_out, g_cast = None, grads[0]
        else:
            g_out, g_cast = grads
        if g_out is None and g_cast is None:
            return (None,) * 6
        need = ctx.needs_input_grad
        d = _epilogue_bwd_cuda(x, mean, mul, bias, identity, g_out, g_cast, relu=kw["relu"],
                               bn_dtype=kw["bn_dtype"], cast_to=kw["cast_to"],
                               need_identity=identity is not None and need[4])
        return (*(t if n else None for t, n in zip(d, need[:5])), None)


def _library() -> ctypes.CDLL:
    from distribuuuu_tpu_torch.ops import _build

    lib, _ = _build.load("epilogue")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in ((lib.dtpu_epilogue_launch, [p, i, p, p, p, p, i, p, p, i, i, ll, i, i, i, p]),
                     (lib.dtpu_epilogue_bwd_launch,
                      [p, i, p, p, p, p, i, i, p, i, p, i, i, i, p, p, p, p, ll, i, i, i, i, p])):
        if fn.argtypes is None:  # without them ctypes passes pointers as 32-bit ints
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib
