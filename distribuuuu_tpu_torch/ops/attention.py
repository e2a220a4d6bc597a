"""Fused biased attention: ``softmax(q·kᵀ + bias)·v`` in one pass.

The port's counterpart of ``distribuuuu_tpu/ops/attention.py``, for
BoTNet's MHSA. On a CUDA tensor, :func:`fused_attention` (bias tensor) and
:func:`fused_attention_abs` (bias ``q·embᵀ`` formed in the kernel from the
shared ``[L, D]`` table) launch the hand-written Hopper kernel in
``csrc/attention.cu``, which replaces all four Pallas kernels (K2-K5: the
single-tile and blockwise variants of both modes): bf16 q/k/v on the
tensor cores, f32 on scalar FMAs. On a CPU tensor they compute
:func:`attention_reference` / :func:`attention_table_reference`, the plain
PyTorch versions, and so on a meta tensor (``obs/flops.py`` counts on it). There is no other route: a CUDA tensor the kernel does
not take raises, and nothing falls back. :func:`attention_blockwise_reference`
repeats the kernel's blockwise rounding in PyTorch, for the checks.

Layout as in the JAX package: ``[B, N, L, D]`` with q pre-scaled. The
kernel takes any strides of B, N and L as long as the last axis is
contiguous, so the head-split views of MHSA reach it without a copy. The
output is a contiguous ``[B, N, L, Dv]`` in q's dtype.

Gradients. Both entry points are differentiable: where grad mode is on and
an input needs a gradient each runs inside an ``autograd.Function`` (the
JAX ``custom_vjp`` of K2/K4, and of K3/K5) that saves ``(q, k, v, bias)``
or ``(q, k, v, emb)`` and whose backward is :func:`fused_attention_backward`
or :func:`fused_attention_abs_backward`. On a CUDA tensor these launch the
backward kernels of ``csrc/attention.cu`` by one of three routes, chosen
by the dtype and L alone (:func:`backward_route`): bf16 at L <= 256 the
one-pass cluster kernel (one launch: a thread-block cluster a head), bf16
above it the blockwise tensor-core kernels (three launches: the rows'
softmax statistics, a key-column pass for dk, dv and dbias that writes ds,
then dq from that ds), f32 the two-pass scalar kernels; the table mode then
sums ``demb`` over heads in two more launches. On a CPU tensor they compute
:func:`attention_backward_reference` / :func:`attention_table_backward_reference`.
Otherwise (serving) no Function node is made and nothing is saved.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Launches of the CUDA kernel since the last reset, per entry point (bias
# tensor: K2/K4; table: K3/K5). chip_smoke.py zeroes them before driving a
# path and reads them after, to show the path went through the kernel.
LAUNCHES = 0
TABLE_LAUNCHES = 0
# calls of the backward kernels, per entry point (bias tensor; table)
BWD_LAUNCHES = 0
TABLE_BWD_LAUNCHES = 0
# calls of the backward kernels per route (both entry points); a call launches
# ROUTE_LAUNCHES[route] CUDA kernels, and in table mode the two of the demb
# reduction besides
BWD_ROUTE_CALLS = {"cluster": 0, "blockwise": 0, "scalar": 0}
ROUTE_LAUNCHES = {"cluster": 1, "blockwise": 3, "scalar": 2}
_ROUTE_CODE = {"scalar": 0, "blockwise": 1, "cluster": 2}
_count_lock = threading.Lock()

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TABLE = -1
MAX_HEAD_DIM = 128  # the kernel's register and shared-memory tiles hold D, Dv <= 128
CLUSTER_MAX_L = 256  # the cluster route holds a head's keys in at most 4 CTAs of 64
_DEMB_CHUNK = 8  # heads the demb kernel's first pass sums a thread (csrc DEMB_CHUNK)
_cluster_ok: set = set()  # (bias dtype code, ceil(L / 64)) whose occupancy was checked


def attention_reference(q, k, v, bias):
    """``softmax(q·kᵀ + bias)·v`` term for term as ``xla_attention``:
    logits accumulated in f32 plus the bias in f32, softmax in f32, the
    weights cast to ``v.dtype``, the product accumulated in f32 and cast to
    ``q.dtype``."""
    logits = torch.einsum("bnxd,bnyd->bnxy", q.float(), k.float()) + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnxy,bnyd->bnxd", weights.float(), v.float()).to(q.dtype)


def attention_table_reference(q, k, v, emb):
    """:func:`attention_reference` with ``bias = q·embᵀ`` (f32) from the
    ``[L, D]`` table."""
    return attention_reference(q, k, v, torch.einsum("bnxd,yd->bnxy", q.float(), emb.float()))


def attention_blockwise_reference(q, k, v, bias_or_emb, *, table: bool, block: int = 64):
    """The blockwise plain version: K4/K5's online softmax over ``block``-key
    tiles, as the CUDA kernel computes it. Per tile the logits are ``q·kᵀ``
    (f32) plus the bias in f32, or plus ``q·embᵀ`` formed in f32 from the
    ``[L, D]`` table; ``p = exp(s − m)`` is summed into ``l`` unrounded and
    cast to ``v.dtype`` for ``p·v`` (f32 accumulate); the output is
    ``round(acc / l)`` in ``q.dtype``. For tests and ``chip_smoke.py``."""
    l = q.shape[-2]
    qf = q.float()
    m = torch.full((*q.shape[:-1], 1), float("-inf"), device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((*q.shape[:-1], v.shape[-1]), device=q.device)
    for k0 in range(0, l, block):
        keys = slice(k0, min(k0 + block, l))
        s = torch.einsum("bnxd,bnyd->bnxy", qf, k[..., keys, :].float())
        if table:
            s = s + torch.einsum("bnxd,yd->bnxy", qf, bias_or_emb[keys].float())
        else:
            s = s + bias_or_emb[..., keys].float()
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)  # first tile: exp(-inf) = 0
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bnxy,bnyd->bnxd", p.to(v.dtype).float(),
                                         v[..., keys, :].float())
        m = m_new
    return (acc / lsum).to(q.dtype)


def attention_backward_reference(q, k, v, bias, g):
    """``(dq, dk, dv, dbias)`` of :func:`attention_reference` for the output
    gradient ``g``, term for term as the JAX ``custom_vjp`` backward
    (``_bwd``): the logits recomputed in f32 (``q·kᵀ`` plus the bias), ``p``
    their f32 softmax (not rounded to ``v.dtype``), ``dp = g·vᵀ``, ``dv =
    pᵀ·g``, ``dsoft = p∘(dp − Σ_y dp∘p)``, ``dq = dsoft·k``, ``dk =
    dsoftᵀ·q`` and ``dbias = dsoft``, all in f32, each cast to its input's
    dtype."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    logits = torch.einsum("bnxd,bnyd->bnxy", qf, kf) + bias.float()
    p = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bnxd,bnyd->bnxy", gf, vf)
    dv = torch.einsum("bnxy,bnxd->bnyd", p, gf).to(v.dtype)
    dsoft = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bnxy,bnyd->bnxd", dsoft, kf).to(q.dtype)
    dk = torch.einsum("bnxy,bnxd->bnyd", dsoft, qf).to(k.dtype)
    return dq, dk, dv, dsoft.to(bias.dtype)


def attention_table_backward_reference(q, k, v, emb, g):
    """``(dq, dk, dv, demb)`` of :func:`attention_table_reference` for the
    output gradient ``g``, term for term as the JAX ``custom_vjp`` backward
    of the table mode (``_abs_bwd``): the logits ``q·kᵀ + q·embᵀ`` in f32,
    ``p``, ``dp``, ``dv`` and ``dsoft`` as :func:`attention_backward_reference`,
    ``dq = dsoft·k + dsoft·emb``, ``dk = dsoftᵀ·q`` and ``demb =
    Σ_{b,n} dsoftᵀ·q``, all in f32, each cast to its input's dtype."""
    qf, kf, vf, ef, gf = (t.float() for t in (q, k, v, emb, g))
    logits = torch.einsum("bnxd,bnyd->bnxy", qf, kf) + torch.einsum("bnxd,jd->bnxj", qf, ef)
    p = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bnxd,bnyd->bnxy", gf, vf)
    dv = torch.einsum("bnxy,bnxd->bnyd", p, gf).to(v.dtype)
    dsoft = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (torch.einsum("bnxy,bnyd->bnxd", dsoft, kf)
          + torch.einsum("bnxj,jd->bnxd", dsoft, ef)).to(q.dtype)
    dk = torch.einsum("bnxy,bnxd->bnyd", dsoft, qf).to(k.dtype)
    demb = torch.einsum("bnxj,bnxd->jd", dsoft, qf).to(emb.dtype)
    return dq, dk, dv, demb


def backward_route(dtype, l: int) -> str:
    """The backward's route on the card, by the dtype and L alone: bf16 at
    L <= CLUSTER_MAX_L ``"cluster"``, bf16 above it ``"blockwise"``, f32
    ``"scalar"``."""
    if dtype == torch.float32:
        return "scalar"
    return "cluster" if l <= CLUSTER_MAX_L else "blockwise"


def _check(q, k, v, last, *, table: bool) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, N, L, D], got {tuple(q.shape)}")
    b, n, l, d = q.shape
    if k.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} must match q {tuple(q.shape)}")
    if v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"v must be [{b}, {n}, {l}, Dv], got {tuple(v.shape)}")
    if q.dtype not in _DT_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if table:
        if last.shape != (l, d):
            raise ValueError(f"emb must be [L, D] = [{l}, {d}], got {tuple(last.shape)}")
        if last.dtype != q.dtype:
            raise TypeError(f"emb must be in q's dtype {q.dtype}, got {last.dtype}")
    else:
        if last.shape != (b, n, l, l):
            raise ValueError(f"bias must be [{b}, {n}, {l}, {l}], got {tuple(last.shape)}")
        if last.dtype not in _DT_CODE:
            raise TypeError(f"bias must be float32 or bfloat16, got {last.dtype}")
    for name, t in (("k", k), ("v", v), ("bias/emb", last)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def fused_attention(q, k, v, bias):
    """``softmax(q·kᵀ + bias)·v`` with a ``[B, N, L, L]`` bias (f32 or bf16);
    q pre-scaled. A CPU tensor gets :func:`attention_reference`; a CUDA
    tensor launches the kernel. Differentiable in all four inputs (module
    docstring)."""
    _check(q, k, v, bias, table=False)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _Attention.apply(q, k, v, bias)
    return _forward(q, k, v, bias)


def _forward(q, k, v, bias):
    if q.device.type in ("cpu", "meta"):
        return attention_reference(q, k, v, bias)
    return _launch(q, k, v, bias, table=False)


def fused_attention_backward(q, k, v, bias, g):
    """``(dq, dk, dv, dbias)`` of :func:`fused_attention` for the output
    gradient ``g`` (any strides with a contiguous last axis on the card).
    A CPU tensor gets :func:`attention_backward_reference`; a CUDA tensor
    launches the backward kernel of :func:`backward_route`. Each result is
    contiguous, in its input's dtype."""
    _check(q, k, v, bias, table=False)
    _check_g(q, v, g)
    if q.device.type in ("cpu", "meta"):
        return attention_backward_reference(q, k, v, bias, g)
    return _launch_backward(q, k, v, bias, g, table=False)


def fused_attention_abs_backward(q, k, v, emb, g):
    """``(dq, dk, dv, demb)`` of :func:`fused_attention_abs` for the output
    gradient ``g``. A CPU tensor gets :func:`attention_table_backward_reference`;
    a CUDA tensor launches the backward kernel of :func:`backward_route` in
    table mode, then the demb reduction over heads. Each result is
    contiguous, in its input's dtype."""
    _check(q, k, v, emb, table=True)
    _check_g(q, v, g)
    if q.device.type in ("cpu", "meta"):
        return attention_table_backward_reference(q, k, v, emb, g)
    return _launch_backward(q, k, v, emb, g, table=True)


def _check_g(q, v, g) -> None:
    if g.shape != v.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must be {q.dtype} {tuple(v.shape)} on {q.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")


class _Attention(torch.autograd.Function):
    """K2/K4 forward, their backward kernel (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        grads = fused_attention_backward(*ctx.saved_tensors, _last_axis_contiguous(g))
        return tuple(t if need else None for t, need in zip(grads, ctx.needs_input_grad))


class _AttentionAbs(torch.autograd.Function):
    """K3/K5 forward, their backward kernel (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, emb):
        ctx.save_for_backward(q, k, v, emb)
        return _forward_abs(q, k, v, emb)

    @staticmethod
    def backward(ctx, g):
        grads = fused_attention_abs_backward(*ctx.saved_tensors, _last_axis_contiguous(g))
        return tuple(t if need else None for t, need in zip(grads, ctx.needs_input_grad))


def _last_axis_contiguous(g):
    """The output gradient as the kernels read it: autograd may hand it over
    in any layout (from an NCHW loss through MHSA's head merge, its last
    axis is strided); one copy then, none otherwise."""
    return g if g.stride(-1) == 1 else g.contiguous()


def fused_attention_abs(q, k, v, emb):
    """``softmax(q·kᵀ + q·embᵀ)·v`` with the ``[L, D]`` table in q's dtype;
    the ``[B, N, L, L]`` bias is never formed in device memory. A CPU tensor
    gets :func:`attention_table_reference`; a CUDA tensor launches the
    kernel. Differentiable in all four inputs (module docstring)."""
    _check(q, k, v, emb, table=True)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, emb)):
        return _AttentionAbs.apply(q, k, v, emb)
    return _forward_abs(q, k, v, emb)


def _forward_abs(q, k, v, emb):
    if q.device.type in ("cpu", "meta"):
        return attention_table_reference(q, k, v, emb)
    return _launch(q, k, v, emb, table=True)


def _check_cuda(q, k, v, last, g=None) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"fused attention runs on cuda, cpu or meta tensors, got {q.device}")
    d, dv = q.shape[-1], v.shape[-1]
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes D, Dv <= {MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias/emb", last), ("g", g)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(
                f"{name} must have a contiguous last axis for the CUDA kernel "
                f"(shape {tuple(t.shape)}, strides {t.stride()})"
            )


def _launch(q, k, v, last, *, table: bool):
    _check_cuda(q, k, v, last)
    b, n, l, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((b, n, l, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if table:
        bias_args = (None, 0, 0, 0, _TABLE, last.data_ptr(), last.stride(0))
    else:
        bias_args = (last.data_ptr(), *last.stride()[:3], _DT_CODE[last.dtype], None, 0)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.dtpu_attention_launch(
            q.data_ptr(), *q.stride()[:3],
            k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3],
            *bias_args,
            out.data_ptr(), _DT_CODE[q.dtype], b, n, l, d, dv,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    global LAUNCHES, TABLE_LAUNCHES
    with _count_lock:
        if table:
            TABLE_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return out


def _launch_backward(q, k, v, last, g, *, table: bool):
    _check_cuda(q, k, v, last, g)
    b, n, l, d = q.shape
    dv = v.shape[-1]
    dq, dk, dvv, dlast = (torch.empty_like(t, memory_format=torch.contiguous_format)
                          for t in (q, k, v, last))
    if b * n * l == 0:  # nothing to compute; demb of no heads is 0
        return dq, dk, dvv, dlast.zero_()
    route = backward_route(q.dtype, l)
    bias_code = _TABLE if table else _DT_CODE[last.dtype]
    lib = _library()
    if route == "cluster":
        _check_cluster_occupancy(lib, bias_code, l, q.device)
    # f32 scratch, held until the launch is enqueued; none where the route takes none:
    # per query row the softmax max, its sum and delta = sum_y dp * p (blockwise and
    # scalar routes), each head's f32 dk and the demb reduction's first pass (table mode)
    shapes = (None if route == "cluster" else (3, b * n, l),
              (b * n, l, d) if table else None,
              (-(-b * n // _DEMB_CHUNK), l, d) if table else None)
    scratch = [None if sh is None else torch.empty(sh, dtype=torch.float32, device=q.device)
               for sh in shapes]
    # the blockwise route's bf16 ds, which its dq pass reads: dbias itself for a
    # bf16 bias, a scratch otherwise
    ds = None
    if route == "blockwise":
        ds = (dlast if not table and last.dtype == torch.bfloat16 else
              torch.empty((b * n, l, l), dtype=torch.bfloat16, device=q.device))
    scratch.insert(1, ds)
    if table:
        bias_args = (None, 0, 0, 0, _TABLE, last.data_ptr(), last.stride(0))
    else:
        bias_args = (last.data_ptr(), *last.stride()[:3], bias_code, None, 0)
    with torch.cuda.device(q.device):
        err = lib.dtpu_attention_backward_launch(
            q.data_ptr(), *q.stride()[:3],
            k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3],
            *bias_args,
            g.data_ptr(), *g.stride()[:3],
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), dlast.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch), _ROUTE_CODE[route],
            _DT_CODE[q.dtype], b, n, l, d, dv,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed ({route} route): "
                           f"cudaError {err}")
    global BWD_LAUNCHES, TABLE_BWD_LAUNCHES
    with _count_lock:
        if table:
            TABLE_BWD_LAUNCHES += 1
        else:
            BWD_LAUNCHES += 1
        BWD_ROUTE_CALLS[route] += 1
    return dq, dk, dvv, dlast


def _check_cluster_occupancy(lib, bias_code: int, l: int, device) -> None:
    """Before the first launch of a cluster shape: the card must hold at
    least one of its clusters (``cudaOccupancyMaxActiveClusters`` > 0)."""
    key = (bias_code, -(-l // 64))
    if key in _cluster_ok:
        return
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dtpu_attention_backward_cluster_occupancy(bias_code, l, ctypes.byref(clusters))
    if err != 0 or clusters.value <= 0:
        raise RuntimeError(
            f"the attention backward's cluster route cannot run on {torch.cuda.get_device_name(device)}"
            f" at L {l}: cudaError {err}, {clusters.value} resident clusters")
    _cluster_ok.add(key)


def _library() -> ctypes.CDLL:
    from distribuuuu_tpu_torch.ops import _build

    lib, _ = _build.load("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strided = [p, ll, ll, ll]
    for fn, args in (
            (lib.dtpu_attention_launch,
             strided * 3 + [p, ll, ll, ll, i, p, ll, p, i, i, i, i, i, i, p]),
            (lib.dtpu_attention_backward_launch,
             strided * 3 + [p, ll, ll, ll, i, p, ll] + strided
             + [p] * 8 + [i, i, i, i, i, i, i, p]),
            (lib.dtpu_attention_backward_cluster_occupancy, [i, i, ctypes.POINTER(i)])):
        if fn.argtypes is None:  # without them ctypes passes pointers as 32-bit ints
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib
