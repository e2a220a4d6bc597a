"""Switch-MoE dispatch and combine: gate -> capacity slots -> packed buffer, and back.

The port's counterpart of ``distribuuuu_tpu/ops/moe_kernel.py``. On a CUDA
tensor, :func:`fused_moe_dispatch` (K6) and :func:`fused_moe_combine` (K7)
launch the hand-written Hopper kernels in ``csrc/moe.cu``; on a CPU tensor
they compute :func:`oracle_dispatch` / :func:`oracle_combine`, the plain
PyTorch versions (the einsum formulation, term for term as the JAX
oracles). There is no other route: a CUDA tensor the kernels do not take
raises, and nothing falls back.

Both are ``torch.autograd.Function``s when an input needs a gradient (and
plain calls otherwise, which keeps their host cost low and lets a CUDA graph
capture them). The JAX kernels' backward recomputes the einsum formulation;
here each backward is a kernel of its own on a CUDA tensor (K6's: the
softmax backward and ``d_x`` from the probabilities the forward saved; K7's:
``d_back`` and ``d_w`` in one pass), and on a CPU tensor its plain version,
:func:`dispatch_backward_reference` / :func:`combine_backward_reference`:
the transpose of the routing written with index ops (a gather of ``d_send``
rows, an ``index_add_`` into ``d_back``) plus the softmax backward on the
``[n, E]`` probabilities, so no ``[n, E, C]`` mask is formed. Their
gradients equal autograd through the oracles, including the rule that under
tied probabilities the gradient of ``top_p`` goes to the argmax alone.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

# Launches of each CUDA kernel since the last reset (one per wrapper call
# that launches). chip_smoke.py zeroes them before driving a path and reads
# them after, to show the path went through the kernels.
DISPATCH_LAUNCHES = 0
COMBINE_LAUNCHES = 0
DISPATCH_BWD_LAUNCHES = 0
COMBINE_BWD_LAUNCHES = 0
_count_lock = threading.Lock()

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32  # tokens a dispatch tile (kTile in csrc/moe.cu): the scratch is sized by it
MAX_EXPERTS = 32  # a warp's lanes hold the experts' values
SMEM_PER_BLOCK = 232_448  # H100: the most shared memory one block can opt in to


def oracle_dispatch(x, gate_kernel, capacity: int):
    """Einsum-formulation dispatch: ``(send, top, pos, w, fp_sum)``, term for
    term as ``distribuuuu_tpu.ops.moe_kernel.oracle_dispatch``: f32 softmax
    gate, lowest-index argmax, the gather for ``top_p``, int32 slot
    counting, the ``[n, E, C]`` f32 mask and the packing einsum.
    ``w = top_p · keep``; ``fp_sum = [Σ onehot, Σ probs]`` (pre-drop)."""
    e = gate_kernel.shape[-1]
    x32 = x.float()
    probs = torch.softmax(x32 @ gate_kernel.float(), dim=-1)
    top = probs.argmax(dim=-1).to(torch.int32)
    # the gather (not max): under tied probabilities the gradient of top_p
    # goes to the argmax alone, as through the JAX oracle's take_along_axis
    top_p = probs.gather(-1, top.long()[:, None])[:, 0]
    onehot_e = F.one_hot(top.long(), e).float()
    oh = onehot_e.to(torch.int32)
    pos = ((oh.cumsum(0, dtype=torch.int32) - 1) * oh).sum(-1, dtype=torch.int32)
    keep = pos < capacity
    pos_c = pos.clamp(0, capacity - 1)
    onehot_c = F.one_hot(pos_c.long(), capacity).float()
    dispatch = onehot_e[:, :, None] * onehot_c[:, None, :] * keep[:, None, None].float()
    send = torch.einsum("nec,nd->ecd", dispatch, x32)
    w = top_p * keep.float()
    fp_sum = torch.stack([onehot_e.sum(0), probs.sum(0)])
    return send, top, pos_c, w, fp_sum


def oracle_combine(back, top, pos, w):
    """Einsum-formulation combine: ``out[t] = w_t · back[top_t, pos_t]``."""
    e, c, _ = back.shape
    mask = (
        F.one_hot(top.long(), e).float()[:, :, None]
        * F.one_hot(pos.long(), c).float()[:, None, :]
        * w[:, None, None]
    )
    return torch.einsum("nec,ecd->nd", mask, back.float())




def dispatch_backward_reference(x, gate_kernel, top, pos, w, d_send, d_w, d_fp, capacity: int, *,
                                need_x: bool = True, need_gate: bool = True):
    """The plain version of K6's backward: ``(d_x, d_gate)`` (``None`` where
    not needed) from the cotangents of ``send``, ``w`` and ``fp_sum``.
    ``probs`` is recomputed from ``x`` and the gate; ``fp_sum[1] = Σ_t
    probs[t]``; ``w = probs[t, top_t] · keep`` (to the argmax alone);
    ``fp_sum[0]`` is a count and carries no gradient."""
    x32 = x.float()
    probs = torch.softmax(x32 @ gate_kernel, dim=-1)
    # w = top_p · keep, and top_p >= 1/E > 0, so keep is w != 0
    keep = (w != 0).float()
    d_probs = d_fp[1].expand_as(probs).clone()
    d_probs.scatter_add_(1, top.long()[:, None], (d_w * keep)[:, None])
    d_logits = probs * (d_probs - (d_probs * probs).sum(-1, keepdim=True))
    d_x = d_gate = None
    if need_x:
        rows = d_send.reshape(-1, x.shape[1]).index_select(0, top.long() * capacity + pos.long())
        d_x = (d_logits @ gate_kernel.t() + keep[:, None] * rows).to(x.dtype)
    if need_gate:
        d_gate = x32.t() @ d_logits
    return d_x, d_gate


def combine_backward_reference(back, top, pos, w, g, *, need_back: bool = True,
                               need_w: bool = True):
    """The plain version of K7's backward: ``(d_back, d_w)`` (``None`` where
    not needed) from the cotangent ``g`` of ``out``. Each slot gets its kept
    token's ``w·g`` (a dropped token adds ``0·g``); ``d_w[t] = <g_t,
    back[top_t, pos_t]>``."""
    e, c, d = back.shape
    idx = top.long() * c + pos.long()
    d_back = d_w = None
    if need_back:
        d_back = torch.zeros((e * c, d), dtype=g.dtype, device=g.device)
        d_back.index_add_(0, idx, g * w[:, None])
        d_back = d_back.view(e, c, d)
    if need_w:
        d_w = (g * back.reshape(e * c, d).index_select(0, idx)).sum(-1)
    return d_back, d_w


@functools.lru_cache(maxsize=64)
def _route_smem(d: int, e: int, x_bytes: int) -> int:
    """Shared memory of one dispatch block with one x tile, an upper bound:
    the tile's TILE rows (D padded to 4), the gate as [E padded to 8/16/32,
    D] f32, and the fixed per-token and per-expert arrays."""
    ep = next(p for p in (8, 16, 32) if e <= p)
    dp = -(-d // 4) * 4
    return TILE * dp * x_bytes + ep * dp * 4 + TILE * (12 + 8 * ep) + 12 * ep + 256


def check_kernel_shape(n: int, d: int, e: int, capacity: int, x_bytes: int = 4) -> None:
    """Raise on a shape the CUDA dispatch kernel cannot take (the counterpart
    of the JAX package's VMEM guard, which fell back to the einsum path).
    ``x_bytes``: the size of one of x's values (4 for f32, 2 for bf16)."""
    if e > MAX_EXPERTS:
        raise ValueError(f"the CUDA dispatch kernel routes to at most {MAX_EXPERTS} experts, got {e}")
    smem = _route_smem(d, e, x_bytes)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"a tile of {TILE} x rows and the [D, E] = [{d}, {e}] gate need {smem} bytes of "
            f"shared memory, more than the {SMEM_PER_BLOCK} one block can hold"
        )
    if n >= 2**31 or e * capacity >= 2**31:
        raise ValueError(f"n = {n} and E·C = {e * capacity} must stay below 2^31 (int32 slots)")


def _check_dispatch(x, gate_kernel, capacity) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [n, D], got {tuple(x.shape)}")
    if x.dtype not in _DT_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if gate_kernel.dim() != 2 or gate_kernel.shape[0] != x.shape[1]:
        raise ValueError(f"gate_kernel must be [{x.shape[1]}, E], got {tuple(gate_kernel.shape)}")
    if gate_kernel.dtype != torch.float32:
        raise TypeError(f"gate_kernel must be float32, got {gate_kernel.dtype}")
    if gate_kernel.device != x.device:
        raise ValueError(f"gate_kernel is on {gate_kernel.device}, x on {x.device}")
    if int(capacity) < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_moe_dispatch runs on cuda or cpu tensors, got {x.device}")


def _check_combine(back, top, pos, w) -> None:
    if back.dim() != 3 or back.dtype != torch.float32:
        raise ValueError(f"back must be float32 [E, C, D], got {back.dtype} {tuple(back.shape)}")
    n = top.shape[0]
    for name, t, dt in (("top", top, torch.int32), ("pos", pos, torch.int32), ("w", w, torch.float32)):
        if t.shape != (n,) or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} [{n}], got {t.dtype} {tuple(t.shape)}")
        if t.device != back.device:
            raise ValueError(f"{name} is on {t.device}, back on {back.device}")
    if back.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_moe_combine runs on cuda or cpu tensors, got {back.device}")


def _contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous for the CUDA kernel "
                f"(shape {tuple(t.shape)}, strides {t.stride()})"
            )


def _launch(fn, what: str, counter: str, dev, *args) -> None:
    """Call the C entry point ``fn`` on ``dev``'s current stream (switching
    the current device only when it differs), raise on a CUDA error, and
    count the launch."""
    if dev.index == torch.cuda.current_device():
        err = fn(*args, _stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"MoE {what} kernel launch failed: cudaError {err}")
    with _count_lock:
        globals()[counter] += 1


def _dispatch_cuda(x, gate_kernel, capacity, want_probs: bool):
    """K6: ``(send, top, pos, w, fp_sum, probs)``; ``probs`` ([n, E] f32, for
    the backward) is None unless ``want_probs``. Three allocations: send, one
    int32 buffer (top, pos, the look-back scratch) and one f32 buffer (w,
    fp_sum, probs)."""
    n, d = x.shape
    e = gate_kernel.shape[1]
    check_kernel_shape(n, d, e, capacity, x.element_size())
    _contiguous(x=x, gate_kernel=gate_kernel)
    dev = x.device
    tiles = -(-n // TILE)
    ints = torch.empty(2 * n + 2 + 4 * e * tiles, dtype=torch.int32, device=dev)
    nf = n + 2 * e
    floats = torch.empty(nf + (n * e if want_probs else 0), dtype=torch.float32, device=dev)
    send = torch.empty((e, capacity, d), dtype=torch.float32, device=dev)
    top, pos = ints[:n], ints[n : 2 * n]
    w, fp_sum = floats[:n], floats[n : n + 2 * e].view(2, e)
    probs = floats[nf:].view(n, e) if want_probs else None
    _launch(_library().dtpu_moe_dispatch_launch, "dispatch", "DISPATCH_LAUNCHES", dev,
            x.data_ptr(), _DT_CODE[x.dtype], gate_kernel.data_ptr(), send.data_ptr(),
            top.data_ptr(), pos.data_ptr(), w.data_ptr(), fp_sum.data_ptr(),
            None if probs is None else probs.data_ptr(), ints.data_ptr() + 8 * n, n, d, e,
            capacity)
    return send, top, pos, w, fp_sum, probs


def _combine_cuda(back, top, pos, w):
    e, c, d = back.shape
    n = top.shape[0]
    _contiguous(back=back, top=top, pos=pos, w=w)
    out = torch.empty((n, d), dtype=torch.float32, device=back.device)
    if n:
        _launch(_library().dtpu_moe_combine_launch, "combine", "COMBINE_LAUNCHES", back.device,
                back.data_ptr(), top.data_ptr(), pos.data_ptr(), w.data_ptr(), out.data_ptr(),
                n, d, e, c)
    return out


def _dispatch_bwd_cuda(x, gate_kernel, probs, top, pos, w, d_send, d_w, d_fp, capacity,
                       need_x: bool):
    """K6's backward kernel: ``(d_x or None, d_logits [n, E] f32)``."""
    n, d = x.shape
    e = gate_kernel.shape[1]
    d_send, d_w, d_fp1 = d_send.contiguous(), d_w.contiguous(), d_fp[1].contiguous()
    d_logits = torch.empty((n, e), dtype=torch.float32, device=x.device)
    d_x = torch.empty_like(x, memory_format=torch.contiguous_format) if need_x else None
    if n:
        _launch(_library().dtpu_moe_dispatch_bwd_launch, "dispatch backward",
                "DISPATCH_BWD_LAUNCHES", x.device, probs.data_ptr(), top.data_ptr(),
                pos.data_ptr(), w.data_ptr(), d_send.data_ptr(), d_w.data_ptr(), d_fp1.data_ptr(),
                gate_kernel.data_ptr(), None if d_x is None else d_x.data_ptr(),
                _DT_CODE[x.dtype], d_logits.data_ptr(), n, d, e, capacity)
    return d_x, d_logits


def _combine_bwd_cuda(back, top, pos, w, g, need_back: bool, need_w: bool):
    """K7's backward kernel: ``(d_back or None, d_w or None)``."""
    e, c, d = back.shape
    n = top.shape[0]
    g = g.contiguous()
    d_back = torch.empty_like(back) if need_back else None
    d_w = torch.empty(n, dtype=torch.float32, device=back.device) if need_w else None
    scratch = torch.empty(2 + (e * c if need_back else 0), dtype=torch.int32, device=back.device)
    _launch(_library().dtpu_moe_combine_bwd_launch, "combine backward", "COMBINE_BWD_LAUNCHES",
            back.device, back.data_ptr(), top.data_ptr(), pos.data_ptr(), w.data_ptr(),
            g.data_ptr(), None if d_back is None else d_back.data_ptr(),
            None if d_w is None else d_w.data_ptr(), scratch.data_ptr(), n, d, e, c)
    return d_back, d_w


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gate_kernel, capacity):
        if x.device.type == "cpu":
            outs, probs = oracle_dispatch(x, gate_kernel, capacity), None
        else:
            *outs, probs = _dispatch_cuda(x, gate_kernel, capacity, want_probs=True)
        _send, top, pos, w, _fp = outs
        ctx.capacity = capacity
        ctx.save_for_backward(x, gate_kernel, top, pos, w, probs)
        ctx.mark_non_differentiable(top, pos)
        return tuple(outs)

    @staticmethod
    def backward(ctx, d_send, _d_top, _d_pos, d_w, d_fp):
        x, gate, top, pos, w, probs = ctx.saved_tensors
        need_x, need_gate = ctx.needs_input_grad[:2]
        if probs is None:
            d_x, d_gate = dispatch_backward_reference(x, gate, top, pos, w, d_send, d_w, d_fp,
                                                      ctx.capacity, need_x=need_x,
                                                      need_gate=need_gate)
        else:
            d_x, d_logits = _dispatch_bwd_cuda(x, gate, probs, top, pos, w, d_send, d_w, d_fp,
                                               ctx.capacity, need_x)
            d_gate = x.float().t() @ d_logits if need_gate else None
        return d_x, d_gate, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, back, top, pos, w):
        if back.device.type == "cpu":
            out = oracle_combine(back, top, pos, w)
        else:
            out = _combine_cuda(back, top, pos, w)
        ctx.save_for_backward(back, top, pos, w)
        return out

    @staticmethod
    def backward(ctx, g):
        back, top, pos, w = ctx.saved_tensors
        need_back, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        if back.device.type == "cpu":
            d_back, d_w = combine_backward_reference(back, top, pos, w, g, need_back=need_back,
                                                     need_w=need_w)
        else:
            d_back, d_w = _combine_bwd_cuda(back, top, pos, w, g, need_back, need_w)
        return d_back, None, None, d_w


def fused_moe_dispatch(x, gate_kernel, *, capacity: int):
    """Gate -> capacity slots -> packed ``[E, C, D]`` f32 send buffer.

    Returns ``(send, top, pos, w, fp_sum)``, exactly :func:`oracle_dispatch`'s
    contract: ``top``/``pos`` int32 ``[n]`` (not differentiable), ``w`` f32
    ``[n]``, ``fp_sum`` f32 ``[2, E]``. ``x`` is the local ``[n, D]`` token
    shard (f32 or bf16; routing and packing are f32), ``gate_kernel`` the f32
    ``[D, E]`` router. Differentiable in both. A CPU tensor gets the plain
    version; a CUDA tensor launches K6 (one kernel; no host sync, so it can
    be captured in a CUDA graph).
    """
    _check_dispatch(x, gate_kernel, capacity)
    capacity = int(capacity)
    if torch.is_grad_enabled() and (x.requires_grad or gate_kernel.requires_grad):
        return _Dispatch.apply(x, gate_kernel, capacity)
    if x.device.type == "cpu":
        return oracle_dispatch(x, gate_kernel, capacity)
    return _dispatch_cuda(x, gate_kernel, capacity, want_probs=False)[:5]


def fused_moe_combine(back, top, pos, w):
    """The transposed un-pack: ``out[t] = w_t · back[top_t, pos_t]``, f32 ``[n, D]``.

    ``back`` is the f32 ``[E, C, D]`` expert-output buffer, ``top``/``pos``/
    ``w`` a routing such as :func:`fused_moe_dispatch` returns. Dropped
    tokens (``w == 0``) combine to exact zeros. Differentiable in ``back``
    and ``w``, for any routing: ``d_back`` sums ``w·g`` over the tokens of
    each slot, as :func:`combine_backward_reference` does (a token with
    ``w == 0`` adds nothing). A CPU tensor gets the plain version; a CUDA
    tensor launches K7.
    """
    _check_combine(back, top, pos, w)
    if torch.is_grad_enabled() and (back.requires_grad or w.requires_grad):
        return _Combine.apply(back, top, pos, w)
    if back.device.type == "cpu":
        return oracle_combine(back, top, pos, w)
    return _combine_cuda(back, top, pos, w)


_LIB: ctypes.CDLL | None = None
# the current stream's handle as an int: PyTorch's own binding where the
# build has it (a call, no Stream object), else the public API
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev) -> int:
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    from distribuuuu_tpu_torch.ops import _build

    lib, _ = _build.load("moe")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in ((lib.dtpu_moe_dispatch_launch, [p, i] + [p] * 8 + [ll, i, i, i, p]),
                     (lib.dtpu_moe_combine_launch, [p] * 5 + [ll, i, i, i, p]),
                     (lib.dtpu_moe_dispatch_bwd_launch, [p] * 9 + [i, p, ll, i, i, i, p]),
                     (lib.dtpu_moe_combine_bwd_launch, [p] * 8 + [ll, i, i, i, p])):
        fn.argtypes = args  # without them ctypes passes pointers as 32-bit ints
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib
