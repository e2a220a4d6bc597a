"""Switch-MoE dispatch and combine: gate -> capacity slots -> packed buffer, and back.

The port's counterpart of ``distribuuuu_tpu/ops/moe_kernel.py``. On a CUDA
tensor, :func:`fused_moe_dispatch` (K6) and :func:`fused_moe_combine` (K7)
launch the hand-written Hopper kernels in ``csrc/moe.cu``; on a CPU tensor
they compute :func:`oracle_dispatch` / :func:`oracle_combine`, the plain
PyTorch versions (the einsum formulation, term for term as the JAX
oracles). There is no other route: a CUDA tensor the kernels do not take
raises, and nothing falls back.

Both are ``torch.autograd.Function``s. The JAX kernels' backward recomputes
the einsum formulation; here the backward is the transpose of the routing
written with index ops (a gather of ``d_send`` rows, an ``index_add_`` into
``d_back``) plus the softmax backward on the ``[n, E]`` probabilities, so no
``[n, E, C]`` mask is formed on the card. Its gradients equal autograd
through the oracle, including the rule that under tied probabilities the
gradient of ``top_p`` goes to the argmax alone. Both run on either device.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

# Launches of each CUDA kernel since the last reset (one per wrapper call;
# dispatch is three launches on one stream, counted once). chip_smoke.py
# zeroes them before driving a path and reads them after, to show the path
# went through the kernels.
DISPATCH_LAUNCHES = 0
COMBINE_LAUNCHES = 0
_count_lock = threading.Lock()

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # tokens per route block in csrc/moe.cu (kTile)
MAX_EXPERTS = 32  # the route kernel's warp holds at most 32 experts' logits
SMEM_PER_BLOCK = 232_448  # H100: the most shared memory one block can opt in to
_ROUTE_STATIC_SMEM = 2048  # the route kernel's fixed shared arrays, rounded up


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


def check_kernel_shape(n: int, d: int, e: int, capacity: int) -> None:
    """Raise on a shape the CUDA dispatch kernel cannot take (the counterpart
    of the JAX package's VMEM guard, which fell back to the einsum path)."""
    if e > MAX_EXPERTS:
        raise ValueError(f"the CUDA dispatch kernel routes to at most {MAX_EXPERTS} experts, got {e}")
    # the route kernel stages the [D, E] gate with E padded to 4, 8, 16 or 32
    smem = d * next(p for p in (4, 8, 16, 32) if e <= p) * 4 + _ROUTE_STATIC_SMEM
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"the [D, E] = [{d}, {e}] gate needs {smem} bytes of shared memory, more than "
            f"the {SMEM_PER_BLOCK} one block can hold"
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


def _dispatch_cuda(x, gate_kernel, capacity):
    n, d = x.shape
    e = gate_kernel.shape[1]
    check_kernel_shape(n, d, e, capacity)
    _contiguous(x=x, gate_kernel=gate_kernel)
    f32, i32, dev = torch.float32, torch.int32, x.device
    send = torch.empty((e, capacity, d), dtype=f32, device=dev)
    top = torch.empty(n, dtype=i32, device=dev)
    pos = torch.empty(n, dtype=i32, device=dev)
    w = torch.empty(n, dtype=f32, device=dev)
    fp_sum = torch.empty((2, e), dtype=f32, device=dev)
    tiles = -(-n // TILE)
    counts = torch.empty(tiles * e + e, dtype=i32, device=dev)  # tile counts, then totals
    psum = torch.empty(max(tiles * e, 1), dtype=f32, device=dev)
    vec = d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.dtpu_moe_dispatch_launch(
            x.data_ptr(), _DT_CODE[x.dtype], gate_kernel.data_ptr(), send.data_ptr(),
            top.data_ptr(), pos.data_ptr(), w.data_ptr(), fp_sum.data_ptr(),
            counts.data_ptr(), psum.data_ptr(), n, d, e, capacity, int(vec),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"MoE dispatch kernel launch failed: cudaError {err}")
    global DISPATCH_LAUNCHES
    with _count_lock:
        DISPATCH_LAUNCHES += 1
    return send, top, pos, w, fp_sum


def _combine_cuda(back, top, pos, w):
    e, c, d = back.shape
    n = top.shape[0]
    _contiguous(back=back, top=top, pos=pos, w=w)
    out = torch.empty((n, d), dtype=torch.float32, device=back.device)
    if n == 0:
        return out
    vec = d % 4 == 0 and back.data_ptr() % 16 == 0
    lib = _library()
    with torch.cuda.device(back.device):
        err = lib.dtpu_moe_combine_launch(
            back.data_ptr(), top.data_ptr(), pos.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, d, e, c, int(vec), torch.cuda.current_stream(back.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"MoE combine kernel launch failed: cudaError {err}")
    global COMBINE_LAUNCHES
    with _count_lock:
        COMBINE_LAUNCHES += 1
    return out


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gate_kernel, capacity):
        if x.device.type == "cpu":
            outs = oracle_dispatch(x, gate_kernel, capacity)
        else:
            outs = _dispatch_cuda(x, gate_kernel, capacity)
        _send, top, pos, w, _fp = outs
        ctx.capacity = capacity
        ctx.save_for_backward(x, gate_kernel, top, pos, w)
        ctx.mark_non_differentiable(top, pos)
        return outs

    @staticmethod
    def backward(ctx, d_send, _d_top, _d_pos, d_w, d_fp):
        x, gate, top, pos, w = ctx.saved_tensors
        c = ctx.capacity
        x32 = x.float()
        probs = torch.softmax(x32 @ gate, dim=-1)  # recomputed: [n, E]
        # w = top_p · keep, and top_p >= 1/E > 0, so keep is w != 0
        keep = (w != 0).float()
        # fp_sum[1] = Σ_t probs[t]; top_p = probs[t, top_t] (to the argmax alone);
        # fp_sum[0] is a count and carries no gradient
        d_probs = d_fp[1].expand_as(probs).clone()
        d_probs.scatter_add_(1, top.long()[:, None], (d_w * keep)[:, None])
        d_logits = probs * (d_probs - (d_probs * probs).sum(-1, keepdim=True))
        d_x = d_gate = None
        if ctx.needs_input_grad[0]:
            rows = d_send.reshape(-1, x.shape[1]).index_select(0, top.long() * c + pos.long())
            d_x = (d_logits @ gate.t() + keep[:, None] * rows).to(x.dtype)
        if ctx.needs_input_grad[1]:
            d_gate = x32.t() @ d_logits
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
        e, c, d = back.shape
        idx = top.long() * c + pos.long()
        d_back = d_w = None
        if ctx.needs_input_grad[0]:
            # each slot gets its kept token's w·g; a dropped token adds 0·g
            d_back = torch.zeros((e * c, d), dtype=g.dtype, device=g.device)
            d_back.index_add_(0, idx, g * w[:, None])
            d_back = d_back.view(e, c, d)
        if ctx.needs_input_grad[3]:
            d_w = (g * back.reshape(e * c, d).index_select(0, idx)).sum(-1)
        return d_back, None, None, d_w


def fused_moe_dispatch(x, gate_kernel, *, capacity: int):
    """Gate -> capacity slots -> packed ``[E, C, D]`` f32 send buffer.

    Returns ``(send, top, pos, w, fp_sum)``, exactly :func:`oracle_dispatch`'s
    contract: ``top``/``pos`` int32 ``[n]`` (not differentiable), ``w`` f32
    ``[n]``, ``fp_sum`` f32 ``[2, E]``. ``x`` is the local ``[n, D]`` token
    shard (f32 or bf16; routing and packing are f32), ``gate_kernel`` the f32
    ``[D, E]`` router. Differentiable in both. A CPU tensor gets the plain
    version; a CUDA tensor launches K6.
    """
    _check_dispatch(x, gate_kernel, capacity)
    return _Dispatch.apply(x, gate_kernel, int(capacity))


def fused_moe_combine(back, top, pos, w):
    """The transposed un-pack: ``out[t] = w_t · back[top_t, pos_t]``, f32 ``[n, D]``.

    ``back`` is the f32 ``[E, C, D]`` expert-output buffer, ``top``/``pos``/
    ``w`` the routing :func:`fused_moe_dispatch` returned. Dropped tokens
    (``w == 0``) combine to exact zeros. Differentiable in ``back`` and
    ``w``. A CPU tensor gets the plain version; a CUDA tensor launches K7.
    """
    _check_combine(back, top, pos, w)
    return _Combine.apply(back, top, pos, w)


def _library() -> ctypes.CDLL:
    from distribuuuu_tpu_torch.ops import _build

    lib, _ = _build.load("moe")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args in ((lib.dtpu_moe_dispatch_launch, [p, i] + [p] * 8 + [ll, i, i, i, i, p]),
                     (lib.dtpu_moe_combine_launch, [p] * 5 + [ll, i, i, i, i, p])):
        if fn.argtypes is None:  # without them ctypes passes pointers as 32-bit ints
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib
