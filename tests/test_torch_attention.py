"""Fused attention of the PyTorch port (distribuuuu_tpu_torch/ops/attention.py).

On the CPU the port's wrappers compute their plain versions. Those are held
against the four JAX Pallas kernels run in the Pallas interpreter, on the
same numpy-seeded inputs cast identically on both sides:

- K2 ``fused_attention`` (single tile) and K4 ``_fused_attention_blk``
  (blockwise online softmax), bias tensor;
- K3 ``fused_attention_abs`` and K5 ``_fused_attention_abs_blk``, the bias
  ``q·embᵀ`` formed from the ``[L, D]`` table;

in float32 within 2e-5 (only summation order differs) and in bfloat16
within 2e-2 (the weights are cast to bf16 before ``p·v``: K2 and the plain
version after normalising, K4/K5 before, so the two round differently by
up to a bf16 ulp of the output; tests/test_ops_attention.py uses the same
bounds). L is ragged against the CUDA kernel's 64-row tiles and Dv != D.

The backward (``attention_backward_reference`` and
``attention_table_backward_reference``, and the autograd Functions around
``fused_attention`` and ``fused_attention_abs`` that call them on the CPU)
is held against ``jax.vjp`` of the JAX ``custom_vjp`` kernels: K2 and K3 at
a ragged single-tile L and K4's and K5's blockwise custom_vjp (``demb``
included), in float32 within 1e-5 of max(1, max|grad|)
(only the f32 summation order differs) and in bfloat16 within one bf16 ulp,
2^-7 of max(1, max|grad|) (both sides compute in f32 and round each
gradient once to bf16; an f32 sum that straddles a rounding boundary lands
one ulp away).

The card-only kernel tests are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distribuuuu_tpu.ops import attention as jax_attention
from distribuuuu_tpu_torch.ops import attention as att

torch.set_num_threads(2)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _inputs(b, n, l, d, dv, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, l, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, n, l, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, n, l, dv)).astype(np.float32)
    bias = rng.standard_normal((b, n, l, l)).astype(np.float32) * 0.5
    emb = rng.standard_normal((l, d)).astype(np.float32) * 0.5
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, bias, emb)]
    j = [jnp.asarray(a, _JNP[dtype]) for a in (q, k, v, bias, emb)]
    return t, j


def _jax_kernel(kernel, q, k, v, last, block):
    if kernel == "K2":
        return jax_attention.fused_attention(q, k, v, last, interpret=True)
    if kernel == "K3":
        return jax_attention.fused_attention_abs(q, k, v, last, interpret=True)
    if kernel == "K4":
        return jax_attention._fused_attention_blk(q, k, v, last, block, True)
    return jax_attention._fused_attention_abs_blk(q, k, v, last, block, True)


# (kernel, L, D, Dv, block): K2/K3 at the single-tile L of the JAX tests,
# K4/K5 at an L of three 16-blocks; L is never a multiple of 64
_CASES = [("K2", 20, 16, 8, None), ("K3", 20, 16, 8, None),
          ("K4", 48, 16, 8, 16), ("K5", 48, 16, 8, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,l,d,dv,block", _CASES, ids=[c[0] for c in _CASES])
def test_plain_versions_match_the_jax_kernels(kernel, l, d, dv, block, dtype):
    (q, k, v, bias, emb), (jq, jk, jv, jbias, jemb) = _inputs(2, 3, l, d, dv, dtype, seed=l + d)
    table = kernel in ("K3", "K5")
    ref = np.asarray(
        _jax_kernel(kernel, jq, jk, jv, jemb if table else jbias, block), np.float32)
    before = (att.LAUNCHES, att.TABLE_LAUNCHES)
    got = (att.fused_attention_abs(q, k, v, emb) if table
           else att.fused_attention(q, k, v, bias))
    assert (att.LAUNCHES, att.TABLE_LAUNCHES) == before  # the CPU never launches
    assert got.dtype == dtype and got.shape == (2, 3, l, dv)
    tol = _TOL[dtype] * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.float().numpy() - ref).max()) <= tol


# The blockwise plain version against the JAX blockwise kernels at its own
# tiling (block 64, two key tiles): both round where the CUDA kernel does (p
# cast to v's dtype before normalising, l summed unrounded), so in f32 only
# summation order differs (2e-5) and in bf16 an output lands at most one bf16
# ulp away (2^-7 of max(1, max|out|)) where the two f32 values straddle a
# rounding boundary, plus a rare flip of one p's rounding: 1e-2.
_BLOCKWISE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_blockwise_reference_matches_the_jax_blockwise_kernels(kernel, dtype):
    (q, k, v, bias, emb), (jq, jk, jv, jbias, jemb) = _inputs(2, 3, 128, 16, 8, dtype, seed=7)
    table = kernel == "K5"
    ref = np.asarray(_jax_kernel(kernel, jq, jk, jv, jemb if table else jbias, 64), np.float32)
    got = att.attention_blockwise_reference(q, k, v, emb if table else bias, table=table)
    assert got.dtype == dtype and got.shape == (2, 3, 128, 8)
    tol = _BLOCKWISE_TOL[dtype] * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.float().numpy() - ref).max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("table", [False, True], ids=["bias", "table"])
def test_blockwise_reference_matches_the_plain_version_at_a_ragged_l(table, dtype):
    """L 70 = 64 + 6: a ragged last key tile; bf16 within the single-tile
    bound (the two round p on either side of normalising)."""
    (q, k, v, bias, emb), _ = _inputs(2, 3, 70, 40, 24, dtype, seed=8)
    last = emb if table else bias
    want = (att.attention_table_reference if table else att.attention_reference)(q, k, v, last)
    got = att.attention_blockwise_reference(q, k, v, last, table=table)
    assert got.dtype == dtype and got.shape == want.shape
    tol = _TOL[dtype] * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_table_mode_equals_bias_mode_on_the_materialised_product():
    (q, k, v, _, emb), _ = _inputs(1, 2, 30, 8, 8, torch.float32, seed=4)
    bias = torch.einsum("bnxd,yd->bnxy", q, emb)
    torch.testing.assert_close(att.fused_attention_abs(q, k, v, emb),
                               att.fused_attention(q, k, v, bias), rtol=1e-6, atol=1e-6)


def test_softmax_is_stable_under_a_huge_uniform_bias():
    (q, k, v, bias, _), _ = _inputs(1, 1, 8, 8, 8, torch.float32, seed=5)
    out = att.fused_attention(q, k, v, bias + 1e4)
    assert torch.isfinite(out).all()


def test_wrapper_refusals():
    (q, k, v, bias, emb), _ = _inputs(1, 2, 6, 4, 4, torch.float32, seed=6)
    with pytest.raises(ValueError, match=r"\[B, N, L, D\]"):
        att.fused_attention(q[0], k, v, bias)
    with pytest.raises(ValueError, match="must match q"):
        att.fused_attention(q, k[:, :, :5], v, bias)
    with pytest.raises(ValueError, match="v must be"):
        att.fused_attention(q, k, v[:, :1], bias)
    with pytest.raises(TypeError, match="one dtype"):
        att.fused_attention(q, k.bfloat16(), v, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        att.fused_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="bias must be"):
        att.fused_attention(q, k, v, bias[..., :5])
    with pytest.raises(TypeError, match="bias must be float32 or bfloat16"):
        att.fused_attention(q, k, v, bias.double())
    with pytest.raises(ValueError, match=r"emb must be \[L, D\]"):
        att.fused_attention_abs(q, k, v, emb[:5])
    with pytest.raises(TypeError, match="q's dtype"):
        att.fused_attention_abs(q, k, v, emb.bfloat16())
    # a meta tensor (shapes only: obs/flops.py's count) takes the plain
    # version, as a CPU tensor does, and launches nothing
    meta = [t.to("meta") for t in (q, k, v, bias)]
    before = (att.LAUNCHES, att.BWD_LAUNCHES)
    out = att.fused_attention(*meta)
    assert out.device.type == "meta" and out.shape == v.shape
    assert (att.LAUNCHES, att.BWD_LAUNCHES) == before


# the backward against the JAX custom_vjp, relative to max(1, max|grad|):
# f32 summation order only; in bf16 one ulp of the rounded gradient
_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


_BWD_CASES = [("K2", 20, None), ("K4", 48, 16), ("K3", 20, None), ("K5", 48, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,l,block", _BWD_CASES, ids=[c[0] for c in _BWD_CASES])
def test_backward_reference_matches_the_jax_custom_vjp(kernel, l, block, dtype):
    (q, k, v, bias, emb), (jq, jk, jv, jbias, jemb) = _inputs(2, 3, l, 16, 8, dtype, seed=l + 1)
    table = kernel in ("K3", "K5")
    g = np.random.default_rng(l).standard_normal((2, 3, l, 8)).astype(np.float32)
    out, pull = jax.vjp(lambda *a: _jax_kernel(kernel, *a, block), jq, jk, jv,
                        jemb if table else jbias)
    want = pull(jnp.asarray(g, out.dtype))
    gt = torch.from_numpy(g).to(dtype)
    got = (att.attention_table_backward_reference(q, k, v, emb, gt) if table
           else att.attention_backward_reference(q, k, v, bias, gt))
    for name, a, b in zip(("dq", "dk", "dv", "demb" if table else "dbias"), got, want):
        b = np.asarray(b, np.float32)
        assert a.dtype == dtype and a.shape == b.shape, name
        tol = _BWD_TOL[dtype] * max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a.float().numpy() - b).max()) <= tol, name


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_function_gradients_on_the_cpu_equal_the_reference_bitwise(bias_dtype):
    """Through ``fused_attention`` with every input needing a gradient: the
    autograd Function's backward on a CPU tensor is the plain backward."""
    dtype = torch.bfloat16
    (q, k, v, bias, _), _ = _inputs(2, 2, 30, 16, 8, dtype, seed=12)
    bias = bias.to(bias_dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = att.fused_attention(*leaves)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    assert torch.equal(out, att.attention_reference(q, k, v, bias))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(dtype)
    before = att.BWD_LAUNCHES
    out.backward(g)
    assert att.BWD_LAUNCHES == before  # the CPU never launches
    for leaf, want in zip(leaves, att.attention_backward_reference(q, k, v, bias, g)):
        assert leaf.grad.dtype == leaf.dtype and torch.equal(leaf.grad, want)
    only_bias = bias.clone().requires_grad_()
    (dbias,) = torch.autograd.grad(att.fused_attention(q, k, v, only_bias), only_bias, g)
    assert torch.equal(dbias, att.attention_backward_reference(q, k, v, bias, g)[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_table_function_gradients_on_the_cpu_equal_the_reference_bitwise(dtype):
    """Through ``fused_attention_abs`` with every input needing a gradient:
    the table mode's autograd Function, whose backward on a CPU tensor is
    the plain table backward, demb included; one input at a time too."""
    (q, k, v, _, emb), _ = _inputs(2, 2, 30, 16, 8, dtype, seed=14)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, emb)]
    out = att.fused_attention_abs(*leaves)
    assert type(out.grad_fn).__name__ == "_AttentionAbsBackward"
    assert torch.equal(out, att.attention_table_reference(q, k, v, emb))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    before = (att.BWD_LAUNCHES, att.TABLE_BWD_LAUNCHES, dict(att.BWD_ROUTE_CALLS))
    out.backward(g)
    # the CPU never launches
    assert (att.BWD_LAUNCHES, att.TABLE_BWD_LAUNCHES, att.BWD_ROUTE_CALLS) == before
    want = att.attention_table_backward_reference(q, k, v, emb, g)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape
        assert torch.equal(leaf.grad, w)
    assert torch.equal(att.fused_attention_abs_backward(q, k, v, emb, g)[3], want[3])
    only_emb = emb.clone().requires_grad_()
    (demb,) = torch.autograd.grad(att.fused_attention_abs(q, k, v, only_emb), only_emb, g)
    assert torch.equal(demb, want[3])


def test_table_backward_reference_equals_bias_backward_on_the_materialised_product():
    """f32: with bias = q·embᵀ formed outside, the bias mode's dk, dv and
    dbias give the table mode's dk, dv, dq - dbias·emb and demb =
    Σ_{b,n} dbiasᵀ·q."""
    (q, k, v, _, emb), _ = _inputs(2, 3, 24, 8, 8, torch.float32, seed=15)
    g = torch.randn(2, 3, 24, 8, generator=torch.Generator().manual_seed(2))
    bias = torch.einsum("bnxd,yd->bnxy", q, emb)
    dq, dk, dv, demb = att.attention_table_backward_reference(q, k, v, emb, g)
    bq, bk, bv, dbias = att.attention_backward_reference(q, k, v, bias, g)
    torch.testing.assert_close(dk, bk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, bv, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dq, bq + torch.einsum("bnxy,yd->bnxd", dbias, emb),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(demb, torch.einsum("bnxy,bnxd->yd", dbias, q),
                               rtol=1e-5, atol=1e-6)


def test_backward_route_is_chosen_by_dtype_and_l():
    assert att.backward_route(torch.bfloat16, 64) == "cluster"
    assert att.backward_route(torch.bfloat16, 196) == "cluster"
    assert att.backward_route(torch.bfloat16, att.CLUSTER_MAX_L) == "cluster"
    assert att.backward_route(torch.bfloat16, att.CLUSTER_MAX_L + 1) == "blockwise"
    assert att.backward_route(torch.bfloat16, 1024) == "blockwise"
    assert att.backward_route(torch.float32, 196) == "scalar"
    assert att.backward_route(torch.float32, 1024) == "scalar"
    # every route has its CUDA launches a call, its code for the C entry point and its count
    assert set(att.ROUTE_LAUNCHES) == set(att._ROUTE_CODE) == set(att.BWD_ROUTE_CALLS)
    assert att.ROUTE_LAUNCHES == {"cluster": 1, "blockwise": 3, "scalar": 2}


def test_no_function_node_without_a_gradient():
    (q, k, v, bias, emb), _ = _inputs(1, 2, 12, 8, 8, torch.float32, seed=13)
    assert att.fused_attention(q, k, v, bias).grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    with torch.no_grad():
        assert att.fused_attention(*leaves).grad_fn is None
    with torch.inference_mode():
        assert att.fused_attention(*leaves).grad_fn is None
    # the table mode: a Function node only where a gradient is needed
    assert att.fused_attention_abs(q, k, v, emb).grad_fn is None
    e = emb.clone().requires_grad_()
    with torch.no_grad():
        assert att.fused_attention_abs(q, k, v, e).grad_fn is None
    with torch.inference_mode():
        assert att.fused_attention_abs(q, k, v, e).grad_fn is None
    att.fused_attention_abs(q, k, v, e).sum().backward()
    assert e.grad is not None and torch.isfinite(e.grad).all()
    with pytest.raises(ValueError, match="g must be"):
        att.fused_attention_backward(q, k, v, bias, torch.zeros(1, 2, 12, 4))
    with pytest.raises(ValueError, match="g must be"):
        att.fused_attention_abs_backward(q, k, v, emb, torch.zeros(1, 2, 12, 4))
