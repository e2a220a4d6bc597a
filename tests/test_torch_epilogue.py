"""Fused conv epilogue of the PyTorch port (distribuuuu_tpu_torch/ops/epilogue.py).

- CPU: the port's plain version equals the JAX kernel (Pallas interpreter)
  and ``oracle_epilogue`` on the same seeded inputs, within the tolerance of
  tests/test_epilogue.py (XLA may contract into an FMA; eager torch does not);
  in modes (b) and (c) (the next conv's bf16 input from the same pass) it
  equals the JAX kernel followed by ``.astype(bf16)`` bitwise, on dyadic
  inputs whose affine product is exact, so an FMA cannot change a bit;
  the wrapper's input checks.
The card-only tests are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distribuuuu_tpu.ops.epilogue import fused_conv_epilogue as jax_epilogue
from distribuuuu_tpu.ops.epilogue import oracle_epilogue
from distribuuuu_tpu_torch.ops import epilogue as ep

# the suite runs several test workers on one host: keep torch's intra-op
# pool small so these CPU forwards do not starve the timing-sensitive tests
torch.set_num_threads(2)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _assert_close(got: np.ndarray, ref: np.ndarray, out_dtype) -> None:
    """tests/test_epilogue.py's tolerance: a few ulps of the output dtype."""
    rtol = 2.0**-6 if out_dtype == torch.bfloat16 else 1e-5
    atol = rtol * max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _inputs(r, c, x_dtype, res_dtype, seed):
    """Seeded numpy inputs, cast identically (round-to-nearest-even) on both sides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, c)).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = (np.abs(rng.standard_normal(c)) + 0.1).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ident = rng.standard_normal((r, c)).astype(np.float32) if res_dtype is not None else None
    mul = np.array(jax.lax.rsqrt(jnp.asarray(var) + 1e-5) * jnp.asarray(scale))
    t = dict(x=torch.from_numpy(x).to(x_dtype), mean=torch.from_numpy(mean),
             mul=torch.from_numpy(mul), bias=torch.from_numpy(bias),
             identity=None if ident is None else torch.from_numpy(ident).to(res_dtype))
    j = dict(x=jnp.asarray(x, _JNP[x_dtype]), mean=jnp.asarray(mean), mul=jnp.asarray(mul),
             bias=jnp.asarray(bias),
             identity=None if ident is None else jnp.asarray(ident, _JNP[res_dtype]))
    return t, j


# every (x dtype, bn dtype, residual, relu) combination once; shapes cycle
# through an exact tiling, a ragged last row tile and narrow channels
_SHAPES = [(64, 128, 32), (67, 128, 32), (130, 48, 128)]
_MATRIX = [
    (*_SHAPES[i % len(_SHAPES)], x_dt, bn_dt, residual, relu)
    for i, (x_dt, bn_dt, residual, relu) in enumerate(
        (x_dt, bn_dt, residual, relu)
        for x_dt in (torch.float32, torch.bfloat16)
        for bn_dt in (torch.float32, torch.bfloat16)
        for residual in (False, True)
        for relu in (False, True)
    )
]


@pytest.mark.parametrize("r,c,block,x_dtype,bn_dtype,residual,relu", _MATRIX)
def test_plain_epilogue_matches_jax_kernel_and_oracle(r, c, block, x_dtype, bn_dtype,
                                                      residual, relu):
    t, j = _inputs(r, c, x_dtype, bn_dtype if residual else None, seed=r * 1000 + c)
    got = ep.fused_conv_epilogue(t["x"], t["mean"], t["mul"], t["bias"], t["identity"],
                                 relu=relu, bn_dtype=bn_dtype)
    assert got.dtype == bn_dtype and got.shape == (r, c)
    jargs = (j["x"], j["mean"], j["mul"], j["bias"], j["identity"])
    kernel = jax_epilogue(*jargs, relu=relu, bn_dtype=_JNP[bn_dtype], block_rows=block,
                          interpret=True)
    oracle = oracle_epilogue(*jargs, relu=relu, bn_dtype=_JNP[bn_dtype])
    got32 = got.float().numpy()
    for ref in (kernel, oracle):
        assert np.dtype(ref.dtype) == np.dtype(_JNP[bn_dtype])
        _assert_close(got32, np.asarray(ref, np.float32), bn_dtype)


def _dyadic_inputs(r, c, x_dtype, res_dtype, seed):
    """Inputs on a 2^-10 grid, |x|, |mean|, |bias|, |identity| < 4, ``mul``
    in j/8 (j = 4..16): ``x - mean`` and its product with ``mul`` are exact
    in f32, so XLA's FMA and eager torch's two roundings agree, while the
    sums keep up to 19 significant bits, so both bf16 casts round."""
    rng = np.random.default_rng(seed)

    def grid(*shape):
        return (rng.integers(-4095, 4096, shape) / 1024.0).astype(np.float32)

    x, mean, bias = grid(r, c), grid(c), grid(c)
    mul = (rng.integers(4, 17, c) / 8.0).astype(np.float32)
    ident = grid(r, c) if res_dtype is not None else None
    t = dict(x=torch.from_numpy(x).to(x_dtype), mean=torch.from_numpy(mean),
             mul=torch.from_numpy(mul), bias=torch.from_numpy(bias),
             identity=None if ident is None else torch.from_numpy(ident).to(res_dtype))
    j = dict(x=jnp.asarray(x, _JNP[x_dtype]), mean=jnp.asarray(mean), mul=jnp.asarray(mul),
             bias=jnp.asarray(bias),
             identity=None if ident is None else jnp.asarray(ident, _JNP[res_dtype]))
    return t, j


@pytest.mark.parametrize(
    "x_dtype,bn_dtype,residual,relu",
    [(x_dt, bn_dt, residual, relu)
     for x_dt in (torch.float32, torch.bfloat16)
     for bn_dt in (torch.float32, torch.bfloat16)
     for residual in (False, True)
     for relu in (False, True)],
)
def test_plain_cast_modes_equal_jax_kernel_then_astype_bitwise(x_dtype, bn_dtype, residual, relu):
    """Mode (b) is the JAX kernel's output cast to bf16, bit for bit; mode
    (c) is the JAX kernel's output and that cast, from one call."""
    r, c = 67, 48
    t, j = _dyadic_inputs(r, c, x_dtype, bn_dtype if residual else None, seed=11)
    args = (t["x"], t["mean"], t["mul"], t["bias"], t["identity"])
    kernel = jax_epilogue(j["x"], j["mean"], j["mul"], j["bias"], j["identity"], relu=relu,
                          bn_dtype=_JNP[bn_dtype], block_rows=32, interpret=True)
    want_cast = torch.from_numpy(np.array(kernel.astype(jnp.bfloat16), np.float32))
    want_boundary = torch.from_numpy(np.array(kernel, np.float32))
    assert torch.equal(want_cast, want_boundary) == (bn_dtype == torch.bfloat16)  # f32 rounds

    cast = ep.fused_conv_epilogue(*args, relu=relu, bn_dtype=bn_dtype,
                                  cast_to=torch.bfloat16, keep_boundary=False)
    assert cast.dtype == torch.bfloat16 and torch.equal(cast.float(), want_cast)
    both = ep.fused_conv_epilogue(*args, relu=relu, bn_dtype=bn_dtype, cast_to=torch.bfloat16)
    boundary, cast_c = both
    assert boundary.dtype == bn_dtype and torch.equal(boundary.float(), want_boundary)
    assert torch.equal(cast_c, cast)
    if bn_dtype == torch.bfloat16:  # the cast is the boundary: one tensor in both roles
        assert boundary is cast_c
    assert torch.equal(ep.fused_conv_epilogue(*args, relu=relu, bn_dtype=bn_dtype), boundary)


def test_serving_case_nchw_channels_last_mixed_dtypes():
    """bf16 conv output, f32 BN and f32 residual, as ResNet serving runs it, on
    a 4-D channels-last tensor against the JAX kernel on the NHWC layout."""
    n, h, w, c = 2, 5, 3, 64
    t, j = _inputs(n * h * w, c, torch.bfloat16, torch.float32, seed=7)
    x4 = t["x"].view(n, h, w, c).permute(0, 3, 1, 2)
    id4 = t["identity"].view(n, h, w, c).permute(0, 3, 1, 2)
    got = ep.fused_conv_epilogue(x4, t["mean"], t["mul"], t["bias"], id4,
                                 relu=True, bn_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    ref = jax_epilogue(j["x"].reshape(n, h, w, c), j["mean"], j["mul"], j["bias"],
                       j["identity"].reshape(n, h, w, c), relu=True, bn_dtype=jnp.float32,
                       interpret=True)
    _assert_close(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), torch.float32)


@pytest.mark.parametrize("bad", ["vector_dtype", "vector_len", "identity_shape", "x_dtype", "rank",
                                 "cast_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.randn(6, 4)
    v = torch.randn(4)
    kw = dict(mean=v, mul=v, bias=v, identity=None)
    if bad == "vector_dtype":
        kw["mean"] = v.double()
    elif bad == "vector_len":
        kw["bias"] = torch.randn(5)
    elif bad == "identity_shape":
        kw["identity"] = torch.randn(6, 5)
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "rank":
        x = torch.randn(2, 3, 4)
    with pytest.raises((ValueError, TypeError)):
        ep.fused_conv_epilogue(x, kw["mean"], kw["mul"], kw["bias"], kw["identity"],
                               relu=True, bn_dtype=torch.float32,
                               cast_to=torch.float16 if bad == "cast_dtype" else None)
