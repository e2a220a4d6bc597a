"""Fused conv epilogue of the PyTorch port (distribuuuu_tpu_torch/ops/epilogue.py).

- CPU: the port's plain version equals the JAX kernel (Pallas interpreter)
  and ``oracle_epilogue`` on the same seeded inputs, within the tolerance of
  tests/test_epilogue.py (XLA may contract into an FMA; eager torch does not);
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


@pytest.mark.parametrize("bad", ["vector_dtype", "vector_len", "identity_shape", "x_dtype", "rank"])
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
    else:
        x = torch.randn(2, 3, 4)
    with pytest.raises((ValueError, TypeError)):
        ep.fused_conv_epilogue(x, kw["mean"], kw["mul"], kw["bias"], kw["identity"],
                               relu=True, bn_dtype=torch.float32)
