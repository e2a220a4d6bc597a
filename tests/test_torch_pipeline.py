"""The port's GPipe pipeline on gloo ranks against the JAX package's on a CPU mesh.

8 JAX-free gloo ranks of ``tests/_torch_parallel_worker.py`` (one run for
the module) against JAX's ``pipeline_apply`` under ``shard_map``, jitted,
from the same stacked stage parameters (member ``s`` holds row ``s``, as
``P("stage")`` hands it):

- ``h + tanh(h @ w1) @ w2`` at P 4 and M 1, 2, 4 and 8, the mean square
  loss: the loss within rtol 1e-6, the gradients rtol 1e-4 / atol 1e-5
  (``tests/test_pipeline.py``'s limits). The stage and its scales are
  ``tutorial/pipeline_moe.py``'s (``[D, D]`` weights, 0.4). At
  ``tests/test_pipeline.py``'s wider stage (``[D, 2D]``, 0.5; gradients up
  to 5.5) f32 reassociation alone parts two frameworks past atol 1e-5:
  there JAX's own f32 gradients lie 3.06e-5 from float64, PyTorch's dense
  f32 ones 2.48e-5, and the two 5.39e-5 from each other;
- data 2 x stage 4, the gradients averaged over data only: rtol 2e-5 /
  atol 2e-6;
- the eps-guarded division stage: every gradient finite and equal to JAX's
  (loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5);
- a batch that M does not divide, refused in JAX's words;
- two encoder blocks of ``tests/_torch_vit_tiny.py``'s widths, one a
  stage, against JAX's ``EncoderBlock`` through ``pipeline_apply``, the
  weights carried by ``from_jax_variables``.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_train_worker import run_ranks
from _torch_zoo import numpy_variables, shapes
from distribuuuu_tpu.models.vit import EncoderBlock as JaxBlock
from distribuuuu_tpu.models.vit import ViT as JaxViT
from distribuuuu_tpu.parallel import pipeline_apply as jax_pipeline
from distribuuuu_tpu.runtime import create_mesh
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.parallel import pipeline_apply

WORKER = Path(__file__).with_name("_torch_parallel_worker.py")
D, STAGES, BATCH, MICRO = 16, 4, 16, [1, 2, 4, 8]
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
VIT_B, VIT_L = 4, 8  # tokens [B, L, dim]
# tests/_torch_vit_tiny.py's widths, copied: importing that module would
# register ``vit_tiny`` in the port's registry of every worker that collects
# this file, which the registry tests read
TINY = dict(patch=8, dim=32, depth=2, num_heads=2, mlp_dim=64)


def jax_mlp(p, h):
    return h + jnp.tanh(h @ p["w1"]) @ p["w2"]


def jax_div(p, h):
    h2 = jnp.tanh(h @ p["w1"]) @ p["w2"]
    return h + h2 / jnp.sqrt(jnp.mean(h2 * h2, axis=-1, keepdims=True) + 1e-4)


def _vit_variables():
    v = numpy_variables(shapes(JaxViT(dtype=jnp.float32, num_classes=5, **TINY), 16), seed=3)
    return {"params": {k: v["params"][k] for k in ("block0", "block1")}}


def _inputs():
    rng = np.random.default_rng(0)
    inputs = {"pp/x": rng.standard_normal((BATCH, D)),
              "pp/y": 0.5 * rng.standard_normal((BATCH, D)),
              "pp/w1": 0.4 * rng.standard_normal((STAGES, D, D)),
              "pp/w2": 0.4 * rng.standard_normal((STAGES, D, D)),
              "vit/x": rng.standard_normal((VIT_B, VIT_L, TINY["dim"])),
              "vit/y": rng.standard_normal((VIT_B, VIT_L, TINY["dim"]))}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    inputs.update({f"vit/{k}": t.numpy() for k, t in
                   from_jax_variables(_vit_variables(), "vit_b16").items()})
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    spec = dict(world=8, inputs=str(tmp / "in.npz"), jobs=["pp", "pp_data", "pp_vit"],
                micro=MICRO, vit=TINY)
    return inputs, run_ranks(spec, tmp / "ranks", deadline_s=120, worker=WORKER)


def _jax_run(stage_fn, params, x, y, m, p=STAGES):
    mesh = create_mesh({"stage": p}, devices=jax.devices()[:p])

    def body(params_local, x, y):
        params_local = jax.tree.map(lambda a: a[0], params_local)

        def loss_fn(q):
            out = jax_pipeline(q, x, stage_fn, num_microbatches=m, axis_name="stage")
            return jnp.mean((out - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params_local)
        return loss, jax.tree.map(lambda g: g[None], grads)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("stage"), P(), P()),
                               out_specs=(P(), P("stage")), check_vma=False))
    loss, grads = fn(params, jnp.asarray(x), jnp.asarray(y))
    return float(loss), jax.tree.map(np.asarray, grads)


def _stacked(ranks, prefix, key):
    """Stage s's gradient from rank s (data row 0), stacked ``[4, ...]``."""
    return np.stack([ranks[s][f"{prefix}/{key}"] for s in range(STAGES)])


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_equals_jax(runs, m):
    inputs, ranks = runs
    params = {k: jnp.asarray(inputs[f"pp/{k}"]) for k in ("w1", "w2")}
    loss, grads = _jax_run(jax_mlp, params, inputs["pp/x"], inputs["pp/y"], m)
    for r in ranks:  # every member holds the loss; data row 1 repeats row 0
        np.testing.assert_allclose(float(r[f"pp{m}/loss"]), loss, rtol=1e-6)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(_stacked(ranks, f"pp{m}", k), grads[k], **GRAD_TOL,
                                   err_msg=k)
        np.testing.assert_array_equal(_stacked(ranks[STAGES:], f"pp{m}", k),
                                      _stacked(ranks, f"pp{m}", k))


def test_pipeline_with_data_axis_equals_jax(runs):
    """data 2 x stage 4: the batch split over data, the gradients averaged
    over data only (the stage parameters are not replicas)."""
    inputs, ranks = runs
    mesh = create_mesh({"data": 2, "stage": STAGES})
    params = {k: jnp.asarray(inputs[f"pp/{k}"])[None] for k in ("w1", "w2")}

    def body(params_local, x_local, y_local):
        params_local = jax.tree.map(lambda a: a[0, 0], params_local)

        def loss_fn(p):
            out = jax_pipeline(p, x_local, jax_mlp, num_microbatches=4, axis_name="stage")
            return jnp.mean((out - y_local) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params_local)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "data"), grads)
        return jax.lax.pmean(loss, "data"), jax.tree.map(lambda g: g[None, None], grads)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(None, "stage"), P("data"),
                                                          P("data")),
                               out_specs=(P(), P(None, "stage")), check_vma=False))
    loss, grads = fn(params, jnp.asarray(inputs["pp/x"]), jnp.asarray(inputs["pp/y"]))
    np.testing.assert_allclose(float(ranks[0]["ppd/loss"]), float(loss), rtol=1e-6)
    for k in ("w1", "w2"):
        for row in (ranks[:STAGES], ranks[STAGES:]):
            np.testing.assert_allclose(_stacked(row, "ppd", k), np.asarray(grads[k])[0],
                                       rtol=2e-5, atol=2e-6, err_msg=k)


def test_division_stage_gradients_finite_and_equal_jax(runs):
    """JAX's NaN-gradient regression (``test_pipeline_division_stage_grads_finite``):
    a pipeline of eps-guarded division stages gives finite gradients equal
    to JAX's, which runs them on zero activations in the bubble."""
    inputs, ranks = runs
    params = {k: jnp.asarray(inputs[f"pp/{k}"]) for k in ("w1", "w2")}
    loss, grads = _jax_run(jax_div, params, inputs["pp/x"][:8], inputs["pp/y"][:8], 4)
    np.testing.assert_allclose(float(ranks[0]["div/loss"]), loss, rtol=1e-5)
    for k in ("w1", "w2"):
        got = _stacked(ranks, "div", k)
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, grads[k], **GRAD_TOL, err_msg=k)


def test_bad_microbatching_refused_in_jax_words(runs):
    _, ranks = runs
    mesh = create_mesh({"stage": STAGES}, devices=jax.devices()[:STAGES])
    f = jax.shard_map(functools.partial(jax_pipeline, stage_fn=jax_mlp, num_microbatches=4),
                      mesh=mesh, in_specs=(P("stage"), P()), out_specs=P(), check_vma=False)
    params = {k: jnp.zeros((STAGES, D, D)) for k in ("w1", "w2")}
    with pytest.raises(ValueError) as want:
        f(params, jnp.zeros((10, D)))
    assert all(str(r["refusal"]) == str(want.value) for r in ranks)


def test_single_stage_runs_the_microbatches_in_turn():
    """One process (no group): P 1, the microbatches in turn, as JAX's
    size-1 axis; gradients as the plain function's."""
    rng = np.random.default_rng(1)
    p = {k: torch.from_numpy(0.5 * rng.standard_normal(s).astype(np.float32)).requires_grad_()
         for k, s in (("w1", (D, D)), ("w2", (D, D)))}
    x = torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32))

    def fn(q, h):
        return h + torch.tanh(h @ q["w1"]) @ q["w2"]

    out = pipeline_apply(p, x, fn, num_microbatches=4, group=None)
    torch.testing.assert_close(out, fn(p, x), rtol=1e-6, atol=1e-6)
    g = torch.autograd.grad(out.square().mean(), list(p.values()))
    want = torch.autograd.grad(fn(p, x).square().mean(), list(p.values()))
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_vit_block_pipeline_equals_jax(runs):
    """Two encoder blocks (dim 32, 2 heads, MLP 64), one a stage, M 2, f32:
    the loss and every block parameter's gradient against JAX's blocks
    through ``pipeline_apply``, mapped to the port's names by
    ``from_jax_variables``."""
    inputs, ranks = runs
    v = _vit_variables()
    block = JaxBlock(num_heads=TINY["num_heads"], mlp_dim=TINY["mlp_dim"], dtype=jnp.float32)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), v["params"]["block0"],
                           v["params"]["block1"])
    loss, grads = _jax_run(lambda q, h: block.apply({"params": q}, h), stacked,
                           inputs["vit/x"], inputs["vit/y"], 2, p=2)
    want = from_jax_variables({"params": {f"block{s}": jax.tree.map(lambda g: g[s], grads)
                                          for s in range(2)}}, "vit_b16")
    for r in ranks:
        np.testing.assert_allclose(float(r["vit/loss"]), loss, rtol=1e-6)
    for name, w in want.items():
        s = int(name.split(".")[2].removeprefix("encoder_layer_"))
        np.testing.assert_allclose(ranks[s][f"vit/grad/{name}"], w.numpy(), **GRAD_TOL,
                                   err_msg=name)
