"""The port's class-parallel head, collectives and ``create_mesh`` against the JAX package's.

8 JAX-free gloo ranks of ``tests/_torch_parallel_worker.py`` (one run for
the module) against JAX under ``shard_map`` on the CPU mesh, jitted:

- ``column_parallel_logits`` + ``tp_cross_entropy`` at model 4 (C 24, 6
  classes a member; the labels are each member's first and last class),
  smoothing 0 and 0.1: the per-example loss within rtol 1e-5 / atol 1e-6,
  the gradients of x, kernel and bias within rtol 1e-4 / atol 1e-6
  (``tests/test_tensor_parallel.py``'s limits), and the same against the
  replicated ``F.cross_entropy``;
- three SGD steps of ``test_tp_head_trains_on_2d_mesh``'s data 2 x model 4
  against JAX's (rtol 1e-4 / atol 1e-6);
- ``scaled_all_reduce`` and ``pmean_tree`` over a 4-rank group against
  JAX's ``pmean``, ``barrier`` on 8 ranks, and all three in one process;
- ``create_mesh``'s groups against JAX's device layout, its errors against
  JAX's words.

JAX's outside-grad canary (``test_tp_outside_grad_is_unsupported_canary``)
pins a transpose quirk of ``shard_map``; the port has no ``shard_map``,
so it has no counterpart and the mis-scaling is not reproduced.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from _torch_train_worker import run_ranks
from distribuuuu_tpu.parallel import column_parallel_logits as jax_logits
from distribuuuu_tpu.parallel import scaled_all_reduce as jax_sar
from distribuuuu_tpu.parallel import tp_cross_entropy as jax_ce
from distribuuuu_tpu.runtime import create_mesh as jax_mesh
from distribuuuu_tpu_torch.parallel import barrier, pmean_tree, scaled_all_reduce
from distribuuuu_tpu_torch.runtime.mesh import create_mesh, mesh_shape

WORKER = Path(__file__).with_name("_torch_parallel_worker.py")
B, D, C, MODEL = 8, 16, 24, 4
SMOOTHS = [0.0, 0.1]
LOSS_TOL, GRAD_TOL = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-6)
MESHES = [{"data": 2, "model": 4}, {"data": -1, "stage": 4}, {"a": 2, "b": 2, "c": 2}]
STEPS, LR = 3, 0.3


def _inputs():
    rng = np.random.default_rng(0)
    inputs = {"tp/x": rng.standard_normal((B, D)), "tp/w": rng.standard_normal((D, C)) * 0.1,
              "tp/b": rng.standard_normal(C) * 0.1}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    # each member's first and last class
    inputs["tp/labels"] = np.array([r * (C // MODEL) + e for r in range(MODEL)
                                    for e in (0, C // MODEL - 1)], np.int64)
    for k in range(STEPS):
        inputs[f"tp2d/x{k}"] = rng.standard_normal((B, D)).astype(np.float32)
        inputs[f"tp2d/y{k}"] = rng.integers(0, C, B).astype(np.int64)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    spec = dict(world=8, inputs=str(tmp / "in.npz"), meshes=MESHES, smooths=SMOOTHS,
                jobs=["tp", "tp2d", "collectives"], sgd_steps=STEPS, lr=LR)
    return inputs, run_ranks(spec, tmp / "ranks", deadline_s=120, worker=WORKER)


def _jax_head(inputs, smooth):
    mesh = jax_mesh({"model": MODEL}, devices=jax.devices()[:MODEL])
    labels = jnp.asarray(inputs["tp/labels"], jnp.int32)

    def body(x, w, b):
        def loss_fn(args):
            per_ex = jax_ce(jax_logits(*args), labels, axis_name="model", label_smooth=smooth)
            return jnp.mean(per_ex), per_ex
        (_, per_ex), g = jax.value_and_grad(loss_fn, has_aux=True)((x, w, b))
        return per_ex, *g

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P(None, "model"), P("model")),
                               out_specs=(P(), P(), P(None, "model"), P("model")),
                               check_vma=False))
    return [np.asarray(a) for a in fn(*(jnp.asarray(inputs[f"tp/{k}"]) for k in "xwb"))]


def _port_head(ranks, smooth):
    """Data row 0 (ranks 0-3) of the port: the loss and dx of rank 0, the
    kernel and bias shards concatenated by model rank."""
    row = ranks[:MODEL]
    return [row[0][f"tp{smooth}/loss"], row[0][f"tp{smooth}/dx"],
            np.concatenate([r[f"tp{smooth}/dw"] for r in row], axis=1),
            np.concatenate([r[f"tp{smooth}/db"] for r in row])]


@pytest.mark.parametrize("smooth", SMOOTHS)
def test_tp_head_loss_and_gradients_equal_jax(runs, smooth):
    inputs, ranks = runs
    want = _jax_head(inputs, smooth)
    got = _port_head(ranks, smooth)
    for name, g, w in zip(("loss", "dx", "dw", "db"), got, want):
        np.testing.assert_allclose(g, w, **(LOSS_TOL if name == "loss" else GRAD_TOL),
                                   err_msg=name)
    for r in ranks[1:]:  # the loss and dx are whole on every rank
        np.testing.assert_array_equal(r[f"tp{smooth}/loss"], got[0])
        np.testing.assert_array_equal(r[f"tp{smooth}/dx"], got[1])


@pytest.mark.parametrize("smooth", SMOOTHS)
def test_tp_head_equals_replicated_cross_entropy(runs, smooth):
    """The same against the replicated head: ``F.cross_entropy`` with
    ``label_smoothing``, every shard's edge classes among the labels."""
    inputs, ranks = runs
    x, w, b = (torch.from_numpy(inputs[f"tp/{k}"]).requires_grad_() for k in "xwb")
    loss = F.cross_entropy(x @ w + b, torch.from_numpy(inputs["tp/labels"]), reduction="none",
                           label_smoothing=smooth)
    loss.mean().backward()
    want = [loss.detach(), x.grad, w.grad, b.grad]
    for name, g, wt in zip(("loss", "dx", "dw", "db"), _port_head(ranks, smooth), want):
        np.testing.assert_allclose(g, wt.numpy(), **(LOSS_TOL if name == "loss" else GRAD_TOL),
                                   err_msg=name)


def test_three_sgd_steps_on_2d_mesh_equal_jax(runs):
    """``test_tp_head_trains_on_2d_mesh``'s step, three times: the batch
    split over data, the local mean loss, the gradients ``pmean``-ed over
    data."""
    inputs, ranks = runs
    mesh = jax_mesh({"data": 2, "model": MODEL})

    def step(x, w, b, labels):
        def loss_fn(wb):
            return jnp.mean(jax_ce(jax_logits(x, *wb), labels, axis_name="model"))
        loss, (gw, gb) = jax.value_and_grad(loss_fn)((w, b))
        gw, gb = jax.lax.pmean(gw, "data"), jax.lax.pmean(gb, "data")
        return w - LR * gw, b - LR * gb, jax.lax.pmean(loss, "data")

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("data"), P(None, "model"),
                                                          P("model"), P("data")),
                               out_specs=(P(None, "model"), P("model"), P()), check_vma=False))
    w, b, losses = jnp.asarray(inputs["tp/w"]), jnp.asarray(inputs["tp/b"]), []
    for k in range(STEPS):
        w, b, loss = fn(jnp.asarray(inputs[f"tp2d/x{k}"]), w, b,
                        jnp.asarray(inputs[f"tp2d/y{k}"], jnp.int32))
        losses.append(loss)
    row = ranks[:MODEL]
    np.testing.assert_allclose(row[0]["tp2d/loss"], np.stack(losses), **LOSS_TOL)
    np.testing.assert_allclose(np.concatenate([r["tp2d/w"] for r in row], axis=1), np.asarray(w),
                               **GRAD_TOL)
    np.testing.assert_allclose(np.concatenate([r["tp2d/b"] for r in row]), np.asarray(b),
                               **GRAD_TOL)
    for r0, r1 in zip(row, ranks[MODEL:]):  # data row 1 holds the same shards
        np.testing.assert_array_equal(r1["tp2d/w"], r0["tp2d/w"])


def test_collectives_over_four_ranks_equal_jax_pmean(runs):
    """Each rank's ``[rank, 2 rank]`` averaged over its model group (ranks
    0-3 and 4-7) against JAX's ``scaled_all_reduce`` on 4 devices, and a
    nested tree averaged leaf by leaf."""
    _, ranks = runs
    mesh = jax_mesh({"model": MODEL}, devices=jax.devices()[:MODEL])
    sar = jax.jit(jax.shard_map(lambda v: jax_sar([v], "model")[0], mesh=mesh,
                                in_specs=P("model"), out_specs=P("model"), check_vma=False))
    for base in (0, MODEL):
        members = np.arange(base, base + MODEL, dtype=np.float64)
        want = np.asarray(sar(np.stack([members, 2 * members], 1).astype(np.float32)))
        for r in ranks[base:base + MODEL]:
            np.testing.assert_allclose(r["sar"], want[0], rtol=1e-6)
            np.testing.assert_allclose(r["tree"], [members.mean(), *[np.mean(members ** 2)] * 2,
                                                   -members.mean()], rtol=1e-6)


def test_collectives_in_one_process_do_nothing():
    """World 1 (no process group), JAX's ``axis_size == 1`` gate: the
    tensors come back as they are and the barrier returns."""
    a, b = torch.ones(3), torch.arange(2.0)
    assert all(x is y for x, y in zip(scaled_all_reduce([a, b]), [a, b]))
    tree = pmean_tree({"a": a, "b": [b]})
    assert tree["a"] is a and tree["b"][0] is b
    barrier("one process")
    mesh = create_mesh({"data": -1, "model": 1}, 1, 0)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {"data": None, "model": None}


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_create_mesh_groups_follow_jax_layout(runs, i):
    """Each rank's group along each axis is the row of JAX's device array
    through that rank; its coords are its index there."""
    _, ranks = runs
    jm = jax_mesh(MESHES[i])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert tuple(mesh_shape(MESHES[i], 8).values()) == ids.shape
    for rank, r in enumerate(ranks):
        where = np.argwhere(ids == rank)[0]
        np.testing.assert_array_equal(r[f"mesh{i}/coords"], where)
        for dim, axis in enumerate(jm.axis_names):
            index = list(where)
            index[dim] = slice(None)
            np.testing.assert_array_equal(r[f"mesh{i}/{axis}"], ids[tuple(index)])


@pytest.mark.parametrize("axes", [{"a": -1, "b": -1}, {"data": 3, "model": -1},
                                  {"data": 2, "model": 2}])
def test_create_mesh_errors_in_jax_words(axes):
    with pytest.raises(ValueError) as want:
        jax_mesh(axes)
    with pytest.raises(ValueError) as got:
        create_mesh(axes, 8, 0)
    assert str(got.value) == str(want.value)
