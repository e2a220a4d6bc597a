"""The port's sequence parallelism on gloo ranks against the JAX package's on a CPU mesh.

- Ring and Ulysses attention at 2 and 4 ranks, causal or not, f32 and
  bf16 (``tests/_torch_seq_worker.py``): the output and the gradients of
  ``sum(out * g)`` against JAX's ``ring_attention``/``ulysses_attention``
  under ``shard_map`` with ``jax.grad``, within JAX's own limits
  (``tests/test_ring_attention.py``, ``tests/test_ulysses.py``): the
  forward 2e-5 in f32 and 5e-2 in bf16, the gradients rtol 2e-4 / atol
  2e-5 in f32 (bf16: the forward's 5e-2; JAX holds none).
- The ``pool='gap'`` ViT classifier at seq 2, ring and Ulysses, against
  JAX's under ``shard_map``: the logits rtol/atol 1e-5, the gradients
  summed over the group rtol 2e-4 / atol 1e-6 (``tests/test_seq_parallel.py``).
- Three MAE LAMB steps at seq 2 (ring, 2 ranks) and at fsdp 2 x seq 2
  (Ulysses, 4 ranks) against JAX's ``make_train_step`` on ``data_mesh(1,
  f, 2)``, each step from JAX's state, JAX's mask of each batch rank handed
  to the port (``tests/_torch_train_worker.py``): the loss rtol 1e-3 /
  atol 1e-5, the parameters rtol 1e-3 / atol 2e-5
  (``tests/test_seq_parallel.py``'s limits). Every rank ends equal.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_train_worker import run_ranks
from _torch_zoo import numpy_variables, shapes
from distribuuuu_tpu.models.mae import MAEViT as JaxMAEViT
from distribuuuu_tpu.models.vit import ViT as JaxViT
from distribuuuu_tpu.parallel import fsdp as jax_fsdp
from distribuuuu_tpu.parallel.ring_attention import ring_attention
from distribuuuu_tpu.parallel.ulysses import ulysses_attention
from distribuuuu_tpu.runtime import create_mesh, data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.models.mae import MAEViT

WORKER = Path(__file__).with_name("_torch_seq_worker.py")
B, H, L, D = 2, 4, 16, 8
CASES = [(impl, causal, dtype) for impl in ("ring", "ulysses") for causal in (False, True)
         for dtype in ("float32", "bfloat16")]
FWD_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
GRAD_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
VIT = dict(patch=4, dim=16, depth=2, num_heads=2, mlp_dim=32, num_classes=5)
LOSS_TOL, PARAM_TOL = dict(rtol=1e-3, atol=1e-5), dict(rtol=1e-3, atol=2e-5)
MAE = dict(patch=4, dim=32, depth=2, num_heads=2, mlp_dim=64, decoder_dim=16)  # _torch_mae_tiny
IM, BATCH, K, LR = 16, 8, 3, 2e-3


def _name(impl, causal, dtype):
    return f"{impl}_{int(causal)}_{dtype}"


def _jax_attention(p, impl, causal, dtype, q, k, v, g):
    fn = ring_attention if impl == "ring" else ulysses_attention
    spec = P(None, None, "seq", None)
    sm = jax.shard_map(functools.partial(fn, axis_name="seq", causal=causal),
                       mesh=create_mesh({"seq": p}, devices=jax.devices()[:p]),
                       in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    args = [jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v)]
    loss = lambda *a: jnp.sum(sm(*a).astype(jnp.float32) * g)  # noqa: E731
    out, grads = jax.jit(lambda *a: (sm(*a), jax.grad(loss, argnums=(0, 1, 2))(*a)))(*args)
    return [np.asarray(t, np.float32) for t in (out, *grads)]


def _vit_inputs():
    jm = JaxViT(pool="gap", dtype=jnp.float32, **VIT)
    v = numpy_variables(shapes(jm, IM), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, IM, IM, 3)).astype(np.float32)
    return jm, v, x, np.array([1, 3], np.int32)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Each case's inputs and the port's ranks at 2 and 4 (the ViT at 2)."""
    tmp = tmp_path_factory.mktemp("seq_jax")
    rng = np.random.default_rng(0)
    inputs = {f"{_name(*c)}/{t}": rng.standard_normal((B, H, L, D)).astype(np.float32)
              for c in CASES for t in "qkvg"}
    _, v, x, y = _vit_inputs()
    inputs.update({f"vit/{n}": t.numpy() for n, t in from_jax_variables(v, "vit_b16").items()})
    inputs.update({"vit/x": x, "vit/y": y})
    np.savez(tmp / "in.npz", **inputs)
    cases = [[_name(*c), *c] for c in CASES]
    runs = {p: run_ranks(dict(world=p, inputs=str(tmp / "in.npz"), jobs=["attention"],
                              cases=cases, vit=dict(VIT, im_size=IM),
                              vit_impls=["ring", "ulysses"] if p == 2 else []),
                         tmp / f"p{p}", deadline_s=120, worker=WORKER)
            for p in (2, 4)}
    return inputs, runs


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("impl,causal,dtype", CASES)
def test_attention_forward_and_gradients_equal_jax(port_runs, p, impl, causal, dtype):
    inputs, runs = port_runs
    name = _name(impl, causal, dtype)
    want = _jax_attention(p, impl, causal, dtype, *(inputs[f"{name}/{t}"] for t in "qkvg"))
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        got = np.concatenate([r[f"{name}/{key}"] for r in runs[p]], axis=2)
        tol = FWD_TOL[dtype] if key == "o" else GRAD_TOL[dtype]
        np.testing.assert_allclose(got, w, **tol, err_msg=f"{name} {key}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gap_vit_classifier_at_seq_2_equals_jax(port_runs, impl):
    """Logits on each rank and the gradients summed over the group (each
    member's is the partial one of its tokens) against JAX's seq ViT."""
    _, runs = port_runs
    jm, v, x, y = _vit_inputs()
    seqm = JaxViT(pool="gap", dtype=jnp.float32, seq_axis="seq", seq_impl=impl, **VIT)

    def member(prms):
        def ce(q):
            logits = seqm.apply({"params": q}, jnp.asarray(x))
            return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), y]), logits
        g, logits = jax.grad(ce, has_aux=True)(prms)
        return logits, jax.lax.psum(g, "seq")

    logits, g = jax.jit(jax.shard_map(member, mesh=create_mesh({"seq": 2}, devices=jax.devices()[:2]),
                              in_specs=(P(),), out_specs=(P(), P()), check_vma=False))(v["params"])
    want = from_jax_variables({"params": jax.tree.map(np.array, g)}, "vit_b16")
    for r in runs[2]:
        np.testing.assert_allclose(r[f"{impl}/logits"], np.asarray(logits), rtol=1e-5, atol=1e-5)
    for n, w in want.items():
        got = sum(r[f"{impl}/grad/{n}"] for r in runs[2])
        np.testing.assert_allclose(got, w.numpy(), rtol=2e-4, atol=1e-6, err_msg=n)


def _jax_mask(key, n, ratio):
    mask_rng, _ = jax.random.split(key)
    return np.asarray(jax.random.bernoulli(mask_rng, ratio, (n, (IM // MAE["patch"]) ** 2)))


@pytest.mark.parametrize("f,impl", [(1, "ring"), (2, "ulysses")])
def test_three_mae_steps_at_seq_2_equal_jax(fresh_cfg, tmp_path, f, impl):
    c = fresh_cfg
    c.MODEL.DTYPE, c.OPTIM.OPTIMIZER, c.OPTIM.WEIGHT_DECAY = "float32", "lamb", 0.05
    c.TRAIN.TASK, c.MESH.FSDP_MIN_SIZE = "mae", 1024
    mesh = data_mesh(1, f, 2)
    jm = JaxMAEViT(dtype=jnp.float32, seq_axis="seq", seq_impl=impl, **MAE)
    state, tx = create_train_state(jm, jax.random.PRNGKey(0), mesh, IM)
    specs = jax_fsdp.specs_of(state) if f > 1 else None
    step = make_train_step(jm, tx, mesh, topk=5, state_specs=specs, task="mae")
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (K, BATCH, IM, IM, 3), dtype=np.uint8)
    axes = ("data", "fsdp") if f > 1 else "data"
    img_s, vec_s = NamedSharding(mesh, P(axes, None, None, None)), NamedSharding(mesh, P(axes))
    inputs = {"image": images, "label": np.zeros((K, BATCH), np.int32),
              "lr": np.full(K, LR, np.float32)}
    losses, posts = [], []
    for k in range(K):
        key = jax.random.PRNGKey(40 + k)
        v = {"params": jax.tree.map(np.array, state.params)}
        inputs.update({f"s{k}/{n}": t.numpy() for n, t in from_jax_variables(v, "mae_vit_b16")
                       .items()})
        inputs[f"m{k}"] = np.concatenate([_jax_mask(jax.random.fold_in(key, b), BATCH // f,
                                                    c.MODEL.MAE_MASK_RATIO) for b in range(f)])
        batch = {"image": jax.device_put(images[k], img_s),
                 "label": jax.device_put(np.zeros(BATCH, np.int32), vec_s)}
        state, m = step(state, batch, jnp.float32(LR), key)
        losses.append(float(m["loss_sum"] / m["n"]))
        posts.append(from_jax_variables({"params": jax.tree.map(np.array, state.params)},
                                        "mae_vit_b16"))
    np.savez(tmp_path / "in.npz", **inputs)
    spec = dict(world=2 * f, threads=1, timeout_s=100, arch="mae_vit_tiny", classes=0,
                syncbn=False, accum=1, data=1, fsdp=f, seq=2, impl=impl, task="mae", decoder=16,
                min_size=1024, optimizer="lamb", weight_decay=0.05, module="_torch_mae_tiny",
                gapless=True, inputs=str(tmp_path / "in.npz"))
    ranks = run_ranks(spec, tmp_path / "ranks", deadline_s=150)
    for key in ranks[0]:
        for other in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][key], other[key], err_msg=key)
    with torch.device("meta"):
        names = [n for n, _ in MAEViT(im_size=IM, **MAE).named_parameters()]
    for k in range(K):
        np.testing.assert_allclose(float(ranks[0][f"loss{k}"]), losses[k], **LOSS_TOL)
        want = np.concatenate([posts[k][n].numpy().reshape(-1) for n in names])
        np.testing.assert_allclose(ranks[0][f"w{k}"], want, **PARAM_TOL)
