"""The port's fsdp (``parallel/fsdp.py``, ``runtime/mesh.py``, ``TrainState`` under a mesh) against the JAX package's.

- The partition rule and the census, leaf for leaf, against JAX's
  ``partition_spec``/``census`` for every parameter of ViT-L/16 and
  ResNet-50 at 224^2 (shapes only: ``jax.eval_shape`` and the port on the
  meta device), at fsdp 2, 4 and 8 and ``MESH.FSDP_MIN_SIZE`` 16384 and
  1024. Each JAX leaf reaches its port key through ``convert`` (a small
  array of the leaf's rank: the key and the axis order), so the test holds
  the port's reading of each JAX shape too.
- Each rank's shard of ResNet-18, through ``convert``'s layout, bitwise
  JAX's ``addressable_shards`` on a CPU mesh (fsdp 2, ``MIN_SIZE`` 1).
- The mesh sizes (``MESH.DATA`` x ``MESH.FSDP`` must be the world) as
  JAX's ``data_mesh`` resolves them.
- The port's fsdp run on gloo ranks of ``tests/_torch_train_worker.py``
  (against JAX's fsdp step: tests/test_torch_fsdp_jax.py), a ResNet-18 at
  32^2 with ``MIN_SIZE`` 1 and SGD and a narrow ViT
  (``tests/_torch_vit_tiny.py``) with ``MIN_SIZE`` 1024 (a mix of sharded
  and replicated leaves) and LAMB, against its own replicated run at the same global
  batch (fsdp 2 against data 2: bitwise with SGD; LAMB within
  tests/test_fsdp.py's limits, the loss rtol 1e-3 / atol 1e-5 and the
  parameters rtol 1e-3 / atol 2e-5, its norms summed from the shards).
- The guard: a NaN in one rank's gradient, in a slot of the other rank's
  shard, skips the step on both ranks, which stay bitwise where they were.
- LAMB's f32 step on a segment of ViT-B's MLP size (2.4 M elements) lies
  within 3e-5 (relative L2) of its float64 step: 1.26e-5 measured with the
  norms accumulated in float64, 4.6e-4 with an f32 running sum (the cause
  of [mae f32]'s card-vs-CPU gap, ``scripts/torch_mae_lamb_numerics.py``).
- ``train_net`` on 2 gloo ranks at fsdp 2 preempted in epoch 2 resumes at
  fsdp 2 bitwise equal to an uninterrupted run and at fsdp 1 (data 2)
  within the limits, from the checkpoint's replicated layout.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from _torch_train_worker import launch_train_net, reap, run_ranks
from _torch_zoo import shapes
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.parallel import fsdp as jax_fsdp
from distribuuuu_tpu.runtime import data_mesh as jax_data_mesh
from distribuuuu_tpu.trainer import create_train_state
from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.parallel import fsdp
from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port
from distribuuuu_tpu_torch.runtime.mesh import mesh_sizes
from distribuuuu_tpu_torch.trainer import TrainState, _aligned_offsets, build_cfg_model

torch.set_num_threads(2)  # the suite runs several test workers on one host

LOSS_TOL = dict(rtol=1e-3, atol=1e-5)  # tests/test_fsdp.py's
PARAM_TOL = dict(rtol=1e-3, atol=2e-5)
ROOT = Path(__file__).resolve().parents[1]
_TINY = (2, 3, 5, 7)  # distinct extents: where each JAX axis lands in torch's layout


def _port_keys(tree, arch: str) -> dict:
    """Each JAX parameter leaf's port key, its JAX shape and, for each
    torch dimension, the JAX dimension it is: ``convert`` applied to the
    leaf alone, as an array of its rank with distinct extents."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        one = np.zeros(_TINY[:len(leaf.shape)], np.float32)
        for k in reversed(path):
            one = {k.key: one}
        (key, t), = from_jax_variables({"params": one}, arch).items()
        out[key] = (tuple(leaf.shape), tuple(_TINY.index(e) for e in t.shape))
    return out


_SHAPES: dict = {}


def _jax_params(arch: str):
    if arch not in _SHAPES:
        _SHAPES[arch] = shapes(jax_build_model(arch, num_classes=1000), 224)["params"]
    return _SHAPES[arch]


@pytest.mark.parametrize("min_size", [16384, 1024])
@pytest.mark.parametrize("f", [2, 4, 8])
@pytest.mark.parametrize("arch", ["vit_l16", "resnet50"])
def test_rule_and_census_equal_jax_leaf_for_leaf(arch, f, min_size):
    tree = _jax_params(arch)
    with torch.device("meta"):
        port = dict(build_model(arch, num_classes=1000, im_size=224).named_parameters())
    keys = _port_keys(tree, arch)
    assert set(keys) == set(port)
    for key, (jshape, axes) in keys.items():
        # the port reads this leaf's JAX shape back from its own parameter
        got_shape, perm = fsdp.jax_layout(key, port[key].shape)
        assert got_shape == jshape and perm == tuple(axes.index(j) for j in range(len(axes))), key
        jdim = jax_fsdp.fsdp_dim(jax_fsdp.partition_spec(jshape, f, min_size))
        want = None if jdim is None else axes.index(jdim)
        assert fsdp.shard_dim(key, port[key].shape, f, min_size) == want, (key, jshape)
    want = jax_fsdp.census(tree, jax_fsdp.tree_specs(tree, f, min_size))
    assert fsdp.census(port.items(), f, min_size) == want
    if (arch, min_size) in (("vit_l16", 16384), ("resnet50", 16384)):
        # the issue's numbers: ViT-L/16 99 / 197 leaves, ResNet-50 52 / 109
        sharded = {"vit_l16": (99, 1_216_008_192), "resnet50": (52, 101_957_632)}[arch]
        assert (want["sharded_leaves"], want["sharded_bytes"]) == sharded
        if arch == "resnet50":  # the stem conv (9408 elements) stays replicated
            assert fsdp.shard_dim("conv1.weight", port["conv1.weight"].shape, f) is None


def test_each_rank_shard_is_jax_addressable_shard_bitwise(fresh_cfg):
    """ResNet-18 at fsdp 2, MIN_SIZE 1: JAX's committed state, each device's
    shard of every parameter through ``convert``, against the port's
    ``ShardLayout.take`` of the same weights on each rank."""
    fresh_cfg.MESH.FSDP, fresh_cfg.MESH.FSDP_MIN_SIZE = 2, 1
    mesh = jax_data_mesh(1, 2)
    model = jax_build_model("resnet18", num_classes=10, dtype=jnp.float32)
    state, _ = create_train_state(model, jax.random.PRNGKey(3), mesh, 32)
    full = from_jax_variables({"params": jax.tree.map(np.array, state.params)}, "resnet18")
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "resnet18", 10, "float32"
    port = build_cfg_model()
    port.load_state_dict(full, strict=False)
    named = list(port.named_parameters())
    offsets, _ = _aligned_offsets([p for _, p in named])
    flat = TrainState(port).params
    specs = jax_fsdp.specs_of(state).params
    for r in range(2):
        def shard_r(a, spec):
            d = jax_fsdp.fsdp_dim(spec)
            if d is None:
                return np.array(a)
            size = a.shape[d] // 2
            return np.array(next(s.data for s in a.addressable_shards
                                 if (s.index[d].start or 0) == r * size))
        jax_shard = from_jax_variables(
            {"params": jax.tree.map(shard_r, state.params, specs,
                                    is_leaf=lambda x: isinstance(x, P))}, "resnet18")
        lay = fsdp.ShardLayout([(n, p.shape) for n, p in named], offsets, 2, r, min_size=1)
        mine = lay.local(lay.take(flat))
        for name, _ in named:
            assert torch.equal(mine[name], jax_shard[name]), (r, name)
    assert len(lay.sharded_leaves) == sum(jax_fsdp.fsdp_dim(s) is not None for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P))) > 0


@pytest.mark.parametrize("data,f", [(-1, -1), (-1, 1), (-1, 0), (2, -1), (-1, 2), (2, 4),
                                    (4, 2), (1, 8)])
def test_mesh_sizes_resolve_as_jax_data_mesh(data, f):
    """The wildcards as JAX's ``data_mesh`` resolves them over the CPU
    mesh's devices (the world here)."""
    world = jax.device_count()
    got = dict(jax_data_mesh(data, f).shape)
    assert mesh_sizes(data, f, world) == (got["data"], got.get("fsdp", 1))


@pytest.mark.parametrize("data,f,world,error", [
    (2, 1, 8, "needs 2 processes, the run has 8"), (1, 2, 1, "needs 2 processes, the run has 1"),
    (3, -1, 8, "do not divide"), (4, 4, 8, "needs 16 processes")])
def test_mesh_sizes_other_than_the_world_raise(data, f, world, error):
    """JAX builds a submesh below the device count and leaves devices idle;
    a process of the run cannot idle, so the port raises naming the sizes."""
    with pytest.raises(ValueError, match=rf"MESH.DATA={data} x MESH.FSDP={f}.*{error}"):
        mesh_sizes(data, f, world)


# ---------------------------------------------------------------------------
# gloo ranks (against JAX's fsdp step: tests/test_torch_fsdp_jax.py)
# ---------------------------------------------------------------------------


@pytest.fixture()
def vit_tiny():
    """``tests/_torch_vit_tiny.py``, whose import registers ``vit_tiny`` in
    the port, for the test alone: the registry and the module forgotten
    after it, so that no later test in this process sees an arch the zoo
    does not have."""
    import importlib
    import sys

    from distribuuuu_tpu_torch.models import registry

    yield importlib.import_module("_torch_vit_tiny")
    registry._REGISTRY.pop("vit_tiny", None)
    sys.modules.pop("_torch_vit_tiny", None)


K, BATCH, IM, CLASSES = 3, 8, 32, 10
MODELS = {  # arch: (MESH.FSDP_MIN_SIZE, optimizer, learning rates)
    "resnet18": (1, "sgd", [0.02, 0.04, 0.06]),
    "vit_tiny": (1024, "lamb", [1e-3, 1e-3, 1e-3]),
}


def _batches():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 256, (K, BATCH, IM, IM, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, (K, BATCH)).astype(np.int32))


def _spec(arch, data, f, world, inputs, **extra):
    min_size, opt, _ = MODELS[arch]
    return dict(world=world, threads=1, timeout_s=100, arch=arch, classes=CLASSES, syncbn=True,
                accum=1, data=data, fsdp=f, min_size=min_size, optimizer=opt,
                module="_torch_vit_tiny", gapless=True, inputs=str(inputs), **extra)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_fsdp_equals_the_ports_replicated_run(tmp_path, arch, vit_tiny):
    """fsdp 2 against data 2 on 2 gloo ranks, 3 free-running steps from one
    state: the loss, the parameters and the optimizer state in the
    replicated layout. SGD's reductions are the same sums of two terms
    (bitwise); LAMB's norms of a sharded leaf sum the shards' squares."""
    images, labels = _batches()
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = arch, CLASSES, IM
    sd = build_cfg_model(torch.Generator().manual_seed(4)).state_dict()
    reset_cfg()
    np.savez(tmp_path / "in.npz", image=images, label=labels,
             lr=np.array(MODELS[arch][2], np.float32), **{f"s0/{n}": t.numpy() for n, t in sd.items()})
    runs = {name: run_ranks(_spec(arch, data, f, 2, tmp_path / "in.npz"), tmp_path / name,
                            deadline_s=150)[0]
            for name, data, f in (("dp", 2, 1), ("fsdp", 1, 2))}
    (tmp_path / "in.npz").unlink()
    for key in runs["dp"]:
        a, b = runs["dp"][key], runs["fsdp"][key]
        if MODELS[arch][1] == "sgd":
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, **(LOSS_TOL if key.startswith("loss") else
                                                PARAM_TOL), err_msg=key)


def test_nan_in_one_ranks_shard_skips_the_step_on_every_rank(tmp_path, vit_tiny):
    """Rank 1's gradient gets a NaN in a slot of rank 0's shard (step 1):
    after the reduce-scatter only rank 0's shard holds it, and the flag's
    all-reduce makes both ranks skip; both stay bitwise at step 0's state."""
    images, labels = _batches()
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = "vit_tiny", CLASSES, IM
    sd = build_cfg_model(torch.Generator().manual_seed(4)).state_dict()
    reset_cfg()
    np.savez(tmp_path / "in.npz", image=images, label=labels,
             lr=np.array(MODELS["vit_tiny"][2], np.float32),
             **{f"s0/{n}": t.numpy() for n, t in sd.items()})
    ranks = run_ranks(_spec("vit_tiny", 1, 2, 2, tmp_path / "in.npz", nan=[1, 1]), tmp_path / "r",
                      deadline_s=150)
    for res in ranks:
        assert [float(res[f"s{k}"]) for k in range(K)] == [0.0, 1.0, 0.0]
        np.testing.assert_array_equal(res["w1"], res["w0"])
        assert int(res["count"]) == 2 and np.isfinite(res["w2"]).all()
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)


def test_lamb_f32_step_of_a_large_segment_is_within_f32_rounding_of_float64():
    from distribuuuu_tpu_torch import optim

    gen = torch.Generator().manual_seed(0)
    n = 768 * 3072  # ViT-B's MLP weight
    p = torch.randn(n + 768, generator=gen, dtype=torch.float64) * 0.023
    g = torch.randn(n + 768, generator=gen, dtype=torch.float64) * 2e-3
    segments = [(0, n, 2), (n, 768, 1)]

    def update(dtype):
        q = p.to(dtype)
        lamb = optim.LAMB(q, segments, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.05)
        before = q.clone()
        lamb.step(q, g.to(dtype), 2e-3)
        return (q - before).double()

    u32, u64 = update(torch.float32), update(torch.float64)
    assert float((u32 - u64).norm() / u64.norm()) <= 3e-5


# ---------------------------------------------------------------------------
# train_net at fsdp 2: preempted, resumed at fsdp 2 and at fsdp 1
# ---------------------------------------------------------------------------

RUN = ["--cfg", str(ROOT / "config" / "resnet18.yaml"), "MODEL.NUM_CLASSES", "10",
       "MODEL.DUMMY_INPUT", "True", "TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "32",
       "TEST.CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
       "TRAIN.DUMMY_EPOCH_SAMPLES", "24", "TRAIN.PRINT_FREQ", "1", "RNG_SEED", "5",
       "OPTIM.MAX_EPOCH", "2", "OPTIM.WARMUP_EPOCHS", "0", "OPTIM.BASE_LR", "0.01",
       "MODEL.SYNCBN", "True", "MESH.FSDP_MIN_SIZE", "1024"]


def _train_net(out: Path, *extra) -> tuple[list, str]:
    procs = launch_train_net(2, [*RUN, "OUT_DIR", str(out), *extra], out.parent /
                             f"{out.name}_logs", pick_rendezvous_port())
    rcs = reap(procs, 240)
    return rcs, (out.parent / f"{out.name}_logs" / "rank0.log").read_text()


def _losses(log: str) -> dict:
    return {(int(e), int(s)): float(v) for e, s, v in
            re.findall(r"Epoch\[(\d+)\] \[\s*(\d+)/\d+\].*?Loss (\S+) \(", log)}


def _final(out: Path) -> dict:
    return torch.load(out / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt", weights_only=True)


def test_train_net_preempted_at_fsdp2_resumes_at_fsdp2_and_fsdp1(tmp_path):
    import shutil

    rcs, whole_log = _train_net(tmp_path / "whole", "MESH.FSDP", "2")
    assert rcs == [0, 0], whole_log[-3000:]
    assert "fsdp=2: params " in whole_log and "Mesh: data 1 x fsdp 2" in whole_log
    rcs, log = _train_net(tmp_path / "pre", "MESH.FSDP", "2", "FAULT.INJECT_PREEMPT_STEP", "4")
    assert rcs == [143, 143], log[-3000:]
    mid = tmp_path / "pre" / "checkpoints" / "ckpt_mid_ep_001_it_000001"
    assert ckpt.verify_checkpoint(str(mid)) == ("ok", [])
    shutil.copytree(tmp_path / "pre", tmp_path / "pre1")
    want = _final(tmp_path / "whole")
    whole = _losses(whole_log)
    for out, mesh in ((tmp_path / "pre", "2"), (tmp_path / "pre1", "1")):
        rcs, log = _train_net(out, "MESH.FSDP", mesh)
        assert rcs == [0, 0], log[-3000:]
        assert re.search(r"Resumed from \S+ckpt_mid_ep_001_it_000001 \(epoch 1, step 1,", log)
        got = _final(out)
        tail = _losses(log)
        assert sorted(tail) == [(1, s) for s in range(1, 3)]
        for part in ("model", "optimizer"):
            for k in want[part]:
                if mesh == "2":
                    assert torch.equal(got[part][k], want[part][k]), (part, k)
                else:
                    np.testing.assert_allclose(got[part][k].numpy(), want[part][k].numpy(),
                                               **PARAM_TOL, err_msg=k)
        np.testing.assert_allclose([tail[s] for s in sorted(tail)],
                                   [whole[s] for s in sorted(tail)],
                                   **({} if mesh == "2" else LOSS_TOL))
    for out in ("whole", "pre", "pre1"):  # ~1 GB of ResNet-18 checkpoints
        shutil.rmtree(tmp_path / out)
