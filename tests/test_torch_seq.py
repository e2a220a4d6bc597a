"""The port's ``MESH.SEQ``: the mesh, the pieces on gloo ranks, the refusals and ``train_net``.

- The layout: every rank's (data, fsdp, seq) indices are the position of
  device ``rank`` in JAX's ``data_mesh`` on the CPU mesh, and ``mesh_sizes``
  resolves as JAX does; ``MESH.SEQ -1``, a world that seq does not divide
  and a seq group across nodes raise.
- On 4 gloo ranks (``tests/_torch_seq_worker.py``): the groups of ``data
  1 x fsdp 2 x seq 2``, ``local_tokens`` (and its refusal of 15 tokens)
  and ``psum_partial``'s identity backward against JAX's under
  ``shard_map``, Ulysses' refusal of 3 heads in JAX's words.
- The trainer's refusals as JAX's: ``SEQ_ATTN none`` at ``MESH.SEQ 2``, a
  BN model at seq 2; a classifier ViT gets ``pool='gap'``.
- ``train_net`` (``mae_vit_b16.yaml``'s recipe on the tiny MAE of
  ``tests/_torch_mae_tiny.py``, 16^2, 2 epochs of 4 steps, in f32 as JAX's
  seq oracle: in bf16 the dense path rounds the softmax weights to bf16
  and the seq paths do not): seq 2 (ring) on
  2 ranks replays the seq-1 run's loss stream, val loss and parameters
  within ``tests/test_seq_parallel.py``'s limits (loss rtol 1e-3 / atol
  1e-5, parameters rtol 1e-3 / atol 2e-5) and its census halves
  ``l_local``, and ``test_net`` at seq 2 on its checkpoint prints its
  last val loss; a seq 2 (Ulysses) run preempted at global step 6 resumes on
  one rank at seq 1 and ends within the same limits of the uninterrupted
  run.
"""

import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_train_worker import launch_train_net, reap, run_ranks
from distribuuuu_tpu.parallel import seq as jax_seq
from distribuuuu_tpu.runtime import create_mesh
from distribuuuu_tpu.runtime.mesh import data_mesh as jax_data_mesh
from distribuuuu_tpu.trainer import _build_cfg_model as jax_build_cfg_model
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port
from distribuuuu_tpu_torch.runtime.mesh import ProcessMesh, check_seq_node_local, mesh_sizes
from distribuuuu_tpu_torch.trainer import _seq_parallel, build_cfg_model, train_model

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
LOSS_TOL, PARAM_TOL = dict(rtol=1e-3, atol=1e-5), dict(rtol=1e-3, atol=2e-5)
MESHES = [(1, 1, 2), (2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4), (2, 1, 4), (-1, 2, 2), (-1, -1, 2)]


@pytest.mark.parametrize("data,f,s", MESHES)
def test_layout_and_sizes_equal_jax_data_mesh(data, f, s):
    """Rank r's indices are where JAX's mesh holds device r; the sizes as JAX resolves them."""
    world = jax.device_count()
    jm = jax_data_mesh(data, f, s)
    shape = dict(jm.shape)
    n = int(jm.devices.size)
    d_n, f_n = mesh_sizes(data, f, n, s)
    assert (d_n, f_n, s) == (shape["data"], shape.get("fsdp", 1), shape["seq"])
    if n == world:
        assert mesh_sizes(data, f, world, s) == (d_n, f_n)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices).reshape(d_n, f_n, s)
    for r in range(n):
        m = ProcessMesh(d_n, f_n, r, seq=s)
        assert ids[m.data_rank, m.fsdp_rank, m.seq_rank] == r
        assert m.batch_rank == m.data_rank * f_n + m.fsdp_rank and m.batch_world == d_n * f_n


@pytest.mark.parametrize("case", ["wildcard", "world", "nodes"])
def test_mesh_refusals(case):
    """``MESH.SEQ -1`` raises as JAX's does; seq groups must fill the world
    and lie on one node (JAX's ``_check_seq_host_local``)."""
    if case == "wildcard":
        with pytest.raises(ValueError, match="no -1 wildcard"):
            jax_data_mesh(1, 1, -1)
        with pytest.raises(ValueError, match="no -1 wildcard"):
            mesh_sizes(1, 1, 4, -1)
    elif case == "world":
        with pytest.raises(ValueError, match="do not divide into seq groups of 2"):
            mesh_sizes(-1, 1, 3, 2)
    else:
        with pytest.raises(ValueError, match=r"MESH.SEQ=2 spans nodes \(a node holds 3 of the 6"):
            check_seq_node_local(2, 6, local_world=3)
        check_seq_node_local(2, 8, local_world=4)  # groups within nodes
        check_seq_node_local(4, 4, local_world=4)


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return run_ranks(dict(world=4, jobs=["units"]), tmp_path_factory.mktemp("units"),
                     deadline_s=90, worker=TESTS / "_torch_seq_worker.py")


def test_groups_of_fsdp_2_x_seq_2(units):
    for r, u in enumerate(units):
        assert u["seq_group"].tolist() == [r - r % 2, r - r % 2 + 1]
        assert u["fsdp_group"].tolist() == u["batch_group"].tolist() == [r % 2, r % 2 + 2]
        assert u["indices"].tolist() == [r // 2, r // 2, r % 2]


def test_local_tokens_and_psum_partial_equal_jax(units):
    mesh = create_mesh({"seq": 4}, devices=jax.devices()[:4])
    x = jnp.arange(16.0).reshape(1, 16, 1)
    want = jax.shard_map(jax_seq.local_tokens, mesh=mesh, in_specs=(P(),),
                         out_specs=P(None, "seq", None), check_vma=False)(x)
    np.testing.assert_array_equal(np.concatenate([u["local"] for u in units], 1), want)
    g = jax.shard_map(lambda t: jax.grad(lambda y: jax_seq.psum_partial(y * y, "seq"))(t),
                      mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)(3.0)
    assert all(float(u["psum_grad"]) == float(g) == 6.0 for u in units)
    with pytest.raises(ValueError, match="not divisible") as jax_err:
        jax.shard_map(jax_seq.local_tokens, mesh=mesh, in_specs=(P(),),
                      out_specs=P(None, "seq", None), check_vma=False)(jnp.zeros((1, 15, 1)))
    assert all(str(u["local_refusal"]) in str(jax_err.value) for u in units)


def test_ulysses_refuses_indivisible_heads_in_jax_words(units):
    from distribuuuu_tpu.parallel.ulysses import ulysses_attention

    mesh = create_mesh({"seq": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as jax_err:
        jax.shard_map(ulysses_attention, mesh=mesh, in_specs=(P(None, None, "seq", None),) * 3,
                      out_specs=P(None, None, "seq", None),
                      check_vma=False)(*(jnp.zeros((1, 3, 16, 2)),) * 3)
    assert all(str(u["refusal"]) == str(jax_err.value) for u in units)


@pytest.fixture()
def _fresh(fresh_cfg):
    reset_cfg()
    yield fresh_cfg
    reset_cfg()


@pytest.mark.parametrize("arch,attn", [("mae_vit_b16", "none"), ("resnet18", "ring"),
                                       ("vit_s16", "ring")])
def test_trainer_checks_at_seq_2(_fresh, arch, attn):
    """``SEQ_ATTN none`` raises as JAX's build does; a BN model (ResNet-18)
    raises once the mesh has a seq axis; a classifier ViT gets the gap pool."""
    task = "mae" if arch.startswith("mae_") else "classify"
    for c in (cfg, _fresh):
        c.MODEL.ARCH, c.MODEL.SEQ_ATTN, c.MESH.SEQ, c.TRAIN.TASK = arch, attn, 2, task
    if attn == "none":
        with pytest.raises(ValueError, match="needs MODEL.SEQ_ATTN 'ring' or 'ulysses'") as e:
            build_cfg_model()
        with pytest.raises(ValueError, match=re.escape(str(e.value))):
            jax_build_cfg_model()
        return
    with torch.device("meta"):
        model = build_cfg_model()
    if arch == "resnet18":
        with pytest.raises(ValueError, match="MESH.SEQ > 1 requires a BatchNorm-free model"):
            _seq_parallel(model, ProcessMesh(1, 1, 0, seq=2), torch.device("cpu"))
    else:
        assert model.pool == "gap" == jax_build_cfg_model().pool


TINY = ["--cfg", str(ROOT / "config" / "mae_vit_b16.yaml"), "MESH.DATA", "1", "MESH.FSDP", "1",
        "MODEL.MODULE", "_torch_mae_tiny", "MODEL.ARCH", "mae_vit_tiny", "MODEL.DUMMY_INPUT",
        "True", "TRAIN.IM_SIZE", "16", "TEST.IM_SIZE", "16", "TEST.CROP_SIZE", "16",
        "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4", "TRAIN.DUMMY_EPOCH_SAMPLES", "16",
        "TRAIN.PRINT_FREQ", "1", "RNG_SEED", "3", "OPTIM.MAX_EPOCH", "2", "OPTIM.BASE_LR",
        "0.02", "OPTIM.WARMUP_EPOCHS", "0", "MODEL.DTYPE", "float32", "FAULT.HANDLE_SIGNALS",
        "False"]


def _read(out: Path, log: str = "") -> dict:
    log = log or "".join(p.read_text() for p in out.glob("*.log"))
    sd = torch.load(out / "checkpoints" / "ckpt_ep_002" / "checkpoint.pt", weights_only=True)
    return dict(log=log, model=sd["model"],
                losses=[float(v) for v in re.findall(r"Epoch\[\d\] \[\s*\d+/4\].*?Loss (\S+) \(",
                                                      log)],
                mse=[float(v) for v in re.findall(r"over 16 images; masked-MSE loss ([0-9.]+)", log)],
                census=re.findall(r'Activation census: .*"l_global": (\d+), "l_local": (\d+)',
                                  log))


def _in_process(out: Path, *extra) -> dict:
    """One rank of ``train_net`` in this process (``mae_vit_tiny`` forgotten after)."""
    from distribuuuu_tpu_torch.models import registry

    reset_cfg()
    load_cfg_fom_args(argv=[*TINY, "OUT_DIR", str(out), *extra])
    sys.path.insert(0, str(TESTS))
    try:
        train_model(device="cpu")
    finally:
        sys.path.remove(str(TESTS))
        registry._REGISTRY.pop("mae_vit_tiny", None)
        sys.modules.pop("_torch_mae_tiny", None)
        reset_cfg()
    return _read(out)


def _ranks(world: int, out: Path, *extra, test: bool = False) -> tuple[list, str]:
    env = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [str(TESTS), env]))
    try:
        procs = launch_train_net(world, [*TINY, "OUT_DIR", str(out), *extra],
                                 out.parent / f"{out.name}_logs", pick_rendezvous_port(), test)
    finally:
        os.environ.pop("PYTHONPATH") if env is None else os.environ.update(PYTHONPATH=env)
    rcs = reap(procs, 240)
    return rcs, (out.parent / f"{out.name}_logs" / "rank0.log").read_text()


@pytest.fixture(scope="module")
def seq1(tmp_path_factory):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(var, None)
    return _in_process(tmp_path_factory.mktemp("seq1") / "run", "MESH.SEQ", "1")


def _close(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **PARAM_TOL, err_msg=k)


def test_train_net_at_seq_2_replays_seq_1(seq1, tmp_path):
    rcs, log = _ranks(2, tmp_path / "ring")
    assert rcs == [0, 0], log[-3000:]
    got = _read(tmp_path / "ring", log)
    assert len(seq1["losses"]) == len(got["losses"]) == 8 and seq1["losses"][-1] < seq1["losses"][0]
    np.testing.assert_allclose(got["losses"], seq1["losses"], **LOSS_TOL)
    np.testing.assert_allclose(got["mse"], seq1["mse"], **LOSS_TOL)
    _close(got["model"], seq1["model"])
    assert "Sequence parallel: 2 processes a group, ring attention over gloo" in log
    assert "Mesh: data 1 x fsdp 1 x seq 2" in log and "global batch 4" in log
    assert seq1["census"] == [("16", "16")] and got["census"] == [("16", "8")]
    # test_net at seq 2 on the last checkpoint: the trainer's last val pass
    rcs, log = _ranks(2, tmp_path / "eval", "MODEL.WEIGHTS",
                      str(tmp_path / "ring" / "checkpoints" / "ckpt_ep_002"), test=True)
    assert rcs == [0, 0], log[-3000:]
    mse = [float(v) for v in re.findall(r"over 16 images; masked-MSE loss ([0-9.]+)", log)]
    assert mse == got["mse"][-1:], (mse, got["mse"])


def test_a_preempted_seq_2_run_resumes_at_seq_1(seq1, tmp_path, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    rcs, log = _ranks(2, tmp_path / "pre", "MODEL.SEQ_ATTN", "ulysses",
                      "FAULT.INJECT_PREEMPT_STEP", "6")
    assert rcs == [143, 143], log[-3000:]
    assert "Preempted at epoch 1 step 2" in log
    got = _in_process(tmp_path / "pre", "MESH.SEQ", "1")
    assert re.search(r"Resumed from \S+ckpt_mid_ep_001_it_000002 \(epoch 1, step 2,", got["log"])
    _close(got["model"], seq1["model"])
