"""The port's data-parallel train step on 2 gloo ranks against the JAX step on a 2-device CPU mesh.

ResNet-18, f32, 32^2, 10 classes, a global batch of 8 (4 a rank), 3 steps,
with ``MODEL.SYNCBN`` off (each rank's statistics, then averaged after the
step as JAX's ``pmean(new_stats)``) and on (``[E[x], E[x^2]]`` all-reduced
in the forward, as flax's ``pmean`` over the data axis). The ranks run
JAX-free in ``tests/_torch_train_worker.py``. Each step starts every rank
from the JAX run's parameters and statistics (the optimizer state carries
over), for the reason tests/test_torch_train.py's K-step test gives. Both
ranks must end bitwise equal; against JAX: the loss over the global batch
within 1e-5; the statistics after each step within a relative L2 of 1e-4
(no gradient reaches them: measured 3e-7); the parameters within 2e-3 and
the momentum after 3 steps within 2e-2. Those two carry the gradients, and
with 4 images a rank a pre-ReLU value within f32 rounding of 0 takes the
other side of the kink in one framework: without SyncBN the first step
meets one in layer1.0's bn1 (its bias gradient 8 % of max apart), which
leaves the parameters 5e-4 and the momentum 5e-3 apart; with SyncBN,
1e-6 and 1e-5.

Elastic resume, through whole ``train_net`` runs of ResNet-18 at 32^2 on
2 gloo ranks (``_torch_train_worker.launch_train_net``, 4 images a rank,
48 JPEGs of one seed, 6 steps an epoch): both ranks preempted at epoch 1
step 2 exit 143 with one mid checkpoint; a 1-rank relaunch at the same
batch logs the remap to step 4 and trains the rest of the epoch on exactly
the sample indices the 2-rank run had left; a batch whose steps cannot land
on the saved offset falls back to ``ckpt_ep_001``; a SIGTERM to rank 1
alone stops both ranks at one step, with one checkpoint.
"""

import os
import re
import shutil
import signal
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_train_worker import launch_train_net, reap, run_ranks
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch import checkpoint as ckpt
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.data import loader as port_loader
from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_model

torch.set_num_threads(2)  # the suite runs several test workers on one host

ARCH, IM, CLASSES, BATCH, K, WORLD = "resnet18", 32, 10, 8, 3, 2


def _flat_like_port(sd: dict, kind: str) -> np.ndarray:
    """A port-layout state_dict as the port's flat parameter or statistics buffer."""
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = ARCH, CLASSES, "float32"
    st = TrainState(build_cfg_model())
    missing, unexpected = st.model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith(("running_mean", "running_var")) for k in missing)
    reset_cfg()
    return (st.params if kind == "params" else st.stats).numpy().copy()


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("syncbn", [False, True])
def test_two_gloo_ranks_equal_jax_two_device_mesh(fresh_cfg, tmp_path, syncbn):
    mesh = data_mesh(WORLD)
    model = jax_build_model(ARCH, num_classes=CLASSES, dtype=jnp.float32,
                            bn_axis_name="data" if syncbn else None)
    state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, IM)
    step = make_train_step(model, tx, mesh, topk=5)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (K, BATCH, IM, IM, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, (K, BATCH)).astype(np.int32)
    lrs = np.array([0.02, 0.04, 0.06], np.float32)
    img_s, vec_s = NamedSharding(mesh, P("data", None, None, None)), NamedSharding(mesh, P("data"))
    inputs, losses, posts = {"image": images, "label": labels, "lr": lrs}, [], []
    for k in range(K):
        v = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
        inputs.update({f"s{k}/{n}": t.numpy() for n, t in from_jax_variables(v, ARCH).items()})
        batch = {"image": jax.device_put(images[k], img_s), "label": jax.device_put(labels[k], vec_s),
                 "weight": jax.device_put(np.ones(BATCH, np.float32), vec_s)}
        state, m = step(state, batch, jnp.float32(lrs[k]), jax.random.PRNGKey(0))
        losses.append(float(m["loss_sum"] / m["n"]))
        v = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
        posts.append(from_jax_variables(v, ARCH))
    momentum = from_jax_variables(
        {"params": jax.tree.map(np.array, state.opt_state[1].momentum)}, ARCH)
    np.savez(tmp_path / "inputs.npz", **inputs)
    ranks = run_ranks(dict(world=WORLD, threads=1, timeout_s=100, arch=ARCH, classes=CLASSES,
                           syncbn=syncbn, accum=1, inputs=str(tmp_path / "inputs.npz")),
                      tmp_path / "ranks", deadline_s=150)
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    res = ranks[0]
    for k in range(K):
        assert abs(float(res[f"loss{k}"]) - losses[k]) <= 1e-5 * max(1.0, losses[k])
        assert _rel_l2(res[f"p{k}"], _flat_like_port(posts[k], "params")) <= 2e-3
        assert _rel_l2(res[f"b{k}"], _flat_like_port(posts[k], "stats")) <= 1e-4
    assert _rel_l2(res["momentum"], _flat_like_port(momentum, "params")) <= 2e-2
    assert int(res["step"]) == int(state.opt_state[1].step) == K


ROOT = Path(__file__).resolve().parents[1]
ELASTIC = ["--cfg", str(ROOT / "config" / "resnet18.yaml"), "MODEL.NUM_CLASSES", "10",
           "TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "32", "TEST.CROP_SIZE", "32",
           "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8", "TRAIN.PRINT_FREQ", "2",
           "TRAIN.WORKERS", "2", "RNG_SEED", "5", "OPTIM.MAX_EPOCH", "2",
           "FAULT.RETRY_BASE_DELAY", "0.001"]
IMAGES = 48  # 6 steps of 2 x 4 an epoch; 12 of 4 on one rank


def _ranks(world, out, *extra, deadline_s=240.0):
    """A whole ``train_net`` run on ``world`` gloo ranks: exit codes and logs."""
    procs = launch_train_net(world, [*ELASTIC, "OUT_DIR", str(out), *extra], out.parent /
                             f"{out.name}_logs", pick_rendezvous_port())
    rcs = reap(procs, deadline_s)
    logs = [(out.parent / f"{out.name}_logs" / f"rank{r}.log").read_text() for r in range(world)]
    return rcs, logs


@pytest.fixture(scope="module")
def image_data(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("elastic_data")
    rng = np.random.default_rng(11)
    for split, n in (("train", IMAGES), ("val", 8)):
        for i in range(n):
            d = root / split / f"c{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 255, (20, 24, 3), np.uint8)).save(d / f"{i:02d}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def preempted(tmp_path_factory, image_data):
    """2 ranks preempted before global step 8 (epoch 1, step 2)."""
    out = tmp_path_factory.mktemp("elastic") / "run"
    rcs, logs = _ranks(2, out, "TRAIN.DATASET", image_data, "FAULT.INJECT_PREEMPT_STEP", "8")
    return out, rcs, logs


def _copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


def _relaunch(out, *extra):
    """One rank, in this process, on ``out``; the train loader's sample
    indices by epoch, and the log."""
    seen: dict = {}
    raw = port_loader.HostDataLoader._load_one_raw

    def spy(self, idx, slot_seed):
        if self.train:
            seen.setdefault(self.epoch, []).append(int(idx))
        return raw(self, idx, slot_seed)
    reset_cfg()
    load_cfg_fom_args(argv=[*ELASTIC, "OUT_DIR", str(out), *extra])
    port_loader.HostDataLoader._load_one_raw = spy
    try:
        train_model(device="cpu")
    finally:
        port_loader.HostDataLoader._load_one_raw = raw
        reset_cfg()
    return seen, "".join(p.read_text() for p in out.glob("*.log"))


def test_two_preempted_ranks_resume_elastically_on_one(preempted, image_data, tmp_path,
                                                       monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    src, rcs, logs = preempted
    assert rcs == [143, 143], logs
    for log in logs:  # both ranks stopped at the same step
        assert "Preempted at epoch 1 step 2" in log, log[-2000:]
    mids = [p.name for p in (src / "checkpoints").iterdir() if p.name.startswith("ckpt_mid")]
    assert mids == ["ckpt_mid_ep_001_it_000002"]
    assert ckpt.verify_checkpoint(str(src / "checkpoints" / mids[0])) == ("ok", [])
    out = _copy(src, tmp_path / "one")
    seen, log = _relaunch(out, "TRAIN.DATASET", image_data)
    assert ("Elastic resume: remapped step 2 (@8 samples/step, 2 devices) -> step 4 "
            "(@4 samples/step) at sample offset 16") in log
    assert re.search(r"Resumed from \S+ckpt_mid_ep_001_it_000002 \(epoch 1, step 4,", log)
    # the rest of epoch 1: exactly the indices the two ranks had left
    left = np.concatenate([port_loader.shard_indices(IMAGES, train=True, seed=5, epoch=1,
                                                     process_index=r, process_count=2)[2 * 4:]
                           for r in range(2)])
    assert sorted(seen[1]) == sorted(left.tolist()) and len(seen[1]) == IMAGES - 16
    assert ckpt.verify_checkpoint(str(out / "checkpoints" / "ckpt_ep_002"))[0] == "ok"


def test_an_offset_the_new_world_cannot_hit_falls_back_to_the_epoch_checkpoint(
        preempted, image_data, tmp_path, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    src, rcs, _ = preempted
    assert rcs == [143, 143]
    out = _copy(src, tmp_path / "twelve")
    # 12 samples a step cannot land on offset 16; MAX_EPOCH 1: resume only
    _, log = _relaunch(out, "TRAIN.DATASET", image_data, "TRAIN.BATCH_SIZE", "12",
                       "OPTIM.MAX_EPOCH", "1")
    assert "ckpt_mid_ep_001_it_000002 skipped for elastic resume" in log
    assert re.search(r"Resumed from \S+ckpt_ep_001 \(epoch 1, step 0,", log), log[-2000:]
    assert (out / "checkpoints" / "ckpt_mid_ep_001_it_000002").is_dir()  # not corrupt: kept


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    """The flag of rank 1 alone rides the window's all-reduce: both ranks
    stop at the same step boundary and rank 0 writes the one checkpoint."""
    out = tmp_path / "term"
    logs_dir = tmp_path / "term_logs"
    argv = [*ELASTIC, "MODEL.DUMMY_INPUT", "True", "TRAIN.DUMMY_EPOCH_SAMPLES", "96",
            "OUT_DIR", str(out)]
    procs = launch_train_net(2, argv, logs_dir, pick_rendezvous_port())
    try:
        end = time.monotonic() + 180
        log0 = logs_dir / "rank0.log"
        while time.monotonic() < end and "Epoch[0] [" not in log0.read_text():
            assert all(p.poll() is None for p in procs), log0.read_text()[-2000:]
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGTERM)
    finally:
        rcs = reap(procs, 180)
    logs = [(logs_dir / f"rank{r}.log").read_text() for r in range(2)]
    assert rcs == [143, 143], logs
    assert "Preemption requested (signal 15)" in logs[1]
    assert "Preemption requested" not in logs[0]  # rank 0 learned it from the all-reduce
    steps = [re.findall(r"Preempted at epoch (\d+) step (\d+)", log) for log in logs]
    assert steps[0] == steps[1] and len(steps[0]) == 1, steps
    epoch, step = map(int, steps[0][0])
    assert step % 2 == 1  # the boundary after a window's all-reduce (PRINT_FREQ 2)
    mids = [p.name for p in (out / "checkpoints").iterdir() if p.name.startswith("ckpt_mid")]
    assert mids == [f"ckpt_mid_ep_{epoch:03d}_it_{step:06d}"]
