"""The port's quantization-aware training (distribuuuu_tpu_torch/quant/qat.py
and the trainer's ``QUANT.QAT``) against the live JAX ``quant.qat`` on the
CPU, from the same weights (``convert.from_jax_variables``).

- ``quantize_values`` (int8, and fp8 with its saturation at +-448),
  ``fake_quant_weight`` (per output channel: OIHW axis 0 against JAX's
  trailing HWIO axis) and the straight-through gradients are bitwise JAX's.
- The fake-quant forward of the tiny DenseNet of tests/test_qat.py and of a
  32 px ResNet-18, in eval and in train mode (the BN statistics updated over
  the fake-quant activations), on JAX's site scales: logits and statistics
  within 1e-5 of max(1, |JAX's|). Two f32 convs may differ by reassociation
  noise; a value on a grid step's rounding edge then lands one step apart,
  so the test also counts the site inputs whose grid index differs between
  the two (none is allowed beyond 0.1 % of a site's elements).
- One ResNet-18 QAT step with ``QUANT.QAT_DISTILL`` 1.0 against JAX's
  ``make_train_step(qat=...)``: the loss within 1e-5 relative, the updated
  parameters and statistics within a relative L2 of 1e-4 (the K-step train
  test's limits, tests/test_torch_train.py); the distillation's teacher
  forward leaves the running statistics bitwise as the fake-quant forward
  left them.
- The rescue chain of tests/test_qat.py on the port: the tiny DenseNet fails
  the int8 gate at its seed, 40 distillation steps of the port's fake-quant
  forward and backward make it pass with both metrics better, and the
  engine refuses the seed (naming QUANT.QAT) and serves the tuned weights.
- ``train_model``/``test_model`` with ``QUANT.QAT True`` on the CPU (the
  ``qat`` record), and the refusals: FSDP, SEQ, MAE, a bad mode, an arch of
  item 8c.
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distribuuuu_tpu import quant as jq
from distribuuuu_tpu.convert import golden_inputs
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.models.densenet import DenseNet as JaxDenseNet
from distribuuuu_tpu.quant.qat import quantize_values as jax_quantize_values
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import make_train_step
from distribuuuu_tpu_torch import obs
from distribuuuu_tpu_torch import quant as pq
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.convert import _family_module_name, from_jax_variables
from distribuuuu_tpu_torch.models import build_model, layers, registry
from distribuuuu_tpu_torch.models.densenet import DenseNet
from distribuuuu_tpu_torch.obs.journal import read_journal, validate_record
from distribuuuu_tpu_torch.quant.qat import _ste, quantize_values
from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec
from distribuuuu_tpu_torch.trainer import TrainState, _build_qat, train_step
from test_torch_resnet import perturbed_variables

torch.set_num_threads(2)

IM, NC = 24, 8
RESCUE_SEED = 3
TOL = 1e-5  # of max(1, |JAX's|): f32 reassociation between two conv implementations


@pytest.fixture()
def port_cfg():
    reset_cfg()
    yield cfg
    reset_cfg()


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# ---- units: bitwise JAX's ----------------------------------------------------


@pytest.mark.parametrize("mode,scale", [("int8", 0.05), ("int8", 0.013), ("fp8", 1.0),
                                        ("fp8", 0.5)])
def test_quantize_values_bitwise_jax(mode, scale):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32) * 20.0
    x[:4] = [1e6, -1e6, 448.0 * scale, -449.0 * scale]  # saturation, the grid's edge
    want = np.asarray(jax_quantize_values(jnp.asarray(x), scale, mode))
    got = quantize_values(torch.from_numpy(x), scale, mode).numpy()
    assert np.array_equal(got, want)
    if mode == "fp8":
        assert np.abs(got).max() == np.float32(448.0) * np.float32(scale)


def test_fake_quant_weight_bitwise_jax_and_per_channel():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)  # HWIO
    w[..., 5] *= 50.0  # a wild channel must not coarsen the others' grid
    w[..., 2] = 0.0  # all zero: scale 1
    for mode in ("int8", "fp8"):
        want = np.asarray(jq.fake_quant_weight(jnp.asarray(w), mode)).transpose(3, 2, 0, 1)
        got = pq.fake_quant_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), mode)
        assert np.array_equal(got.numpy(), want)
    q = pq.fake_quant_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), "int8").numpy()
    scales = np.abs(w).reshape(-1, 8).max(axis=0) / 127.0
    err = np.abs(q - w.transpose(3, 2, 0, 1))
    for ch in range(8):
        assert np.all(err[ch] <= max(scales[ch], 1e-30) / 2 + 1e-7)
    assert not q[2].any()


def test_ste_gradients_are_identity_as_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    pq.fake_quant_act(xt, 0.1, "int8").sum().backward()
    pq.fake_quant_weight(wt, "fp8").sum().backward()
    jgx = jax.grad(lambda a: jnp.sum(jq.fake_quant_act(a, 0.1, "int8")))(jnp.asarray(x))
    assert np.array_equal(xt.grad.numpy(), np.asarray(jgx))
    assert np.array_equal(wt.grad.numpy(), np.ones_like(w))
    xt, q = torch.from_numpy(x), torch.from_numpy(x).round()
    assert torch.equal(_ste(xt, q), xt + (q - xt))


# ---- the fake-quant forward against JAX's QATModel.apply ----------------------


def _tiny_densenet_variables():
    jm = JaxDenseNet(growth_rate=8, block_config=(2, 2), num_init_features=16, num_classes=NC,
                     dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(RESCUE_SEED), jnp.zeros((1, IM, IM, 3)), train=False)
    return jm, jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})


def _pair(arch):
    """(JAX model, variables, port model, im) of the two test models, f32."""
    if arch == "densenet":
        jm, v = _tiny_densenet_variables()
        pm = DenseNet(8, (2, 2), 16, num_classes=NC, dtype=torch.float32)
        pm.load_state_dict(from_jax_variables(v, "densenet121"), strict=True)
        return jm, v, pm.to(memory_format=torch.channels_last), IM, "densenet121"
    v = perturbed_variables("resnet18", 7, im=32, classes=NC)
    jm = jax_build_model("resnet18", num_classes=NC, dtype=jnp.float32)
    pm = build_model("resnet18", num_classes=NC, dtype=torch.float32)
    pm.load_state_dict(from_jax_variables(v, "resnet18"), strict=True)
    return jm, v, pm.to(memory_format=torch.channels_last), 32, "resnet18"


def _calibrated(jm, v, pm, im, arch):
    """Both QATModels from the same batches, the port's sites on JAX's amax
    (the calibration's own parity is tests/test_torch_quant.py's)."""
    rng = np.random.default_rng(1234)
    batches = [rng.standard_normal((4, im, im, 3)).astype(np.float32) for _ in range(2)]
    jqat = jq.calibrate_qat(jm, v, [jnp.asarray(b) for b in batches])
    pqat = pq.calibrate_qat(pm, [torch.from_numpy(b) for b in batches])
    name = _family_module_name(arch)
    jsites = {name(k.split("/")): s for k, s in jqat.sites.items()}
    assert set(jsites) == set(pqat.sites)
    for key, site in pqat.sites.items():
        assert site.amax == pytest.approx(jsites[key].amax, rel=1e-5)
        site.amax = float(jsites[key].amax)
    return jqat, pqat


def _jax_run(jm, v, jqat, x, name, train):
    """JAX's fake-quant forward of ``x`` (jitted): (logits, mutated
    statistics or None, each site's input and output by the port's module
    name, NCHW)."""
    import flax.linen as nn

    def run(variables, images):
        io = {}

        def interceptor(next_fun, args, kwargs, context):
            path = context.module.path
            key = name(list(path)) if path else None
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__" and key is not None and args and key not in io:
                io[key] = (args[0], out)
            return out

        with nn.intercept_methods(interceptor):
            if train:
                logits, mutated = jqat.apply(jm, variables, images, train=True,
                                             mutable=["batch_stats"])
                return logits, mutated["batch_stats"], io
            return jqat.apply(jm, variables, images), None, io

    logits, mutated, io = jax.jit(run)(v, jnp.asarray(x))
    io = {k: tuple(_nchw_np(np.asarray(t, np.float32)) for t in pair) for k, pair in io.items()}
    return np.asarray(logits), mutated, io


def _nchw_np(a):
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _port_run(pm, pqat, x, train):
    """The port's fake-quant forward of ``x``: (logits, each site's input)."""
    seen = {}

    def record(key):
        def hook(mod, args):
            t = args[0].boundary if isinstance(args[0], layers.Pair) else args[0]
            seen.setdefault(key, t.detach().float().numpy())
        return hook

    hooks = [pm.get_submodule(k).register_forward_pre_hook(record(k)) for k in pqat.sites]
    pm.train(train)
    try:
        with torch.no_grad():
            logits = pqat.apply(pm, torch.from_numpy(x.copy())).numpy()
    finally:
        for h in hooks:
            h.remove()
    return logits, seen


def _flips(pqat, seen, io):
    """Per site, in forward order: the input elements whose grid index
    differs between the two forwards, and whether each lies within 1e-3 of
    a grid step's rounding edge in JAX's value."""
    out = []
    for key, site in pqat.sites.items():
        s = np.float32(pqat.act_scale(site))
        j = io[key][0] / s
        differ = np.round(seen[key] / s) != np.round(j)
        edge = np.abs(np.abs(j - np.floor(j)) - 0.5) < 1e-3
        out.append((key, int(differ.sum()), bool(np.all(edge[differ])), differ.size))
    return out


@pytest.mark.parametrize("arch", ["densenet", "resnet18"])
def test_qat_forward_matches_jax_eval_and_train(arch):
    jm, v, pm, im, name = _pair(arch)
    jqat, pqat = _calibrated(jm, v, pm, im, name)
    key_name = _family_module_name(name)
    x = np.random.default_rng(9).standard_normal((4, im, im, 3)).astype(np.float32)
    want, _, io = _jax_run(jm, v, jqat, x, key_name, train=False)
    # each site on JAX's own input: its fake-quant product within TOL
    for key, site in pqat.sites.items():
        mod = pm.get_submodule(key)
        fwd = pqat._site_forward(site, mod, mod.forward)
        with torch.no_grad():
            _close(fwd(torch.from_numpy(io[key][0].copy())).numpy(), io[key][1])
    fresh = {k: t.clone() for k, t in pm.state_dict().items()}
    for train in (False, True):
        if train:
            want, mutated, io = _jax_run(jm, v, jqat, x, key_name, train=True)
        got, seen = _port_run(pm, pqat, x, train)
        flips = [f for f in _flips(pqat, seen, io) if f[1]]
        if not flips:
            _close(got, want)
        else:
            # the first site whose grid indices differ: every one on a
            # rounding edge, at most 0.1 % of its elements (later sites see
            # the step's consequence, so only the first is counted)
            key, n, on_edge, size = flips[0]
            assert on_edge and n <= max(1, 1e-3 * size), flips[0]
            assert np.array_equal(got.argmax(1), want.argmax(1))
    stats = from_jax_variables({"params": v["params"],
                                "batch_stats": jax.tree.map(np.asarray, mutated)}, name)
    moved = 0.0
    for k, t in pm.state_dict().items():
        if "running" in k:
            if not flips:
                _close(t.numpy(), stats[k].numpy())
            moved = max(moved, float((t - fresh[k]).abs().max()))
    assert moved > 0.0  # train mode updated the statistics


def test_qat_step_with_distill_matches_jax_make_train_step(port_cfg, fresh_cfg):
    """The tiny DenseNet of tests/test_qat.py's own step test, batch 4. The
    step's fake-quant forward is first checked to flip no grid index between
    the two (a flip on a rounding edge would move every batch statistic
    after it, and the comparison would then measure the flip)."""
    from distribuuuu_tpu import optim as jax_optim
    from distribuuuu_tpu import trainer as jax_trainer
    from distribuuuu_tpu.data.transforms import device_normalize as jax_normalize

    n, lr = 4, 0.05
    fresh_cfg.QUANT.QAT, fresh_cfg.QUANT.QAT_DISTILL = True, 1.0
    jm, v, pm, im, name = _pair("densenet")
    jqat, pqat = _calibrated(jm, v, pm, im, name)
    rng = np.random.default_rng(11)
    b = {"image": rng.integers(0, 256, (n, im, im, 3), dtype=np.uint8),
         "label": rng.integers(0, NC, n).astype(np.int32)}
    x = np.asarray(jax_normalize(jnp.asarray(b["image"])))
    _, _, io = _jax_run(jm, v, jqat, x, _family_module_name(name), train=True)
    _, seen = _port_run(pm, pqat, x, True)
    pm.load_state_dict(from_jax_variables(v, name), strict=True)  # the statistics back
    assert [f for f in _flips(pqat, seen, io) if f[1]] == []
    tx = jax_optim.construct_optimizer()
    state = jax_trainer.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                                   opt_state=tx.init(v["params"]))
    step = make_train_step(jm, tx, data_mesh(1), topk=5, qat=jqat)
    state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()}, jnp.float32(lr),
                    jax.random.PRNGKey(0))
    port = TrainState(pm)
    batch = {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"]).long()}
    stats0 = port.stats.clone()
    pmet = train_step(port, batch, lr, topk=5, qat=pqat, distill=1.0)
    want_loss = float(m["loss_sum"] / m["n"])
    assert abs(float(pmet["loss_sum"] / pmet["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
    want = from_jax_variables(jax.tree.map(np.array, {"params": state.params,
                                                      "batch_stats": state.batch_stats}), name)
    got = port.model.state_dict()
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    assert (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5 <= 1e-4
    # the teacher leaves the statistics as the fake-quant forward left them:
    # the same step without the distillation term updates them bitwise alike
    stats_distill = port.stats.clone()
    port.model.load_state_dict(from_jax_variables(v, name), strict=True)
    assert torch.equal(port.stats, stats0)
    train_step(port, batch, lr, topk=5, qat=pqat, distill=0.0)
    assert torch.equal(port.stats, stats_distill)


# ---- the rescue chain -----------------------------------------------------------


def _gate(pm, calib, x):
    qm, qp = pq.quantize(pm, pq.calibrate(pm, calib))
    with torch.no_grad():
        fp = pm(x).numpy()
    q = qm.apply(pm, qp, x).numpy()
    return pq.compare_logits(fp, q, min_top1_agree=0.99, max_logit_rmse=0.25)


def _distill_steps(pm, qat, xs):
    """tests/test_qat.py's rescue: SGD at 0.05 on the distillation objective
    alone (the fake-quant logits against the plain ones, no gradient through
    the latter), the statistics updated by the fake-quant forward."""
    params = list(pm.parameters())
    pm.train()
    for x in xs:
        with qat.intercept(pm):
            q = pm(torch.from_numpy(x))
            with torch.no_grad(), qat.bypass(), layers.frozen_running_stats():
                fp = pm(torch.from_numpy(x))
            grads = torch.autograd.grad((q - fp).square().mean(), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(0.05 * g)
    return pm.eval()


def _jax_rescue(jm, v, calib, xs):
    qat = jq.calibrate_qat(jm, v, [jnp.asarray(c) for c in calib])

    def loss_fn(p, stats, x):
        varp = {"params": p, "batch_stats": stats}
        ql, mut = qat.apply(jm, varp, x, train=True, mutable=["batch_stats"])
        fl, _ = jm.apply(varp, x, train=True, mutable=["batch_stats"])
        return jnp.mean((ql - jax.lax.stop_gradient(fl)) ** 2), mut["batch_stats"]

    @jax.jit
    def step(p, stats, x):
        (_, new_stats), g = jax.value_and_grad(loss_fn, has_aux=True)(p, stats, x)
        return jax.tree.map(lambda a, b: a - 0.05 * b, p, g), new_stats

    p, stats = v["params"], v["batch_stats"]
    for x in xs:
        p, stats = step(p, stats, jnp.asarray(x))
    return jax.tree.map(np.asarray, {"params": p, "batch_stats": stats})


@pytest.fixture(scope="module")
def rescued(tmp_path_factory):
    """The tiny DenseNet's seed weights and its rescue (40 steps of
    :func:`_distill_steps` on the port, the same 40 in JAX), with the gate's
    measurement at each on tests/test_qat.py's inputs."""
    tmp = tmp_path_factory.mktemp("qat_rescue")
    registry.register_model("qat_tiny_densenet")(lambda **kw: DenseNet(8, (2, 2), 16, **kw))
    jm, v = _tiny_densenet_variables()

    def port_model(variables):
        pm = DenseNet(8, (2, 2), 16, num_classes=NC, dtype=torch.float32)
        pm.load_state_dict(from_jax_variables(variables, "densenet121"), strict=True)
        return pm.to(memory_format=torch.channels_last).eval()

    rng = np.random.default_rng(0)
    calib = [rng.standard_normal((4, IM, IM, 3)).astype(np.float32) for _ in range(2)]
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((8, IM, IM, 3)).astype(np.float32) for _ in range(40)]
    x = torch.from_numpy(np.random.default_rng(42).standard_normal((16, IM, IM, 3))
                         .astype(np.float32))
    seed = port_model(v)
    calib_t = [torch.from_numpy(c) for c in calib]
    seed_gate = _gate(seed, calib_t, x)
    torch.save(seed.state_dict(), tmp / "seed.pt")
    tuned = _distill_steps(seed, pq.calibrate_qat(seed, calib_t), xs)
    torch.save(tuned.state_dict(), tmp / "tuned.pt")
    jax_tuned = _jax_rescue(jm, v, calib, xs)
    torch.save(port_model(jax_tuned).state_dict(), tmp / "jax_tuned.pt")
    # JAX's engine gate of its rescue: its synthetic calibration (2 x 4 from
    # seed 1234) and convert.golden_inputs(16), as serve/engine.py's
    rng = np.random.default_rng(1234)
    ecal = [jnp.asarray(rng.standard_normal((4, IM, IM, 3)), jnp.float32) for _ in range(2)]
    qm, qp = jq.quantize(jax_tuned, jq.calibrate(jm, jax_tuned, ecal))
    g = jnp.asarray(golden_inputs(16, IM, 0))
    jax_engine_gate = jq.compare_logits(np.asarray(jm.apply(jax_tuned, g, train=False)),
                                        np.asarray(qm.apply(jm, jax_tuned, qp, g)),
                                        min_top1_agree=0.99, max_logit_rmse=0.25)
    yield dict(seed=str(tmp / "seed.pt"), tuned=str(tmp / "tuned.pt"),
               jax_tuned=str(tmp / "jax_tuned.pt"), seed_gate=seed_gate,
               tuned_gate=_gate(tuned, calib_t, x), jax_engine_gate=jax_engine_gate)
    registry._REGISTRY.pop("qat_tiny_densenet")


def test_seed_fails_gate_and_qat_rescues_it(rescued):
    seed, tuned = rescued["seed_gate"], rescued["tuned_gate"]
    assert not seed.passed and tuned.passed, (seed, tuned)
    assert tuned.top1_agree > seed.top1_agree and tuned.logit_rmse < seed.logit_rmse


def test_engine_refuses_seed_naming_qat_and_serves_tuned(rescued):
    """The engine's own gate (its calibration, convert.golden_inputs) refuses
    the seed naming the remedy. It serves the rescue: JAX's rescued weights
    pass it with JAX's engine's measurement (JAX's calibrate, quantize and
    apply on the same batches and inputs); the port's rescued weights halve
    the seed's RMSE there. Their top-1 agreement is not asserted: golden
    input 11's two largest fp logits lie 0.0095 apart, below the int8 RMSE
    (~0.017), so whether its argmax agrees turns on f32 rounding in the 40
    steps (the port's rescue lands it at 1 CPU thread and misses it at 2, 4
    and 8), which the engine therefore hosts under ``QUANT.GATE False``."""
    events = []

    def engine(**quant):
        return InferenceEngine(batch_sizes=[1, 4], im_size=IM, num_classes=NC,
                               input_dtype="float32", compute_dtype="float32", device="cpu",
                               journal_event=lambda kind, **f: events.append(
                                   dict(kind=kind, ts=time.time(), **f)),
                               quant_cfg={"calib_batches": 2, "calib_batch_size": 4,
                                          "gate_n": 16, **quant})

    with pytest.raises(RuntimeError, match="refusing to serve.*QUANT.QAT"):
        engine().load(ModelSpec("dn", "qat_tiny_densenet", rescued["seed"], quant="int8"))
    seed_rmse = events[-1]["logit_rmse"]
    e = engine()
    hosted = e.load(ModelSpec("dn", "qat_tiny_densenet", rescued["jax_tuned"], quant="int8"))
    want = rescued["jax_engine_gate"]
    assert hosted.gate.passed and want.passed
    assert hosted.gate.top1_agree == want.top1_agree
    assert hosted.gate.logit_rmse == pytest.approx(want.logit_rmse, rel=1e-4)
    assert e.forward("dn", np.zeros((4, IM, IM, 3), np.float32)).shape == (4, NC)
    own = engine(gate=False).load(ModelSpec("dn", "qat_tiny_densenet", rescued["tuned"],
                                            quant="int8"))
    assert own.gate.logit_rmse < 0.75 * seed_rmse
    assert abs(own.gate.logit_rmse - want.logit_rmse) <= 0.15 * want.logit_rmse
    assert [q["passed"] for q in events if q["kind"] == "quant_quality"][:2] == [False, True]
    assert all(validate_record(r) == [] for r in events)


# ---- the trainer ------------------------------------------------------------------


def _tiny_run(out_dir, **extra):
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "resnet18", 4, "float32"
    cfg.MODEL.DUMMY_INPUT = True
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 4
    cfg.TRAIN.IM_SIZE = cfg.TEST.IM_SIZE = cfg.TEST.CROP_SIZE = 32
    cfg.TRAIN.DUMMY_EPOCH_SAMPLES, cfg.TRAIN.PRINT_FREQ = 8, 1
    cfg.OPTIM.MAX_EPOCH, cfg.OPTIM.WARMUP_EPOCHS = 1, 0
    cfg.QUANT.QAT, cfg.QUANT.CALIB_BATCHES, cfg.QUANT.CALIB_BATCH_SIZE = True, 1, 2
    cfg.RNG_SEED, cfg.OUT_DIR, cfg.OBS.MFU = 5, str(out_dir), False
    cfg.FAULT.HANDLE_SIGNALS = False
    for key, value in extra.items():
        section, name = key.split("__")
        cfg[section][name] = value


@pytest.mark.parametrize("mode,distill", [("int8", 1.0), ("fp8", 0.0)])
def test_train_net_and_test_net_under_qat_on_the_cpu(tmp_path, mode, distill):
    from distribuuuu_tpu_torch.trainer import test_model, train_model

    _tiny_run(tmp_path, QUANT__QAT_MODE=mode, QUANT__QAT_DISTILL=distill)
    try:
        state, _ = train_model(device="cpu")
        assert all(torch.isfinite(p).all() for p in state.model.parameters())
        recs = list(read_journal(str(tmp_path / "telemetry.jsonl")))
        (q,) = [r for r in recs if r["kind"] == "qat"]
        assert (q["mode"], q["layers"], q["calib_batches"], q["distill"]) == (mode, 21, 1,
                                                                              distill)
        assert validate_record(q) == []
        cfg.MODEL.WEIGHTS = str(tmp_path / "checkpoints" / "ckpt_ep_001")
        acc1, _ = test_model(device="cpu")
        assert 0.0 <= acc1 <= 100.0
    finally:
        obs.end_run(clean=True)
        reset_cfg()


def test_build_qat_refusals(port_cfg):
    model = build_model("resnet18", num_classes=NC, dtype=torch.float32)
    mesh = SimpleNamespace(fsdp=1, seq=1)
    port_cfg.QUANT.QAT_MODE = "int4"
    with pytest.raises(ValueError, match="QUANT.QAT_MODE.*int8.*fp8"):
        _build_qat(model, mesh, "cpu")
    port_cfg.QUANT.QAT_MODE = "int8"
    with pytest.raises(ValueError, match="MESH.FSDP 1"):
        _build_qat(model, SimpleNamespace(fsdp=2, seq=1), "cpu")
    with pytest.raises(ValueError, match="MESH.SEQ 1 and TRAIN.TASK 'classify'"):
        _build_qat(model, SimpleNamespace(fsdp=1, seq=2), "cpu")
    port_cfg.TRAIN.TASK = "mae"
    with pytest.raises(ValueError, match="MESH.SEQ 1 and TRAIN.TASK 'classify'"):
        _build_qat(model, mesh, "cpu")
    port_cfg.TRAIN.TASK = "classify"
    port_cfg.MODEL.ARCH, port_cfg.TRAIN.IM_SIZE = "efficientnet_b0", 32
    b0 = build_model("efficientnet_b0", num_classes=NC, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="efficientnet_b0.*item 8c"):
        _build_qat(b0, mesh, "cpu")
