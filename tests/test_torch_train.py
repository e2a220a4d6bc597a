"""Training pieces of the PyTorch port against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both. Tolerances:

- train-mode BN (``layers.BatchNorm`` through K1's plain version) against
  flax ``nn.BatchNorm`` + add + relu and against ``EpilogueBatchNorm`` (the
  Pallas kernel in interpret mode): outputs and the new running statistics
  within 1e-5 of max|.| in f32 (the batch statistics' f32 summation order),
  within one bf16 ulp (2^-7 of max|.|) with bf16 boundaries, gradients
  within 1e-4 of max|.| (the backward's sums over the batch, and through
  the statistics);
- K1's backward (``epilogue_backward_reference``, autograd through the plain
  version) against the JAX ``custom_vjp`` gradients on dyadic inputs whose
  products and sums are exact in f32: every gradient bitwise;
- the LR tables equal per epoch; SGD and LAMB after N updates on fixed
  gradients within 1e-6 of max|p| (XLA may contract ``g + wd * p`` into an
  FMA where eager PyTorch rounds twice);
- the loss (with smoothing) within 1e-6, the top-k counts equal, ties too;
- the K-step train step of ResNet-18 (f32, 32^2, 10 classes, batch 8)
  against ``make_train_step`` on a 1-device CPU mesh, each step from JAX's
  parameters and statistics: losses within 1e-5, state within a relative L2
  of 1e-4, momentum 1e-3 (the test says why);
- 2 steps of botnet50 (f32, 32^2, feature map 2x2, 10 classes, batch 4)
  against ``make_train_step`` the same way (JAX's trajectory computed once
  in a module-scoped fixture): the first step's zero-γ ``bn_out`` leaves the
  attention branch without a gradient, the second trains it through the
  attention Function's backward; limits set by how far JAX's own f32
  gradient lies from its float64 one at this size (the test says);
- the non-finite guard: a NaN batch leaves the state bitwise unchanged;
- ``DummyLoader`` batches bitwise JAX's;
- the first real-image batch (the digits ImageFolder) bitwise from both
  packages' loaders, and one f32 ResNet-18 step on it from JAX's state
  within the K-step limits.
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from distribuuuu_tpu import config as jax_config
from distribuuuu_tpu import metrics as jax_metrics
from distribuuuu_tpu import optim as jax_optim
from distribuuuu_tpu.data import loader as jax_loader
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.models.layers import EpilogueBatchNorm
from distribuuuu_tpu.ops.epilogue import fused_conv_epilogue as jax_epilogue
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch import metrics, optim
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.data import loader
from distribuuuu_tpu_torch.models import layers
from distribuuuu_tpu_torch.ops import epilogue as ep
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

# the suite runs several test workers on one host: keep torch's intra-op
# pool small so these CPU steps do not starve the timing-sensitive tests
torch.set_num_threads(2)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture()
def port_cfg():
    reset_cfg()
    yield cfg
    reset_cfg()


def _nchw(a: np.ndarray, dtype=torch.float32):
    """An NHWC numpy array as the port's NCHW channels-last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rtol * scale, (err, rtol * scale)


@pytest.mark.parametrize("bn_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,relu", [(False, True), (True, True), (True, False),
                                           (False, False)])
def test_train_mode_bn_matches_flax_and_epilogue_batchnorm(bn_dtype, residual, relu):
    rng = np.random.default_rng(5)
    n, h, w, c = 4, 5, 3, 16
    x = (rng.standard_normal((n, h, w, c)) * 2 + 0.5).astype(np.float32)
    ident = rng.standard_normal((n, h, w, c)).astype(np.float32) if residual else None
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ra_mean = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    g = rng.standard_normal((n, h, w, c)).astype(np.float32)
    jdt = _JNP[bn_dtype]

    # the port: BatchNorm in train mode through bn_epilogue (K1's plain version)
    bn = layers.BatchNorm(c, bn_dtype=bn_dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    xt = _nchw(x).requires_grad_()
    it = None if ident is None else _nchw(ident, bn_dtype).requires_grad_()
    out = layers.bn_epilogue(xt, bn, it, relu=relu)
    out.backward(_nchw(g, out.dtype))

    # flax: nn.BatchNorm + add + relu, and EpilogueBatchNorm (interpret mode)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}
    jid = None if ident is None else jnp.asarray(ident, jdt)

    def plain(params, xx, idd):
        y, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                               dtype=jdt).apply({**variables, "params": params}, xx,
                                                mutable=["batch_stats"])
        if idd is not None:
            y = y + idd
        return (fnn.relu(y) if relu else y), upd

    def fused(params, xx, idd):
        return EpilogueBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                                 dtype=jdt, relu=relu).apply(
            {**variables, "params": params}, xx, idd, mutable=["batch_stats"])

    tol_out = 1e-5 if bn_dtype == torch.float32 else 2.0**-7
    for fn in (plain, fused):
        y, upd = fn(variables["params"], jnp.asarray(x), jid)
        _close(_nhwc(out), y.astype(jnp.float32), tol_out)
        _close(bn.running_mean.numpy(), upd["batch_stats"]["mean"], 1e-5)
        _close(bn.running_var.numpy(), upd["batch_stats"]["var"], 1e-5)
        _, pull = jax.vjp(lambda p, xx, idd, fn=fn: fn(p, xx, idd)[0], variables["params"],
                          jnp.asarray(x), jid)
        dp, dx, did = pull(jnp.asarray(g, y.dtype))
        _close(_nhwc(xt.grad), dx, 1e-4)
        _close(bn.weight.grad.numpy(), dp["scale"], 1e-4)
        _close(bn.bias.grad.numpy(), dp["bias"], 1e-4)
        if residual:
            _close(_nhwc(it.grad), did.astype(jnp.float32), 1e-4)


def _dyadic(rng, *shape, den=1024, hi=4):
    return (rng.integers(-hi * den + 1, hi * den, shape) / den).astype(np.float32)


@pytest.mark.parametrize("x_dtype,bn_dtype,res_dtype,relu", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.float32, torch.float32, True),
    (torch.bfloat16, torch.float32, torch.bfloat16, False),
    (torch.float32, torch.float32, None, True),
    (torch.bfloat16, torch.bfloat16, None, False),
    (torch.float32, torch.bfloat16, torch.float32, True),
])
def test_plain_backward_equals_jax_custom_vjp_bitwise(x_dtype, bn_dtype, res_dtype, relu):
    """Dyadic inputs: x, mean, bias on a 2^-6 grid (|.| < 4), mul in j/8,
    the cotangent in quarters (|.| <= 2): every product and every sum over
    the 60 rows is exact in f32 and the bf16 casts are exact or round the
    same way, so the two frameworks' gradients agree bit for bit."""
    rng = np.random.default_rng(9)
    r, c = 60, 24
    x, mean, bias = _dyadic(rng, r, c, den=64), _dyadic(rng, c, den=64), _dyadic(rng, c, den=64)
    mul = (rng.integers(4, 17, c) / 8.0).astype(np.float32)
    ident = None if res_dtype is None else _dyadic(rng, r, c, den=64)
    out_dt = bn_dtype if res_dtype is None else torch.promote_types(bn_dtype, res_dtype)
    g = (rng.integers(-8, 9, (r, c)) / 4.0).astype(np.float32)
    t = [torch.from_numpy(x).to(x_dtype), torch.from_numpy(mean), torch.from_numpy(mul),
         torch.from_numpy(bias), None if ident is None else torch.from_numpy(ident).to(res_dtype)]
    got = ep.epilogue_backward_reference(*t, torch.from_numpy(g).to(out_dt), relu=relu,
                                         bn_dtype=bn_dtype)
    j = [jnp.asarray(x, _JNP[x_dtype]), jnp.asarray(mean), jnp.asarray(mul), jnp.asarray(bias),
         None if ident is None else jnp.asarray(ident, _JNP[res_dtype])]
    y, pull = jax.vjp(lambda *a: jax_epilogue(*a, relu=relu, bn_dtype=_JNP[bn_dtype],
                                              block_rows=16, interpret=True), *j)
    want = pull(jnp.asarray(g, y.dtype))
    for name, a, b in zip(("d_x", "d_mean", "d_mul", "d_bias", "d_identity"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
            jnp.dtype(b.dtype).type], name
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32), err_msg=name)


@pytest.mark.parametrize("policy,steps", [("cos", []), ("steps", [0, 3, 6])])
def test_epoch_lr_equals_jax_per_epoch(port_cfg, fresh_cfg, policy, steps):
    for c in (port_cfg, fresh_cfg):
        c.OPTIM.LR_POLICY, c.OPTIM.STEPS = policy, steps
        c.OPTIM.MAX_EPOCH, c.OPTIM.WARMUP_EPOCHS, c.OPTIM.BASE_LR = 9, 3, 0.4
        c.OPTIM.MIN_LR = 0.01
    got = [optim.get_epoch_lr(e) for e in range(9)]
    want = [jax_optim.get_epoch_lr(e) for e in range(9)]
    assert got == want and len(set(got)) > 3


_SHAPES = {"conv": (3, 3, 4, 8), "bn_scale": (8,), "bn_bias": (8,), "fc": (8, 5), "fc_b": (5,)}


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k], np.float32).reshape(-1) for k in _SHAPES])


@pytest.mark.parametrize("opt,nesterov,dampening", [("sgd", True, 0.0), ("sgd", False, 0.0),
                                                    ("sgd", False, 0.3), ("lamb", False, 0.0)])
def test_optimizer_updates_equal_optax_chain(port_cfg, fresh_cfg, opt, nesterov, dampening):
    for c in (port_cfg, fresh_cfg):
        c.OPTIM.OPTIMIZER, c.OPTIM.NESTEROV, c.OPTIM.DAMPENING = opt, nesterov, dampening
        c.OPTIM.WEIGHT_DECAY = 1e-2
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}
    params["bn_bias"][:] = 0.0  # a zero-norm parameter: LAMB's trust ratio is 1 there
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in _SHAPES.items()}
             for _ in range(4)]
    tx = jax_optim.construct_optimizer()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax_optim.apply_updates_with_lr(jp, upd, 0.05 * (i + 1))
    segments, o = [], 0
    for s in _SHAPES.values():
        segments.append((o, int(np.prod(s)), len(s)))
        o += int(np.prod(s))
    flat = torch.from_numpy(_flat(params))
    tx_port = optim.construct_optimizer(flat, segments)
    for i, g in enumerate(grads):
        tx_port.step(flat, torch.from_numpy(_flat(g)), 0.05 * (i + 1))
    want = _flat(jp)
    assert float(np.abs(flat.numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())
    if opt == "sgd":
        mom = _flat(st[1].momentum)
        got = tx_port.state["momentum"].numpy()
        assert int(tx_port.state["step"]) == int(st[1].step) == 4
    else:
        mom = _flat(st[0].mu)
        got = tx_port.state["mu"].numpy()
        assert int(tx_port.state["count"]) == int(st[0].count) == 4
    assert float(np.abs(got - mom).max()) <= 1e-6 * float(np.abs(mom).max())


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_loss_and_topk_equal_jax_with_ties(smooth):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, 7)).astype(np.float32)
    logits[3] = 1.0  # all tied: rank 0, correct at every k
    logits[5, :3] = logits[5, 4]  # the true label tied with three others
    labels = rng.integers(0, 7, 12).astype(np.int64)
    labels[5] = 4
    got = metrics.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), smooth)
    want = jax_metrics.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), smooth)
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    gk = metrics.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), ks=(1, 2, 5))
    wk = jax_metrics.topk_correct(jnp.asarray(logits), jnp.asarray(labels), ks=(1, 2, 5))
    assert {k: float(v) for k, v in gk.items()} == {k: float(v) for k, v in wk.items()}
    w = (rng.random(12) > 0.3).astype(np.float32)
    gw = metrics.topk_correct_weighted(torch.from_numpy(logits), torch.from_numpy(labels),
                                       torch.from_numpy(w), ks=(1, 5))
    ww = jax_metrics.topk_correct_weighted(jnp.asarray(logits), jnp.asarray(labels),
                                           jnp.asarray(w), ks=(1, 5))
    assert {k: float(v) for k, v in gw.items()} == {k: float(v) for k, v in ww.items()}


def _batches(k, n, im, classes, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (n, im, im, 3), dtype=np.uint8),
             "label": rng.integers(0, classes, n).astype(np.int32),
             "weight": np.ones(n, np.float32)} for _ in range(k)]


def _jax_state_tree(state):
    """(variables, momentum as a params-shaped tree) of a JAX TrainState."""
    v = jax.tree.map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
    return v, jax.tree.map(np.array, state.opt_state[1].momentum)


def _rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of two state_dicts."""
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_resnet18_k_step_train_equals_jax_make_train_step(port_cfg, fresh_cfg, accum):
    """K steps of ResNet-18 (f32, 32^2, 10 classes, batch 8) against
    ``make_train_step`` on a 1-device CPU mesh. Each step starts both from
    JAX's parameters and BN statistics (the port's optimizer state carries
    over on its own), because two f32 implementations do not stay together
    over free-running steps here: a pre-ReLU value within f32 rounding of 0
    takes the other side of the kink in one of them (about two such values a
    step at this size), and BN over 4-32 samples a channel amplifies that.
    JAX's own f32 gradient at the second step differs from its float64 one
    by 2 % of the largest entry of layer2.1's conv2. So the tolerances are
    over whole states: losses within 1e-5, the updated parameters and BN
    statistics within a relative L2 of 1e-4 and the momentum after K steps
    within 1e-3 (measured: 2e-6 and 2e-5 with one micro-batch, 4e-5 and
    3e-4 with two of 4 images); the step counter equal."""
    arch, im, classes, n, k = "resnet18", 32, 10, 8, 3
    fresh_cfg.MODEL.DTYPE = port_cfg.MODEL.DTYPE = "float32"
    port_cfg.MODEL.ARCH, port_cfg.MODEL.NUM_CLASSES, port_cfg.TRAIN.IM_SIZE = arch, classes, im
    mesh = data_mesh(1)
    model = jax_build_model(arch, num_classes=classes, dtype=jnp.float32)
    state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, im)
    step = make_train_step(model, tx, mesh, topk=5, accum_steps=accum)
    port = TrainState(build_cfg_model())
    for i, b in enumerate(_batches(k, n, im, classes, seed=11)):
        v, _ = _jax_state_tree(state)
        port.model.load_state_dict(from_jax_variables(v, arch), strict=True)
        lr = 0.02 * (i + 1)
        state, m = step(state, {kk: jnp.asarray(a) for kk, a in b.items()}, jnp.float32(lr),
                        jax.random.PRNGKey(0))
        pm = train_step(port, {"image": torch.from_numpy(b["image"]),
                               "label": torch.from_numpy(b["label"]).long()}, lr,
                        accum_steps=accum, topk=5)
        want_loss = float(m["loss_sum"] / m["n"])
        assert abs(float(pm["loss_sum"] / pm["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
        assert float(pm["correct1"]) == float(m["correct1"])
        v, mom = _jax_state_tree(state)
        assert _rel_l2(port.model.state_dict(), from_jax_variables(v, arch)) <= 1e-4
    mom_want = from_jax_variables({"params": mom}, arch)
    assert _rel_l2(port.unflatten(port.optimizer.state["momentum"]), mom_want) <= 1e-3
    assert int(port.optimizer.state["step"]) == int(state.opt_state[1].step) == k


BOT_STEPS, BOT_IM, BOT_CLASSES, BOT_BATCH = 2, 32, 10, 4
BOT_LR = 0.2 * BOT_BATCH / 256  # config/botnet50.yaml's BASE_LR, linearly scaled from 256 to 4


@pytest.fixture(scope="module")
def jax_botnet_steps():
    """JAX's botnet50 trajectory over BOT_STEPS steps of ``make_train_step``
    on a 1-device CPU mesh: per step the variables before it, the batch, the
    LR, the metrics and the variables after; then the momentum tree and the
    step counter."""
    from distribuuuu_tpu.models import layers as jax_layers

    jax_config.reset_cfg()
    jax_config.cfg.MODEL.DTYPE = "float32"
    try:
        mesh = data_mesh(1)
        model = jax_build_model("botnet50", num_classes=BOT_CLASSES, dtype=jnp.float32)
        state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, BOT_IM)
        step = make_train_step(model, tx, mesh, topk=5, accum_steps=1)
        steps = []
        for i, b in enumerate(_batches(BOT_STEPS, BOT_BATCH, BOT_IM, BOT_CLASSES, seed=21)):
            before, _ = _jax_state_tree(state)
            lr = BOT_LR
            state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()}, jnp.float32(lr),
                            jax.random.PRNGKey(0))
            after, mom = _jax_state_tree(state)
            steps.append((before, b, lr, {k: float(x) for k, x in m.items()}, after))
        return steps, mom, int(state.opt_state[1].step)
    finally:
        jax_config.reset_cfg()
        jax_layers.set_bn_compute_dtype(jnp.float32)


def test_botnet50_train_steps_equal_jax_make_train_step(port_cfg, jax_botnet_steps):
    """As the ResNet-18 test, for botnet50, each step from JAX's state. At
    this size BN takes its statistics over 16 values a channel from stage 3
    on, which makes the f32 gradient ill-conditioned: JAX's own f32
    gradient at the first step lies 2.9 % (relative L2) from its float64
    one, the port's 1.35 %. So: the loss within 1e-5; each step's parameter
    update (SGD with nesterov momentum at the config's BASE_LR scaled to
    batch 4) within a relative L2 of 5e-2 of JAX's, and the momentum after
    the steps too (measured 1.7e-2 and 2.1e-2); the whole state (parameters
    and BN statistics) within a relative L2 of 3e-4 (measured 1.0e-4 and
    1.2e-4). In the second step the MHSA parameters get a gradient."""
    steps, mom, count = jax_botnet_steps
    port_cfg.MODEL.ARCH, port_cfg.MODEL.NUM_CLASSES = "botnet50", BOT_CLASSES
    port_cfg.TRAIN.IM_SIZE, port_cfg.MODEL.DTYPE = BOT_IM, "float32"
    port = TrainState(build_cfg_model())
    mhsa = port.model._modules["7"].net[0].net[3]
    names = set(port.names)
    for i, (before, b, lr, m, after) in enumerate(steps):
        start = from_jax_variables(before, "botnet50")
        port.model.load_state_dict(start, strict=True)
        pm = train_step(port, {"image": torch.from_numpy(b["image"]),
                               "label": torch.from_numpy(b["label"]).long()}, lr, topk=5)
        want_loss = m["loss_sum"] / m["n"]
        assert abs(float(pm["loss_sum"] / pm["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
        assert float(pm["correct1"]) == m["correct1"]
        got, want = port.model.state_dict(), from_jax_variables(after, "botnet50")
        assert _rel_l2(got, want) <= 3e-4
        assert _rel_l2({k: got[k] - start[k] for k in names},
                       {k: want[k] - start[k] for k in names}) <= 5e-2
        grads = [mhsa.to_qk.weight.grad, mhsa.pos_emb.rel_height.grad]
        assert all(float(t.abs().max()) > 0 for t in grads) == (i > 0), i
    mom_want = from_jax_variables({"params": mom}, "botnet50")
    assert _rel_l2(port.unflatten(port.optimizer.state["momentum"]), mom_want) <= 5e-2
    assert int(port.optimizer.state["step"]) == count == BOT_STEPS


def test_nonfinite_guard_leaves_state_bitwise(port_cfg):
    port_cfg.MODEL.ARCH, port_cfg.MODEL.NUM_CLASSES, port_cfg.MODEL.DTYPE = "resnet18", 10, "float32"
    port = TrainState(build_cfg_model(torch.Generator().manual_seed(0)))
    good = _batches(1, 4, 32, 10, seed=1)[0]
    batch = {"image": torch.from_numpy(good["image"]), "label": torch.from_numpy(good["label"])}
    train_step(port, batch, 0.1)  # a momentum buffer and a step count that are not zero
    before = [t.clone() for t in (port.params, port.stats, *port.optimizer.state.values())]
    bad = dict(batch, image=torch.full((4, 32, 32, 3), float("nan")))
    m = train_step(port, bad, 0.1)
    after = (port.params, port.stats, *port.optimizer.state.values())
    for a, b in zip(before, after):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert float(m["skipped"]) == 1.0 and float(m["n"]) == 0.0 and float(m["loss_sum"]) == 0.0
    m = train_step(port, batch, 0.1)
    assert float(m["skipped"]) == 0.0 and int(port.optimizer.state["step"]) == 2


def test_dummy_loader_batches_bitwise_jax(port_cfg, fresh_cfg):
    for c in (port_cfg, fresh_cfg):
        c.MODEL.DUMMY_INPUT = True
        c.TRAIN.BATCH_SIZE, c.TRAIN.IM_SIZE, c.TRAIN.DUMMY_EPOCH_SAMPLES = 6, 16, 100
        c.TRAIN.ACCUM_STEPS = 2
        c.TEST.BATCH_SIZE, c.TEST.CROP_SIZE = 7, 16
    mesh = data_mesh(1)
    for ours, theirs in ((loader.construct_train_loader(), jax_loader.construct_train_loader(mesh)),
                         (loader.construct_val_loader(), jax_loader.construct_val_loader(mesh))):
        assert len(ours) == len(theirs)
        a, b = next(iter(ours)), next(iter(theirs))
        for key in ("image", "label", "weight"):
            np.testing.assert_array_equal(a[key], b[key])
    batches = list(loader.DevicePrefetcher(loader.construct_train_loader(), torch.device("cpu")))
    assert len(batches) == 100 // 12 and batches[0]["image"].dtype == torch.uint8
    port_cfg.MODEL.DUMMY_INPUT = False  # now the image loader: the default root is not there
    with pytest.raises(FileNotFoundError, match="ILSVRC"):
        loader.construct_train_loader()


def test_first_real_image_batch_and_one_f32_step_equal_jax(port_cfg, fresh_cfg, tmp_path):
    """The first train batch of the digits ImageFolder from each package's
    loader (PIL on both), bitwise; then one f32 ResNet-18 step on it from
    JAX's state against ``make_train_step``, within the K-step test's
    limits: loss 1e-5, state 1e-4 relative L2."""
    from distribuuuu_tpu_torch.data.provision import digits_imagefolder

    arch, im, classes, n = "resnet18", 32, 10, 8
    root = digits_imagefolder(str(tmp_path / "digits"), train_per_class=8)
    for c in (port_cfg, fresh_cfg):
        c.TRAIN.DATASET, c.TRAIN.IM_SIZE, c.TRAIN.BATCH_SIZE, c.RNG_SEED = root, im, n, 1
        c.MODEL.DTYPE = "float32"
    port_cfg.MODEL.ARCH, port_cfg.MODEL.NUM_CLASSES = arch, classes
    mesh = data_mesh(1)
    ours, theirs = loader.construct_train_loader(), jax_loader.construct_train_loader(mesh)
    ours.use_native = theirs.use_native = False
    it = iter(ours)
    got, batch = next(it), theirs.decode_batch(0)
    it.close()
    for key in ("image", "label", "weight"):
        np.testing.assert_array_equal(got[key], batch[key])
    assert len(set(batch["label"].tolist())) > 1
    model = jax_build_model(arch, num_classes=classes, dtype=jnp.float32)
    state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, im)
    port = TrainState(build_cfg_model())
    port.model.load_state_dict(from_jax_variables(_jax_state_tree(state)[0], arch), strict=True)
    state, m = make_train_step(model, tx, mesh, topk=5)(
        state, {k: jnp.asarray(a) for k, a in batch.items()}, jnp.float32(0.05),
        jax.random.PRNGKey(0))
    pm = train_step(port, {"image": torch.from_numpy(got["image"]),
                           "label": torch.from_numpy(got["label"]).long()}, 0.05, topk=5)
    want_loss = float(m["loss_sum"] / m["n"])
    assert abs(float(pm["loss_sum"] / pm["n"]) - want_loss) <= 1e-5 * max(1.0, want_loss)
    assert _rel_l2(port.model.state_dict(),
                   from_jax_variables(_jax_state_tree(state)[0], arch)) <= 1e-4


@pytest.mark.parametrize("name", sorted(p.name for p in (
    __import__("pathlib").Path(__file__).resolve().parents[1] / "config").glob("*.yaml")))
def test_every_repo_yaml_merges_into_the_port_config_as_into_jax(port_cfg, fresh_cfg, name):
    """Every shipped YAML merges unchanged, and every key the port shares
    with the JAX tree ends with the JAX tree's value."""
    from pathlib import Path

    from distribuuuu_tpu_torch.config import load_cfg_fom_args

    path = str(Path(__file__).resolve().parents[1] / "config" / name)
    load_cfg_fom_args(argv=["--cfg", path])
    jax_config.merge_from_file(path)

    def walk(ours, theirs, prefix=""):
        for k, v in ours.items():
            if k in theirs:
                if isinstance(v, dict):
                    walk(v, theirs[k], f"{prefix}{k}.")
                else:
                    assert v == theirs[k], f"{prefix}{k}"
    walk(port_cfg, fresh_cfg)


def test_init_follows_the_jax_initialisers(port_cfg):
    """Convs N(0, 2/fan_out), the linear U(+-1/sqrt(fan_in)) with a zero
    bias, BN ones/zeros, zero-init-residual; the same generator seed gives
    the same weights."""
    from distribuuuu_tpu_torch.models import build_model

    model = layers.init_weights(build_model("resnet50", num_classes=1000, dtype=torch.float32),
                                torch.Generator().manual_seed(0))
    w = model.layer3[0].conv2.weight.detach()  # 256 x 256 x 3 x 3: 590k draws
    assert abs(float(w.std()) / (2.0 / (256 * 9)) ** 0.5 - 1.0) < 0.01
    assert abs(float(w.mean())) < 1e-3
    bound = 1.0 / 2048**0.5
    fc_w, fc_b = model.fc.weight.detach(), model.fc.bias.detach()
    assert float(fc_w.abs().max()) <= bound and float(fc_w.std()) > 0.55 * bound
    assert float(fc_b.abs().max()) == 0.0
    assert torch.equal(model.bn1.weight, torch.ones(64)) and torch.equal(model.bn1.bias, torch.zeros(64))
    again = layers.init_weights(build_model("resnet50", num_classes=1000, dtype=torch.float32),
                                torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
    zi = layers.init_weights(build_model("resnet18", num_classes=10, zero_init_residual=True),
                             torch.Generator().manual_seed(0))
    assert float(zi.layer1[0].bn2.weight.detach().abs().max()) == 0.0
    assert float(zi.layer1[0].bn1.weight.detach().min()) == 1.0
    v = jax_build_model("resnet18", num_classes=10).init(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 32, 32, 3)))["params"]
    jw = np.asarray(v["layer3_0"]["conv2"]["kernel"])
    assert abs(float(jw.std()) / float(w.std()) - 1.0) < 0.02


def test_init_draws_botnet_position_tables_from_the_generator():
    """The position tables come from the generator (two builds from one seed
    are bitwise equal whatever the global RNG did in between) as JAX's
    ``normal(dim_head**-0.5)`` params, and each BoTBlock's bn_out starts at
    zero-γ as JAX's ``zero_scale=True``."""
    from distribuuuu_tpu_torch.models import build_model

    def build(seed, global_seed):
        torch.manual_seed(global_seed)
        return layers.init_weights(build_model("botnet50", num_classes=10, dtype=torch.float32,
                                               im_size=112), torch.Generator().manual_seed(seed))

    a, b, c = build(0, 1), build(0, 2), build(1, 1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    tables = [k for k in sa if k.endswith(("rel_height", "rel_width"))]
    assert len(tables) == 6 and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(torch.equal(sa[k], sc[k]) for k in tables)
    drawn = torch.cat([sa[k].reshape(-1) for k in tables])  # 6 x 13 x 128 draws
    assert abs(float(drawn.std()) * 128**0.5 - 1.0) < 0.03 and abs(float(drawn.mean())) < 5e-3
    from distribuuuu_tpu.models.botnet import RelPosEmb

    jt = np.concatenate([np.asarray(a).reshape(-1) for i in range(3) for a in RelPosEmb(
        7, 7, 128).init(jax.random.PRNGKey(i), jnp.zeros((1, 4, 49, 128)))["params"].values()])
    assert jt.size == drawn.numel()
    assert abs(float(jt.std()) / float(drawn.std()) - 1.0) < 0.05
    for i in range(3):
        assert float(sa[f"7.net.{i}.net.8.weight"].abs().max()) == 0.0
        assert float(sa[f"7.net.{i}.net.1.weight"].min()) == 1.0
