"""The port's int8 post-training quantization (distribuuuu_tpu_torch/quant/)
against the live JAX ``quant`` on the CPU, from the same weights
(``convert.from_jax_variables``), at 32 px as tests/test_quant.py.

- ``quantize_weight`` is bitwise JAX's after the layout transpose;
  ``compare_logits`` gives JAX's verdicts.
- ResNet-18 (f32, two calibration batches of 8): the same site set, kinds,
  statics and folded set as JAX's; ``act_scale`` within 1e-5 relative (the
  two f32 forwards differ by reassociation noise, ~1e-6 of an amax); each
  site's int8 weights and folded bias bitwise JAX's.
- Each of five sites' int32 accumulators (the stem's 7x7/2, a 3x3 stride 1
  and 2, the downsample's 1x1 stride 2, the fc) ``torch.equal`` to JAX's
  ``lax.conv_general_dilated``/``dot_general`` with ``preferred_element_type
  =int32`` on the same int8 input; the card's im2col route, run here on the
  CPU's ``_int_mm``, equal to it too.
- The int8 logits track JAX's ``Int8Model.apply``: the same top-1, and an
  RMSE at most half the quantization noise (JAX's int8 vs fp RMSE). They are
  not bitwise: XLA contracts the dequant ``acc * scale + bias`` into an FMA,
  one rounding where the port has two, so a value on a rounding tie
  quantizes differently downstream and the flip propagates.
- Under calibration every conv quantizes the BN boundary (f32 in a bf16
  model), as JAX's conv receives it, and the fp logits are bitwise those of
  the model's own handoffs.
- The small DenseNet folds exactly ``norm0`` and the ``norm2``s; a branch
  tapping the pre-BN conv output has its fold rejected, as in JAX.
- An ``:int8`` InferenceEngine passes the gate, journals ``quant_quality``,
  serves through the int8 modules with the fp weights gone; a failing gate
  refuses (``RuntimeError``, the record written), or serves under ``QUANT.GATE
  False``; an arch the int8 path does not take is refused.
- The 11 ``QUANT`` keys merge; ``QUANT.QAT True`` is accepted, and a bad
  ``QUANT.QAT_MODE`` raises naming the key when the trainer calibrates.
- ``CUDNN.DETERMINISTIC`` sets ``use_deterministic_algorithms`` and
  ``CUBLAS_WORKSPACE_CONFIG``; False leaves both unset.
"""

import os
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from distribuuuu_tpu import quant as jq
from distribuuuu_tpu.convert import export_state_dict, golden_inputs
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.models.densenet import DenseNet as JaxDenseNet
from distribuuuu_tpu_torch import config as port_config
from distribuuuu_tpu_torch import quant as pq
from distribuuuu_tpu_torch.convert import _family_module_name, from_jax_variables
from distribuuuu_tpu_torch.models import build_model, layers
from distribuuuu_tpu_torch.models.densenet import DenseNet
from distribuuuu_tpu_torch.obs.journal import validate_record
from distribuuuu_tpu_torch.quant import ptq
from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec
from test_torch_resnet import perturbed_variables

torch.set_num_threads(2)

IM, NC = 32, 8
# ResNet-18's 20 convs and fc; its 20 BNs each consume a conv directly
RN18_SITES, RN18_FOLDED = 21, 20


def _port_model(arch, variables, dtype=torch.float32):
    model = build_model(arch, num_classes=NC, dtype=dtype)
    model.load_state_dict(from_jax_variables(variables, arch), strict=True)
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("shape", [(3, 3, 4, 16), (64, 10), (2, 2, 3, 4)])
def test_quantize_weight_is_jax_bitwise(shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] *= 40.0  # one wild channel
    if shape == (2, 2, 3, 4):
        w[..., 0] = 0.0  # an all-zero channel: scale 1
    jw, js = jq.quantize_weight(w)
    to_torch = (3, 2, 0, 1) if w.ndim == 4 else (1, 0)  # HWIO -> OIHW, [in, out] -> [out, in]
    pw, ps = pq.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.transpose(to_torch))))
    assert pw.dtype == np.int8 and np.array_equal(pw, jw.transpose(to_torch))
    assert np.array_equal(ps, js)


def test_compare_logits_gives_jax_verdicts():
    fp = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    kw = dict(min_top1_agree=0.99, max_logit_rmse=0.25)
    for q, k in ((fp + 0.01, kw), (fp[:, ::-1].copy(), dict(kw, max_logit_rmse=10.0)),
                 (fp + 5.0, dict(kw, min_top1_agree=0.5))):
        assert pq.compare_logits(fp, q, **k).fields() == jq.compare_logits(fp, q, **k).fields()
    with pytest.raises(ValueError, match="shapes"):
        pq.compare_logits(fp, fp[:1], **kw)


@pytest.fixture(scope="module")
def rn18():
    v = perturbed_variables("resnet18", 7, im=IM, classes=NC)
    jm = jax_build_model("resnet18", num_classes=NC, dtype=jnp.float32)
    pm = _port_model("resnet18", v)
    rng = np.random.default_rng(1234)
    batches = [rng.standard_normal((8, IM, IM, 3)).astype(np.float32) for _ in range(2)]
    js = jq.calibrate(jm, v, [jnp.asarray(b) for b in batches])
    ps = pq.calibrate(pm, [torch.from_numpy(b) for b in batches])
    jqm, jqp = jq.quantize(v, js)
    pqm, pqp = pq.quantize(pm, ps)
    name = _family_module_name("resnet18")
    return dict(v=v, jm=jm, pm=pm, js={name(k.split("/")): s for k, s in js.items()}, ps=ps,
                jqm=jqm, jqp={name(k.split("/")): q for k, q in jqp.items()}, jqp_jax=jqp,
                pqm=pqm, pqp=pqp, name=name)


def test_rn18_site_table_matches_jax(rn18):
    js, ps, name = rn18["js"], rn18["ps"], rn18["name"]
    assert set(ps) == set(js) and len(ps) == RN18_SITES
    for key, p in ps.items():
        j = js[key]
        assert p.kind == j.kind
        if p.kind == "conv":
            assert (p.strides, p.padding, p.groups) == (tuple(j.strides), list(j.padding),
                                                        j.groups)
        assert p.amax == pytest.approx(j.amax, rel=1e-5)
        assert (p.bn is None) == (j.bn is None)
        if p.bn is not None:
            assert p.bn.path == name(list(j.bn.path)) and p.bn.epsilon == j.bn.epsilon
    assert rn18["pqm"].n_quantized == rn18["jqm"].n_quantized == RN18_SITES
    assert rn18["pqm"].folded == {name(f.split("/")) for f in rn18["jqm"].folded}
    assert len(rn18["pqm"].folded) == RN18_FOLDED
    for key, p in rn18["pqp"].items():
        j = rn18["jqp"][key]
        jw = np.asarray(j["w_q"])
        assert np.array_equal(p["w_q"].numpy(), jw.transpose((3, 2, 0, 1) if jw.ndim == 4
                                                             else (1, 0)))
        assert np.array_equal(p["bias"].numpy(), np.asarray(j["bias"]))
        np.testing.assert_allclose(p["act_scale"].numpy(), np.asarray(j["act_scale"]), rtol=1e-5)
        np.testing.assert_allclose(p["scale"].numpy(), np.asarray(j["scale"]), rtol=1e-5)


@pytest.mark.parametrize("site", ["conv1", "layer1.0.conv1", "layer2.0.conv1",
                                  "layer2.0.downsample.0", "fc"])
def test_rn18_int32_accumulator_equals_jax(rn18, site):
    """One site's int32 accumulator on a seeded int8 input, port (the plain
    version, and the card's im2col route on the CPU's _int_mm) vs JAX."""
    s, q = rn18["ps"][site], rn18["pqp"][site]
    mod = rn18["pm"].get_submodule(site)
    rng = np.random.default_rng(5)
    w_mat = ptq.int8_matrix(q["w_q"])
    jw = np.asarray(rn18["jqp"][site]["w_q"])
    if s.kind == "conv":
        x = rng.integers(-127, 128, size=(2, 16, 16, mod.in_channels), dtype=np.int8)
        want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(jw), s.strides, s.padding,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
        xq = torch.from_numpy(x).permute(0, 3, 1, 2)
        args = (xq, w_mat, q["w_q"].shape[0], s.kernel, s.strides, [lo for lo, _ in s.padding])
        got = ptq.int8_conv2d(*args)
        assert torch.equal(ptq._int8_conv2d_gemm(*args), got)
        got = got.permute(0, 2, 3, 1)
    else:
        x = rng.integers(-127, 128, size=(3, mod.in_features), dtype=np.int8)
        want = lax.dot_general(jnp.asarray(x), jnp.asarray(jw), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
        got = ptq.int8_linear(torch.from_numpy(x), w_mat, q["w_q"].shape[0])
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_rn18_int8_logits_track_jax(rn18):
    x = golden_inputs(16, IM, 0)
    jl = np.asarray(rn18["jqm"].apply(rn18["jm"], rn18["v"], rn18["jqp_jax"], jnp.asarray(x)))
    pl = rn18["pqm"].apply(rn18["pm"], rn18["pqp"], torch.from_numpy(x)).numpy()
    jfp = np.asarray(rn18["jm"].apply(rn18["v"], jnp.asarray(x), train=False))

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    assert pl.dtype == np.float32 and pl.shape == (16, NC)
    assert np.array_equal(pl.argmax(1), jl.argmax(1))
    assert rmse(pl, jl) <= 0.5 * rmse(jl, jfp)
    assert pq.compare_logits(jfp, pl, min_top1_agree=0.99, max_logit_rmse=0.25).passed


def test_calibration_quantizes_the_bn_boundary_of_a_bf16_model():
    """In a bf16 model K1 hands each conv its bf16 cast; under calibration
    it hands the f32 BN boundary (what JAX's conv receives and quantizes),
    and the fp logits stay bitwise the same."""
    v = perturbed_variables("resnet18", 3, im=IM, classes=NC)
    model = _port_model("resnet18", v, torch.bfloat16)
    x = torch.from_numpy(golden_inputs(2, IM, 1))
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(
        (a[0].cast if isinstance(a[0], layers.Pair) else a[0]).dtype))
        for m in model.modules() if isinstance(m, layers.Conv2d)]
    with torch.no_grad():
        plain = model(x)
        sites = pq.calibrate(model, [x])
        with layers.boundary_handoffs(model):
            relinked = model(x)
    for h in hooks:
        h.remove()
    n = len(hooks)
    assert torch.bfloat16 in seen[:n] and torch.equal(plain, relinked)
    assert {s.in_dtype for s in sites.values()} == {torch.float32} and len(sites) == RN18_SITES
    assert model.stem_handoff  # the model's own handoffs are back


def test_densenet_folds_only_post_conv_bns():
    """tests/test_quant.py's small DenseNet-BC: only the stem's norm0 and
    each layer's norm2 consume a conv directly, in JAX and in the port."""
    jm = JaxDenseNet(growth_rate=8, block_config=(2, 2), num_init_features=16, num_classes=NC,
                     dtype=jnp.float32)
    v = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IM, IM, 3)),
                                              train=False)))
    pm = DenseNet(8, (2, 2), 16, num_classes=NC, dtype=torch.float32)
    pm.load_state_dict(from_jax_variables(v, "densenet121"), strict=True)
    pm = pm.to(memory_format=torch.channels_last).eval()
    batch = np.random.default_rng(0).standard_normal((2, IM, IM, 3)).astype(np.float32)
    jqm, _ = jq.quantize(v, jq.calibrate(jm, v, [jnp.asarray(batch)]))
    pqm, _ = pq.quantize(pm, pq.calibrate(pm, [torch.from_numpy(batch)]))
    name = _family_module_name("densenet121")
    assert pqm.folded == {name(f.split("/")) for f in jqm.folded} == {
        "features.norm0", *(f"features.denseblock{b}.denselayer{i}.norm2"
                            for b in (1, 2) for i in (1, 2))}
    assert pqm.n_quantized == jqm.n_quantized


class _Tapped(torch.nn.Module):
    """conv -> BN with the pre-BN conv output tapped (``tapped``), or
    conv -> BN -> ReLU -> conv -> ReLU -> BN -> fc (one foldable BN, one
    not), tests/test_quant.py's two modules in the port."""

    def __init__(self, tapped: bool):
        super().__init__()
        self.tapped = tapped
        self.conv1 = layers.conv(3, 8, 1 if tapped else 3, dtype=torch.float32)
        self.bn1 = layers.BatchNorm(8)
        if not tapped:
            self.conv2 = torch.nn.Conv2d(8, 8, 3, padding=1)
            self.bn2 = layers.BatchNorm(8)
            self.fc = torch.nn.Linear(8, 4)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        h = self.conv1(x)
        if self.tapped:
            return (self.bn1(h) + 2.0 * h).mean((2, 3)) @ torch.ones(8, 4)
        h = torch.relu(self.conv2(torch.relu(self.bn1(h))))
        return self.fc(self.bn2(h).mean((2, 3)))


class _JaxTapped(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool = False):
        h = nn.Conv(8, (1, 1), use_bias=False, name="conv1")(x)
        skip = h
        h = nn.BatchNorm(use_running_average=not train, name="bn1")(h)
        return jnp.mean(h + 2.0 * skip, axis=(1, 2)) @ jnp.ones((8, 4), jnp.float32)


@pytest.mark.parametrize("tapped", [True, False])
def test_fold_check_rejects_a_tapped_pre_bn_value(tapped):
    torch.manual_seed(0)
    model = _Tapped(tapped).eval()
    with torch.no_grad():
        model.bn1.running_mean.add_(0.5)
        model.bn1.running_var.add_(0.5)
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(np.float32)
    sites = pq.calibrate(model, [torch.from_numpy(x)])
    qmodel, qparams = pq.quantize(model, sites)
    if tapped:
        assert sites["conv1"].bn is None and qmodel.folded == frozenset()
        assert sites["conv1"].out_dtype == sites["conv1"].raw_out_dtype
        jm = _JaxTapped()
        w = model.conv1.weight.detach().numpy().transpose(2, 3, 1, 0)
        v = {"params": {"conv1": {"kernel": w}, "bn1": {"scale": np.ones(8, np.float32),
                                                         "bias": np.zeros(8, np.float32)}},
             "batch_stats": {"bn1": {"mean": np.full(8, 0.5, np.float32),
                                     "var": np.full(8, 1.5, np.float32)}}}
        assert jq.calibrate(jm, v, [jnp.asarray(x)])["conv1"].bn is None
    else:
        assert set(sites) == {"conv1", "conv2", "fc"} and qmodel.folded == {"bn1"}
        assert sites["fc"].kind == "dense" and sites["conv2"].bn is None
    with torch.no_grad():
        fp = model(torch.from_numpy(x)).numpy()
    q = qmodel.apply(model, qparams, torch.from_numpy(x)).numpy()
    assert pq.compare_logits(fp, q, min_top1_agree=0.99, max_logit_rmse=0.25).passed


@pytest.fixture()
def rn18_weights(tmp_path):
    path = tmp_path / "rn18.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in export_state_dict(
        perturbed_variables("resnet18", 7, im=IM, classes=NC), "resnet18").items()}, path)
    return str(path)


def _engine(events, **quant):
    return InferenceEngine(batch_sizes=[1, 4], im_size=IM, num_classes=NC, input_dtype="float32",
                           compute_dtype="float32", device="cpu",
                           journal_event=lambda kind, **f: events.append(
                               dict(kind=kind, ts=time.time(), **f)),
                           quant_cfg=dict(dict(calib_batches=2), **quant))


def test_int8_engine_gates_journals_and_prunes(rn18_weights):
    events = []
    engine = _engine(events)
    hosted = engine.load(ModelSpec("q", "resnet18", rn18_weights, quant="int8"))
    assert hosted.gate.passed and hosted.quant_s > 0
    (qq,) = [e for e in events if e["kind"] == "quant_quality"]
    assert (qq["passed"], qq["mode"], qq["layers"], qq["folded_bn"]) == (
        True, "int8", RN18_SITES, RN18_FOLDED)
    engine.warmup()
    compiles = [e for e in events if e["kind"] == "serve_compile"]
    assert [(c["batch_size"], c["quant"]) for c in compiles] == [(1, "int8"), (4, "int8")]
    assert all(validate_record(e) == [] for e in events)
    # the fp weights are gone: every conv, linear and BN is an int8 module
    mods = list(hosted.module.modules())
    assert not any(isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, layers.BatchNorm))
                   for m in mods)
    assert sum(isinstance(m, (ptq.QuantConv2d, ptq.QuantLinear)) for m in mods) == RN18_SITES
    assert sum(isinstance(m, ptq.FoldedBatchNorm) for m in mods) == RN18_FOLDED
    fp = _port_model("resnet18", perturbed_variables("resnet18", 7, im=IM, classes=NC))
    x = golden_inputs(4, IM, 42)
    with torch.no_grad():
        want = fp(torch.from_numpy(x)).numpy()
    got = engine.forward("q", x)
    assert pq.compare_logits(want, got, min_top1_agree=0.99, max_logit_rmse=0.25).passed


def test_failing_gate_refuses_unless_gate_off(rn18_weights):
    events = []
    engine = _engine(events, max_logit_rmse=1e-9, calib_batches=1, calib_batch_size=4, gate_n=4)
    with pytest.raises(RuntimeError, match="refusing to serve") as exc:
        engine.load(ModelSpec("q", "resnet18", rn18_weights, quant="int8"))
    assert "QUANT.QAT" in str(exc.value) and "q" not in engine.models
    engine.quant_cfg["gate"] = False
    assert engine.load(ModelSpec("q", "resnet18", rn18_weights, quant="int8")).gate.passed is False
    assert [e["passed"] for e in events if e["kind"] == "quant_quality"] == [False, False]
    assert engine.forward("q", np.zeros((1, IM, IM, 3), np.float32)).shape == (1, NC)


def test_int8_engine_refuses_an_arch_it_does_not_take(tmp_path):
    model = build_model("efficientnet_b0", num_classes=NC, dtype=torch.float32)
    path = tmp_path / "b0.pt"
    torch.save(model.state_dict(), path)
    with pytest.raises(NotImplementedError, match="item 8c"):
        _engine([]).load(ModelSpec("q", "efficientnet_b0", str(path), quant="int8"))


_QUANT_KEYS = {"CALIB_BATCHES": 2, "CALIB_BATCH_SIZE": 4, "CALIB_SEED": 7, "GATE": False,
               "GATE_N": 8, "GATE_SEED": 3, "MIN_TOP1_AGREE": 0.9, "MAX_LOGIT_RMSE": 0.5,
               "QAT": False, "QAT_MODE": "fp8", "QAT_DISTILL": 1.0}


def test_quant_keys_merge_and_qat_raises():
    from types import SimpleNamespace

    from distribuuuu_tpu.config import cfg as jax_cfg
    from distribuuuu_tpu_torch.trainer import _build_qat, _check_supported

    cfg = port_config.cfg
    assert set(_QUANT_KEYS) == set(cfg.QUANT) == set(jax_cfg.QUANT)
    port_config.reset_cfg()
    try:
        cfg.merge_from_list([x for k, v in _QUANT_KEYS.items() for x in (f"QUANT.{k}", str(v))])
        assert {k: cfg.QUANT[k] for k in _QUANT_KEYS} == _QUANT_KEYS
        cfg.merge_from_list(["QUANT.QAT", "True", "QUANT.QAT_MODE", "int4"])
        _check_supported()  # QUANT.QAT is ported (tests/test_torch_qat.py)
        model = build_model("resnet18", num_classes=NC, dtype=torch.float32)
        with pytest.raises(ValueError, match="QUANT.QAT_MODE.*int4"):
            _build_qat(model, SimpleNamespace(fsdp=1, seq=1), "cpu")
    finally:
        port_config.reset_cfg()


def test_configure_determinism_sets_every_op_deterministic(monkeypatch):
    from distribuuuu_tpu_torch.runtime.seeding import configure_determinism

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled())
    try:
        configure_determinism(False)
        assert not torch.are_deterministic_algorithms_enabled()
        assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
        configure_determinism(True, benchmark=True)
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[:2]
        torch.use_deterministic_algorithms(before[2])
