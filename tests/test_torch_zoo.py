"""DenseNet, RegNet, EfficientNet and ViT of the PyTorch port against the JAX package.

(MAE has its own file, ``test_torch_mae.py``; every JAX zoo name, MAE
included, is registered.)

Each family is built small through the JAX classes' own constructor
fields (``tests/_torch_zoo.py``: ``FAMILIES``), with weights drawn from a
numpy seed and carried into the port by ``from_jax_variables``. Training
against ``make_train_step``, the mid-epoch resume and the trainer's checks
are in ``test_torch_zoo_train.py``. Tolerances:

- eval logits in f32 within ``1e-5 * max(1, max|logit|)`` of JAX
  ``apply(train=False)`` (the convs' and matmuls' summation orders;
  measured up to 6.6e-7); in bf16 (compute bf16, BN boundaries f32, as
  served) within ``3e-2 * max(1, max|logit|)`` of JAX's bf16 forward and
  ``5e-2`` of JAX's f32 one (``chip_smoke.BF16_REL_TOL``). Both round to
  bf16 at every op, but XLA on the CPU keeps f32 across a fused chain of
  elementwise ops where eager PyTorch rounds each: measured 1.3e-3 to
  2.8e-3 for the CNNs and 1.6e-2 for ViT, whose peaky attention amplifies
  a few bf16 ulps (JAX's own bf16 ViT lies 1.1e-2 from its f32 one, the
  port's 1.9e-2); a wrong layer moves logits by O(1);
- ``export_state_dict`` equals ``from_jax_variables`` bitwise and loads
  with ``strict=True``; at full size the parameter counts equal JAX's
  tables and the state_dict keys and shapes JAX's export;
- every BN input channels-last dense with a width K1's vector route takes
  (what K1 needs on the card), one K1 call for every BN of the JAX tree;
- the initialisers' moments against the JAX initialisers drawn at the
  same shapes, within 3 %;
- the dropout stream: kept values exactly ``h / keep``, the same key the
  same mask, another rank, step or micro-step another.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_zoo import (
    CLASSES,
    FAMILIES,
    FULL_PARAMS,
    images,
    jax_logits,
    jax_model,
    port_model,
    shapes,
    zoo_variables,
)
from distribuuuu_tpu.convert import export_state_dict
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu_torch.config import reset_cfg
from distribuuuu_tpu_torch.convert import from_jax_variables, load_weights
from distribuuuu_tpu_torch.models import build_model, layers, list_models
from distribuuuu_tpu_torch.models.densenet import DenseNet
from distribuuuu_tpu_torch.models.efficientnet import EfficientNet
from distribuuuu_tpu_torch.models.vit import ViT
from distribuuuu_tpu_torch.trainer import TrainState, dropout_seed, train_step

torch.set_num_threads(2)  # the suite runs several test workers on one host


@pytest.fixture(scope="module")
def variables():
    return zoo_variables()


def _bn_count(v) -> int:
    return sum(1 for path, _ in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]
               if path[-1].key == "mean")


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_logits_match_jax(family, dtype, variables):
    v = variables[family]
    x = images(4, 1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    ref = jax_logits(jax_model(family, jdt), v, x)
    m = port_model(family, tdt)
    m.load_state_dict(from_jax_variables(v, FAMILIES[family][3]), strict=True)
    with torch.inference_mode():
        got = m.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (4, CLASSES) and got.dtype == np.float32
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= (1e-5 if dtype == "float32" else 3e-2) * scale
    if dtype == "bfloat16":
        f32 = jax_logits(jax_model(family), v, x)
        assert float(np.abs(got - f32).max()) <= 5e-2 * max(1.0, float(np.abs(f32).max()))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_state_dict_loads_strict_and_equals_from_jax_variables(family, variables):
    v, arch = variables[family], FAMILIES[family][3]
    exported = {k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in export_state_dict(v, arch).items()}
    mine = from_jax_variables(v, arch)
    assert sorted(exported) == sorted(mine)
    for k in mine:
        assert torch.equal(exported[k], mine[k]), k
    port_model(family).load_state_dict(exported, strict=True)


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_size_parameters_and_keys_equal_jax(arch):
    """At full width (shapes only: JAX's ``eval_shape`` and the port on the
    meta device): the parameter count of JAX's tables, and the port's
    state_dict keys and shapes equal to JAX's export."""
    tree = shapes(jax_build_model(arch, num_classes=1000), 224)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    with torch.device("meta"):
        port = build_model(arch, num_classes=1000, im_size=224)
    assert sum(p.numel() for p in port.parameters()) == FULL_PARAMS[arch]
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree["params"])) == \
        FULL_PARAMS[arch]
    exported = {k: tuple(a.shape) for k, a in export_state_dict(zeros, arch).items()}
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == exported


def test_every_jax_zoo_name_but_mae_is_registered():
    """Every arch the JAX package's own zoo modules register (other tests
    register archs of their own in the same process), the MAE ViTs
    included, is the port's. Each MAE ViT has JAX's parameter count at full
    width (``jax.eval_shape`` against the port on the meta device), and
    ``mae_vit_s16``'s full-width JAX tree converts onto the port's keys and
    shapes exactly."""
    from distribuuuu_tpu.models.registry import _REGISTRY as jax_registry

    zoo = {name for name, factory in jax_registry.items()
           if factory.__module__.startswith("distribuuuu_tpu.models.")}
    assert "densenet121" in zoo and "vit_l16" in zoo and "mae_vit_b16" in zoo
    assert set(list_models()) == zoo
    for arch in sorted(a for a in zoo if a.startswith("mae_")):
        tree = shapes(jax_build_model(arch, num_classes=1000), 224)
        with torch.device("meta"):
            port = build_model(arch, num_classes=1000, im_size=224)
        assert sum(p.numel() for p in port.parameters()) == \
            sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree["params"]))
        if arch == "mae_vit_s16":
            zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
            got = {k: tuple(t.shape) for k, t in from_jax_variables(zeros, arch).items()}
            assert got == {k: tuple(t.shape) for k, t in port.state_dict().items()}


@pytest.mark.parametrize("family", ["densenet", "regnet", "efficientnet"])
def test_every_bn_is_one_k1_call_on_a_channels_last_input(family, variables, monkeypatch):
    """In a bf16 forward (f32 boundaries, as served) and a train-mode one
    (bf16 boundaries, drop path active for EfficientNet), every K1 call
    gets a dense channels-last input (and residual), and there is one a BN
    of the JAX tree."""
    calls = []
    real = layers.fused_conv_epilogue

    def spy(x, mean, mul, bias, identity=None, **kw):
        assert x.is_contiguous(memory_format=torch.channels_last), (x.shape, x.stride())
        assert identity is None or identity.is_contiguous(memory_format=torch.channels_last)
        assert x.shape[1] % 8 == 0  # the vector route's width
        calls.append(tuple(x.shape))
        return real(x, mean, mul, bias, identity, **kw)

    monkeypatch.setattr(layers, "fused_conv_epilogue", spy)
    v = variables[family]
    m = port_model(family, torch.bfloat16)
    m.load_state_dict(from_jax_variables(v, FAMILIES[family][3]), strict=True)
    x = torch.from_numpy(images(4, 2))
    with torch.inference_mode():
        m.eval()(x)
    assert len(calls) == _bn_count(v)
    calls.clear()
    _, pcls, fields, _ = FAMILIES[family]
    if family == "efficientnet":
        fields = dict(fields, drop_path_rate=0.5)
    t = pcls(num_classes=CLASSES, dtype=torch.bfloat16, bn_dtype=torch.bfloat16, **fields)
    layers.set_generator(t, torch.Generator().manual_seed(0))
    t.train()(x).float().sum().backward()
    assert len(calls) == _bn_count(v)


def test_init_follows_the_jax_initialisers():
    """The families' JAX initialisers, each against the JAX initialiser
    itself drawn at the same shape: convs N(0, 2/fan_out); SE convs flax
    ``nn.Conv``'s ``lecun_normal`` (cut at +-2 sigma, rescaled to std
    sqrt(1/fan_in)) with zero biases; the CNN heads U(+-1/sqrt(fan_in));
    ViT's patch embedding, class token and position table flax's
    ``truncated_normal(0.02)`` (N(0, 0.02) cut at +-0.04: std 0.0176),
    xavier-uniform encoder linears with zero biases, LayerNorm ones and
    zeros, a zero head. The same generator seed gives the same weights."""
    import flax.linen as fnn

    from distribuuuu_tpu.models.layers import kaiming_normal_out
    from distribuuuu_tpu.models.vit import trunc_normal_02, xavier_uniform

    def init(m, seed=0):
        return layers.init_weights(m, torch.Generator().manual_seed(seed))

    def jax_std(initializer, shape):
        return float(np.asarray(initializer(jax.random.PRNGKey(1), shape)).std())

    def near(a, b, rel=0.03):
        return abs(a / b - 1.0) < rel

    eff = init(EfficientNet(num_classes=1000, dtype=torch.float32))
    blk = eff.blocks[5][0]
    se = blk.se.conv_reduce.weight.detach()  # 28 x 672: lecun over fan-in 672
    assert near(float(se.std()), jax_std(fnn.initializers.lecun_normal(), (1, 1, 672, 28)))
    assert near(float(se.std()) * 672**0.5, 1.0)
    assert float(se.abs().max()) <= 2.0 / 0.87962566103423978 / 672**0.5 + 1e-7
    assert float(blk.se.conv_reduce.bias.detach().abs().max()) == 0.0
    dw = blk.conv_dw.weight.detach()  # 672 x 1 x 5 x 5, fan_out 672 * 25
    assert near(float(dw.std()), jax_std(kaiming_normal_out, (5, 5, 1, 672)))
    bound = 1.0 / 1280**0.5
    assert float(eff.classifier.weight.detach().abs().max()) <= bound

    def vit(seed=0):
        return init(ViT(patch=16, dim=384, depth=1, num_heads=6, mlp_dim=1536, im_size=224,
                        num_classes=1000, dtype=torch.float32), seed)

    v = vit()
    for mine, shape in ((v.conv_proj.weight, (16, 16, 3, 384)),
                        (v.encoder.pos_embedding, (1, 197, 384))):
        mine = mine.detach()
        assert near(float(mine.std()), jax_std(trunc_normal_02, shape))
        assert near(float(mine.std()), 0.02 * 0.87962566103423978)
        assert 0.039 < float(mine.abs().max()) <= 0.04
    assert float(v.class_token.detach().abs().max()) <= 0.04
    assert tuple(v.class_token.shape) == (1, 1, 384)
    block = v.encoder.layers.encoder_layer_0
    qkv = block.self_attention.in_proj_weight.detach()  # [3D, D]
    assert near(float(qkv.std()), jax_std(xavier_uniform, (384, 3 * 384)))
    assert float(qkv.abs().max()) <= (6.0 / (384 + 3 * 384)) ** 0.5
    fc1 = block.mlp.linear_1.weight.detach()
    assert near(float(fc1.std()), jax_std(xavier_uniform, (384, 1536)))
    assert float(block.self_attention.in_proj_bias.detach().abs().max()) == 0.0
    assert float(block.mlp.linear_1.bias.detach().abs().max()) == 0.0
    assert torch.equal(block.ln_1.weight.detach(), torch.ones(384))
    assert float(v.heads.head.weight.detach().abs().max()) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(v.state_dict().values(),
                                                  vit().state_dict().values()))
    assert not torch.equal(v.encoder.pos_embedding, vit(1).encoder.pos_embedding)

    dn = init(DenseNet(32, (6, 12, 24, 16), 64, num_classes=1000, dtype=torch.float32))
    w = dn.features.denseblock3.denselayer1.conv2.weight.detach()  # 32 x 128 x 3 x 3
    assert near(float(w.std()), jax_std(kaiming_normal_out, (3, 3, 128, 32)))
    bound = 1.0 / 1024**0.5
    fc = dn.classifier.weight.detach()
    assert float(fc.abs().max()) <= bound and float(fc.std()) > 0.55 * bound
    rn = init(build_model("regnety_040", num_classes=1000, dtype=torch.float32))
    assert float(rn.s2.b1.se.fc1.bias.detach().abs().max()) == 0.0
    assert rn.s2.b1.se.fc1.out_channels == 32  # round(0.25 * 128), the block's input width
    assert torch.equal(rn.s2.b1.conv3.bn.weight.detach(), torch.ones(192))


@pytest.mark.parametrize("kind", ["drop_path", "dropout"])
def test_random_masks_keep_exactly_h_over_keep_and_follow_their_key(kind):
    """Kept values are exactly ``h / keep`` in ``h``'s dtype, dropped ones 0;
    the same ``(seed, epoch, step, micro, rank)`` gives the same mask,
    another rank or step another; no generator in training raises."""
    layer = (layers.DropPath if kind == "drop_path" else layers.Dropout)(0.3).train()
    h = torch.randn(64, 8, 4, 4).bfloat16()
    with pytest.raises(RuntimeError, match="needs a generator"):
        layer(h)

    def masked(key):
        layers.set_generator(layer, torch.Generator().manual_seed(dropout_seed(*key)))
        return layer(h)

    out = masked((3, 1, 5, 0, 0))
    kept = out != 0
    assert out.dtype == h.dtype
    assert torch.equal(out[kept], (h / 0.7)[kept])
    share = float(kept.float().mean())
    assert 0.55 < share < 0.85
    if kind == "drop_path":  # one draw a sample
        assert torch.equal(kept, kept[:, :1, :1, :1].expand_as(kept) & (h != 0))
    assert torch.equal(masked((3, 1, 5, 0, 0)), out)
    assert not torch.equal(masked((3, 1, 5, 0, 1)), out)  # another rank
    assert not torch.equal(masked((3, 1, 6, 0, 0)), out)  # another step
    assert not torch.equal(masked((3, 1, 5, 1, 0)), out)  # another micro-step
    assert torch.equal(layer.eval()(h), h)


def test_efficientnet_with_rates_draws_only_in_training(variables):
    """With its default rates (drop path 0.2, dropout 0.2) the small
    EfficientNet's eval forward equals JAX's, draws nothing and needs no
    generator; a train step through the trainer draws from the key's stream
    (two keys, two results; one key, one result)."""
    jcls, pcls, fields, arch = FAMILIES["efficientnet"]
    fields = dict(fields, dropout=0.2, drop_path_rate=0.2)
    v, x = variables["efficientnet"], images(4, 3)
    ref = jax_logits(jcls(num_classes=CLASSES, dtype=jnp.float32, **fields), v, x)
    m = pcls(num_classes=CLASSES, dtype=torch.float32, **fields)
    m.load_state_dict(from_jax_variables(v, arch), strict=True)
    with torch.inference_mode():
        got = m.eval()(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-5 * max(1.0, float(np.abs(ref).max()))
    reset_cfg()
    try:
        rng = np.random.default_rng(9)
        batch = {"image": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)),
                 "label": torch.from_numpy(rng.integers(0, CLASSES, 8))}
        results = []
        for key in ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 1, 0)):
            st = TrainState(pcls(num_classes=CLASSES, dtype=torch.float32, **fields))
            st.model.load_state_dict(from_jax_variables(v, arch), strict=True)
            assert st.draws
            train_step(st, batch, 0.05, dropout_key=key)
            results.append(st.params.clone())
        assert torch.equal(results[0], results[1]) and not torch.equal(results[0], results[2])
        with pytest.raises(RuntimeError, match="needs a generator"):
            train_step(st, batch, 0.05)
    finally:
        reset_cfg()


def test_load_weights_remaps_densenet_legacy_keys(tmp_path, variables):
    sd = from_jax_variables(variables["densenet"], "densenet121")
    legacy = {re.sub(r"(denselayer\d+\.(?:norm|conv))([12])\.", r"\1.\2.", k): t
              for k, t in sd.items()}
    assert legacy.keys() != sd.keys()
    torch.save({"state_dict": {f"module.{k}": t for k, t in legacy.items()}}, tmp_path / "w.pth")
    loaded = load_weights(str(tmp_path / "w.pth"))
    assert sorted(loaded) == sorted(sd)
    port_model("densenet").load_state_dict(loaded, strict=True)


def test_vit_serves_channels_last_through_the_engine(tmp_path):
    """The engine moves the model channels-last (a ViT keeps working) and
    sizes its position table from SERVE.IM_SIZE; its logits equal the
    model's own f32 forward of the same normalized batch."""
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec

    model = layers.init_weights(build_model("vit_s16", num_classes=CLASSES, dtype=torch.float32,
                                            im_size=48), torch.Generator().manual_seed(0))
    with torch.no_grad():  # a zero head would make every logit 0
        model.heads.head.weight.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(1))
    full = model.state_dict()
    torch.save(full, tmp_path / "vit.pt")
    engine = InferenceEngine(batch_sizes=[2], im_size=48, num_classes=CLASSES,
                             compute_dtype="float32", device="cpu")
    hosted = engine.load(ModelSpec(name="v", arch="vit_s16", weights=str(tmp_path / "vit.pt")))
    assert hosted.module.encoder.pos_embedding.shape == (1, 10, 384)
    x = np.random.default_rng(0).integers(0, 256, (2, 48, 48, 3), dtype=np.uint8)
    got = engine.forward("v", x)
    ref = build_model("vit_s16", num_classes=CLASSES, dtype=torch.float32, im_size=48)
    ref.load_state_dict(full, strict=True)
    with torch.inference_mode():
        want = ref.eval()(device_normalize(torch.from_numpy(x))).numpy()
    assert np.allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))
