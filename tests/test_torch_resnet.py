"""ResNet of the PyTorch port against the JAX package on shared weights.

Weights come from ``distribuuuu_tpu.convert.synthetic_variables`` with the
BN statistics and affine perturbed from numpy (so the epilogue's fold is
not the identity), carried into the port by ``from_jax_variables``. Eval
logits agree with JAX ``model.apply(train=False)`` in float32 within
``1e-4 * max(1, max|logit|)``, which covers the two frameworks' conv
summation orders.
"""

from collections import Counter

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from distribuuuu_tpu.convert import export_state_dict, golden_inputs, synthetic_variables
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu_torch.convert import from_jax_variables, load_weights
from distribuuuu_tpu_torch.models import build_model, layers, list_models

# the suite runs several test workers on one host: keep torch's intra-op
# pool small so these CPU forwards do not starve the timing-sensitive tests
torch.set_num_threads(2)

IM, CLASSES = 32, 10


def perturbed_variables(arch: str, seed: int, im: int = IM, classes: int = CLASSES) -> dict:
    """Seeded JAX variables with BN stats/affine drawn away from the identity."""
    v = synthetic_variables(arch, seed, im_size=im, num_classes=classes)
    rng = np.random.default_rng(seed)

    def perturb(tree, collection):
        out = {}
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                out[k] = perturb(leaf, collection)
            elif k == "mean":
                out[k] = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
            elif k == "bias" and collection == "params":
                out[k] = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
            else:
                out[k] = leaf
        return out

    return {c: perturb(v[c], c) for c in ("params", "batch_stats")}


def port_model(arch, state_dict, classes=CLASSES, dtype=torch.float32):
    m = build_model(arch, num_classes=classes, dtype=dtype)
    m.load_state_dict(state_dict, strict=True)
    return m.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def variables():
    return {arch: perturbed_variables(arch, 3) for arch in ("resnet18", "resnet50")}


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_eval_logits_match_jax(arch, variables):
    v = variables[arch]
    x = golden_inputs(2, IM, 0)
    ref = np.asarray(
        jax_build_model(arch, num_classes=CLASSES, dtype=jnp.float32).apply(v, x, train=False)
    )
    with torch.inference_mode():
        got = port_model(arch, from_jax_variables(v, arch))(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, CLASSES) and got.dtype == np.float32
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_export_state_dict_loads_strict_and_equals_from_jax_variables(arch, variables):
    v = variables[arch]
    exported = {k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in export_state_dict(v, arch).items()}
    mine = from_jax_variables(v, arch)
    assert sorted(exported) == sorted(mine)
    for k in mine:
        assert torch.equal(exported[k], mine[k]), k
    port_model(arch, exported)  # strict=True inside


def test_load_weights_unwraps_torchvision_layout(tmp_path, variables):
    sd = from_jax_variables(variables["resnet18"], "resnet18")
    wrapped = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    wrapped["state_dict"]["module.bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save(wrapped, tmp_path / "w.pth")
    loaded = load_weights(str(tmp_path / "w.pth"))
    assert sorted(loaded) == sorted(sd)
    port_model("resnet18", loaded)


def _mode(kw) -> str:
    """K1's mode: (a) the BN boundary, (b) the next conv's input, (c) both."""
    if kw.get("cast_to") is None:
        return "a"
    return "c" if kw.get("keep_boundary", True) else "b"


# arch -> (launches, by residual, by relu, by mode, the stem's mode): every BN
# is a K1 call; bn3 (bn2) writes both forms only where the next block has no
# projection, the compute dtype alone where it has one, the boundary alone
# before the head; the downsample BNs write the boundary, without ReLU
K1_SITES = {
    "resnet50": (53, {False: 37, True: 16}, {True: 49, False: 4}, {"a": 5, "b": 36, "c": 12}, "b"),
    "resnet18": (20, {False: 12, True: 8}, {True: 17, False: 3}, {"a": 4, "b": 11, "c": 5}, "c"),
}


@pytest.mark.parametrize("arch", ["resnet50", "resnet18"])
def test_epilogue_sites_are_channels_last_and_53_for_resnet50(arch, monkeypatch, variables):
    """Every K1 call site gets a dense channels-last conv output (what the
    CUDA kernel requires). Every BN is one: ResNet-50 makes 53 (stem + 16 x 3
    + 4 downsample BNs), ResNet-18 20 (stem + 8 x 2 + 3)."""
    calls = []
    real = layers.fused_conv_epilogue

    def spy(x, mean, mul, bias, identity=None, **kw):
        assert x.is_contiguous(memory_format=torch.channels_last), (x.shape, x.stride())
        if identity is not None:
            assert identity.is_contiguous(memory_format=torch.channels_last)
            assert identity.dtype == torch.float32  # the boundary, never the bf16 form
        calls.append((tuple(x.shape), identity is not None, kw["relu"], _mode(kw)))
        return real(x, mean, mul, bias, identity, **kw)

    monkeypatch.setattr(layers, "fused_conv_epilogue", spy)
    m = port_model(arch, from_jax_variables(variables[arch], arch), dtype=torch.bfloat16)
    with torch.inference_mode():
        out = m(torch.randn(2, 64, 64, 3))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    n, by_res, by_relu, by_mode, stem = K1_SITES[arch]
    assert len(calls) == n
    assert Counter(c[1] for c in calls) == Counter(by_res)
    assert Counter(c[2] for c in calls) == Counter(by_relu)
    assert Counter(c[3] for c in calls) == Counter(by_mode)
    assert calls[0] == ((2, 64, 32, 32), False, True, stem)  # the stem, before the max-pool
    assert calls[-1][1:] == (True, True, "a")  # the last block feeds the f32 head


def ignoring_cast_to(real):
    """K1 as the model called it before the hand-off: the BN boundary only,
    each conv casting its input itself (mode (c) gets the boundary twice)."""

    def k1(*args, cast_to=None, keep_boundary=True, **kw):
        out = real(*args, **kw)
        return (out, out) if cast_to is not None and keep_boundary else out

    return k1


def conv_input_dtypes(monkeypatch) -> list:
    """Spy on every conv's input dtype (a Pair's ``cast``) for one forward."""
    seen = []
    real = layers.Conv2d.forward

    def spy(self, x):
        seen.append((x.cast if isinstance(x, layers.Pair) else x).dtype)
        return real(self, x)

    monkeypatch.setattr(layers.Conv2d, "forward", spy)
    return seen


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_bf16_handoff_changes_no_logit_bit(arch, monkeypatch, variables):
    """K1 writing each conv's bf16 input (modes b/c) gives bitwise the
    logits of casting the f32 boundary in the conv (the parent's
    composition), and leaves no conv but the stem's to cast its input."""
    m = port_model(arch, from_jax_variables(variables[arch], arch), dtype=torch.bfloat16)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode(), monkeypatch.context() as mp:
        seen = conv_input_dtypes(mp)
        got = m(x)
    assert seen[0] == torch.float32 and set(seen[1:]) == {torch.bfloat16}
    with torch.inference_mode(), monkeypatch.context() as mp:
        mp.setattr(layers, "fused_conv_epilogue", ignoring_cast_to(layers.fused_conv_epilogue))
        seen = conv_input_dtypes(mp)
        want = m(x)
    assert set(seen) == {torch.float32}  # the parent's composition: every conv casts
    assert torch.equal(got, want)


def test_bf16_max_pool_commutes_with_the_cast():
    """The stem pools its bf16 form: max commutes with a monotone rounding,
    and the implicit -inf padding never wins, even where a window's values
    are all negative."""
    x = torch.randn(2, 64, 17, 17, generator=torch.Generator().manual_seed(5)) * 3
    x[:, :, 0, :] = -torch.rand(2, 64, 17) - 1  # all-negative border windows
    x = x.to(memory_format=torch.channels_last)
    pooled = layers.max_pool(layers.Pair(x, x.bfloat16()))
    assert pooled.cast.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(pooled.cast, pooled.boundary.bfloat16())
    assert torch.equal(pooled.boundary, F.max_pool2d(x, 3, 2, 1))


def test_all_nine_factories_registered_with_torchvision_names():
    """The nine ResNets, plus botnet50 (tests/test_torch_botnet.py), the
    rest of the zoo (tests/test_torch_zoo.py) and the MAE ViTs
    (tests/test_torch_mae.py)."""
    assert set(list_models()) == {
        "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
        "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
        "botnet50", "densenet121", "densenet161", "densenet169", "densenet201",
        "regnetx_160", "regnety_040", "regnety_160", "regnety_320", "efficientnet_b0",
        "efficientnet_b1", "vit_s16", "vit_b16", "vit_l16", "mae_vit_s16", "mae_vit_b16",
        "mae_vit_l16",
    }
    keys = build_model("resnext50_32x4d", num_classes=5).state_dict().keys()
    assert {"conv1.weight", "bn1.running_var", "layer1.0.downsample.0.weight",
            "layer4.2.bn3.bias", "fc.weight"} <= set(keys)
    assert not any(k.endswith("num_batches_tracked") for k in keys)
