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


def test_epilogue_sites_are_channels_last_and_49_for_resnet50(monkeypatch, variables):
    """Every K1 call site gets a dense channels-last conv output (what the
    CUDA kernel requires), and ResNet-50 makes 49 of them: stem + 16 x 3."""
    calls = []
    real = layers.fused_conv_epilogue

    def spy(x, mean, mul, bias, identity=None, **kw):
        assert x.is_contiguous(memory_format=torch.channels_last), (x.shape, x.stride())
        if identity is not None:
            assert identity.is_contiguous(memory_format=torch.channels_last)
        calls.append((tuple(x.shape), identity is not None))
        return real(x, mean, mul, bias, identity, **kw)

    monkeypatch.setattr(layers, "fused_conv_epilogue", spy)
    m = port_model("resnet50", from_jax_variables(variables["resnet50"], "resnet50"),
                   dtype=torch.bfloat16)
    with torch.inference_mode():
        out = m(torch.randn(2, 64, 64, 3))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert len(calls) == 49
    assert Counter(res for _, res in calls) == Counter({False: 33, True: 16})
    assert calls[0] == ((2, 64, 32, 32), False)  # the stem, before the max-pool


def test_all_nine_factories_registered_with_torchvision_names():
    """The nine ResNets, plus botnet50 (tests/test_torch_botnet.py)."""
    assert set(list_models()) == {
        "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
        "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
        "botnet50",
    }
    keys = build_model("resnext50_32x4d", num_classes=5).state_dict().keys()
    assert {"conv1.weight", "bn1.running_var", "layer1.0.downsample.0.weight",
            "layer4.2.bn3.bias", "fc.weight"} <= set(keys)
    assert not any(k.endswith("num_batches_tracked") for k in keys)
