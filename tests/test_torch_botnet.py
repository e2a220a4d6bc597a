"""BoTNet-50 of the PyTorch port (distribuuuu_tpu_torch/models/botnet.py).

Against the JAX package on shared weights, in float32 on the CPU (where the
port's attention wrappers compute their plain versions):

- ``relative_logits_1d`` and ``MHSA`` (``rel_pos_emb`` True and False) at a
  non-square 4x6 feature map, so a swap of height and width shows, against
  JAX ``MHSA(fuse=False)``, within 1e-5;
- ``botnet50`` eval logits at 64x64 (feature map 4x4) against JAX
  ``apply(train=False)``, within ``1e-4 * max(1, max|logit|)``, on weights
  from ``perturbed_variables`` (every BN scale drawn away from 0, ``bn_out``
  included, so the attention branch reaches the logits);
- ``export_state_dict(v, "botnet50")`` loads with ``strict=True`` and
  equals ``from_jax_variables``; a forward makes 3 attention and 53 K1
  calls (every BN); with a bf16 model, K1 handing each conv its bf16 input
  changes no logit bit; a CPU ``InferenceEngine`` hosts botnet50 and
  answers with the JAX serving forward's logits.
"""

from collections import Counter

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distribuuuu_tpu.convert import export_state_dict, golden_inputs
from distribuuuu_tpu.data.transforms import device_normalize as jax_device_normalize
from distribuuuu_tpu.models import botnet as jax_botnet
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu_torch.convert import from_jax_variables
from distribuuuu_tpu_torch.models import botnet, build_model, layers
from distribuuuu_tpu_torch.serve.engine import InferenceEngine, ModelSpec
from test_torch_resnet import _mode, conv_input_dtypes, ignoring_cast_to, perturbed_variables

torch.set_num_threads(2)

IM, CLASSES = 64, 10


def _close(got: np.ndarray, ref: np.ndarray, rel: float) -> None:
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def variables():
    return perturbed_variables("botnet50", 3, im=IM, classes=CLASSES)


def port_botnet(state_dict, dtype=torch.float32):
    m = build_model("botnet50", num_classes=CLASSES, dtype=dtype, im_size=IM)
    m.load_state_dict(state_dict, strict=True)
    return m.to(memory_format=torch.channels_last).eval()


def test_relative_logits_1d_matches_jax_at_a_non_square_map():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, 4, 6, 8)).astype(np.float32)
    rel = rng.standard_normal((11, 8)).astype(np.float32)
    ref = np.asarray(jax_botnet.relative_logits_1d(jnp.asarray(q), jnp.asarray(rel)))
    got = botnet.relative_logits_1d(torch.from_numpy(q), torch.from_numpy(rel)).numpy()
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("rel", [True, False], ids=["rel_pos", "abs_table"])
def test_mhsa_matches_jax_at_a_non_square_map(rel):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    kw = dict(fmap_size=(4, 6), heads=2, dim_qk=8, dim_v=8, rel_pos_emb=rel)
    jax_mhsa = jax_botnet.MHSA(dtype=jnp.float32, fuse=False, **kw)
    params = jax_mhsa.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = np.asarray(jax_mhsa.apply({"params": params}, jnp.asarray(x)))

    def oihw(kernel):
        return torch.from_numpy(np.transpose(np.array(kernel), (3, 2, 0, 1)).copy())

    sd = {"to_qk.weight": oihw(params["to_qk"]["kernel"]),
          "to_v.weight": oihw(params["to_v"]["kernel"])}
    sd.update({f"pos_emb.{k}": torch.from_numpy(np.array(a)) for k, a in params["pos_emb"].items()})
    mhsa = botnet.MHSA(16, dtype=torch.float32, **kw)
    mhsa.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = mhsa(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _close(got, ref, 1e-5)


def test_eval_logits_match_jax(variables):
    x = golden_inputs(2, IM, 0)
    ref = np.asarray(jax_build_model("botnet50", num_classes=CLASSES, dtype=jnp.float32)
                     .apply(variables, x, train=False))
    with torch.inference_mode():
        got = port_botnet(from_jax_variables(variables, "botnet50"))(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-4)


def test_export_state_dict_loads_strict_and_equals_from_jax_variables(variables):
    exported = {k: torch.from_numpy(np.array(a)) for k, a in
                export_state_dict(variables, "botnet50").items()}
    mine = from_jax_variables(variables, "botnet50")
    assert sorted(exported) == sorted(mine)
    for k in mine:
        assert torch.equal(exported[k], mine[k]), k
    assert {"0.weight", "1.running_var", "4.0.downsample.0.weight", "6.5.bn3.bias",
            "7.net.0.shortcut.0.weight", "7.net.0.shortcut.1.running_mean",
            "7.net.2.net.3.to_qk.weight", "7.net.1.net.3.pos_emb.rel_height",
            "7.net.2.net.8.weight", "10.bias"} <= set(mine)
    port_botnet(exported)  # strict=True inside


def test_a_forward_makes_3_attention_and_53_k1_calls(monkeypatch, variables):
    """Every BN is a K1 call: the trunk's 43 (stem, 13 x 3, 3 downsample) and
    10 in the BoTBlocks (3 x bn_in/bn_mid/bn_out, one shortcut BN)."""
    calls = Counter()
    real_attn, real_k1 = botnet.fused_attention, layers.fused_conv_epilogue

    def attn_spy(q, k, v, bias):
        calls["attention"] += 1
        assert bias.dtype == q.dtype == torch.bfloat16 and bias.shape[-2:] == (16, 16)
        return real_attn(q, k, v, bias)

    def k1_spy(*a, **kw):
        calls["K1"] += 1
        calls[f"mode {_mode(kw)}"] += 1
        return real_k1(*a, **kw)

    monkeypatch.setattr(botnet, "fused_attention", attn_spy)
    monkeypatch.setattr(layers, "fused_conv_epilogue", k1_spy)
    m = port_botnet(from_jax_variables(variables, "botnet50"), dtype=torch.bfloat16)
    with torch.inference_mode():
        out = m(torch.randn(2, IM, IM, 3))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # (a): 3 trunk downsample BNs, the BoTStack's shortcut BN, the last bn_out;
    # (c): trunk bn3 before a block without projection (10), BoTBlocks 0 and 1
    assert calls == Counter({"attention": 3, "K1": 53, "mode a": 5, "mode b": 36, "mode c": 12})


def test_bf16_handoff_changes_no_logit_bit(monkeypatch, variables):
    """As for ResNet (tests/test_torch_resnet.py): bitwise the logits of the
    parent's composition, and only the stem's conv casts its input."""
    m = port_botnet(from_jax_variables(variables, "botnet50"), dtype=torch.bfloat16)
    x = torch.randn(2, IM, IM, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode(), monkeypatch.context() as mp:
        seen = conv_input_dtypes(mp)
        got = m(x)
    assert seen[0] == torch.float32 and set(seen[1:]) == {torch.bfloat16}
    with torch.inference_mode(), monkeypatch.context() as mp:
        mp.setattr(layers, "fused_conv_epilogue", ignoring_cast_to(layers.fused_conv_epilogue))
        want = m(x)
    assert torch.equal(got, want)


def test_cpu_engine_hosts_botnet50(variables, tmp_path):
    path = tmp_path / "bot.pt"
    torch.save({k: torch.from_numpy(np.array(a))
                for k, a in export_state_dict(variables, "botnet50").items()}, path)
    engine = InferenceEngine(batch_sizes=[1, 2], im_size=IM, num_classes=CLASSES,
                             compute_dtype="float32", device="cpu")
    engine.load(ModelSpec("bot", "botnet50", str(path)))
    engine.warmup()
    imgs = np.random.default_rng(2).integers(0, 256, size=(2, IM, IM, 3), dtype=np.uint8)
    got = engine.forward("bot", imgs)
    ref = np.asarray(jax_build_model("botnet50", num_classes=CLASSES, dtype=jnp.float32)
                     .apply(variables, jax_device_normalize(jnp.asarray(imgs)), train=False))
    _close(got, ref, 1e-4)


def test_tables_are_sized_by_the_crop_and_a_wrong_crop_raises():
    m = build_model("botnet50", num_classes=5, dtype=torch.float32, im_size=IM)
    assert m.state_dict()["7.net.0.net.3.pos_emb.rel_width"].shape == (7, 128)
    big = build_model("botnet50", num_classes=5, im_size=512)
    assert big.state_dict()["7.net.2.net.3.pos_emb.rel_height"].shape == (63, 128)
    assert build_model("resnet18", num_classes=5, im_size=512).fc.out_features == 5
    with torch.inference_mode(), pytest.raises(ValueError, match="im_size=96"):
        m.eval()(torch.zeros(1, 96, 96, 3))
