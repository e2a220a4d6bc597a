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
  answers with the JAX serving forward's logits;
- gradients: ``MHSA(rel_pos_emb=True)`` and ``MHSA(rel_pos_emb=False)``
  (the port's attention Functions, whose CPU backward is
  ``attention_backward_reference`` / ``attention_table_backward_reference``)
  against JAX ``MHSA(fuse=True)`` (the K2 / K3 ``custom_vjp`` in interpret
  mode) at the 4x6 map for the input, ``to_qk``, ``to_v`` and both position
  tables, and at the 512^2 crop's 32x32 map (L 1024: JAX's blockwise K4 /
  K5), within 1e-5 of max(1, max|grad|); two BoTBlocks (projection, then identity
  shortcut) in train mode for one SGD step against JAX, BN scales drawn
  away from 0 so the attention branch gets a gradient;
- ``botnet50_trunk_from_resnet50`` + ``merge_pretrained`` bitwise the JAX
  functions' result on a seeded resnet50 state_dict.
"""

from collections import Counter

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distribuuuu_tpu import convert as jax_convert
from distribuuuu_tpu.convert import export_state_dict, golden_inputs
from distribuuuu_tpu.data.transforms import device_normalize as jax_device_normalize
from distribuuuu_tpu.models import botnet as jax_botnet
from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu_torch import convert
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

    mhsa = port_mhsa(params, 16, kw)
    with torch.inference_mode():
        got = mhsa(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _close(got, ref, 1e-5)


def port_mhsa(params, dim, kw):
    """The port's MHSA (f32) holding the JAX MHSA ``params``."""
    def oihw(kernel):
        return torch.from_numpy(np.transpose(np.array(kernel), (3, 2, 0, 1)).copy())

    sd = {"to_qk.weight": oihw(params["to_qk"]["kernel"]),
          "to_v.weight": oihw(params["to_v"]["kernel"])}
    sd.update({f"pos_emb.{k}": torch.from_numpy(np.array(a)) for k, a in params["pos_emb"].items()})
    mhsa = botnet.MHSA(dim, dtype=torch.float32, **kw)
    mhsa.load_state_dict(sd, strict=True)
    return mhsa


def _hwio(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(2, 3, 1, 0).numpy()


@pytest.mark.parametrize("rel", [True, False], ids=["rel_pos", "abs_table"])
def test_mhsa_gradients_match_the_jax_custom_vjp(rel):
    """f32: the two backward passes differ only in f32 summation order.
    ``rel_pos_emb=False`` runs the table mode's Function (K3's custom_vjp
    in JAX): the tables' gradients come through ``emb = height + width``."""
    _mhsa_gradients_match_jax(rel, (4, 6), batch=2, seed=7)


@pytest.mark.parametrize("rel", [True, False], ids=["rel_pos", "abs_table"])
def test_mhsa_gradients_match_the_jax_blockwise_custom_vjp_at_fmap_32(rel, monkeypatch):
    """The 512^2 crop's feature map, 32x32 (L 1024), batch 1, 2 heads of 8:
    JAX's MHSA re-tiles to the blockwise kernels (K4, or K5 in table mode, in
    interpret mode), whose custom_vjp is the one the port's blockwise route
    computes; the port runs its plain backward. The same limit as at 4x6. At
    these narrow widths the table mode's single tile fits JAX's default VMEM
    budget, so the budget is set to 8 MB, below both single-tile estimates."""
    from distribuuuu_tpu.ops import attention as jax_attention

    monkeypatch.setenv("DTPU_ATTN_VMEM_BUDGET_MB", "8")
    assert jax_attention._tile_vmem_bytes(1024, 8, 8, 4, rel) > \
        jax_attention._VMEM_GUARD.budget_bytes()
    calls = Counter()
    for name in ("_fused_attention", "_fused_attention_abs", "_fused_attention_blk",
                 "_fused_attention_abs_blk"):
        def spy(*args, _real=getattr(jax_attention, name), _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(jax_attention, name, spy)
    _mhsa_gradients_match_jax(rel, (32, 32), batch=1, seed=11)
    assert set(calls) == {"_fused_attention_blk" if rel else "_fused_attention_abs_blk"}, calls


def _mhsa_gradients_match_jax(rel, fmap, batch, seed):
    """The port's MHSA gradients (input, ``to_qk``, ``to_v``, both position
    tables) against ``jax.vjp`` of JAX ``MHSA(fuse=True)`` on its weights,
    within 1e-5 of max(1, max|grad|)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *fmap, 16)).astype(np.float32)
    g = rng.standard_normal((batch, *fmap, 16)).astype(np.float32)
    kw = dict(fmap_size=fmap, heads=2, dim_qk=8, dim_v=8, rel_pos_emb=rel)
    jax_mhsa = jax_botnet.MHSA(dtype=jnp.float32, fuse=True, **kw)
    params = jax_mhsa.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    _, pull = jax.vjp(lambda p, xx: jax_mhsa.apply({"params": p}, xx), params, jnp.asarray(x))
    dparams, dx = pull(jnp.asarray(g))
    mhsa = port_mhsa(params, 16, kw)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = mhsa(xt)
    assert type(out.grad_fn).__name__ != "NoneType"
    out.permute(0, 2, 3, 1).backward(torch.from_numpy(g))
    tables = ("rel_height", "rel_width") if rel else ("height", "width")
    for name, got, want in (
            ("x", xt.grad.permute(0, 2, 3, 1).numpy(), dx),
            ("to_qk", _hwio(mhsa.to_qk.weight.grad), dparams["to_qk"]["kernel"]),
            ("to_v", _hwio(mhsa.to_v.weight.grad), dparams["to_v"]["kernel"]),
            *((t, getattr(mhsa.pos_emb, t).grad.numpy(), dparams["pos_emb"][t]) for t in tables)):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0, name
        _close(got, want, 1e-5)


class _JaxBoTPair(__import__("flax").linen.Module):
    """Two BoTBlocks: a projection shortcut (32 -> 64), then the identity."""

    @__import__("flax").linen.compact
    def __call__(self, x, train: bool = True):
        kw = dict(fmap_size=(4, 6), dim_out=64, heads=2, dim_qk=16, dim_v=16, rel_pos_emb=True,
                  dtype=jnp.float32)
        x = jax_botnet.BoTBlock(name="bot_0", **kw)(x, train)
        return jax_botnet.BoTBlock(name="bot_1", **kw)(x, train)


def test_botblock_pair_sgd_step_matches_jax():
    """One SGD step (lr 0.1) of two BoTBlocks in train mode, f32, from the
    same weights. Gradients within 5e-4 of each tensor's max|grad|: BN over
    48 samples a channel amplifies f32 rounding, and JAX's own f32 gradients
    here lie up to 2.7e-4 of max|grad| from its float64 ones (the port's
    within 1.1e-4). After the step each parameter within that bound times
    the learning rate, the BN running statistics within 1e-5 of
    max(1, max|.|)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    g = rng.standard_normal((2, 4, 6, 64)).astype(np.float32)
    model, lr, grad_rtol = _JaxBoTPair(), 0.1, 5e-4
    v = model.init(jax.random.PRNGKey(2), jnp.asarray(x), False)
    v = jax.tree.map(np.array, {"params": v["params"], "batch_stats": v["batch_stats"]})
    for block in v["params"].values():  # every BN scale away from 0 (bn_out starts at zero-γ)
        for mod in block.values():
            if "scale" in mod:
                mod["scale"] = rng.uniform(0.5, 1.5, mod["scale"].shape).astype(np.float32)

    def loss(params):
        out, upd = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), True, mutable=["batch_stats"])
        return jnp.sum(out * g), upd

    (_, upd), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    new = {"params": jax.tree.map(lambda p, d: np.asarray(p - lr * d), v["params"], grads),
           "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])}

    blocks = [botnet.BoTBlock(dim, (4, 6), 64, heads=2, dim_qk=16, dim_v=16, rel_pos_emb=True,
                              dtype=torch.float32, bn_dtype=torch.float32).train()
              for dim in (32, 64)]

    def block_sd(variables, i):
        sd = from_jax_variables({c: {"bot_0": variables[c][f"bot_{i}"]} for c in variables},
                                "botnet50")
        return {k.removeprefix("7.net.0."): t for k, t in sd.items()}

    for i, blk in enumerate(blocks):
        blk.load_state_dict(block_sd(v, i), strict=True)
        blk.to(memory_format=torch.channels_last)
    out = blocks[1](blocks[0](torch.from_numpy(x).permute(0, 3, 1, 2)))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    for i, blk in enumerate(blocks):
        want_grads = block_sd({"params": jax.tree.map(np.asarray, grads)}, i)
        scale = {}
        for name, prm in blk.named_parameters():
            want = want_grads[name].numpy()
            scale[name] = float(np.abs(want).max())
            assert scale[name] > 0, name  # the attention branch gets a gradient
            assert float(np.abs(prm.grad.numpy() - want).max()) <= grad_rtol * scale[name], name
        with torch.no_grad():
            for prm in blk.parameters():
                prm -= lr * prm.grad
        want = block_sd(new, i)
        got = blk.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            tol = grad_rtol * lr * scale[k] if k in scale else 1e-5 * max(
                1.0, float(want[k].abs().max()))
            assert float((got[k] - want[k]).abs().max()) <= tol, k


def test_botnet50_trunk_from_resnet50_equals_jax(variables):
    """A seeded resnet50 state_dict in torchvision naming (with a ``module.``
    prefix and ``num_batches_tracked``, as torch checkpoints carry them)
    over a fresh botnet50: the trunk comes from resnet50, the BoTStack and
    the head stay; bitwise the JAX functions' result."""
    rn = export_state_dict(perturbed_variables("resnet50", 4, im=IM, classes=CLASSES), "resnet50")
    sd = {f"module.{k}": torch.from_numpy(np.array(a)) for k, a in rn.items()}
    sd["module.bn1.num_batches_tracked"] = torch.tensor(7)
    want = from_jax_variables(jax_convert.merge_pretrained(
        variables, jax_convert.botnet50_trunk_from_resnet50(sd)), "botnet50")
    fresh = from_jax_variables(variables, "botnet50")
    got = convert.merge_pretrained(fresh, convert.botnet50_trunk_from_resnet50(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["4.0.conv1.weight"], torch.from_numpy(np.array(rn["layer1.0.conv1.weight"])))
    assert torch.equal(got["7.net.0.net.3.to_qk.weight"], fresh["7.net.0.net.3.to_qk.weight"])
    port_botnet(got)  # strict=True inside
    with pytest.raises(ValueError, match="no resnet50 trunk"):
        convert.botnet50_trunk_from_resnet50({"fc.weight": torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="does not match"):
        convert.merge_pretrained(fresh, {"0.weight": torch.zeros(1)})


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
