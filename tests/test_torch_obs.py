"""The port's telemetry (``distribuuuu_tpu_torch/obs``) against the JAX package's ``obs``, on the CPU.

- ``SCHEMA`` is JAX's but for ``run_start``'s ``torch_version``, and the
  two validators return the same errors on tests/test_obs.py's good and bad
  records;
- ``render`` of tests/test_obs.py's golden records is JAX's text line for
  line but the compile line (the port reports its nvcc builds), and the
  CLI's exit codes are JAX's;
- the journal's torn tail, its healing by a relaunch and ``.part<N>``;
- ``classify_op`` on kernel names the card's profiles show and the port's
  ``.cu`` files define;
- ``mfu`` by hand and the peak table by card name;
- ``step_flops``: a dense-only model is 4·B·I·O exactly and JAX's lowered
  step the same products plus its elementwise ops; ResNet-18 at 64^2 and
  ResNet-50 at 224^2 are the hand count of every full kernel window, and
  XLA's count is the taps inside the unpadded input (one padded conv
  exactly; each step within XLA's elementwise share above that count).
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from distribuuuu_tpu.models import build_model as jax_build_model
from distribuuuu_tpu.models import registry as jax_registry
from distribuuuu_tpu.obs import flops as jax_flops
from distribuuuu_tpu.obs import journal as jax_journal
from distribuuuu_tpu.obs.summarize import render as jax_render
from distribuuuu_tpu.runtime import data_mesh
from distribuuuu_tpu.trainer import create_train_state, make_train_step
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.models import registry
from distribuuuu_tpu_torch.obs import attribution, flops, journal
from distribuuuu_tpu_torch.obs.__main__ import main as obs_cli
from distribuuuu_tpu_torch.obs.summarize import render
from test_obs import _GOLDEN_RECORDS

DENSE = dict(im=16, classes=512, batch=256)  # I = 16 * 16 * 3

class _PortDense(torch.nn.Module):
    def __init__(self, num_classes=1000, dtype=torch.bfloat16, **_):
        super().__init__()
        self.fc = torch.nn.Linear(DENSE["im"] ** 2 * 3, num_classes)
        self.dtype = dtype

    def forward(self, x):
        fc, dt = self.fc, self.dtype
        return torch.nn.functional.linear(x.reshape(x.shape[0], -1).to(dt),
                                          fc.weight.to(dt), fc.bias.to(dt)).float()


class _JaxDense(fnn.Module):
    num_classes: int = 1000

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Dense(self.num_classes)(x.reshape(x.shape[0], -1))


@pytest.fixture()
def port_cfg():
    reset_cfg()
    yield cfg
    reset_cfg()


@pytest.fixture()
def dense_arch():
    """``obs_dense`` in both registries for one test (every test worker
    imports this file: a registration at import would show in other files'
    registry tests)."""
    registry.register_model("obs_dense")(_PortDense)
    jax_registry.register_model("obs_dense")(
        lambda num_classes, dtype=None, bn_axis_name=None, remat=False: _JaxDense(num_classes))
    yield
    registry._REGISTRY.pop("obs_dense")
    jax_registry._REGISTRY.pop("obs_dense")


def _to_port(rec: dict) -> dict:
    """A JAX record as the port writes it (``torch_version`` for ``jax_version``)."""
    rec = dict(rec)
    if "jax_version" in rec:
        rec["torch_version"] = rec.pop("jax_version")
    return rec


def test_schema_is_jax_but_torch_version():
    want = dict(jax_journal.SCHEMA)
    required, optional = want["run_start"]
    required = dict(required)
    required["torch_version"] = required.pop("jax_version")
    want["run_start"] = (required, optional)
    assert journal.SCHEMA == want


_RECORDS = [
    {"ts": 1.0, "kind": "fault_skipped_steps", "epoch": 0, "count": 2},
    {"ts": 2.0, "kind": "eval", "epoch": 1, "acc1": 76.4, "acck": 93.1, "loss": None,
     "wall_s": 1.5, "samples": 64.0},
    {"ts": 1.0, "kind": "preempt", "epoch": 1, "step": 3, "path": "x"},
    {"ts": 1.0, "kind": "no_such_kind"},
    {"kind": "preempt"},
    {"ts": 1.0, "kind": "preempt", "epoch": "one", "step": 3, "path": "x"},
    {"ts": 1.0, "kind": "preempt", "epoch": 1, "step": True, "path": "x"},
    {"ts": 1.0, "kind": "eval"},
    ["not", "a", "record"],
    {"ts": 1.0},
    *_GOLDEN_RECORDS,
]


@pytest.mark.parametrize("i", range(len(_RECORDS)))
def test_validate_record_agrees_with_jax(i):
    rec = _RECORDS[i]
    port_rec = _to_port(rec) if isinstance(rec, dict) else rec
    assert journal.validate_record(port_rec) == jax_journal.validate_record(rec)


def test_render_is_jax_golden_text_but_the_build_line(tmp_path, capsys):
    want = jax_render(_GOLDEN_RECORDS).splitlines()
    got = render([_to_port(r) for r in _GOLDEN_RECORDS]).splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.startswith("compiles:"):
            assert g == "builds: 0 nvcc build(s), 0.0s total"
        else:
            assert g == w
    path = tmp_path / "g.jsonl"
    path.write_text("".join(json.dumps(_to_port(r)) + "\n" for r in _GOLDEN_RECORDS))
    assert obs_cli(["validate", str(path)]) == 0
    assert obs_cli(["summarize", str(path)]) == 0
    assert "run r1: resnet50 on 8xTPU v5 lite" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ts": 1.0, "kind": "eval"}\n')
    corrupt = tmp_path / "corrupt.jsonl"
    corrupt.write_text('not json\n{"ts": 1.0, "kind": "fault_skipped_steps", "epoch": 0, '
                       '"count": 1}\n')
    assert obs_cli(["validate", str(bad)]) == 1
    assert obs_cli(["validate", str(corrupt)]) == obs_cli(["summarize", str(corrupt)]) == 1
    with pytest.raises(SystemExit) as exc:
        obs_cli([])
    assert exc.value.code == 2


def test_torn_tail_healing_and_parts(tmp_path):
    path = tmp_path / "j.jsonl"
    path.write_text('{"ts": 1.0, "kind": "fault_skipped_steps", "epoch": 0, "count": 1}\n'
                    '{"ts": 2.0, "kind": "fau')  # a kill mid-append
    assert [r["epoch"] for r in journal.read_journal(str(path))] == [0]
    with pytest.raises(json.JSONDecodeError):
        list(journal.read_journal(str(path), strict=True))
    j = journal.Journal(str(path), fsync=True)  # a relaunch drops the torn line first
    j.append({"ts": np.float64(3.0), "kind": "fault_skipped_steps", "epoch": np.int32(1),
              "count": 2})
    j.commit()
    j.close()
    j.append({"ts": 4.0, "kind": "fault_skipped_steps", "epoch": 9, "count": 1})  # closed
    for suffix, epoch in ((".part2", 3), (".part1", 2)):  # read back in part order
        with open(str(path) + suffix, "w") as f:
            f.write(json.dumps({"ts": 5.0, "kind": "fault_skipped_steps", "epoch": epoch,
                                "count": 1}) + "\n")
    recs = list(journal.read_journal(str(path)))
    assert [r["epoch"] for r in recs] == [0, 1, 2, 3]
    assert list(jax_journal.read_journal(str(path))) == recs
    assert journal.validate_journal(str(path)) == []


# kernel names from the card's profiler windows (torch.profiler, H100) and
# the ``__global__`` functions of ``ops/csrc/*.cu``
_KERNELS = [
    ("void epilogue_vec_kernel<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, "
     "__nv_bfloat16, true>(__nv_bfloat16 const*, float const*)", "vector"),
    ("void epilogue_scalar_kernel<float, float, float, float, float, false>(float const*)",
     "vector"),
    ("epilogue_bwd_bf16_kernel(BwdArgs, int, int)", "vector"),
    ("epilogue_bwd_finalize(float const*, float*, int, int)", "vector"),
    ("moe_dispatch_kernel", "vector"),
    ("moe_combine_bwd_kernel", "vector"),
    ("void attention_mma_kernel<true>(AttnArgs)", "matmul"),
    ("attention_bwd_cluster_kernel", "matmul"),
    ("attention_bwd_kv_kernel", "matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "matmul"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nh", "matmul"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tiles", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>"
     "(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8::Params)", "matmul"),
    ("cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_optimized_bf16_64x64>",
     "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "vector"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "vector"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "infeed"),
    ("Memcpy DtoH (Device -> Pageable)", "infeed"),
    ("Memcpy DtoD (Device -> Device)", "vector"),
    ("Memset (Device)", "vector"),
]


@pytest.mark.parametrize("name, bucket", _KERNELS)
def test_classify_op_on_card_kernel_names(name, bucket):
    assert attribution.classify_op(name) == bucket


def test_attribution_folds_a_window_into_buckets():
    names = [n for n, _ in _KERNELS]
    trace = {"events": [[n, 10.0 * i, 10.0 * i + 1000.0] for i, n in enumerate(names)],
             "host_events": [["cudaMemcpyAsync", 0.0, 500.0]]}
    rec = attribution.attribute_trace(trace, 2)
    per = {b: sum(0.5 for n, bb in _KERNELS if bb == b) for b in attribution.BUCKETS}
    assert rec["buckets"] == dict(per, host=0.25)
    assert rec["device_ms_per_step"] == pytest.approx(0.5 * len(names))
    assert rec["matmul_pct"] == pytest.approx(100.0 * per["matmul"] / (0.5 * len(names)), abs=0.01)
    assert attribution.attribute_trace({}, 2)["device_ms_per_step"] is None


def test_mfu_by_hand_and_the_peak_table():
    """tests/test_obs.py's hand case, (256 * 12.3e9 / 0.1) / (8 * 197e12),
    in both packages; an H100 at its datasheet's dense bf16 rate."""
    for f in (flops.mfu, jax_flops.mfu):
        assert f(256 * 12.3e9, 0.1, 8, 197e12) == pytest.approx(0.0199797, rel=1e-4)
        assert f(None, 0.1, 8, 197e12) is None and f(1e9, 0.1, 8, None) is None
        assert f(1e9, 0.0, 8, 197e12) is None and f(1e9, 0.1, 0, 197e12) is None
    assert flops.peak_for_kind("NVIDIA H100 80GB HBM3") == pytest.approx(989.4e12)
    assert flops.peak_for_kind("NVIDIA H100 SXM5 80GB") == pytest.approx(989.4e12)
    assert flops.peak_for_kind("NVIDIA H100 PCIe") == pytest.approx(756.0e12)
    assert flops.peak_for_kind("NVIDIA A100-SXM4-80GB") is None
    assert flops.peak_flops_per_device("cpu") is None
    assert flops.peak_flops_per_device("cpu", override_tflops=2.5) == pytest.approx(2.5e12)


def _jax_step_flops(arch: str, classes: int, im: int, n: int) -> float:
    mesh = data_mesh(1)
    model = jax_build_model(arch, num_classes=classes, dtype=jnp.float32)
    state, tx = create_train_state(model, jax.random.PRNGKey(0), mesh, im)
    step = make_train_step(model, tx, mesh, topk=5)
    batch = {"image": jnp.zeros((n, im, im, 3), jnp.uint8), "label": jnp.zeros((n,), jnp.int32)}
    return jax_flops.lowered_step_cost(step, state, batch, jnp.float32(0.1),
                                       jax.random.PRNGKey(0))["flops"]


def test_step_flops_of_a_dense_model_is_the_hand_count_and_jax_products(port_cfg, fresh_cfg,
                                                                        dense_arch):
    """One Dense layer, no padding anywhere: forward and weight gradient,
    2·B·I·O each (the images need no gradient), exactly; JAX's lowered
    step counts the same products plus the elementwise ops of the input's
    normalisation, the loss and SGD, 2.09 % more at this size."""
    im, classes, n = DENSE["im"], DENSE["classes"], DENSE["batch"]
    port_cfg.MODEL.ARCH, port_cfg.MODEL.NUM_CLASSES = "obs_dense", classes
    port_cfg.TRAIN.IM_SIZE, port_cfg.TRAIN.BATCH_SIZE = im, n
    hand = 4.0 * n * (im * im * 3) * classes
    assert flops.step_flops() == hand
    assert flops.step_flops(batch_ranks=4) == 4 * hand
    got = _jax_step_flops("obs_dense", classes, im, n)
    assert hand <= got <= 1.03 * hand


def _taps(h: int, k: int, s: int, p: int) -> tuple[int, int]:
    """One axis of a conv: (kernel taps over the outputs, those inside the input)."""
    ho = (h + 2 * p - k) // s + 1
    return ho * k, sum(0 <= o * s - p + t < h for o in range(ho) for t in range(k))


def _resnet_macs(stages, bottleneck: bool, im: int, classes: int) -> tuple[int, int, int, int]:
    """(multiply-adds of every full window, of the taps inside the input) of
    a ResNet forward on one image, and the same two of its stem."""
    convs = [(3, 64, 7, 2, 3, im)]
    h = ((im + 6 - 7) // 2 + 1 + 2 - 3) // 2 + 1  # the stem, then the 3x3/2 max pool
    cin = 64
    for i, n in enumerate(stages):
        planes = 64 << i
        out = planes * (4 if bottleneck else 1)
        for b in range(n):
            s = 2 if i and not b else 1
            ho = (h + 2 - 3) // s + 1
            if bottleneck:
                convs += [(cin, planes, 1, 1, 0, h), (planes, planes, 3, s, 1, h),
                          (planes, out, 1, 1, 0, ho)]
            else:
                convs += [(cin, planes, 3, s, 1, h), (planes, planes, 3, 1, 1, ho)]
            if s != 1 or cin != out:
                convs.append((cin, out, 1, s, 0, h))
            cin, h = out, ho
    full = valid = 0
    for ci, co, k, s, p, h in convs:
        f, v = _taps(h, k, s, p)
        full, valid = full + f * f * ci * co, valid + v * v * ci * co
    stem_f, stem_v = (t * t * 3 * 64 for t in _taps(im, 7, 2, 3))
    return full + cin * classes, valid + cin * classes, stem_f, stem_v


def test_xla_counts_a_padded_conv_by_its_inner_taps():
    """XLA's lowered cost of a 3x3 conv on a 2x2 map (the last stage of a
    ResNet at 64^2): the forward, the input and the weight gradient each
    count the taps inside the unpadded input, 4 of the 9 of an output
    pixel, where FlopCounterMode counts all 9."""
    x, w = jnp.ones((2, 2, 2, 8)), jnp.ones((3, 3, 8, 16))

    def conv(x, w):
        return jax.lax.conv_general_dilated(x, w, (1, 1), [(1, 1), (1, 1)],
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def cost(f):
        return jax.jit(f).lower(x, w).cost_analysis()["flops"]

    inner = 2 * 2 * (_taps(2, 3, 1, 1)[1] ** 2) * 8 * 16
    assert 9 * inner == 4 * (2 * 2 * 36 * 8 * 16)
    assert cost(conv) == inner
    assert cost(lambda x, w: jax.grad(lambda x: conv(x, w).sum())(x)) == inner
    assert cost(lambda x, w: jax.grad(lambda w: conv(x, w).sum())(w)) == inner
    with torch.device("meta"):
        weight = torch.empty(16, 8, 3, 3)
    with FlopCounterMode(display=False) as counter:
        torch.nn.functional.conv2d(torch.empty(2, 8, 2, 2, device="meta"), weight, padding=1)
    assert counter.get_total_flops() * 4 == inner * 9


@pytest.mark.parametrize("arch, stages, bottleneck, im, n, ratio", [
    ("resnet18", (2, 2, 2, 2), False, 64, 8, 0.790),
    ("resnet50", (3, 4, 6, 3), True, 224, 2, 0.986),
])
def test_step_flops_is_the_hand_count_and_xla_the_inner_taps(port_cfg, fresh_cfg, arch, stages,
                                                            bottleneck, im, n, ratio):
    """A ResNet step in f32: the port's count is 3 x 2 x the full-window
    multiply-adds less the stem's input gradient, exactly. XLA's lowered
    step lies above the inner-tap count of the same step by its
    elementwise ops only (BN, ReLU, the loss, SGD: 3.96 % at ResNet-18 64^2
    batch 8, 1.24 % at ResNet-50 224^2 batch 2), so it reads ``ratio`` of
    the port's: 0.790 where the last stage is 2x2, 0.986 at 224^2."""
    port_cfg.MODEL.ARCH, port_cfg.MODEL.DTYPE = arch, "float32"
    port_cfg.TRAIN.IM_SIZE, port_cfg.TRAIN.BATCH_SIZE = im, n
    full, valid, stem_full, stem_valid = _resnet_macs(stages, bottleneck, im, 1000)
    port = flops.step_flops()
    assert port == 2.0 * n * (3 * full - stem_full)
    xla = _jax_step_flops(arch, 1000, im, n)
    inner_step = 2.0 * n * (3 * valid - stem_valid)
    assert inner_step <= xla <= 1.05 * inner_step
    assert xla / port == pytest.approx(ratio, abs=0.005)
