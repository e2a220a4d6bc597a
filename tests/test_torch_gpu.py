"""Card-only tests of the PyTorch port (``gpu`` marker; skipped without a card).

They import neither JAX nor the JAX package, so they run on a machine that
has only PyTorch. tests/conftest.py imports JAX, so run them there with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import pytest
import torch

from distribuuuu_tpu_torch.models import build_model, layers
from distribuuuu_tpu_torch.ops import attention as att
from distribuuuu_tpu_torch.ops import epilogue as ep


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_epilogue_equals_plain_bitwise(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def nchw(n, h, w, c, dtype):  # channels-last NCHW view of an NHWC tensor
        return torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype).permute(0, 3, 1, 2)

    for (n, h, w, c) in [(2, 7, 7, 2048), (4, 56, 56, 64), (3, 5, 9, 24)]:
        for x_dt in (torch.float32, torch.bfloat16):
            for bn_dt in (torch.float32, torch.bfloat16):
                for res_dt in (None, torch.float32, torch.bfloat16):
                    for relu in (False, True):
                        x = nchw(n, h, w, c, x_dt)
                        ident = None if res_dt is None else nchw(n, h, w, c, res_dt)
                        vecs = [torch.randn(c, generator=gen, device=cuda) for _ in range(3)]
                        before = ep.LAUNCHES
                        got = ep.fused_conv_epilogue(x, *vecs, ident, relu=relu, bn_dtype=bn_dt)
                        assert ep.LAUNCHES == before + 1
                        want = ep.epilogue_reference(x, *vecs, ident, relu=relu, bn_dtype=bn_dt)
                        torch.cuda.synchronize()
                        assert got.dtype == want.dtype
                        assert torch.equal(got, want), (n, h, w, c, x_dt, bn_dt, res_dt, relu)
    contiguous_nchw = torch.randn(2, 8, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        ep.fused_conv_epilogue(contiguous_nchw, *[torch.zeros(8, device=cuda)] * 3,
                               bn_dtype=torch.float32)


@pytest.mark.gpu
def test_resnet50_forward_at_224_launches_kernel_49_times(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full f32 convs
    cpu = build_model("resnet50", num_classes=1000, dtype=torch.float32)
    cpu = cpu.to(memory_format=torch.channels_last).eval()
    gpu = build_model("resnet50", num_classes=1000, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.randn(2, 224, 224, 3)
    before = ep.LAUNCHES
    with torch.inference_mode():
        got = gpu(x.to(cuda)).cpu()
        want = cpu(x)
    assert ep.LAUNCHES - before == 49
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def _heads_first(t, heads):
    """[B, L, heads * d] -> the [B, heads, L, d] view MHSA hands the kernel."""
    b, l, c = t.shape
    return t.view(b, l, heads, c // heads).transpose(1, 2)


@pytest.mark.gpu
def test_cuda_attention_matches_plain(cuda):
    """Both modes, both dtypes, both bias dtypes; head-split (strided) views;
    L ragged against the 64-row tiles, Dv != D, D not a multiple of 4. The
    bf16 tolerance covers the kernel casting p before normalising (the
    plain version casts after)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for (b, n, l, d, dv) in [(2, 4, 196, 128, 128), (1, 2, 70, 32, 24), (1, 1, 5, 7, 3),
                             (1, 2, 1024, 128, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            q = _heads_first(torch.randn(b, l, n * d, generator=gen, device=cuda) * 0.3, n).to(dt)
            k = _heads_first(torch.randn(b, l, n * d, generator=gen, device=cuda) * 0.3, n).to(dt)
            v = _heads_first(torch.randn(b, l, n * dv, generator=gen, device=cuda), n).to(dt)
            bias = torch.randn(b, n, l, l, generator=gen, device=cuda) * 0.5
            emb = (torch.randn(l, d, generator=gen, device=cuda) * 0.5).to(dt)
            for mode in ("f32 bias", "bf16 bias", "table"):
                before = att.LAUNCHES + att.TABLE_LAUNCHES
                if mode == "table":
                    got = att.fused_attention_abs(q, k, v, emb)
                    want = att.attention_table_reference(q, k, v, emb)
                else:
                    bb = bias if mode == "f32 bias" else bias.bfloat16()
                    got = att.fused_attention(q, k, v, bb)
                    want = att.attention_reference(q, k, v, bb)
                torch.cuda.synchronize()
                assert att.LAUNCHES + att.TABLE_LAUNCHES == before + 1
                assert got.dtype == dt and got.shape == (b, n, l, dv)
                tol = (2e-5 if dt == torch.float32 else 2e-2) * max(1.0, want.abs().max().item())
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol, ((b, n, l, d, dv), dt, mode, err)
    q = torch.zeros(1, 1, 8, 129, device=cuda)
    with pytest.raises(ValueError, match="D, Dv <= 128"):
        att.fused_attention(q, q, q, torch.zeros(1, 1, 8, 8, device=cuda))
    q = torch.zeros(1, 1, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous last axis"):
        att.fused_attention(q, q, q, torch.zeros(1, 1, 16, 16, device=cuda).transpose(2, 3))


@pytest.mark.gpu
def test_botnet50_forward_at_224_launches_attention_3_and_k1_40_times(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full f32 convs
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = build_model("botnet50", num_classes=1000, dtype=torch.float32, im_size=224)
    for m in cpu.modules():  # bn_out starts at zero-γ: draw every BN scale away from 0
        if isinstance(m, layers.BatchNorm):
            torch.nn.init.uniform_(m.weight, 0.5, 1.5)
    cpu = cpu.to(memory_format=torch.channels_last).eval()
    gpu = build_model("botnet50", num_classes=1000, dtype=torch.float32, im_size=224)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.randn(2, 224, 224, 3)
    before = (att.LAUNCHES, ep.LAUNCHES)
    with torch.inference_mode():
        got = gpu(x.to(cuda)).cpu()
        want = cpu(x)
    assert (att.LAUNCHES - before[0], ep.LAUNCHES - before[1]) == (3, 40)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
