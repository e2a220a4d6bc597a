"""Card-only tests of the PyTorch port (``gpu`` marker; skipped without a card).

They import neither JAX nor the JAX package, so they run on a machine that
has only PyTorch. tests/conftest.py imports JAX, so run them there with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import pytest
import torch

from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.ops import epilogue as ep


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the epilogue kernel has no CPU mode")
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
