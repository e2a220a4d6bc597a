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
from distribuuuu_tpu_torch.ops import moe_kernel as moe


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


# K1's three modes: (a) the boundary, (b) the next conv's input, (c) both
_K1_MODES = {"a": {}, "b": dict(keep_boundary=False), "c": {}}


@pytest.mark.gpu
def test_cuda_epilogue_equals_plain_bitwise(cuda):
    """K1 vs its plain version, bitwise, in every mode at every dtype
    combination (x, BN, residual, cast). Shapes: a ResNet-50 site, the stem's
    width, C 40 (five 8-channel groups: the vector route with a grid that is
    not a power of two), C 36 and views 2 elements off a 16-byte boundary (the
    scalar route), and a 2-D [R, C] tensor."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def nchw(n, h, w, c, dtype, offset=0):  # channels-last NCHW view of an NHWC tensor
        t = torch.randn(n * h * w * c + offset, generator=gen, device=cuda).to(dtype)
        return t[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    cases = [((2, 7, 7, 2048), 0, False), ((4, 56, 56, 64), 0, False), ((3, 5, 9, 40), 0, False),
             ((3, 5, 9, 36), 0, True), ((2, 6, 6, 64), 2, True), ((37, 1, 1, 96), 0, False)]
    for (n, h, w, c), offset, scalar in cases:
        for x_dt in (torch.float32, torch.bfloat16):
            for bn_dt in (torch.float32, torch.bfloat16):
                for res_dt in (None, torch.float32, torch.bfloat16):
                    for cast_dt in (torch.float32, torch.bfloat16):
                        x = nchw(n, h, w, c, x_dt, offset)
                        ident = None if res_dt is None else nchw(n, h, w, c, res_dt, offset)
                        if n == 37:  # the 2-D [R, C] form
                            x = x.reshape(n, c)
                            ident = None if ident is None else ident.reshape(n, c)
                        vecs = [torch.randn(c, generator=gen, device=cuda) for _ in range(3)]
                        for relu in (False, True):
                            for mode, kw in _K1_MODES.items():
                                kw = dict(kw, relu=relu, bn_dtype=bn_dt,
                                          cast_to=None if mode == "a" else cast_dt)
                                before = (ep.LAUNCHES, ep.SCALAR_LAUNCHES)
                                got = ep.fused_conv_epilogue(x, *vecs, ident, **kw)
                                assert (ep.LAUNCHES, ep.SCALAR_LAUNCHES) == (
                                    before[0] + 1, before[1] + scalar)
                                want = ep.epilogue_reference(x, *vecs, ident, **kw)
                                torch.cuda.synchronize()
                                case = ((n, h, w, c), offset, x_dt, bn_dt, res_dt, cast_dt, relu, mode)
                                pairs = zip(got, want) if mode == "c" else [(got, want)]
                                for g, wt in pairs:
                                    assert g.dtype == wt.dtype and g.shape == wt.shape, case
                                    assert torch.equal(g, wt), case
                                    if g.dim() == 4:
                                        assert g.is_contiguous(memory_format=torch.channels_last)
    contiguous_nchw = torch.randn(2, 8, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        ep.fused_conv_epilogue(contiguous_nchw, *[torch.zeros(8, device=cuda)] * 3,
                               bn_dtype=torch.float32)


def _k1_forward(arch, cuda, monkeypatch, im=224, **kw):
    """A seeded ``arch`` on the CPU and its copy on the card, f32 (TF32 off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full f32 convs
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=im)
    for m in cpu.modules():  # bn_out starts at zero-γ: draw every BN scale away from 0
        if isinstance(m, layers.BatchNorm):
            torch.nn.init.uniform_(m.weight, 0.5, 1.5)
    cpu = cpu.to(memory_format=torch.channels_last).eval()
    gpu = build_model(arch, num_classes=1000, dtype=torch.float32, im_size=im)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda, memory_format=torch.channels_last).eval()
    bf16 = build_model(arch, num_classes=1000, dtype=torch.bfloat16, im_size=im)
    bf16.load_state_dict(cpu.state_dict())
    return cpu, gpu, bf16.to(cuda, memory_format=torch.channels_last).eval()


def _bf16_handoff_is_bitwise(model, x, monkeypatch):
    """The bf16 model's logits with K1 writing each conv's input equal those
    with K1 writing the f32 boundary and each conv casting it."""
    real = layers.fused_conv_epilogue

    def boundary_only(*args, cast_to=None, keep_boundary=True, **kw):
        out = real(*args, **kw)
        return (out, out) if cast_to is not None and keep_boundary else out

    with torch.inference_mode():
        got = model(x)
        with monkeypatch.context() as mp:
            mp.setattr(layers, "fused_conv_epilogue", boundary_only)
            want = model(x)
    return torch.equal(got, want)


@pytest.mark.gpu
def test_resnet50_forward_at_224_launches_kernel_53_times(cuda, monkeypatch):
    cpu, gpu, bf16 = _k1_forward("resnet50", cuda, monkeypatch)
    x = torch.randn(2, 224, 224, 3)
    before = ep.LAUNCHES
    with torch.inference_mode():
        got = gpu(x.to(cuda)).cpu()
        want = cpu(x)
    assert ep.LAUNCHES - before == 53
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert _bf16_handoff_is_bitwise(bf16, x.to(cuda), monkeypatch)


def _heads_first(t, heads):
    """[B, L, heads * d] -> the [B, heads, L, d] view MHSA hands the kernel."""
    b, l, c = t.shape
    return t.view(b, l, heads, c // heads).transpose(1, 2)


# bf16 kernel vs the blockwise plain version, which rounds where the kernel
# does: one bf16 ulp of the output (2^-7 of max(1, max|out|)) where the two
# f32 sums straddle a rounding boundary, plus a rare flip of one p's rounding
# (chip_smoke.ATTN_BLOCKWISE_TOL)
BLOCKWISE_BF16_TOL = 1e-2


@pytest.mark.gpu
def test_cuda_attention_matches_plain(cuda):
    """Both modes, both dtypes, both bias dtypes; head-split (strided) views;
    L ragged against the 64-row tiles and at 63, 64, 65, Dv != D, D not a
    multiple of 4 or 16, odd row lengths (the kernel's 2-byte copies). The
    bf16 tolerance against the single-tile plain version covers the kernel
    casting p before normalising (the plain version casts after); against
    the blockwise plain version, which casts where the kernel does, it is
    BLOCKWISE_BF16_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    for (b, n, l, d, dv) in [(2, 4, 196, 128, 128), (1, 2, 70, 32, 24), (1, 1, 5, 7, 3),
                             (1, 2, 1024, 128, 128), (1, 2, 63, 128, 128), (1, 2, 64, 128, 128),
                             (1, 2, 65, 128, 128), (2, 3, 196, 40, 24)]:
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
                blk = att.attention_blockwise_reference(
                    q, k, v, emb if mode == "table" else bb, table=mode == "table")
                tol = (2e-5 if dt == torch.float32 else BLOCKWISE_BF16_TOL) * max(
                    1.0, blk.float().abs().max().item())
                err = (got.float() - blk.float()).abs().max().item()
                assert err <= tol, ((b, n, l, d, dv), dt, mode, "blockwise", err)
            # a huge uniform bias: the online softmax subtracts the running max
            huge = bias.to(dt) + 1e4
            got = att.fused_attention(q, k, v, huge)
            assert torch.isfinite(got).all(), ((b, n, l, d, dv), dt)
            if dt == torch.bfloat16:  # f32 logits near 1e4 keep 2^-10 absolute: bf16 only
                want = att.attention_reference(q, k, v, huge)
                err = (got.float() - want.float()).abs().max().item()
                assert err <= 2e-2 * max(1.0, want.abs().max().item()), ((b, n, l, d, dv), "1e4")
    q = torch.zeros(1, 1, 8, 129, device=cuda)
    with pytest.raises(ValueError, match="D, Dv <= 128"):
        att.fused_attention(q, q, q, torch.zeros(1, 1, 8, 8, device=cuda))
    q = torch.zeros(1, 1, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous last axis"):
        att.fused_attention(q, q, q, torch.zeros(1, 1, 16, 16, device=cuda).transpose(2, 3))


# the backward kernel vs attention_backward_reference, relative to
# max(1, max|grad|), by the gradient's dtype: f32 differs in summation order
# only; bf16 rounds each gradient once to bf16 on both sides, with f32 sums
# in different orders
ATTN_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# and the error's L2 norm relative to the reference's, which scales with the
# data (a typical dbias entry at L 1024 is ~1e-2, far below max(1, max|grad|));
# as chip_smoke.ATTN_BWD_REL_L2
ATTN_BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_grad_close(x, z, what):
    """x within both limits of the plain version's z, by z's dtype."""
    xf, zf = x.float(), z.float()
    err = (xf - zf).abs().max().item()
    assert err <= ATTN_BWD_TOL[z.dtype] * max(1.0, zf.abs().max().item()), (what, err)
    rel = ((xf - zf).norm() / zf.norm().clamp_min(1e-30)).item()
    assert rel <= ATTN_BWD_REL_L2[z.dtype], (what, rel)


@pytest.mark.gpu
def test_cuda_attention_backward_matches_plain(cuda):
    """dq, dk, dv and dbias of the backward kernel against the plain
    backward, both dtypes and both bias dtypes; head-split (strided) views
    of q, k, v and a transposed view of g, as MHSA hands them over; L ragged
    against the kernel's tiles and at 1024, Dv != D, odd D; the cluster
    route's edges, one to four CTAs a cluster: L 64 (one full tile), 65 (a
    1-key second tile), 130, 256 (four full tiles), and L 257 on the
    blockwise route. Two calls are bitwise equal, and each call counts one
    backward call, on the route of ``backward_route`` (which launches
    ``att.ROUTE_LAUNCHES`` kernels a call: one on the cluster route, three on
    the blockwise one, two on the scalar one)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for (b, n, l, d, dv) in [(2, 4, 196, 128, 128), (1, 2, 70, 32, 24), (1, 1, 5, 7, 3),
                             (1, 2, 1024, 128, 128), (1, 2, 65, 128, 128), (2, 3, 196, 40, 24),
                             (2, 3, 64, 128, 128), (2, 3, 130, 128, 128), (2, 3, 256, 128, 128),
                             (2, 3, 257, 128, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            q = _heads_first(torch.randn(b, l, n * d, generator=gen, device=cuda) * 0.3, n).to(dt)
            k = _heads_first(torch.randn(b, l, n * d, generator=gen, device=cuda) * 0.3, n).to(dt)
            v = _heads_first(torch.randn(b, l, n * dv, generator=gen, device=cuda), n).to(dt)
            g = _heads_first(torch.randn(b, l, n * dv, generator=gen, device=cuda), n).to(dt)
            bias = torch.randn(b, n, l, l, generator=gen, device=cuda) * 0.5
            for bias_dt in (torch.float32, torch.bfloat16):
                bb = bias.to(bias_dt)
                before = (att.BWD_LAUNCHES, dict(att.BWD_ROUTE_CALLS))
                got = att.fused_attention_backward(q, k, v, bb, g)
                again = att.fused_attention_backward(q, k, v, bb, g)
                want = att.attention_backward_reference(q, k, v, bb, g)
                torch.cuda.synchronize()
                case = ((b, n, l, d, dv), dt, bias_dt)
                route = att.backward_route(dt, l)
                assert att.BWD_LAUNCHES == before[0] + 2, case
                assert _route_calls(before[1]) == {route: 2}, case
                for name, x, y, z in zip(("dq", "dk", "dv", "dbias"), got, again, want):
                    assert x.dtype == z.dtype and x.shape == z.shape and x.is_contiguous(), case
                    assert torch.equal(x, y), (case, name, "two calls")
                    _assert_grad_close(x, z, (case, name))


def _route_calls(before):
    """The backward's calls per route since ``before``, nonzero only."""
    return {k: v - before[k] for k, v in att.BWD_ROUTE_CALLS.items() if v != before[k]}


@pytest.mark.gpu
def test_cuda_attention_table_backward_on_every_route(cuda):
    """The table mode's backward (dq, dk, dv, demb) against
    ``attention_table_backward_reference`` on the three routes: bf16 on the
    cluster route (L 196, and a ragged L 70 with D 40, Dv 24), bf16 on the
    blockwise route (L 1024, and L 300 ragged), f32 on the scalar route (L
    196, L 70 ragged). Head-split views, a strided table; two calls bitwise
    equal; one table-backward call a call, on its route."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    for (b, n, l, d, dv) in [(8, 4, 196, 128, 128), (2, 3, 70, 40, 24), (2, 4, 1024, 128, 128),
                             (1, 3, 300, 40, 24)]:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, g = (_heads_first(torch.randn(b, l, n * w, generator=gen, device=cuda) * sc, n)
                          .to(dt) for w, sc in ((d, 0.3), (d, 0.3), (dv, 1.0), (dv, 1.0)))
            emb = (torch.randn(l, 2 * d, generator=gen, device=cuda) * 0.5).to(dt)[:, :d]
            route = att.backward_route(dt, l)
            before = (att.TABLE_BWD_LAUNCHES, att.BWD_LAUNCHES, dict(att.BWD_ROUTE_CALLS))
            got = att.fused_attention_abs_backward(q, k, v, emb, g)
            again = att.fused_attention_abs_backward(q, k, v, emb, g)
            want = att.attention_table_backward_reference(q, k, v, emb, g)
            torch.cuda.synchronize()
            case = ((b, n, l, d, dv), dt, route)
            assert (att.TABLE_BWD_LAUNCHES, att.BWD_LAUNCHES) == (before[0] + 2, before[1]), case
            assert _route_calls(before[2]) == {route: 2}, case
            for name, x, y, z in zip(("dq", "dk", "dv", "demb"), got, again, want):
                assert x.dtype == z.dtype and x.shape == z.shape and x.is_contiguous(), case
                assert torch.equal(x, y), (case, name, "two calls")
                _assert_grad_close(x, z, (case, name))


@pytest.mark.gpu
def test_cuda_attention_blockwise_route_past_the_cluster_cut(cuda):
    """The bf16 backward's blockwise route (L > 256) against the plain
    backwards: L 257 (just past the cluster route's cut: a 1-key last tile),
    L 1024 at B*N 128 (the 512^2 training step's shape) and a ragged L 300
    with D 40, Dv 24; a bf16 bias (whose dbias is the ds the dq pass reads),
    an f32 bias and the table mode. Head-split views and a transposed g; two
    calls bitwise equal; each call one backward call on the blockwise route
    (three launches, and the demb reduction's two in table mode); every
    gradient within both limits, the L2-relative one included."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    for (b, n, l, d, dv) in [(2, 3, 257, 128, 128), (32, 4, 1024, 128, 128), (1, 3, 300, 40, 24)]:
        q, k, v, g = (_heads_first(torch.randn(b, l, n * w, generator=gen, device=cuda) * sc, n)
                      .bfloat16() for w, sc in ((d, 0.3), (d, 0.3), (dv, 1.0), (dv, 1.0)))
        bias = torch.randn(b, n, l, l, generator=gen, device=cuda) * 0.5
        emb = (torch.randn(l, d, generator=gen, device=cuda) * 0.5).bfloat16()
        assert att.backward_route(torch.bfloat16, l) == "blockwise"
        for mode in ("bf16 bias", "f32 bias", "table"):
            last = emb if mode == "table" else bias.to(
                torch.bfloat16 if mode == "bf16 bias" else torch.float32)
            fn = (att.fused_attention_abs_backward if mode == "table"
                  else att.fused_attention_backward)
            plain = (att.attention_table_backward_reference if mode == "table"
                     else att.attention_backward_reference)
            before = (att.BWD_LAUNCHES + att.TABLE_BWD_LAUNCHES, dict(att.BWD_ROUTE_CALLS))
            got = fn(q, k, v, last, g)
            again = fn(q, k, v, last, g)
            want = plain(q, k, v, last, g)
            torch.cuda.synchronize()
            case = ((b, n, l, d, dv), mode)
            assert att.BWD_LAUNCHES + att.TABLE_BWD_LAUNCHES == before[0] + 2, case
            assert _route_calls(before[1]) == {"blockwise": 2}, case
            for name, x, y, z in zip(("dq", "dk", "dv", "dlast"), got, again, want):
                assert x.dtype == z.dtype and x.shape == z.shape and x.is_contiguous(), case
                assert torch.equal(x, y), (case, name, "two calls")
                _assert_grad_close(x, z, (case, name))
            del got, again, want


@pytest.mark.gpu
def test_mhsa_table_mode_bf16_sgd_step_trains_on_the_card(cuda):
    """``MHSA(rel_pos_emb=False)`` at BoTNet-50's width (512 in, 4 heads of
    128, fmap 14x14), bf16, one SGD step on the card: one table-mode forward
    and one table backward on the cluster route; the position tables and
    ``to_qk`` get finite, non-zero gradients and move."""
    from distribuuuu_tpu_torch.models.botnet import MHSA

    torch.manual_seed(4)
    m = MHSA(512, (14, 14), 4, 128, 128, rel_pos_emb=False, dtype=torch.bfloat16).to(cuda)
    x = torch.relu(torch.randn(8, 512, 14, 14, device=cuda)).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    start = {k: t.detach().clone() for k, t in m.named_parameters()}
    before = (att.TABLE_LAUNCHES, att.TABLE_BWD_LAUNCHES, dict(att.BWD_ROUTE_CALLS))
    m(x).float().square().mean().backward()
    opt.step()
    torch.cuda.synchronize()
    assert (att.TABLE_LAUNCHES - before[0], att.TABLE_BWD_LAUNCHES - before[1]) == (1, 1)
    assert _route_calls(before[2]) == {"cluster": 1}
    for name in ("pos_emb.height", "pos_emb.width", "to_qk.weight"):
        grad = dict(m.named_parameters())[name].grad
        assert grad is not None and torch.isfinite(grad).all(), name
        assert float(grad.float().abs().max()) > 0, name
        assert not torch.equal(dict(m.named_parameters())[name], start[name]), name


@pytest.mark.gpu
def test_attention_gradients_flow_on_the_card(cuda):
    """Through ``fused_attention`` and ``fused_attention_abs`` on CUDA
    tensors the output has a grad_fn and the gradients are the backward
    kernels'; without a gradient no Function node is made and nothing
    launches backward."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, g = (torch.randn(2, 4, 196, 128, generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    bias = torch.randn(2, 4, 196, 196, generator=gen, device=cuda).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = att.fused_attention(*leaves)
    assert out.grad_fn is not None
    before = (att.LAUNCHES, att.BWD_LAUNCHES)
    out.backward(g)
    assert (att.LAUNCHES, att.BWD_LAUNCHES) == (before[0], before[1] + 1)
    for leaf, want in zip(leaves, att.fused_attention_backward(q, k, v, bias, g)):
        assert torch.equal(leaf.grad, want)
    with torch.inference_mode():
        assert att.fused_attention(*leaves).grad_fn is None
    emb = torch.randn(196, 128, generator=gen, device=cuda).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (q, k, v, emb)]
    out = att.fused_attention_abs(*leaves)
    assert out.grad_fn is not None
    before = (att.TABLE_LAUNCHES, att.TABLE_BWD_LAUNCHES)
    out.backward(g)
    assert (att.TABLE_LAUNCHES, att.TABLE_BWD_LAUNCHES) == (before[0], before[1] + 1)
    for leaf, want in zip(leaves, att.fused_attention_abs_backward(q, k, v, emb, g)):
        assert torch.equal(leaf.grad, want)
    with torch.no_grad():
        out = att.fused_attention_abs(*leaves)
    assert out.grad_fn is None and out.shape == (2, 4, 196, 128)


def _botnet_state(cuda, dtype, im, seed=0):
    """A seeded botnet50 TrainState on the card with every BN scale drawn in
    [0.5, 1.5] (bn_out starts at zero-γ, which would leave MHSA without a
    gradient in the first step)."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model

    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "botnet50", 10, dtype
    cfg.TRAIN.IM_SIZE = im
    model = build_cfg_model(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
    return TrainState(model.to(cuda))


@pytest.mark.gpu
def test_botnet50_bf16_training_step_launches_and_trains_mhsa(cuda):
    """One bf16 botnet50 training step at 224^2: 3 attention forward and 3
    backward calls, 53 K1 and 53 K1-bwd, none on a scalar route; every MHSA
    parameter, and the conv before it, gets a non-zero gradient (before the
    attention Function, the kernel's output had no grad_fn there)."""
    from distribuuuu_tpu_torch.config import reset_cfg
    from distribuuuu_tpu_torch.trainer import train_step

    st = _botnet_state(cuda, "bfloat16", 224)
    gen = torch.Generator().manual_seed(2)
    batch = {"image": torch.randint(0, 256, (4, 224, 224, 3), dtype=torch.uint8,
                                    generator=gen).to(cuda),
             "label": torch.randint(0, 10, (4,), generator=gen).to(cuda)}
    counts = (att.LAUNCHES, att.BWD_LAUNCHES, ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES,
              ep.BWD_SCALAR_LAUNCHES)
    m = train_step(st, batch, 0.01)
    torch.cuda.synchronize()
    reset_cfg()
    after = (att.LAUNCHES, att.BWD_LAUNCHES, ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES,
             ep.BWD_SCALAR_LAUNCHES)
    assert tuple(b - a for a, b in zip(counts, after)) == (3, 3, 53, 53, 0, 0)
    assert float(m["skipped"]) == 0.0 and torch.isfinite(m["loss_sum"])
    for i in range(3):
        block = st.model._modules["7"].net[i].net
        for name, prm in [("net.0", block[0].weight), *block[3].named_parameters()]:
            assert prm.grad is not None and float(prm.grad.abs().max()) > 0, (i, name)


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.gpu
def test_botnet50_train_step_card_equals_cpu(cuda, monkeypatch):
    """One f32 training step (TF32 off) of botnet50 at 64^2, batch 8, every
    BN scale in [0.5, 1.5] so MHSA trains in this step, on the card against
    the same step on the CPU. Without zero-γ residuals the ResNet-50 trunk's
    gradient grows from the head to the stem at init, and f32 summation
    order alone moves it: on the CPU the JAX package and the port, from one
    state, part by 8.8e-5 in the loss, 3.6e-2 in the update's relative L2
    and 3.3e-5 in the BN statistics'. So: the loss within 1e-3, the update
    of all parameters and the MHSA parameters' gradient within a relative
    L2 of 1e-1, the BN statistics within 1e-3; the card launches the
    attention backward 3 times."""
    from distribuuuu_tpu_torch.config import reset_cfg
    from distribuuuu_tpu_torch.trainer import train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    res = {}
    for dev in ("cpu", cuda):
        st = _botnet_state(dev, "float32", 64)
        start = st.params.cpu().clone()
        before = att.BWD_LAUNCHES
        m = train_step(st, {"image": imgs.to(dev), "label": labels.to(dev)}, 0.2 * 8 / 256)
        mhsa = torch.cat([st.grads[o:o + n].cpu() for name, (o, n, _) in
                          zip(st.names, st.segments) if ".net.3." in name])
        res[str(dev)] = (m["loss_sum"].item(), st.params.cpu() - start, st.stats.cpu(), mhsa,
                         att.BWD_LAUNCHES - before)
    reset_cfg()
    (l_cpu, u_cpu, s_cpu, a_cpu, n_cpu), (l_gpu, u_gpu, s_gpu, a_gpu, n_gpu) = (
        res["cpu"], res[str(cuda)])
    assert (n_cpu, n_gpu) == (0, 3)
    assert abs(l_cpu - l_gpu) <= 1e-3 * abs(l_cpu)
    assert _rel_l2(u_gpu, u_cpu) <= 1e-1 and _rel_l2(a_gpu, a_cpu) <= 1e-1
    assert float(a_cpu.abs().max()) > 0 and _rel_l2(s_gpu, s_cpu) <= 1e-3


@pytest.mark.gpu
def test_botnet50_forward_at_224_launches_attention_3_and_k1_53_times(cuda, monkeypatch):
    cpu, gpu, bf16 = _k1_forward("botnet50", cuda, monkeypatch)
    x = torch.randn(2, 224, 224, 3)
    before = (att.LAUNCHES, ep.LAUNCHES)
    with torch.inference_mode():
        got = gpu(x.to(cuda)).cpu()
        want = cpu(x)
    assert (att.LAUNCHES - before[0], ep.LAUNCHES - before[1]) == (3, 53)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert _bf16_handoff_is_bitwise(bf16, x.to(cuda), monkeypatch)


def _dyadic(shape, k, den, gen, device):
    """Integers in [-k, k] over den: with x in k/8 and the gate in m/64 every
    f32 logit is exact in any summation order (see chip_smoke.dyadic)."""
    return torch.randint(-k, k + 1, shape, generator=gen, device=device).float() / den


@pytest.mark.gpu
def test_cuda_moe_dispatch_and_combine_equal_plain_on_dyadic_inputs(cuda):
    """K6/K7 vs their plain versions: top, pos, send, fp_sum[0] and the
    combined out bitwise, w within 1e-6 and fp_sum[1] within 1e-5 relative
    (exp, and the order of the probability sums, may differ by an ulp).
    Both x dtypes; the soak's shard, a ragged N, capacity 1, E 4/16/32, D
    that takes the 16-byte path and D that does not."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n, d, e, c in [(8192, 128, 8, 1280), (8191, 128, 8, 1280), (300, 768, 8, 48),
                       (64, 128, 4, 1), (100, 30, 16, 10), (1000, 64, 32, 40)]:
        for dt in (torch.float32, torch.bfloat16):
            x = _dyadic((n, d), 16, 8, gen, cuda).to(dt)
            g = _dyadic((d, e), 32, 64, gen, cuda)
            back = torch.randn(e, c, d, generator=gen, device=cuda)
            before = (moe.DISPATCH_LAUNCHES, moe.COMBINE_LAUNCHES)
            send, top, pos, w, fp = moe.fused_moe_dispatch(x, g, capacity=c)
            out = moe.fused_moe_combine(back, top, pos, w)
            torch.cuda.synchronize()
            assert (moe.DISPATCH_LAUNCHES - before[0], moe.COMBINE_LAUNCHES - before[1]) == (1, 1)
            want = moe.oracle_dispatch(x, g, c)
            case = (n, d, e, c, dt)
            for a, b in ((send, want[0]), (top, want[1]), (pos, want[2]), (fp[0], want[4][0])):
                assert a.dtype == b.dtype and torch.equal(a, b), case
            assert bool(((w - want[3]).abs() <= 1e-6 * want[3].abs()).all()), case
            assert bool(((fp[1] - want[4][1]).abs() <= 1e-5 * want[4][1].abs()).all()), case
            assert torch.equal(out, moe.oracle_combine(back, top, pos, w)), case
            assert not bool(out[w == 0].any()), case
    # contiguous views 4 bytes past an allocation: the kernels take the scalar path
    n, d, e, c = 500, 128, 8, 80
    x = _dyadic((n * d + 1,), 16, 8, gen, cuda)[1:].view(n, d)
    g = _dyadic((d, e), 32, 64, gen, cuda)
    back = torch.randn(e * c * d + 1, generator=gen, device=cuda)[1:].view(e, c, d)
    send, top, pos, w, _ = moe.fused_moe_dispatch(x, g, capacity=c)
    want = moe.oracle_dispatch(x, g, c)
    assert torch.equal(send, want[0]) and torch.equal(top, want[1]) and torch.equal(pos, want[2])
    assert torch.equal(moe.fused_moe_combine(back, top, pos, w), moe.oracle_combine(back, top, pos, w))
    x = torch.zeros(16, 8, device=cuda)
    with pytest.raises(ValueError, match="at most 32 experts"):
        moe.fused_moe_dispatch(x, torch.zeros(8, 33, device=cuda), capacity=2)
    with pytest.raises(ValueError, match="contiguous"):
        moe.fused_moe_dispatch(torch.zeros(8, 16, device=cuda).t(), torch.zeros(8, 4, device=cuda),
                               capacity=2)


@pytest.mark.gpu
def test_cuda_moe_gradients_match_autograd_through_plain(cuda):
    """The soak's loss through dispatch -> tanh(send) + b0 -> combine: value
    and gradients of the kernels' path (index-op backward) against autograd
    through the plain versions, within 1e-5 of each gradient's max (f32; a
    bf16 x's gradient is rounded to bf16, 2^-8)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    n, d, e, c = 2048, 128, 8, 320
    for dt in (torch.float32, torch.bfloat16):
        x0 = _dyadic((n, d), 16, 8, gen, cuda).to(dt)
        g0 = _dyadic((d, e), 32, 64, gen, cuda)
        b00 = torch.randn(e, c, d, generator=gen, device=cuda)
        results = []
        for dispatch, combine in (
                (lambda a, b: moe.fused_moe_dispatch(a, b, capacity=c), moe.fused_moe_combine),
                (lambda a, b: moe.oracle_dispatch(a, b, c), moe.oracle_combine)):
            x, g, b0 = (t.clone().requires_grad_() for t in (x0, g0, b00))
            send, top, pos, w, fp = dispatch(x, g)
            out = combine(torch.tanh(send) + b0, top, pos, w)
            loss = (out**2).sum() + 0.01 * (fp[0] * fp[1]).sum()
            loss.backward()
            results.append((loss.detach(), x.grad.float(), g.grad, b0.grad))
        (lk, *gk), (lp, *gp) = results
        assert float((lk - lp).abs()) <= 1e-5 * float(lp.abs())
        for name, a, b in zip(("x", "gate", "b0"), gk, gp):
            tol = (2.0**-8 if name == "x" and dt == torch.bfloat16 else 1e-5) * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol, (dt, name)


@pytest.mark.gpu
def test_cuda_moe_dispatch_is_one_kernel_per_call(cuda):
    """K6 is one kernel launch per fused_moe_dispatch (the profiler's kernel
    names; the scratch reset is a memset, not a kernel), K7 one per combine."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(5)
    n, d, e, c = 8192, 128, 8, 1280
    x, g = _dyadic((n, d), 16, 8, gen, cuda), _dyadic((d, e), 32, 64, gen, cuda)
    back = torch.randn(e, c, d, generator=gen, device=cuda)
    with torch.no_grad():
        _, top, pos, w, _ = moe.fused_moe_dispatch(x, g, capacity=c)
        torch.cuda.synchronize()
        calls = 4
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                moe.fused_moe_dispatch(x, g, capacity=c)
                moe.fused_moe_combine(back, top, pos, w)
            torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
             and "memset" not in ev.name.lower()]
    assert sum("moe_dispatch_kernel" in k for k in names) == calls, names
    assert sum("moe_combine_kernel" in k for k in names) == calls, names
    assert len(names) == 2 * calls, names


@pytest.mark.gpu
def test_cuda_moe_graph_capture_replays_bitwise(cuda):
    """Dispatch + combine (forward, no grad) captured in one CUDA graph: each
    replay equals the eager calls bitwise, also after new inputs are copied
    into the captured ones (the look-back scratch is reset on the stream)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    n, d, e, c = 8192, 768, 8, 1280
    x = torch.randn(n, d, generator=gen, device=cuda) * 0.5
    g = torch.randn(d, e, generator=gen, device=cuda) * 0.1
    back = torch.randn(e, c, d, generator=gen, device=cuda)

    def step():
        send, top, pos, w, fp = moe.fused_moe_dispatch(x, g, capacity=c)
        return send, top, pos, w, fp, moe.fused_moe_combine(back, top, pos, w)

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = (moe.DISPATCH_LAUNCHES, moe.COMBINE_LAUNCHES)
        with torch.cuda.graph(graph):
            captured = step()
        assert (moe.DISPATCH_LAUNCHES - before[0], moe.COMBINE_LAUNCHES - before[1]) == (1, 1)
        for _ in range(2):
            graph.replay()
            eager = step()
            torch.cuda.synchronize()
            for a, b in zip(captured, eager):
                assert torch.equal(a, b)
            x.copy_(torch.randn(n, d, generator=gen, device=cuda) * 0.5)


@pytest.mark.gpu
def test_cuda_moe_dispatch_is_deterministic(cuda):
    """Two dispatches of the same continuous input are bitwise equal,
    fp_sum[1] (summed across tiles) included, for both x dtypes; n 0 gives
    an all-zero send."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for n, d, e, c in [(8192, 128, 8, 1280), (8191, 768, 16, 640)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(n, d, generator=gen, device=cuda) * 0.5).to(dt)
            g = torch.randn(d, e, generator=gen, device=cuda) * 0.1
            first = moe.fused_moe_dispatch(x, g, capacity=c)
            second = moe.fused_moe_dispatch(x, g, capacity=c)
            torch.cuda.synchronize()
            for a, b in zip(first, second):
                assert torch.equal(a, b), (n, d, e, c, dt)
    send, top, _, _, fp = moe.fused_moe_dispatch(torch.zeros(0, 64, device=cuda),
                                                 torch.zeros(64, 4, device=cuda), capacity=3)
    assert top.shape == (0,) and not bool(send.any()) and not bool(fp.any())


@pytest.mark.gpu
def test_cuda_moe_backward_kernels_match_plain(cuda):
    """K6's and K7's backward kernels against their plain versions on dyadic
    inputs and seeded cotangents: d_back bitwise (w·g into each kept slot,
    zeros elsewhere); d_w, d_x and d_gate within 1e-5 of each max|grad| (a
    bf16 d_x within one bf16 rounding, 2^-8); one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for n, d, e, c in [(8192, 128, 8, 1280), (8192, 768, 8, 1280), (1000, 30, 16, 40),
                       (4096, 128, 8, 300)]:
        for dt in (torch.float32, torch.bfloat16):
            x = _dyadic((n, d), 16, 8, gen, cuda).to(dt)
            g = _dyadic((d, e), 32, 64, gen, cuda)
            send, top, pos, w, fp, probs = moe._dispatch_cuda(x, g, c, want_probs=True)
            d_send = torch.randn(e, c, d, generator=gen, device=cuda)
            d_w = torch.randn(n, generator=gen, device=cuda)
            d_fp = torch.randn(2, e, generator=gen, device=cuda)
            before = (moe.DISPATCH_BWD_LAUNCHES, moe.COMBINE_BWD_LAUNCHES)
            d_x, d_logits = moe._dispatch_bwd_cuda(x, g, probs, top, pos, w, d_send, d_w, d_fp, c,
                                                   True)
            d_gate = x.float().t() @ d_logits
            want_x, want_gate = moe.dispatch_backward_reference(x, g, top, pos, w, d_send, d_w,
                                                                d_fp, c)
            back = torch.randn(e, c, d, generator=gen, device=cuda)
            out_g = torch.randn(n, d, generator=gen, device=cuda)
            d_back, d_wc = moe._combine_bwd_cuda(back, top, pos, w, out_g, True, True)
            want_back, want_wc = moe.combine_backward_reference(back, top, pos, w, out_g)
            torch.cuda.synchronize()
            assert (moe.DISPATCH_BWD_LAUNCHES - before[0], moe.COMBINE_BWD_LAUNCHES - before[1]) == (1, 1)
            case = (n, d, e, c, dt, int((w == 0).sum()))
            assert d_x.dtype == dt and torch.equal(d_back, want_back), case
            x_tol = 2.0**-8 if dt == torch.bfloat16 else 1e-5
            for name, a, b, tol in (("d_x", d_x, want_x, x_tol), ("d_gate", d_gate, want_gate, 1e-5),
                                    ("d_w", d_wc, want_wc, 1e-5)):
                err = float((a.float() - b.float()).abs().max())
                assert err <= tol * float(b.float().abs().max()), (case, name, err)


@pytest.mark.gpu
def test_cuda_moe_combine_backward_takes_any_routing(cuda):
    """K7's backward kernel on routings fused_moe_dispatch does not produce,
    against the plain version on the CPU: kept tokens whose w is 0 (their
    slots zeros, not left unwritten), two tokens with w != 0 in one slot
    (their sum, within 1e-6 of its max), and drops; d_back starts from
    memory the allocator last filled with NaN. d_w within 1e-5 of its max;
    vector (D 128) and scalar (D 30) routes."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for n, d, e, c in [(4096, 128, 8, 300), (1000, 30, 8, 100)]:
        x, g = _dyadic((n, d), 16, 8, gen, cuda), _dyadic((d, e), 32, 64, gen, cuda)
        _, top, pos, w, _ = moe.fused_moe_dispatch(x, g, capacity=c)
        kept = (w != 0).nonzero()[:, 0]
        w = w.clone()
        w[kept[::7]] = 0.0
        top, pos = top.clone(), pos.clone()
        i, j = kept[1], kept[2]
        top[j], pos[j] = top[i], pos[i]
        back = torch.randn(e, c, d, generator=gen, device=cuda)
        out_g = torch.randn(n, d, generator=gen, device=cuda)
        del x
        torch.full((e, c, d), float("nan"), device=cuda)  # freed: empty_like may reuse it
        d_back, d_w = moe._combine_bwd_cuda(back, top, pos, w, out_g, True, True)
        want_back, want_w = moe.combine_backward_reference(back.cpu(), top.cpu(), pos.cpu(),
                                                           w.cpu(), out_g.cpu())
        got = d_back.cpu()
        shared = (int(top[i]), int(pos[i]))
        assert torch.allclose(got[shared], want_back[shared], rtol=0, atol=1e-6 * float(
            want_back[shared].abs().max())), (n, d)
        got[shared] = want_back[shared]
        assert torch.equal(got, want_back), (n, d, int((got != want_back).sum()))
        err = float((d_w.cpu() - want_w).abs().max())
        assert err <= 1e-5 * float(want_w.abs().max()), (n, d, err)



# K1-bwd's per-channel sums against the plain version's, relative to an upper
# bound of the sum of |terms| (bwd_scales): both are f32 sums of the same
# rounded products in different orders (the kernel: per-thread runs, a block
# tree, a fixed-order pass over the blocks), each within ~log2(R) + R /
# threads roundings of the sum of |terms|; 1e-5 is above that for every
# ResNet-50 site (a few hundred 2^-24 roundings) and far below a wrong term.
BWD_SUM_RTOL = 1e-5


def bwd_scales(x, mean, mul, bias, identity, g_out, g_cast, kw):
    """Per channel, upper bounds of sum|terms| of d_mean, d_mul and d_bias:
    the plain backward fed |g| gives sum|g1| (the ReLU mask and the roundings
    keep |.|), times |mul| and max|x - mean|."""
    abs_ = [None if g is None else g.abs() for g in (g_out, g_cast)]
    s = ep.epilogue_backward_reference(x, mean, mul, bias, identity, *abs_, **kw)[3]
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    spread = (x.float() - mean.view(1, -1, *([1] * (x.dim() - 2)))).abs().amax(dims)
    return s * mul.abs(), s * spread, s


def bwd_check(x, mean, mul, bias, identity, g_out, g_cast, kw, what):
    """K1-bwd against its plain version: d_x and d_identity bitwise, the
    per-channel sums within BWD_SUM_RTOL; two calls bitwise equal."""
    got = ep.fused_conv_epilogue_backward(x, mean, mul, bias, identity, g_out, g_cast, **kw)
    again = ep.fused_conv_epilogue_backward(x, mean, mul, bias, identity, g_out, g_cast, **kw)
    want = ep.epilogue_backward_reference(x, mean, mul, bias, identity, g_out, g_cast, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert (g is None) == (a is None) and (g is None or torch.equal(g, a)), what
    for name, g, w in (("d_x", got[0], want[0]), ("d_identity", got[4], want[4])):
        assert (g is None) == (w is None), (what, name)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
            assert torch.equal(g, w), (what, name, (g.float() - w.float()).abs().max().item())
    worst = 0.0
    for name, g, w, s in zip(("d_mean", "d_mul", "d_bias"), got[1:4], want[1:4],
                             bwd_scales(x, mean, mul, bias, identity, g_out, g_cast, kw)):
        rel = ((g - w).abs() / s.clamp_min(1e-30)).max().item()
        assert rel <= BWD_SUM_RTOL, (what, name, rel)
        worst = max(worst, rel)
    return worst


@pytest.mark.gpu
def test_cuda_epilogue_backward_equals_plain(cuda):
    """K1-bwd vs autograd through the plain version, at ResNet-50 training
    widths and the scalar route's shapes (C 36, a misaligned view, 2-D), in
    every mode, bf16 and f32 boundaries, with and without residual and ReLU;
    the autograd Function around K1 gives the same gradients."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def nchw(n, h, w, c, dtype, offset=0):
        t = torch.randn(n * h * w * c + offset, generator=gen, device=cuda).to(dtype)
        return t[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    cases = [((8, 56, 56, 64), 0, False), ((4, 7, 7, 2048), 0, False), ((3, 5, 9, 40), 0, False),
             ((3, 5, 9, 36), 0, True), ((2, 6, 6, 64), 2, True), ((37, 1, 1, 96), 0, False)]
    for (n, h, w, c), offset, scalar in cases:
        for bn_dt, res_dt, cast_dt in ((torch.bfloat16, torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32, torch.bfloat16),
                                       (torch.float32, torch.bfloat16, torch.bfloat16),
                                       (torch.bfloat16, None, torch.float32)):
            for res in (False, True):
                x = nchw(n, h, w, c, torch.bfloat16, offset)
                ident = nchw(n, h, w, c, res_dt or bn_dt, offset) if res else None
                if n == 37:
                    x = x.reshape(n, c)
                    ident = None if ident is None else ident.reshape(n, c)
                mean = torch.randn(c, generator=gen, device=cuda) * 0.1
                mul = torch.rand(c, generator=gen, device=cuda) + 0.5
                bias = torch.randn(c, generator=gen, device=cuda) * 0.1
                out_dt = bn_dt if ident is None else torch.promote_types(bn_dt, ident.dtype)
                for relu in (False, True):
                    for mode in ("a", "b", "c"):
                        kw = dict(relu=relu, bn_dtype=bn_dt, cast_to=None if mode == "a" else cast_dt,
                                  keep_boundary=mode != "b")
                        g_out = None if mode == "b" else torch.randn(
                            x.shape, generator=gen, device=cuda).to(out_dt)
                        g_cast = None if mode == "a" else torch.randn(
                            x.shape, generator=gen, device=cuda).to(cast_dt)
                        if g_out is not None and x.dim() == 4:
                            g_out = g_out.contiguous(memory_format=torch.channels_last)
                        if g_cast is not None and x.dim() == 4:
                            g_cast = g_cast.contiguous(memory_format=torch.channels_last)
                        what = ((n, h, w, c), offset, bn_dt, res_dt, cast_dt, res, relu, mode)
                        before = (ep.BWD_LAUNCHES, ep.BWD_SCALAR_LAUNCHES)
                        bwd_check(x, mean, mul, bias, ident, g_out, g_cast, kw, what)
                        assert (ep.BWD_LAUNCHES, ep.BWD_SCALAR_LAUNCHES) == (
                            before[0] + 2, before[1] + 2 * scalar), what
                # through autograd: the Function around K1, mode c
                leaves = [t.detach().requires_grad_() for t in (x, mean, mul, bias)]
                idl = None if ident is None else ident.detach().requires_grad_()
                kw = dict(relu=True, bn_dtype=bn_dt, cast_to=cast_dt)
                outs = ep.fused_conv_epilogue(*leaves, idl, **kw)
                outs = outs if isinstance(outs, tuple) else (outs,)
                gs = [torch.randn(o.shape, generator=gen, device=cuda).to(o.dtype) for o in outs]
                before = ep.BWD_LAUNCHES
                torch.autograd.backward(outs, gs)
                assert ep.BWD_LAUNCHES == before + 1
                inputs = [t.detach() for t in (x, mean, mul, bias)] + [ident]
                if outs[0] is outs[-1]:  # one tensor in both roles: autograd summed its grads
                    want = ep.epilogue_backward_reference(
                        *inputs, gs[0] + gs[-1] if len(gs) == 2 else gs[0], None, relu=True,
                        bn_dtype=bn_dt)
                else:
                    want = ep.epilogue_backward_reference(*inputs, *gs, **kw)
                assert torch.equal(leaves[0].grad, want[0]), ("autograd d_x", (n, h, w, c))
                if idl is not None:
                    assert torch.equal(idl.grad, want[4]), ("autograd d_identity", (n, h, w, c))
                for t, wt in zip(leaves[1:], want[1:4]):
                    assert torch.allclose(t.grad, wt, rtol=1e-4, atol=1e-3), (n, h, w, c)


@pytest.mark.gpu
def test_resnet18_train_step_card_equals_cpu(cuda, monkeypatch):
    """One f32 training step (TF32 off) of ResNet-18 at 64^2 on the card
    against the same step on the CPU: loss, parameters and BN statistics
    within 1e-3 of each tensor's max|.| (summation order in the convs and
    the statistics, amplified by one SGD step at lr 0.1)."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.MODEL.DTYPE = "resnet18", 10, "float32"
    cfg.TRAIN.IM_SIZE = 64
    gen = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (8,), generator=gen)
    states = {}
    for dev in ("cpu", cuda):
        model = build_cfg_model(torch.Generator().manual_seed(1)).to(dev)
        st = TrainState(model)
        before = ep.BWD_LAUNCHES
        m = train_step(st, {"image": imgs.to(dev), "label": labels.to(dev)}, 0.1, topk=5)
        states[str(dev)] = (m["loss_sum"].item(), st.params.cpu(), st.stats.cpu())
        if dev == cuda:
            assert ep.BWD_LAUNCHES - before == 20
    reset_cfg()
    (l_cpu, p_cpu, s_cpu), (l_gpu, p_gpu, s_gpu) = states["cpu"], states[str(cuda)]
    assert abs(l_cpu - l_gpu) <= 1e-3 * abs(l_cpu)
    assert (p_cpu - p_gpu).abs().max() <= 1e-3 * p_cpu.abs().max()
    assert (s_cpu - s_gpu).abs().max() <= 1e-3 * s_cpu.abs().max()


def _determinism_state() -> tuple:
    """What ``configure_determinism`` sets process-wide, to put back after."""
    import os

    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


def _restore_determinism(state: tuple) -> None:
    import os

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = state[:2]
    torch.use_deterministic_algorithms(state[2])
    if state[3] is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = state[3]


@pytest.mark.gpu
def test_deterministic_training_steps_repeat_bitwise(cuda):
    """CUDNN.DETERMINISTIC: two runs of two bf16 ResNet-18 training steps
    from one seed end with bitwise-equal parameters, BN statistics and
    gradients (K1-bwd sums in a fixed order, without float atomics)."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.runtime.seeding import configure_determinism
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    before = _determinism_state()
    configure_determinism(True, benchmark=False)
    try:
        runs = []
        for _ in range(2):
            reset_cfg()
            cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = "resnet18", 10, 64
            st = TrainState(build_cfg_model(torch.Generator().manual_seed(0)).to(cuda))
            gen = torch.Generator().manual_seed(1)
            for _ in range(2):
                train_step(st, {"image": torch.randint(0, 256, (16, 64, 64, 3), dtype=torch.uint8,
                                                       generator=gen).to(cuda),
                                "label": torch.randint(0, 10, (16,), generator=gen).to(cuda)}, 0.1)
            runs.append([t.cpu() for t in (st.params, st.stats, st.grads)])
    finally:
        reset_cfg()
        _restore_determinism(before)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_deterministic_botnet50_training_steps_repeat_bitwise(cuda):
    """CUDNN.DETERMINISTIC: two runs of two bf16 botnet50 training steps at
    64^2 from one seed end with bitwise-equal parameters, BN statistics and
    gradients (the attention backward sums in a fixed order, without float
    atomics, as K1-bwd does)."""
    from distribuuuu_tpu_torch.config import reset_cfg
    from distribuuuu_tpu_torch.runtime.seeding import configure_determinism
    from distribuuuu_tpu_torch.trainer import train_step

    before = _determinism_state()
    configure_determinism(True, benchmark=False)
    try:
        runs = []
        for _ in range(2):
            st = _botnet_state(cuda, "bfloat16", 64)
            gen = torch.Generator().manual_seed(1)
            for _ in range(2):
                train_step(st, {"image": torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                                                       generator=gen).to(cuda),
                                "label": torch.randint(0, 10, (8,), generator=gen).to(cuda)}, 0.01)
            runs.append([t.cpu() for t in (st.params, st.stats, st.grads)])
    finally:
        reset_cfg()
        _restore_determinism(before)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _jpeg_folder(path):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(32):
        (path / f"c{i % 4}").mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(
            path / f"c{i % 4}" / f"{i}.jpg", quality=90)
    return str(path)


_PIN_KW = dict(host_batch=8, train=True, im_size=48, process_index=0, process_count=1, seed=3,
               prefetch_batches=4)


def _assert_prefetched_bitwise(pinned, host, cuda):
    """13 epochs of ``pinned`` through ``DevicePrefetcher`` at depth 2, the
    compute stream kept busy a millisecond a batch, against ``host``'s
    batches decoded on the host, in order; ``pinned``'s batches pinned."""
    from distribuuuu_tpu_torch.data import loader

    got, want = [], []
    for epoch in range(13):
        pinned.set_epoch(epoch)
        host.set_epoch(epoch)
        for b, batch in enumerate(loader.DevicePrefetcher(pinned, cuda, depth=2)):
            torch.cuda._sleep(2_000_000)  # ~1 ms of a busy compute stream
            got.append({k: v.clone() for k, v in batch.items()})
            want.append(host.decode_batch(b))
    assert len(got) == 52
    first = next(iter(pinned))
    assert all(t.is_pinned() for t in first.values())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for k in ("image", "label", "weight"):
            assert torch.equal(g[k].cpu(), torch.from_numpy(w[k])), k


@pytest.mark.gpu
def test_producer_pinned_batches_reach_the_card_bitwise(cuda, tmp_path):
    """TRAIN.PIN_MEMORY: the loader's producer thread decodes each batch into
    fresh pinned tensors, which the caching host allocator recycles only
    after their copy's event. 52 batches of a changing stream (13 epochs of
    a train ImageFolder) through ``DevicePrefetcher`` at TRAIN.PREFETCH's
    default depth 2, the compute stream kept busy a millisecond a batch,
    arrive on the card bitwise equal to the same batches decoded on the
    host, in order."""
    from distribuuuu_tpu_torch.data import dataset, loader

    root = _jpeg_folder(tmp_path)
    kw = dict(_PIN_KW, workers=4)
    pinned = loader.HostDataLoader(dataset.ImageFolder(root), pin_device=cuda, **kw)
    host = loader.HostDataLoader(dataset.ImageFolder(root), **kw)
    host.use_native = pinned.use_native
    _assert_prefetched_bitwise(pinned, host, cuda)


@pytest.mark.gpu
def test_service_pinned_batches_reach_the_card_bitwise(cuda, tmp_path):
    """DATA.SERVICE: the ``ServiceLoader``'s receiving thread reads each frame
    into fresh pinned tensors; the same 52 batches as the local loader's
    test reach the card bitwise equal to local decode."""
    from distribuuuu_tpu_torch.data import dataset, loader
    from distribuuuu_tpu_torch.dataplane import DataPlaneService, ServiceLoader

    root = _jpeg_folder(tmp_path)
    host = loader.HostDataLoader(dataset.ImageFolder(root), workers=4, **_PIN_KW)
    svc = DataPlaneService(workers=2, worker_threads=2, in_process=True).start()
    try:
        pinned = ServiceLoader(svc.address, root=root, fallback=False, pin_device=cuda,
                               **_PIN_KW)
        _assert_prefetched_bitwise(pinned, host, cuda)
        assert pinned.fallbacks == 0
    finally:
        svc.stop()


@pytest.mark.gpu
def test_watchdog_fires_while_the_host_waits_on_a_stalled_device(cuda):
    """The hang as it happens on the card: the host runs ahead, so a stalled
    device shows as the host blocked in a sync (the trainer's window fetch,
    an NCCL wait). A kernel that spins ``torch.cuda._sleep`` far past
    ``HANG_TIMEOUT_S``, then a sync: the watchdog thread still runs (the
    sync releases the GIL), dumps every stack, the blocked sync's frame
    among them, and the process exits 124 without waiting for the kernel."""
    import subprocess
    import sys
    import time
    from pathlib import Path

    timeout_s = 3.0
    code = ("import sys, torch; sys.path.insert(0, %r)\n"
            "from distribuuuu_tpu_torch import resilience\n"
            "torch.cuda.init()\n"
            "resilience.start_watchdog(%r)\n"
            "resilience.watchdog_beat(0)\n"
            "torch.cuda._sleep(int(120e9))  # ~60 s of spinning at the H100's ~2 GHz\n"
            "def wait_for_the_stalled_device():\n"
            "    torch.cuda.synchronize()\n"
            "wait_for_the_stalled_device()\n"
            "print('the sync returned')\n" % (str(Path(__file__).resolve().parents[1]), timeout_s))
    tic = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=150)
    wall = time.monotonic() - tic
    assert proc.returncode == 124, proc.stderr[-3000:]
    assert wall < timeout_s + 25, wall  # process start, CUDA init, not the kernel's 60 s
    assert "the sync returned" not in proc.stdout
    assert "WATCHDOG: hang" in proc.stderr
    assert "wait_for_the_stalled_device" in proc.stderr and "synchronize" in proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["resnet18", "efficientnet_b0"])
def test_remat_training_steps_equal_without_remat_on_the_card(cuda, arch):
    """MODEL.REMAT on the card, cuDNN deterministic: two bf16 steps at 64^2,
    batch 8, from one state, with REMAT on and off, give torch.equal
    parameters, BN statistics and optimizer state (EfficientNet-B0 with its
    drop path and dropout drawing from the trainer's CUDA generator, which
    the recompute replays); K1 launches once more for every BN inside a
    block, K1-bwd once for every BN."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.runtime.seeding import configure_determinism
    from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step

    before = _determinism_state()
    configure_determinism(True, benchmark=False)
    runs = []
    try:
        for remat in (False, True):
            reset_cfg()
            cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = arch, 10, 64
            cfg.MODEL.REMAT = remat
            model = build_cfg_model(torch.Generator().manual_seed(0))
            units = [m for m in model.modules() if isinstance(m, layers.RematUnit)]
            bns = sum(isinstance(m, layers.BatchNorm) for m in model.modules())
            inner = sum(isinstance(m, layers.BatchNorm) for u in units for m in u.modules())
            st = TrainState(model.to(cuda))
            gen = torch.Generator().manual_seed(1)
            k1, k1_bwd = ep.LAUNCHES, ep.BWD_LAUNCHES
            for step in range(2):
                train_step(st, {"image": torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                                                       generator=gen).to(cuda),
                                "label": torch.randint(0, 10, (8,), generator=gen).to(cuda)},
                           0.1, dropout_key=(3, 0, step, 0))
            torch.cuda.synchronize()
            assert ep.LAUNCHES - k1 == 2 * (bns + inner * remat)
            assert ep.BWD_LAUNCHES - k1_bwd == 2 * bns
            runs.append([st.params.cpu(), st.stats.cpu(),
                         *(v.cpu() for v in st.optimizer.state.values())])
    finally:
        reset_cfg()
        _restore_determinism(before)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_mae_forward_and_step_card_equal_cpu(cuda, monkeypatch):
    """A small MAE ViT (patch 4, width 64, depth 2) in f32 with TF32 off, at
    32^2, batch 4, under one mask: the predictions within 1e-5 of max|pred|
    and one LAMB step's parameters within 1e-4 of max|p|, card vs CPU."""
    from distribuuuu_tpu_torch.config import cfg, reset_cfg
    from distribuuuu_tpu_torch.data.transforms import device_normalize
    from distribuuuu_tpu_torch.models.mae import MAEViT
    from distribuuuu_tpu_torch.trainer import TrainState, mae_mask, train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    reset_cfg()
    cfg.OPTIM.OPTIMIZER, cfg.OPTIM.WEIGHT_DECAY = "lamb", 0.05
    gen = torch.Generator().manual_seed(2)
    imgs = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8, generator=gen)
    mask = mae_mask(4, 64, gen)
    out = {}
    try:
        for dev in ("cpu", cuda):
            model = layers.init_weights(
                MAEViT(patch=4, dim=64, depth=2, num_heads=2, mlp_dim=128, decoder_dim=32,
                       im_size=32, dtype=torch.float32), torch.Generator().manual_seed(0)).to(dev)
            with torch.no_grad():
                pred = model.eval()(device_normalize(imgs.to(dev)), mask.to(dev)).cpu()
            st = TrainState(model)
            train_step(st, {"image": imgs.to(dev), "label": torch.zeros(4, dtype=torch.long,
                                                                        device=dev)},
                       2e-3, task="mae", mask=mask.to(dev))
            out[str(dev)] = (pred, st.params.cpu())
    finally:
        reset_cfg()
    (pc, wc), (pg, wg) = out["cpu"], out[str(cuda)]
    assert (pg - pc).abs().max() <= 1e-5 * pc.abs().max()
    assert (wg - wc).abs().max() <= 1e-4 * wc.abs().max()


_FSDP_RANK = """
import sys, datetime, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.runtime.mesh import data_mesh
from distribuuuu_tpu_torch.runtime.seeding import configure_determinism
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step
from distribuuuu_tpu_torch.ops import epilogue as ep
r, f = int(sys.argv[1]), int(sys.argv[2])
torch.cuda.set_device(r)
dist.init_process_group("nccl", init_method=sys.argv[3], rank=r, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
configure_determinism(True, benchmark=False)
cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = "resnet18", 10, 64
st = TrainState(build_cfg_model(torch.Generator().manual_seed(0)).cuda(), dist.group.WORLD,
                data_mesh(-1, f, 2, r, dist.group.WORLD), min_size=1024)
gen = torch.Generator().manual_seed(1)
before = (ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES, ep.BWD_SCALAR_LAUNCHES)
for _ in range(2):
    x = torch.randint(0, 256, (16, 64, 64, 3), dtype=torch.uint8, generator=gen)
    y = torch.randint(0, 10, (16,), generator=gen)
    train_step(st, {"image": x[8 * r:8 * (r + 1)].cuda(), "label": y[8 * r:8 * (r + 1)].cuda()},
               0.1)
launches = [b - a for a, b in zip(before, (ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES,
                                         ep.BWD_SCALAR_LAUNCHES))]
opt = st.full_optimizer_state()
torch.save({"params": [p.detach().cpu() for p in st.model.parameters()],
            "momentum": opt["momentum"].cpu(), "launches": launches, "fsdp": st.fsdp},
           sys.argv[5])
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_fsdp_two_nccl_ranks_step_as_data_parallel(cuda, tmp_path):
    """2 bf16 ResNet-18 steps on 2 NCCL ranks (one card each, cuDNN
    deterministic) at fsdp 2 (``MIN_SIZE`` 1024) and at data 2: the
    parameters and the momentum in the replicated layout bitwise equal (the
    reduce-scatter and the all-reduce add the same two terms), K1 and K1-bwd
    20 times a step on every rank, none scalar."""
    import subprocess
    import sys
    from pathlib import Path

    from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA GPUs: NCCL refuses two ranks on one card")
    root = str(Path(__file__).resolve().parents[1])
    runs = {}
    for f in (2, 1):
        init = f"tcp://127.0.0.1:{pick_rendezvous_port()}"
        outs = [tmp_path / f"f{f}_r{r}.pt" for r in range(2)]
        procs = [subprocess.Popen([sys.executable, "-c", _FSDP_RANK, str(r), str(f), init, root,
                                   str(outs[r])]) for r in range(2)]
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
        runs[f] = [torch.load(o, weights_only=True) for o in outs]
    for res in (*runs[2], *runs[1]):
        assert res["launches"] == [40, 40, 0, 0]
    assert runs[2][0]["fsdp"] == 2 and runs[1][0]["fsdp"] == 1
    for a in (*runs[2], runs[1][1]):
        b = runs[1][0]
        assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
        assert torch.equal(a["momentum"], b["momentum"])


@pytest.mark.gpu
def test_fsdp_shard_layout_round_trips_on_the_card(cuda):
    """``ShardLayout`` on CUDA buffers: each of 4 ranks' ``take`` of a
    ResNet-50's full aligned buffer, stacked rank-major, is what ``pack``
    writes and what ``unpack`` reads back into every parameter bitwise;
    the views stay 16-byte aligned."""
    from distribuuuu_tpu_torch.parallel.fsdp import ShardLayout
    from distribuuuu_tpu_torch.trainer import _aligned_offsets

    model = build_model("resnet50", num_classes=1000)
    named = [(n, p.shape) for n, p in model.named_parameters()]
    offsets, total = _aligned_offsets([p for p in model.parameters()])
    full = torch.randn(total, generator=torch.Generator().manual_seed(0)).to(cuda)
    lays = [ShardLayout(named, offsets, 4, r) for r in range(4)]
    shards = [lay.take(full) for lay in lays]
    stage = torch.cat([s[:lays[0].chunk] for s in shards])
    packed = torch.empty_like(stage)
    lays[0].pack(full, packed)
    assert torch.equal(packed, stage) and len(lays[0].sharded_leaves) == 52
    back = torch.zeros_like(full)
    lays[0].unpack(stage, back)
    for (name, shape), o in zip(named, offsets):
        n = torch.Size(shape).numel()
        if any(leaf[0] == name for leaf in lays[0].sharded_leaves):
            assert torch.equal(back[o:o + n], full[o:o + n]), name
        assert (full[o:].data_ptr() % 16) == 0


_SEQ_RANK = """
import sys, datetime, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[3])
from distribuuuu_tpu_torch.parallel import seq
r = int(sys.argv[1])
torch.cuda.set_device(r)
dist.init_process_group("nccl", init_method=sys.argv[2], rank=r, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
gen, out = torch.Generator().manual_seed(0), {}
for impl in ("ring", "ulysses"):
    for causal in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            t = [torch.randn(2, 4, 64, 32, generator=gen).cuda() for _ in range(4)]
            q, k, v = (seq.local_tokens(x, dist.group.WORLD, 2).to(dtype).requires_grad_()
                       for x in t[:3])
            o = seq.seq_attention(q, k, v, impl=impl, group=dist.group.WORLD, causal=causal)
            (o.float() * seq.local_tokens(t[3], dist.group.WORLD, 2)).sum().backward()
            out[(impl, causal, str(dtype))] = [x.detach().float().cpu()
                                               for x in (o, q.grad, k.grad, v.grad, *t)]
torch.save(out, sys.argv[4])
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_ring_and_ulysses_on_two_nccl_cards(cuda, tmp_path):
    """Ring and Ulysses attention over a 2-rank NCCL seq group (one card
    each), causal or not, f32 and bf16: each rank's output tokens and the
    gradients of ``sum(out * g)`` against dense attention of the whole
    sequence on the card, within JAX's limits (``tests/test_ring_attention.py``:
    f32 2e-5 forward, rtol 2e-4 / atol 2e-5 gradients; bf16 5e-2)."""
    import subprocess
    import sys
    from pathlib import Path

    from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA GPUs: NCCL refuses two ranks on one card")
    init, root = f"tcp://127.0.0.1:{pick_rendezvous_port()}", str(Path(__file__).parents[1])
    outs = [tmp_path / f"r{r}.pt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _SEQ_RANK, str(r), init, root, str(outs[r])])
             for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    runs = [torch.load(o, weights_only=False) for o in outs]
    for key, (o0, *grads0, q, k, v, g) in runs[0].items():
        impl, causal, dtype = key
        dt = getattr(torch, dtype.split(".")[1])
        qd, kd, vd = (x.to(cuda, dt).requires_grad_() for x in (q, k, v))
        s = torch.matmul(qd.float(), kd.float().transpose(-1, -2)) * 32 ** -0.5
        if causal:
            s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool, device=cuda).tril(),
                              float("-inf"))
        od = torch.matmul(torch.softmax(s, -1), vd.float()).to(dt)
        (od.float() * g.to(cuda)).sum().backward()
        tol = dict(rtol=5e-2, atol=5e-2) if dt == torch.bfloat16 else None
        for i, want in enumerate((od, qd.grad, kd.grad, vd.grad)):
            got = torch.cat([runs[r][key][i] for r in range(2)], dim=2)
            lim = tol or (dict(rtol=2e-5, atol=2e-5) if i == 0 else dict(rtol=2e-4, atol=2e-5))
            torch.testing.assert_close(got, want.detach().float().cpu(), **lim, msg=str(key))


_PARALLEL_RANK = """
import sys, datetime, numpy as np, torch, torch.distributed as dist
sys.path[:0] = [sys.argv[3], sys.argv[3] + "/scripts"]
from distribuuuu_tpu_torch.parallel import column_parallel_logits, pipeline_apply, tp_cross_entropy
from torch_parallel_dist import moe_step
r = int(sys.argv[1])
torch.cuda.set_device(r)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("nccl", init_method=sys.argv[2], rank=r, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
g, rng, out = dist.group.WORLD, np.random.default_rng(0), {}
x, w, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
           for s in ((16, 32), (32, 24), (24,)))
labels = torch.from_numpy(rng.integers(0, 24, 16)).cuda()
xl = x.clone().requires_grad_()
wl, bl = (t[..., 12 * r:12 * (r + 1)].clone().requires_grad_() for t in (w, b))
loss = tp_cross_entropy(column_parallel_logits(xl, wl, bl, group=g), labels, group=g,
                        label_smooth=0.1)
loss.mean().backward()
out["tp"] = [t.detach().cpu() for t in (x, w, b, labels, loss, xl.grad, wl.grad, bl.grad)]
p = {k: torch.from_numpy(0.4 * rng.standard_normal((2, 16, 16), dtype=np.float32)).cuda()
     for k in ("w1", "w2")}
h, y = (torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32)).cuda() for _ in "hy")
mine = {k: v[r].clone().requires_grad_() for k, v in p.items()}
o = pipeline_apply(mine, h, lambda q, a: a + torch.tanh(a @ q["w1"]) @ q["w2"],
                   num_microbatches=4, group=g)
lp = torch.mean((o - y) ** 2)
lp.backward()
out["pp"] = [p["w1"].cpu(), p["w2"].cpu(), h.cpu(), y.cpu(), lp.detach().cpu(),
             mine["w1"].grad.cpu(), mine["w2"].grad.cpu()]
data = {"x": (rng.integers(-16, 17, (2, 256, 64)) / 8).astype(np.float32),
        "y": rng.standard_normal((2, 256, 64), dtype=np.float32),
        "gate": (rng.integers(-32, 33, (64, 2)) / 64).astype(np.float32),
        "w": rng.standard_normal((2, 64, 128), dtype=np.float32) / np.float32(8),
        "v": rng.standard_normal((2, 128, 64), dtype=np.float32) / np.float32(np.sqrt(128))}
host = dist.new_group(backend="gloo")
out["moe"] = [*moe_step(torch.device("cuda", r), g, data, r, torch.float32, 160),
              *moe_step(torch.device("cpu"), host, data, r, torch.float32, 160)]
torch.save(out, sys.argv[4])
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def nccl_pair(tmp_path_factory):
    """Two NCCL ranks (one card each) of ``_PARALLEL_RANK``: the
    class-parallel head at model 2, a 2-stage pipeline and ``switch_moe``
    at E 2 (on the card, then the same ranks over gloo on the CPU)."""
    import subprocess
    import sys
    from pathlib import Path

    from distribuuuu_tpu_torch.runtime.dist import pick_rendezvous_port

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA GPUs: NCCL refuses two ranks on one card")
    tmp = tmp_path_factory.mktemp("nccl_pair")
    init, root = f"tcp://127.0.0.1:{pick_rendezvous_port()}", str(Path(__file__).parents[1])
    outs = [tmp / f"r{r}.pt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _PARALLEL_RANK, str(r), init, root,
                               str(outs[r])]) for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.mark.gpu
def test_tp_head_on_two_nccl_cards_equals_replicated(nccl_pair, monkeypatch):
    """Model 2, smoothing 0.1, f32: each rank's per-example loss, dx and its
    kernel and bias shards' gradients against ``F.cross_entropy`` of the
    replicated head on the card (``tests/test_tensor_parallel.py``'s limits)."""
    import torch.nn.functional as F

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, w, b, labels = (t.cuda() for t in nccl_pair[0]["tp"][:4])
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    loss = F.cross_entropy(x @ w + b, labels, reduction="none", label_smoothing=0.1)
    loss.mean().backward()
    for r, run in enumerate(nccl_pair):
        got_loss, dx, dw, db = run["tp"][4:]
        torch.testing.assert_close(got_loss, loss.detach().cpu(), rtol=1e-5, atol=1e-6)
        for g, want in ((dx, x.grad), (dw, w.grad[:, 12 * r:12 * (r + 1)]),
                        (db, b.grad[12 * r:12 * (r + 1)])):
            torch.testing.assert_close(g, want.cpu(), rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_pipeline_on_two_nccl_cards_equals_dense(nccl_pair, monkeypatch):
    """2 stages of ``h + tanh(h @ w1) @ w2``, 4 microbatches, f32: the loss
    on both ranks and each stage's gradients against the dense stack on the
    card (``tests/test_pipeline.py``'s limits)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    w1, w2, h, y = (t.cuda() for t in nccl_pair[0]["pp"][:4])
    w1, w2 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
    a = h
    for s in range(2):
        a = a + torch.tanh(a @ w1[s]) @ w2[s]
    loss = torch.mean((a - y) ** 2)
    loss.backward()
    for r, run in enumerate(nccl_pair):
        got_loss, g1, g2 = run["pp"][4:]
        torch.testing.assert_close(got_loss, loss.detach().cpu(), rtol=1e-6, atol=0.0)
        torch.testing.assert_close(g1, w1.grad[r].cpu(), rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(g2, w2.grad[r].cpu(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_switch_moe_on_two_nccl_cards_equals_cpu_ranks(nccl_pair):
    """``switch_moe`` at E 2 over NCCL (one expert a card), f32 on dyadic
    inputs, against the same ranks over gloo on the CPU (the plain
    versions): the routing equal, everything else within 1e-5 of max|.|;
    K6, K7 and both backward kernels once a rank on the card, none on the
    CPU."""
    for run in nccl_pair:
        card, launches, cpu, cpu_launches = run["moe"]
        assert launches == [1, 1, 1, 1] and cpu_launches == [0, 0, 0, 0]
        assert torch.equal(card["top"], cpu["top"]) and torch.equal(card["pos"], cpu["pos"])
        for k in ("loss", "aux", "out", "gate_grad", "w_grad", "v_grad"):
            assert (card[k] - cpu[k]).abs().max() <= 1e-5 * cpu[k].abs().max(), k


@pytest.mark.gpu
def test_peak_flops_lookup_names_this_card(cuda):
    """``obs/flops.py``'s peak for the card's own name: an H100 is in the
    table (989.4 TFLOP/s dense bf16 for SXM/HBM3, 756 for PCIe), and the
    config override wins over it."""
    from distribuuuu_tpu_torch.obs import flops

    name = torch.cuda.get_device_name(cuda).lower()
    peak = flops.peak_flops_per_device(cuda)
    if "h100" in name:
        assert peak == pytest.approx((756.0 if "pcie" in name else 989.4) * 1e12)
    assert flops.peak_flops_per_device(cuda, override_tflops=123.0) == pytest.approx(123e12)
    assert flops.peak_flops_per_device("cpu") is None


@pytest.mark.gpu
def test_memory_snapshot_reads_the_allocator(cuda):
    """``obs/memory.snapshot`` on the card is ``torch.cuda.memory_stats``:
    live blocks, allocated bytes, and every byte counter under the card's
    index, its peak the epoch log line's ``max_memory_allocated``."""
    from distribuuuu_tpu_torch.obs import memory

    keep = torch.empty(3 << 20, device=cuda)
    snap = memory.snapshot(cuda)
    stats = torch.cuda.memory_stats(cuda)
    assert snap["live_bytes"] == stats["allocated_bytes.all.current"] >= keep.numel() * 4
    assert snap["live_arrays"] == stats["active.all.current"] >= 1
    per = snap["per_device"][str(cuda.index or 0)]
    assert per["allocated_bytes.all.peak"] == torch.cuda.max_memory_allocated(cuda)
    assert all("bytes" in k for k in per)


@pytest.mark.gpu
def test_profile_window_names_k1_and_attributes_the_step(cuda, tmp_path):
    """A 2-step ``ProfilerWindows`` over ResNet-18 training steps on the
    card (bf16, 64^2, batch 8): the profile record's top_ops name K1's and
    K1-bwd's kernels, and the step_attribution buckets add up to its device
    time, convolutions in matmul and K1 in vector."""
    from distribuuuu_tpu_torch.obs import attribution
    from distribuuuu_tpu_torch.obs.profiler import ProfilerWindows
    from distribuuuu_tpu_torch.trainer import TrainState, train_step

    class Recorder:
        def __init__(self):
            self.records = {}

        def event(self, kind, **fields):
            self.records[kind] = fields

    model = build_model("resnet18", num_classes=10, dtype=torch.bfloat16, bn_dtype=torch.bfloat16)
    layers.init_weights(model, torch.Generator().manual_seed(0))
    state = TrainState(model.to(cuda))
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                                    generator=gen).to(cuda),
             "label": torch.randint(0, 10, (8,), generator=gen).to(cuda)}
    train_step(state, batch, 0.1)  # cuDNN's first-call work outside the window
    rec = Recorder()
    prof = ProfilerWindows(str(tmp_path), at_steps=[0], num_steps=2, top_ops=64, sigusr1=False,
                           telemetry=rec, device=cuda, batch=8)
    for g in range(2):
        prof.maybe_start(g)
        train_step(state, batch, 0.1)
        prof.after_step(g)
    p, a = rec.records["profile"], rec.records["step_attribution"]
    names = [o["op"] for o in p["top_ops"]]
    assert any("epilogue_vec_kernel" in n for n in names), names
    assert any("epilogue_bwd" in n for n in names), names
    dev = sum(v for b, v in a["buckets"].items() if b != "host")
    assert dev == pytest.approx(p["device_ms_per_step"], rel=1e-3)
    assert a["buckets"]["matmul"] > 0 and a["buckets"]["vector"] > 0
    assert attribution.classify_op(next(n for n in names if "epilogue" in n)) == "vector"
    assert a["device_kind"] == torch.cuda.get_device_name(cuda)


@pytest.mark.gpu
def test_cuda_epilogue_int32_mode_equals_plain_bitwise(cuda):
    """K1's int32 input mode (a quantized conv's accumulator, values past
    2^24 included, so the int -> f32 rounding shows) vs its plain version,
    bitwise, on the vector route and on the scalar one (C 36; a view 2
    elements off a 16-byte boundary), with mean 0 as the int8 path runs it
    and with a mean, each BN, residual and cast dtype, each mode; every call
    counted in ``INT32_LAUNCHES``. Gradients are refused."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def nchw(n, h, w, c, dtype, offset=0):
        if dtype == torch.int32:
            t = torch.randint(-(1 << 26), 1 << 26, (n * h * w * c + offset,), generator=gen,
                              device=cuda, dtype=torch.int32)
        else:
            t = torch.randn(n * h * w * c + offset, generator=gen, device=cuda).to(dtype)
        return t[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    for (n, h, w, c), offset, scalar in (((2, 7, 7, 2048), 0, False), ((3, 5, 9, 40), 0, False),
                                         ((3, 5, 9, 36), 0, True), ((2, 6, 6, 64), 2, True)):
        x = nchw(n, h, w, c, torch.int32, offset)
        for bn_dt in (torch.float32, torch.bfloat16):
            for res_dt in (None, torch.float32, torch.bfloat16):
                ident = None if res_dt is None else nchw(n, h, w, c, res_dt, offset)
                mul = torch.rand(c, generator=gen, device=cuda) * 1e-6
                bias = torch.randn(c, generator=gen, device=cuda)
                for mean in (torch.zeros(c, device=cuda), torch.randn(c, generator=gen,
                                                                      device=cuda) * 1e5):
                    for relu in (False, True):
                        for mode, kw in _K1_MODES.items():
                            kw = dict(kw, relu=relu, bn_dtype=bn_dt,
                                      cast_to=None if mode == "a" else torch.bfloat16)
                            before = (ep.LAUNCHES, ep.SCALAR_LAUNCHES, ep.INT32_LAUNCHES)
                            got = ep.fused_conv_epilogue(x, mean, mul, bias, ident, **kw)
                            assert (ep.LAUNCHES, ep.SCALAR_LAUNCHES, ep.INT32_LAUNCHES) == (
                                before[0] + 1, before[1] + scalar, before[2] + 1)
                            want = ep.epilogue_reference(x, mean, mul, bias, ident, **kw)
                            torch.cuda.synchronize()
                            pairs = zip(got, want) if mode == "c" else [(got, want)]
                            for g, wt in pairs:
                                assert g.dtype == wt.dtype and torch.equal(g, wt), (
                                    (n, h, w, c), offset, bn_dt, res_dt, relu, mode)
    with pytest.raises(TypeError, match="no backward"):
        ep.fused_conv_epilogue(x, mean, mul.requires_grad_(), bias, bn_dtype=torch.float32)


# (N, C, H, W, O, k, stride, padding): ResNet-50's stem (K 147 padded to 152),
# a 1x1, the downsample's 1x1 stride 2, a 3x3 stride 2, a 3x3 and one whose
# M (1 * 4 * 4) is below _int_mm's 17 rows
_INT8_CONVS = [(2, 3, 224, 224, 64, 7, 2, 3), (4, 256, 56, 56, 64, 1, 1, 0),
               (4, 512, 28, 28, 1024, 1, 2, 0), (4, 256, 28, 28, 256, 3, 2, 1),
               (2, 64, 56, 56, 64, 3, 1, 1), (1, 512, 4, 4, 512, 3, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _INT8_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_accumulator_on_the_card_equals_plain(cuda, shape):
    """The int8 conv's card route (im2col + ``torch._int_mm``) vs its plain
    version (the float64 conv of the int8 values, on the card): the int32
    accumulators ``torch.equal``, channels-last."""
    from distribuuuu_tpu_torch.quant import ptq

    n, c, h, w, o, k, s, p = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    xq = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=cuda,
                       dtype=torch.int8).permute(0, 3, 1, 2)
    wm = ptq.int8_matrix(torch.randint(-127, 128, (o, c, k, k), generator=gen, device=cuda,
                                       dtype=torch.int8))
    args = (xq, wm, o, (k, k), (s, s), (p, p))
    got, want = ptq.int8_conv2d(*args), ptq.int8_conv2d_reference(*args)
    assert got.dtype == torch.int32 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 128])
def test_int8_linear_accumulator_on_the_card_equals_plain(cuda, n):
    """ResNet-50's fc (2048 -> 1000) in int8 at batch 1 (M 1, padded to 17
    rows) and 128: ``torch._int_mm``'s int32 accumulator ``torch.equal`` to
    the float64 product on the card."""
    from distribuuuu_tpu_torch.quant import ptq

    gen = torch.Generator(device=cuda).manual_seed(2)
    xq = torch.randint(-127, 128, (n, 2048), generator=gen, device=cuda, dtype=torch.int8)
    wm = ptq.int8_matrix(torch.randint(-127, 128, (1000, 2048), generator=gen, device=cuda,
                                       dtype=torch.int8))
    assert torch.equal(ptq.int8_linear(xq, wm, 1000), ptq.int8_linear_reference(xq, wm, 1000))


_VIT_STEPS = r'''
import sys
sys.path.insert(0, sys.argv[1])
from distribuuuu_tpu_torch.runtime.seeding import configure_determinism
configure_determinism(True, benchmark=False)  # before any CUDA work, as the trainer
import torch
from distribuuuu_tpu_torch.config import cfg, reset_cfg
from distribuuuu_tpu_torch.trainer import TrainState, build_cfg_model, train_step
# other CUDA work first: GEMMs on the default stream and on a side stream, a conv
a = torch.randn(1024, 1024, device="cuda")
side = torch.cuda.Stream()
with torch.cuda.stream(side):
    (a @ a.t()).sum().item()
(a @ a).sum().item()
torch.nn.functional.conv2d(torch.randn(2, 3, 32, 32, device="cuda"),
                           torch.randn(8, 3, 3, 3, device="cuda")).sum().item()
runs = []
for _ in range(2):
    reset_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.TRAIN.IM_SIZE = "vit_s16", 10, 64
    st = TrainState(build_cfg_model(torch.Generator().manual_seed(0)).cuda())
    gen = torch.Generator().manual_seed(1)
    for k in range(2):
        train_step(st, {"image": torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                                               generator=gen).cuda(),
                        "label": torch.randint(0, 10, (8,), generator=gen).cuda()}, 1e-3,
                   dropout_key=(0, 0, k, 0))
    runs.append([st.params.cpu(), st.grads.cpu()])
assert torch.are_deterministic_algorithms_enabled()
print("equal" if all(torch.equal(x, y) for x, y in zip(*runs)) else "differ")
'''


@pytest.mark.gpu
def test_deterministic_vit_steps_repeat_after_other_cuda_work(cuda):
    """CUDNN.DETERMINISTIC as the trainer sets it, before the process's first
    CUDA work: after GEMMs on two streams and a conv, two runs of two ViT-S/16
    steps (64^2, batch 8) in the same process end with torch.equal
    parameters and gradients. A fresh process, so that the setting comes
    before any cuBLAS handle."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", _VIT_STEPS, root], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "equal"


@pytest.mark.gpu
def test_qat_forward_tracks_int8_and_scopes_tf32_on_the_card(cuda):
    """The fake-quant forward of a seeded ResNet-18 (f32, 64^2, eval) against
    the true int8 path of the same weights on the card, with cuDNN's and
    cuBLAS's TF32 on for the process: TF32 off inside the interception and
    as it was after; at every site, on the input the int8 forward gave it,
    the fake-quant product equals the int8 accumulator times the activation
    and weight scales (plus the bias) within 1e-5 of the product's
    sum|terms| (``quant.qat.site_product_errors``; chip_smoke.py
    QAT_TRACK_ACC: float32 accumulation leaves a few units of 2**-24 of it);
    with the interception's TF32 scoping disabled the same check reads
    above that limit."""
    import contextlib
    import copy

    from distribuuuu_tpu_torch.quant import calibrate_qat, prune_variables, quantize
    from distribuuuu_tpu_torch.quant import qat as qat_mod

    gen = torch.Generator().manual_seed(0)
    model = build_model("resnet18", num_classes=10, dtype=torch.float32)
    layers.init_weights(model, gen)
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    batches = [torch.randn(8, 64, 64, 3, generator=gen).to(cuda) for _ in range(2)]
    x = torch.randn(8, 64, 64, 3, generator=gen).to(cuda)
    qat = calibrate_qat(model, batches)
    qmodel, qparams = quantize(model, qat.sites)
    prior, tf32 = qat_mod._tf32(), []
    hook = model.conv1.register_forward_pre_hook(lambda m, a: tf32.append(qat_mod._tf32()))
    qat_mod._set_tf32(True, True)
    scoped = qat_mod._tf32_as
    try:
        with torch.no_grad():
            qat.apply(model, x)
        assert qat_mod._tf32() == (True, True) and tf32 == [(False, False)]
        hook.remove()
        fp_model = copy.deepcopy(model)
        prune_variables(model, qmodel, qparams)
        seen = {}

        def record(key):
            def hook(mod, args):
                seen.setdefault(key, args[0].detach().clone())
            return hook

        hooks = [model.get_submodule(k).register_forward_pre_hook(record(k)) for k in qat.sites]
        with torch.no_grad():
            model(x)
        for h in hooks:
            h.remove()
        errors = qat_mod.site_product_errors(qat, fp_model, model, seen)
        assert max(errors.values()) <= 1e-5, errors
        qat_mod._tf32_as = lambda conv, matmul: contextlib.nullcontext()
        unscoped = qat_mod.site_product_errors(qat, fp_model, model, seen)
        assert max(unscoped.values()) > 1e-5, unscoped
    finally:
        qat_mod._tf32_as = scoped
        qat_mod._set_tf32(*prior)
        hook.remove()


@pytest.mark.gpu
def test_qat_train_step_launches_k1_and_k1_bwd_a_bn_on_the_card(cuda):
    """A bf16 ResNet-18 QAT step with the distillation term at 64^2 on the
    card: K1 twice a BN (the fake-quant forward and the teacher's), K1-bwd
    once, none scalar; the loss finite; the teacher leaves the statistics
    as the same step without it does."""
    from distribuuuu_tpu_torch.config import reset_cfg
    from distribuuuu_tpu_torch.quant import calibrate_qat
    from distribuuuu_tpu_torch.trainer import TrainState, train_step

    reset_cfg()
    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                                    generator=gen).to(cuda),
             "label": torch.randint(0, 10, (8,), generator=gen).to(cuda)}
    calib = [torch.randn(8, 64, 64, 3, generator=gen).to(cuda)]
    stats = []
    for distill in (1.0, 0.0):
        model = build_model("resnet18", num_classes=10, dtype=torch.bfloat16,
                            bn_dtype=torch.bfloat16)
        layers.init_weights(model, torch.Generator().manual_seed(1))
        st = TrainState(model.to(cuda))
        qat = calibrate_qat(st.model, calib)
        before = (ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES, ep.BWD_SCALAR_LAUNCHES)
        m = train_step(st, batch, 0.01, qat=qat, distill=distill)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip((ep.LAUNCHES, ep.BWD_LAUNCHES, ep.SCALAR_LAUNCHES,
                                           ep.BWD_SCALAR_LAUNCHES), before))
        assert got == ((2 if distill else 1) * 20, 20, 0, 0)
        assert torch.isfinite(m["loss_sum"]).item()
        stats.append(st.stats.clone())
    assert torch.equal(*stats)
