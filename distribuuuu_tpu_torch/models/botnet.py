"""BoTNet-50 (counterpart of ``models/botnet.py``): ResNet-50's trunk with
stage 4 replaced by a stack of 3 multi-head self-attention bottlenecks.

Serving numerics, as the JAX model runs them: ``to_qk``/``to_v`` are 1x1
convs in the model's dtype; q is scaled by ``dim_qk**-0.5`` in that dtype
(the scale rounded to it first, as jnp does with a weak-typed scalar)
before the position bias is formed from it; the relative-position bias is
built in that dtype; the attention itself is
:func:`~distribuuuu_tpu_torch.ops.attention.fused_attention` (or
``fused_attention_abs`` with the absolute table), which launches the CUDA
kernel on the card. Every BN runs through K1 (53 per forward): the trunk's
as in ResNet-50 (43), and in each BoTBlock ``bn_in`` + ReLU and ``bn_mid``
+ ReLU (writing their convs' input in the compute dtype), the shortcut's
BN + ReLU, and ``bn_out`` fused with ``relu(net + shortcut)`` (10). That is
the JAX block's function term for term: f32 BN outputs, an f32 add, ReLU.

Module names give the reference's ``nn.Sequential`` numbering, exactly the
keys ``distribuuuu_tpu.convert.export_state_dict(v, "botnet50")`` emits:
``0`` conv1, ``1`` bn1, ``4``-``6`` layer1-3, ``7.net.{i}`` the BoTBlocks
(``shortcut.{0,1}``, ``net.{0,1,3,5,7,8}``, ``net.3.{to_qk,to_v,pos_emb}``),
``10`` fc. The slots without state (ReLU, max-pool, avg-pool, flatten) are
left out of the top level. Position tables are sized at construction, so
the factory takes the crop: the feature map is ``ceil(crop / 16)`` (14x14 at
224); the JAX model reads it off the traced input instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    BatchNorm,
    RematUnit,
    bn_epilogue,
    boundary,
    classifier_head,
    conv,
    link_handoffs,
    max_pool,
    set_remat,
)
from distribuuuu_tpu_torch.models.registry import register_model
from distribuuuu_tpu_torch.models.resnet import Bottleneck, resnet_stages
from distribuuuu_tpu_torch.ops.attention import fused_attention, fused_attention_abs


def rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """``[B, N, L, 2L-1]`` relative logits -> ``[B, N, L, L]`` absolute logits."""
    b, n, l, _ = x.shape
    x = F.pad(x, (0, 1))  # col pad -> 2L
    x = x.reshape(b, n, l * 2 * l)
    x = F.pad(x, (0, l - 1))
    x = x.reshape(b, n, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def relative_logits_1d(q: torch.Tensor, rel_k: torch.Tensor) -> torch.Tensor:
    """q ``[B, N, H, W, d]``, rel_k ``[2W-1, d]`` -> ``[B, N, qh, qw, kh, kw]``
    (an expanded view: the same relative-width logit for every key row)."""
    b, n, h, w, _ = q.shape
    logits = torch.einsum("bnhwd,md->bnhwm", q, rel_k)
    logits = rel_to_abs(logits.reshape(b, n * h, w, 2 * w - 1))
    logits = logits.reshape(b, n, h, w, w)
    logits = logits[:, :, :, None, :, :].expand(b, n, h, h, w, w)
    return logits.permute(0, 1, 2, 4, 3, 5)


class _PosTables(nn.Module):
    """Position tables drawn as the JAX params are, ``N(0, dim_head^-0.5)``:
    at construction from the global RNG, and by :meth:`init_tables` (which
    ``layers.init_weights`` calls in module order) from a generator."""

    TABLES: tuple[str, ...] = ()

    def init_tables(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name in self.TABLES:
                t = getattr(self, name)
                t.normal_(0.0, t.shape[1] ** -0.5, generator=generator)


class RelPosEmb(_PosTables):
    """2-D factorized relative position logits: the ``[B, N, L, L]`` bias."""

    TABLES = ("rel_height", "rel_width")

    def __init__(self, height: int, width: int, dim_head: int):
        super().__init__()
        self.fmap = (height, width)
        scale = dim_head**-0.5
        self.rel_height = nn.Parameter(torch.randn(2 * height - 1, dim_head) * scale)
        self.rel_width = nn.Parameter(torch.randn(2 * width - 1, dim_head) * scale)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        b, n, _, d = q.shape
        h, w = self.fmap
        q2 = q.reshape(b, n, h, w, d)
        logits_w = relative_logits_1d(q2, self.rel_width.to(q.dtype))
        # the height pass runs on transposed axes, then swaps back
        logits_h = relative_logits_1d(q2.transpose(2, 3), self.rel_height.to(q.dtype))
        logits_h = logits_h.permute(0, 1, 3, 2, 5, 4)
        return (logits_w + logits_h).reshape(b, n, h * w, h * w)


class AbsPosEmb(_PosTables):
    """Absolute position embedding: the shared ``[L, d]`` table, in q's
    dtype, that the kernel turns into the bias ``q·embᵀ`` itself."""

    TABLES = ("height", "width")

    def __init__(self, height: int, width: int, dim_head: int):
        super().__init__()
        scale = dim_head**-0.5
        self.height = nn.Parameter(torch.randn(height, dim_head) * scale)
        self.width = nn.Parameter(torch.randn(width, dim_head) * scale)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        emb = self.height[:, None, :] + self.width[None, :, :]
        return emb.reshape(-1, self.height.shape[1]).to(q.dtype)


class MHSA(nn.Module):
    """Multi-head self-attention over a 2-D feature map.

    Takes and returns NCHW-logical, channels-last tensors; the head split
    is ``heads_first`` of the JAX module on the NHWC view of the channels.
    """

    def __init__(self, dim: int, fmap_size: tuple[int, int], heads: int = 4, dim_qk: int = 128,
                 dim_v: int = 128, rel_pos_emb: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.fmap_size = tuple(fmap_size)
        self.heads, self.dim_qk, self.dim_v = heads, dim_qk, dim_v
        self.rel_pos_emb = rel_pos_emb
        self.to_qk = conv(dim, 2 * heads * dim_qk, 1, dtype=dtype)
        self.to_v = conv(dim, heads * dim_v, 1, dtype=dtype)
        self.pos_emb = (RelPosEmb if rel_pos_emb else AbsPosEmb)(*self.fmap_size, dim_qk)
        # the q scale as a value of the compute dtype (jnp rounds a weak-typed scalar so);
        # on the CPU, so the model can also be built on the meta device
        self.scale = torch.tensor(dim_qk**-0.5, dtype=dtype, device="cpu").item()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        if (h, w) != self.fmap_size:
            fh, fw = self.fmap_size
            raise ValueError(
                f"MHSA position tables are sized for a {fh}x{fw} feature map "
                f"(botnet50 built with im_size={16 * fh}); got {h}x{w} "
                f"(botnet50 needs im_size={16 * h}): build the model for the crop it serves"
            )
        heads, dqk, dv = self.heads, self.dim_qk, self.dim_v
        qk = self.to_qk(x).permute(0, 2, 3, 1).reshape(b, h * w, 2 * heads, dqk)
        q = qk[:, :, :heads].transpose(1, 2) * self.scale
        k = qk[:, :, heads:].transpose(1, 2)
        v = self.to_v(x).permute(0, 2, 3, 1).reshape(b, h * w, heads, dv).transpose(1, 2)
        attend = fused_attention if self.rel_pos_emb else fused_attention_abs
        out = attend(q, k, v, self.pos_emb(q))  # [B, N, L, Dv]
        return out.transpose(1, 2).reshape(b, h, w, heads * dv).permute(0, 3, 1, 2)


class BoTBlock(RematUnit):
    """MHSA bottleneck: ``net`` is the reference's Sequential (0 conv_in,
    1 bn_in, 2 ReLU, 3 MHSA, 4 avg-pool or identity, 5 bn_mid, 6 ReLU,
    7 conv_out, 8 bn_out with zero-γ at init); ``shortcut`` is conv -> BN ->
    ReLU on a shape change, else the identity. Output ``relu(net + shortcut)``.
    The ReLU and pooling slots are kept for the numbering; ``forward`` runs
    each BN with its ReLU (and the residual add) as one K1 pass."""

    def __init__(self, dim: int, fmap_size, dim_out: int, stride: int = 1, heads: int = 4,
                 proj_factor: int = 4, dim_qk: int = 128, dim_v: int = 128,
                 rel_pos_emb: bool = False, *, dtype=torch.bfloat16, bn_dtype=torch.float32):
        super().__init__()
        self.shortcut = (
            nn.Sequential(conv(dim, dim_out, 1, stride, dtype=dtype),
                          BatchNorm(dim_out, bn_dtype=bn_dtype), nn.ReLU())
            if dim != dim_out or stride != 1 else nn.Identity()
        )
        bottleneck = dim_out // proj_factor
        self.net = nn.Sequential(
            conv(dim, bottleneck, 1, dtype=dtype),
            BatchNorm(bottleneck, bn_dtype=bn_dtype),
            nn.ReLU(),
            MHSA(bottleneck, fmap_size, heads, dim_qk, dim_v, rel_pos_emb, dtype=dtype),
            nn.AvgPool2d(2, 2) if stride == 2 else nn.Identity(),
            BatchNorm(heads * dim_v, bn_dtype=bn_dtype),
            nn.ReLU(),
            conv(heads * dim_v, dim_out, 1, dtype=dtype),
            BatchNorm(dim_out, bn_dtype=bn_dtype, zero_scale=True),
        )
        self.compute_dtype = dtype
        self.handoff: dict = {}  # the K1 mode of bn_out (link_handoffs)

    @property
    def projects(self) -> bool:
        return not isinstance(self.shortcut, nn.Identity)

    def forward(self, x):
        net = self.net
        to_conv = dict(cast_to=self.compute_dtype, keep_boundary=False)
        h = bn_epilogue(net[0](x), net[1], **to_conv)  # read by MHSA's to_qk and to_v
        h = bn_epilogue(net[4](net[3](h)), net[5], **to_conv)  # read by conv_out
        shortcut = (bn_epilogue(self.shortcut[0](x), self.shortcut[1]) if self.projects
                    else boundary(x))
        return bn_epilogue(net[7](h), net[8], shortcut, **self.handoff)


class BoTStack(nn.Module):
    """The reference's slot 7: ``net`` holds the BoTBlocks."""

    def __init__(self, blocks):
        super().__init__()
        self.net = nn.Sequential(*blocks)

    def forward(self, x):
        return self.net(x)


class BoTNet50(nn.Module):
    """ResNet-50 stem and stages 1-3, a 3-block BoTStack (2048 wide, heads
    4, dim_qk = dim_v = 128, relative position bias, stride 1), the head.
    ``stem_s2d`` is accepted and changes nothing, as in :class:`ResNet`.
    ``remat``: each Bottleneck and BoTBlock is recomputed in the backward."""

    crop_sized = True  # the position tables are sized by the crop at construction

    def __init__(self, num_classes=1000, fmap_size=(14, 14), dtype=torch.bfloat16,
                 bn_dtype=torch.float32, stem_s2d=False, remat=False):
        super().__init__()
        self.add_module("0", conv(3, 64, 7, 2, padding=3, dtype=dtype))
        self.add_module("1", BatchNorm(64, bn_dtype=bn_dtype))
        stages, width = resnet_stages(Bottleneck, [3, 4, 6], dtype=dtype, bn_dtype=bn_dtype)
        for i, layer in enumerate(stages):
            self.add_module(str(4 + i), layer)
        self.add_module("7", BoTStack([
            BoTBlock(width if i == 0 else 2048, fmap_size, 2048, rel_pos_emb=True,
                     dtype=dtype, bn_dtype=bn_dtype)
            for i in range(3)
        ]))
        self.add_module("10", nn.Linear(2048, num_classes))
        blocks = [b for layer in (*stages, self._modules["7"].net) for b in layer]
        self.stem_handoff = link_handoffs(blocks, dtype)
        set_remat(self, remat)

    def forward(self, x):
        """``x``: NHWC images (float); returns ``[N, num_classes]`` float32 logits."""
        m = self._modules
        x = x.permute(0, 3, 1, 2)  # a view: NCHW-logical, channels-last in memory
        x = max_pool(bn_epilogue(m["0"](x), m["1"], **self.stem_handoff))
        for slot in ("4", "5", "6", "7"):
            x = m[slot](x)
        return classifier_head(x, m["10"])


@register_model("botnet50")
def botnet50(*, im_size: int = 224, **kw):
    side = -(-int(im_size) // 16)  # four stride-2 steps, each ceil(n / 2)
    return BoTNet50(fmap_size=(side, side), **kw)
