"""Vision Transformer (counterpart of ``models/vit.py``), torchvision naming.

Patch embedding (a stride-``patch`` conv with bias), a class token and a
learned position table, pre-LN encoder blocks (packed-qkv attention, exact
erf-GELU MLP), the final LayerNorm, a linear head on the class token
(``pool='token'``) or the tokens' f32 mean (``'gap'``). Numerics as JAX's:

- the residual stream is in the compute dtype; the linears compute in it
  (input, weight and bias cast) and emit it;
- each LayerNorm reads f32 and writes f32 (eps 1e-6), the next linear
  casts back down; the final one's output is cast to the compute dtype;
- the attention is a plain composition, as JAX's outside any Pallas
  kernel: scores ``q kᵀ`` with f32 accumulation and an f32 result (bf16
  products are exact in f32, so q and k are widened and multiplied in f32),
  an f32 softmax of the scores times ``head_dim**-0.5``, the weights cast
  to v's dtype, then the product with v;
- the head is f32.

There is no BatchNorm, so no K1; ``bn_dtype`` is accepted for the factory
contract and ignored. Parameters keep JAX's ranks (``class_token`` [1, 1,
D], ``pos_embedding`` [1, L, D], the packed ``in_proj_weight`` [3D, D]), so
LAMB's weight-decay mask (``ndim > 1``) covers the same parameters. The
position table is sized by the crop at construction (``im_size``), so the
trainer refuses an eval crop other than the training one
(``crop_sized``). Under ``remat`` each encoder block is recomputed in the
backward.

Sequence parallelism (``MESH.SEQ`` > 1; the trainer switches it on after
the build with :func:`~distribuuuu_tpu_torch.parallel.seq.set_seq`, which
leaves the parameters as they are): embedding and positions run on the
whole stream, ``local_tokens`` keeps this member's block, the attention is
ring or Ulysses over the seq group, and the head, which needs ``pool='gap'``
(the class token has no home block), is JAX's bias-1/S head: ``logits_s =
W (sum of the member's tokens) / L + b / S``, summed over the group by
``psum_partial``, so every parameter's gradient stays member-partial.

Module names follow torchvision's ``vit_b_16`` (``conv_proj``,
``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_{i}.{ln_1, self_attention, ln_2, mlp}``,
``encoder.ln``, ``heads.head``): the keys
``distribuuuu_tpu.convert.export_state_dict(v, "vit_b16")`` emits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    RematUnit,
    set_remat,
    trunc_normal_,
    xavier_uniform_,
)
from distribuuuu_tpu_torch.models.registry import register_model
from distribuuuu_tpu_torch.parallel.seq import local_tokens, psum_partial, seq_attention

LN_EPS = 1e-6


def _linear(x, lin: nn.Linear, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class SelfAttention(nn.Module):
    """Packed-qkv multi-head self-attention (torchvision's
    ``nn.MultiheadAttention`` parameter names). With ``seq_group`` set the
    score and value contractions run as ``seq_impl`` attention over it."""

    seq_group, seq_impl = None, "ring"

    def __init__(self, dim: int, num_heads: int, *, dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.num_heads = num_heads
        self.compute_dtype = dtype

    def forward(self, x):
        b, l, d = x.shape
        dt, h = self.compute_dtype, self.num_heads
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = qkv.view(b, l, 3, h, d // h).permute(2, 0, 3, 1, 4)  # each [B, H, L, hd]
        if self.seq_group is not None:
            out = seq_attention(q, k, v, impl=self.seq_impl, group=self.seq_group)
        else:
            s = torch.matmul(q.float(), k.float().transpose(-1, -2))
            w = torch.softmax(s * (d // h) ** -0.5, dim=-1)
            out = torch.matmul(w.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, l, d)
        return _linear(out, self.out_proj, dt)


class MLP(nn.Module):
    """``linear_1`` -> exact GELU -> ``linear_2``, in the compute dtype."""

    def __init__(self, dim: int, mlp_dim: int, *, dtype):
        super().__init__()
        self.linear_1 = nn.Linear(dim, mlp_dim)
        self.linear_2 = nn.Linear(mlp_dim, dim)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return _linear(F.gelu(_linear(x, self.linear_1, dt)), self.linear_2, dt)


class EncoderBlock(RematUnit):
    """Pre-LN block: ``x + attn(LN(x))``, then ``x + mlp(LN(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *, dtype):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.self_attention = SelfAttention(dim, num_heads, dtype=dtype)
        self.ln_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLP(dim, mlp_dim, dtype=dtype)

    def forward(self, x):
        x = x + self.self_attention(self.ln_1(x.float())).to(x.dtype)
        return x + self.mlp(self.ln_2(x.float())).to(x.dtype)


class Encoder(nn.Module):
    """The position table, ``layers.encoder_layer_{i}`` and the final ``ln``."""

    def __init__(self, seq_len: int, dim: int, depth: int, num_heads: int, mlp_dim: int, *,
                 dtype):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(1, seq_len, dim))
        self.layers = nn.Module()
        for i in range(depth):
            self.layers.add_module(f"encoder_layer_{i}",
                                   EncoderBlock(dim, num_heads, mlp_dim, dtype=dtype))
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        for block in self.layers.children():
            x = block(x)
        return self.ln(x.float()).to(x.dtype)


class ViT(nn.Module):
    """ViT classifier: patch embedding -> encoder -> head."""

    crop_sized = True  # the position table is sized by the crop at construction
    seq_group, seq_impl = None, "ring"  # set_seq's

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, num_classes: int = 1000, pool: str = "token",
                 im_size: int = 224, dtype=torch.bfloat16, bn_dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        if pool not in ("token", "gap"):
            raise ValueError(f"pool must be 'token' or 'gap', got {pool!r}")
        self.patch, self.dim, self.pool, self.im_size = patch, dim, pool, int(im_size)
        self.depth, self.mlp_dim = depth, mlp_dim
        self.compute_dtype = dtype
        self.conv_proj = nn.Conv2d(3, dim, patch, patch)
        if pool == "token":
            self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        seq_len = (self.im_size // patch) ** 2 + (pool == "token")
        self.encoder = Encoder(seq_len, dim, depth, num_heads, mlp_dim, dtype=dtype)
        self.heads = nn.Module()
        self.heads.head = nn.Linear(dim, num_classes)
        set_remat(self, remat)

    def forward(self, x):
        """``x``: NHWC images (float); returns ``[N, num_classes]`` float32 logits."""
        b, h, w, _ = x.shape
        if (h, w) != (self.im_size, self.im_size):
            raise ValueError(f"{h}x{w} images into a ViT whose position table is sized for "
                             f"{self.im_size}x{self.im_size}: build the model for the crop it sees")
        group = self.seq_group
        if group is not None and self.pool != "gap":
            raise ValueError("sequence-parallel ViT requires pool='gap': the class token has no "
                             "home shard once tokens shard over the seq axis")
        dt = self.compute_dtype
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.conv_proj.weight.to(dt),
                     self.conv_proj.bias.to(dt), stride=self.patch)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)  # [B, L, D], row-major patches
        if self.pool == "token":
            x = torch.cat([self.class_token.to(dt).expand(b, 1, self.dim), x], dim=1)
        x = x + self.encoder.pos_embedding.to(dt)
        if group is not None:
            x = local_tokens(x, group)
        x = self.encoder(x)
        w, bias = self.heads.head.weight.float(), self.heads.head.bias.float()
        if group is not None:  # the bias-1/S head: every parameter's use stays partial
            p = dist.get_world_size(group)
            rep = x.float().sum(1) / (x.shape[1] * p)
            return psum_partial(F.linear(rep, w, bias) - (1.0 - 1.0 / p) * bias, group)
        rep = x[:, 0].float() if self.pool == "token" else x.mean(1, dtype=torch.float32)
        return F.linear(rep, w, bias)

    def init_params(self, generator: torch.Generator) -> None:
        """JAX's initialisers: ``trunc_normal_02`` for the patch embedding,
        the class token and the position table, ``xavier_uniform`` with zero
        biases for every encoder linear, LayerNorm at one and zero, and a
        zero head."""
        trunc_normal_(self.conv_proj.weight, 0.02, generator)
        self.conv_proj.bias.zero_()
        if self.pool == "token":
            trunc_normal_(self.class_token, 0.02, generator)
        trunc_normal_(self.encoder.pos_embedding, 0.02, generator)
        for m in self.encoder.modules():
            if isinstance(m, SelfAttention):
                xavier_uniform_(m.in_proj_weight, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Linear):
                xavier_uniform_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.heads.head.weight.zero_()
        self.heads.head.bias.zero_()


def _vit(patch, dim, depth, heads, mlp, **kw) -> ViT:
    return ViT(patch=patch, dim=dim, depth=depth, num_heads=heads, mlp_dim=mlp, **kw)


@register_model("vit_s16")
def vit_s16(*, im_size: int = 224, **kw):
    return _vit(16, 384, 12, 6, 1536, im_size=im_size, **kw)


@register_model("vit_b16")
def vit_b16(*, im_size: int = 224, **kw):
    return _vit(16, 768, 12, 12, 3072, im_size=im_size, **kw)


@register_model("vit_l16")
def vit_l16(*, im_size: int = 224, **kw):
    return _vit(16, 1024, 24, 16, 4096, im_size=im_size, **kw)
