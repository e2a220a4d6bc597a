"""Masked-autoencoder ViT (counterpart of ``models/mae.py``): ``TRAIN.TASK mae``.

SimMIM-style masked image modelling, as the JAX package formulates it: the
patch embedding (a stride-``patch`` conv with bias), masked tokens replaced
by a learned mask token, the position table added, the pre-LN encoder
blocks of :mod:`~distribuuuu_tpu_torch.models.vit` and its final
LayerNorm, then a per-token pixel decoder (``dec_fc`` -> exact GELU ->
``dec_pred``). The encoder runs the full token count (784 at 448^2, patch
16); the loss lives in the trainer (``trainer.mae_loss``): the mean squared
error of the masked patches against :func:`patchify` of the normalised
images.

Numerics as JAX's: the embedding, the substitution ``x * (1 - m) +
mask_token * m`` (arithmetic, not a select) and the position add in the
compute dtype; the blocks as ViT's; ``ln_f`` reads and writes f32, its
output cast to the compute dtype; ``dec_fc`` and the GELU in the compute
dtype; ``dec_pred`` in f32. There is no BatchNorm, so no K1, and the
attention is ViT's plain composition (no Pallas kernel in JAX either).

Module names are JAX's, with the blocks as ``blocks.{i}`` in the port's
ViT block naming (``ln_1``, ``self_attention.in_proj_weight``, ...):
``convert.from_jax_variables`` maps a JAX tree onto them. ``pos_embed`` is
sized by the crop at construction (``crop_sized``). ``remat`` recomputes
each encoder block in the backward.

Sequence parallelism (``MESH.SEQ`` > 1, switched on by the trainer with
:func:`~distribuuuu_tpu_torch.parallel.seq.set_seq`): the mask token and
the positions are applied on the whole stream, then ``local_tokens`` keeps
this member's block; the blocks attend over the seq group, and the pixel
decoder, per token, runs on the member's tokens alone, so the predictions
are ``[B, L / S, patch^2 * 3]`` (``trainer.mae_loss`` slices its target and
mask to match).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import set_remat, trunc_normal_, xavier_uniform_
from distribuuuu_tpu_torch.models.registry import register_model
from distribuuuu_tpu_torch.models.vit import LN_EPS, EncoderBlock, SelfAttention, _linear
from distribuuuu_tpu_torch.parallel.seq import local_tokens


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, L, patch^2 * C]`` in the patch conv's token
    order (row-major over the ``(H/p, W/p)`` grid): the reconstruction
    target."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


class MAEViT(nn.Module):
    """Patch embed -> mask-token substitution -> ViT encoder -> pixel decoder.

    ``forward(x, mask=None)``: ``x`` NHWC images (float), ``mask`` a ``[B,
    L]`` bool (True: masked) or None (unmasked). Returns per-token pixel
    predictions ``[B, L, patch^2 * 3]`` in float32 (``L / S`` tokens, this
    member's, under sequence parallelism). ``num_classes`` and
    ``bn_dtype`` are accepted for the factory contract and ignored."""

    crop_sized = True  # the position table is sized by the crop at construction
    seq_group, seq_impl = None, "ring"  # set_seq's

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, decoder_dim: int = 512, num_classes: int = 0,
                 im_size: int = 224, dtype=torch.bfloat16, bn_dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.patch, self.dim, self.im_size = patch, dim, int(im_size)
        self.depth, self.mlp_dim = depth, mlp_dim
        self.compute_dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch, patch)
        # created unconditionally, as JAX's: masked and unmasked calls share
        # one parameter inventory
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (self.im_size // patch) ** 2, dim))
        self.blocks = nn.ModuleList(EncoderBlock(dim, num_heads, mlp_dim, dtype=dtype)
                                    for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=LN_EPS)
        self.dec_fc = nn.Linear(dim, decoder_dim)
        self.dec_pred = nn.Linear(decoder_dim, patch * patch * 3)
        set_remat(self, remat)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        if (h, w) != (self.im_size, self.im_size):
            raise ValueError(f"{h}x{w} images into an MAE ViT whose position table is sized for "
                             f"{self.im_size}x{self.im_size}: build the model for the crop it sees")
        dt = self.compute_dtype
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)  # [B, L, D], row-major patches
        if mask is not None:
            m = mask.to(x.dtype)[..., None]
            x = x * (1.0 - m) + self.mask_token.to(x.dtype) * m
        x = x + self.pos_embed.to(x.dtype)
        if self.seq_group is not None:
            x = local_tokens(x, self.seq_group)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x.float()).to(x.dtype)
        h = F.gelu(_linear(x, self.dec_fc, dt))
        return F.linear(h.float(), self.dec_pred.weight.float(), self.dec_pred.bias.float())

    def init_params(self, generator: torch.Generator) -> None:
        """JAX's initialisers: ``trunc_normal_02`` for the patch embedding,
        the mask token and the position table, ``xavier_uniform`` with zero
        biases for every linear (the encoder's and the decoder's), LayerNorm
        at one and zero."""
        trunc_normal_(self.patch_embed.weight, 0.02, generator)
        self.patch_embed.bias.zero_()
        trunc_normal_(self.mask_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        for m in self.modules():
            if isinstance(m, SelfAttention):
                xavier_uniform_(m.in_proj_weight, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Linear):
                xavier_uniform_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def _mae(patch, dim, depth, heads, mlp, *, im_size: int = 224, **kw) -> MAEViT:
    kw.pop("zero_init_residual", None)  # the ResNet family's option; meaningless here
    return MAEViT(patch=patch, dim=dim, depth=depth, num_heads=heads, mlp_dim=mlp,
                  im_size=im_size, **kw)


@register_model("mae_vit_s16")
def mae_vit_s16(*, im_size: int = 224, **kw):
    return _mae(16, 384, 12, 6, 1536, im_size=im_size, **kw)


@register_model("mae_vit_b16")
def mae_vit_b16(*, im_size: int = 224, **kw):
    return _mae(16, 768, 12, 12, 3072, im_size=im_size, **kw)


@register_model("mae_vit_l16")
def mae_vit_l16(*, im_size: int = 224, **kw):
    return _mae(16, 1024, 24, 16, 4096, im_size=im_size, **kw)
