"""A narrow ViT registered in the port as ``vit_tiny`` (patch 8, width 32,
depth 2, 2 heads, MLP 64), for multi-process fsdp runs on the CPU through
``MODEL.MODULE _torch_vit_tiny MODEL.ARCH vit_tiny``. Imports no JAX; the
JAX package's ``ViT`` takes the same fields (``TINY``)."""

from distribuuuu_tpu_torch.models.registry import register_model
from distribuuuu_tpu_torch.models.vit import ViT

TINY = dict(patch=8, dim=32, depth=2, num_heads=2, mlp_dim=64)


@register_model("vit_tiny")
def vit_tiny(*, im_size: int = 32, **kw):
    kw.pop("zero_init_residual", None)
    return ViT(im_size=im_size, **TINY, **kw)
