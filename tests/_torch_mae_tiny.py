"""A tiny MAE ViT registered in the port as ``mae_vit_tiny`` (patch 4, width
32, depth 2, 2 heads), for whole ``train_model`` runs on the CPU: ``MODEL.MODULE
_torch_mae_tiny MODEL.ARCH mae_vit_tiny``. Imports no JAX."""

from distribuuuu_tpu_torch.models.mae import MAEViT
from distribuuuu_tpu_torch.models.registry import register_model

TINY = dict(patch=4, dim=32, depth=2, num_heads=2, mlp_dim=64)


@register_model("mae_vit_tiny")
def mae_vit_tiny(*, im_size: int = 16, **kw):
    kw.pop("zero_init_residual", None)
    return MAEViT(im_size=im_size, **TINY, **kw)
