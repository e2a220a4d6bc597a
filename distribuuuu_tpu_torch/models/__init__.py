"""Model zoo of the port. Importing it registers the ResNet family, BoTNet-50,
DenseNet, RegNetX/Y, EfficientNet-B0/B1, ViT and the MAE ViTs: the JAX zoo."""

from distribuuuu_tpu_torch.models import (  # noqa: F401  (registers the factories)
    botnet,
    densenet,
    efficientnet,
    mae,
    regnet,
    resnet,
    vit,
)
from distribuuuu_tpu_torch.models.registry import build_model, list_models, register_model

__all__ = ["build_model", "list_models", "register_model"]
