"""Model zoo of the port. Importing it registers the ResNet family, BoTNet-50,
DenseNet, RegNetX/Y, EfficientNet-B0/B1 and ViT (the JAX zoo but MAE)."""

from distribuuuu_tpu_torch.models import (  # noqa: F401  (registers the factories)
    botnet,
    densenet,
    efficientnet,
    regnet,
    resnet,
    vit,
)
from distribuuuu_tpu_torch.models.registry import build_model, list_models, register_model

__all__ = ["build_model", "list_models", "register_model"]
