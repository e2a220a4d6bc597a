"""Model zoo of the port. Importing it registers the ResNet family and BoTNet-50."""

from distribuuuu_tpu_torch.models import botnet, resnet  # noqa: F401  (registers the factories)
from distribuuuu_tpu_torch.models.registry import build_model, list_models, register_model

__all__ = ["build_model", "list_models", "register_model"]
