"""Device-side input normalization (counterpart of ``data/transforms.py``)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


_CONSTANTS: dict = {}


def _constants(device):
    """``(mean, std)`` on ``device``, made once: building them per call is a
    pageable host-to-device copy, which waits for the stream."""
    if device not in _CONSTANTS:
        _CONSTANTS[device] = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                                   for v in (IMAGENET_MEAN, IMAGENET_STD))
    return _CONSTANTS[device]


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """``ToTensor`` + ``Normalize`` for NHWC uint8 batches, in float32 on the
    tensor's device: ``(x / 255 - mean) / std``. Float input passes through
    (already normalized on the host)."""
    if images.dtype != torch.uint8:
        return images
    mean, std = _constants(images.device)
    x = images.to(torch.float32) / 255.0
    return (x - mean) / std
