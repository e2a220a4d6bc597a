"""Image transforms of the port (counterpart of ``data/transforms.py``).

The host side decodes with PIL and emits raw uint8 HWC crops:

- train: RandomResizedCrop(IM_SIZE) -> RandomHorizontalFlip
- eval:  Resize(TEST.IM_SIZE) (shorter side) -> CenterCrop(TEST.CROP_SIZE)

with torchvision's semantics (area scale in (0.08, 1), log-uniform aspect in
(3/4, 4/3), 10 tries then the center fallback; bilinear). A train crop is a
pure function of the image and ``random.Random(slot_seed)``: the draws come
in the JAX package's order, so both packages cut the same crops. The device
side, :func:`device_normalize`, is ``ToTensor`` + ``Normalize``.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_BILINEAR = Image.Resampling.BILINEAR


def random_resized_crop(img: Image.Image, size: int, scale=(0.08, 1.0),
                        ratio=(3.0 / 4.0, 4.0 / 3.0), rng: random.Random | None = None
                        ) -> Image.Image:
    """torchvision ``RandomResizedCrop``: per try, ``uniform`` for the area,
    ``uniform`` for the log aspect, then ``randint`` for the top and the
    left of a box that fits."""
    rng = rng or random
    width, height = img.size
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h)
            j = rng.randint(0, width - w)
            return img.resize((size, size), _BILINEAR, box=(j, i, j + w, i + h))
    # fallback: the whole image at the aspect clamped into ``ratio``, centered
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return img.resize((size, size), _BILINEAR, box=(j, i, j + w, i + h))


def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    """torchvision ``Resize(int)``: the shorter side to ``size``, the longer
    truncated (``int(size * long / short)``), as torchvision computes it."""
    width, height = img.size
    if width <= height:
        new_w, new_h = size, max(1, int(size * height / width))
    else:
        new_w, new_h = max(1, int(size * width / height)), size
    return img.resize((new_w, new_h), _BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    width, height = img.size
    left = (width - size) // 2
    top = (height - size) // 2
    return img.crop((left, top, left + size, top + size))


def _to_u8_array(img: Image.Image) -> np.ndarray:
    """HWC uint8; a grayscale image promoted to three channels."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def train_transform_u8(img: Image.Image, im_size: int, rng: random.Random | None = None
                       ) -> np.ndarray:
    """The crop, then a flip on ``rng.random() < 0.5``; raw uint8 out."""
    rng = rng or random
    img = random_resized_crop(img, im_size, rng=rng)
    if rng.random() < 0.5:
        img = img.transpose(Image.Transpose.FLIP_LEFT_RIGHT)
    return _to_u8_array(img)


def eval_transform_u8(img: Image.Image, resize_size: int, crop_size: int = 224) -> np.ndarray:
    return _to_u8_array(center_crop(resize_shorter(img, resize_size), crop_size))


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
