"""Synthetic dataset of the port (the ``DummyDataset`` of ``data/dataset.py``).

The image datasets (``ImageFolder``, ``TarImageFolder``) and their decoder
are not yet ported (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import numpy as np


class DummyDataset:
    """Random uint8 pixels with label 0, drawn from numpy's
    ``default_rng(seed)`` in the JAX package's order, so the batches are
    bitwise its batches. Raw uint8 like a real loader's, so a DUMMY_INPUT
    run takes the same H2D copy and on-device normalisation."""

    def __init__(self, length: int = 1000, im_size: int = 224, seed: int = 0):
        self.len = length
        self.im_size = im_size
        self._rng = np.random.default_rng(seed)

    def sample_batch(self, batch_size: int) -> dict:
        return {
            "image": self._rng.integers(
                0, 256, (batch_size, self.im_size, self.im_size, 3), dtype=np.uint8
            ),
            "label": np.zeros((batch_size,), dtype=np.int32),
            "weight": np.ones((batch_size,), dtype=np.float32),
        }

    def __len__(self) -> int:
        return self.len
