"""A real-image dataset without a download (counterpart of ``data/provision.py``).

:func:`digits_imagefolder` writes the 1,797 handwritten-digit scans of the
UCI ML "Optical Recognition of Handwritten Digits" test set (E. Alpaydin,
C. Kaynak, 1998; 8x8 pixels in 0..16, 10 classes) as a JPEG ImageFolder.
The scans are read from ``digits.csv.gz`` beside this file: a byte-for-byte
copy of the ``sklearn/datasets/data/digits.csv.gz`` that scikit-learn
1.9.0 ships (BSD-3-Clause; the UCI data is CC BY 4.0), one row a scan, 64
pixels then the label. It is read with numpy, so the port needs no
scikit-learn; ``tests/test_torch_data.py`` holds it equal to
``sklearn.datasets.load_digits()``.

The files are the JAX package's files bit for bit: the same split (the last
``val_per_class`` scans of each class to ``val``), the same upscale and the
same JPEG encoder settings.
"""

from __future__ import annotations

import contextlib
import fcntl
import gzip
import os
import shutil
from pathlib import Path

import numpy as np
from PIL import Image

DIGITS_CSV = Path(__file__).resolve().parent / "digits.csv.gz"


def load_digits() -> tuple[np.ndarray, np.ndarray]:
    """``(images, labels)``: float64 ``(1797, 8, 8)`` in 0..16 and int64
    ``(1797,)``, as ``sklearn.datasets.load_digits()`` returns them."""
    with gzip.open(DIGITS_CSV, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(np.int64)


@contextlib.contextmanager
def _provision_lock(root: str):
    """An exclusive ``flock`` beside ``root``: two processes provisioning
    the same root would interleave their writes."""
    os.makedirs(os.path.dirname(root.rstrip("/")) or ".", exist_ok=True)
    with open(root.rstrip("/") + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def digits_imagefolder(root: str, im_size: int = 64, val_per_class: int = 30,
                       train_per_class: int | None = None) -> str:
    """Write the digits as ``root/{train,val}/digit_<c>/<i>.jpg``, upscaled
    bilinearly to ``im_size``; ``train_per_class`` keeps the first N train
    scans of a class (val is never cut). Idempotent: a ``.complete`` stamp
    with the parameters is written last, and a tree without the matching
    stamp is rebuilt. Returns ``root``."""
    stamp = (f"v1 im_size={im_size} val_per_class={val_per_class}"
             f" train_per_class={train_per_class}\n")
    marker = os.path.join(root, ".complete")

    def complete() -> bool:
        return os.path.exists(marker) and Path(marker).read_text() == stamp

    if complete():
        return root
    with _provision_lock(root):
        if complete():  # another process provisioned it while this one waited
            return root
        if os.path.exists(root):  # partial, or made with other parameters
            shutil.rmtree(root)
        images, labels = load_digits()
        for c in range(10):
            imgs = images[labels == c]
            n_val = min(val_per_class, len(imgs) // 5)
            for i, img in enumerate(imgs):
                split = "val" if i >= len(imgs) - n_val else "train"
                if split == "train" and train_per_class is not None and i >= train_per_class:
                    continue
                d = os.path.join(root, split, f"digit_{c}")
                os.makedirs(d, exist_ok=True)
                u8 = np.round(img / 16.0 * 255.0).astype(np.uint8)
                pil = Image.fromarray(u8).convert("RGB")  # 2-D uint8: mode "L"
                pil = pil.resize((im_size, im_size), Image.Resampling.BILINEAR)
                pil.save(os.path.join(d, f"{i:04d}.jpg"), quality=95)
        Path(marker).write_text(stamp)
    return root
