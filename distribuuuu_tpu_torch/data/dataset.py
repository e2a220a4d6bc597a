"""Datasets of the port (counterpart of ``data/dataset.py``).

- :class:`ImageFolder`: ``root/<class>/**/<image>``, classes sorted into
  contiguous ids, files sorted within each class (torchvision's order);
- :class:`TarImageFolder`: the same tree packed into ``root/*.tar`` shards,
  members indexed once from the tar headers and read by positional
  ``os.pread`` (thread-safe, no open per image), decoded from memory;
- :func:`open_image_dataset`: the tar form when ``root`` holds shards;
- :class:`DummyDataset`: random uint8 pixels with label 0 (DUMMY_INPUT).
"""

from __future__ import annotations

import os
import tarfile
from collections import Counter

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


class ImageFolder:
    """``samples``: ``(path, class_id)`` under ``root/<class_name>/``."""

    def __init__(self, root: str):
        if not os.path.isdir(root):
            raise FileNotFoundError(f"Dataset directory not found: {root}")
        self.root = root
        self.classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"No class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for cls in self.classes:
            for dirpath, _, filenames in sorted(os.walk(os.path.join(root, cls))):
                self.samples += [(os.path.join(dirpath, f), self.class_to_idx[cls])
                                 for f in sorted(filenames) if f.lower().endswith(IMG_EXTENSIONS)]
        if not self.samples:
            raise FileNotFoundError(f"No images found under {root}")

    def __len__(self) -> int:
        return len(self.samples)


class TarImageFolder:
    """ImageFolder semantics over ``root/*.tar``: members named
    ``<class_name>/<file>`` (leading ``./`` dropped). The classes come from
    a ``classes.txt`` beside the shards when there is one (one name a line:
    the source tree's class list, so the ids equal ImageFolder's even where
    a class has no member), else the sorted member directories.
    ``samples`` holds ``(member_name, class_id)``; :meth:`read_bytes` the
    member's bytes."""

    def __init__(self, root: str):
        self.root = root
        self.shards = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".tar"))
        if not self.shards:
            raise FileNotFoundError(f"No .tar shards under {root}")
        names: list[str] = []
        locs: list[tuple[int, int, int]] = []  # (shard, offset, size)
        found: set[str] = set()
        for si, shard in enumerate(self.shards):
            with tarfile.open(shard, "r:") as tf:  # headers only
                for m in tf:
                    name = m.name
                    while name.startswith("./"):
                        name = name[2:]
                    if m.isfile() and "/" in name and name.lower().endswith(IMG_EXTENSIONS):
                        found.add(name.split("/", 1)[0])
                        names.append(name)
                        locs.append((si, m.offset_data, m.size))
        if not names:
            raise FileNotFoundError(f"No class-dir image members in the shards under {root}")
        manifest = os.path.join(root, "classes.txt")
        if os.path.isfile(manifest):
            with open(manifest) as f:
                self.classes = [ln.strip() for ln in f if ln.strip()]
            dupes = sorted(c for c, n in Counter(self.classes).items() if n > 1)
            if dupes:  # a repeated line would shift every later class id
                raise ValueError(f"{manifest} has duplicate class lines: {dupes[:5]}")
            missing = sorted(found - set(self.classes))
            if missing:
                raise ValueError(f"{manifest} is missing classes found in the shards: "
                                 f"{missing[:5]}")
        else:
            self.classes = sorted(found)
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = [(n, self.class_to_idx[n.split("/", 1)[0]]) for n in names]
        self._locs = locs
        self._fds = [os.open(s, os.O_RDONLY) for s in self.shards]

    def read_bytes(self, idx: int) -> tuple[bytes, str]:
        """``(bytes, member_name)`` of sample ``idx``; a short read (a network
        filesystem may return one) is continued until the member is whole."""
        si, off, size = self._locs[idx]
        chunks, got = [], 0
        while got < size:
            chunk = os.pread(self._fds[si], size - got, off + got)
            if not chunk:
                raise OSError(f"short read in {self.shards[si]} at {off + got} "
                              f"({got}/{size} bytes of {self.samples[idx][0]})")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks), self.samples[idx][0]

    def __len__(self) -> int:
        return len(self.samples)

    def __del__(self, _close=os.close):
        # ``_close`` bound at definition: at interpreter exit ``os`` may be gone
        for fd in getattr(self, "_fds", []):
            try:
                _close(fd)
            except OSError:
                pass


def open_image_dataset(root: str):
    """:class:`TarImageFolder` when ``root`` holds ``.tar`` shards, else
    :class:`ImageFolder`."""
    if os.path.isdir(root) and any(f.endswith(".tar") for f in os.listdir(root)):
        return TarImageFolder(root)
    return ImageFolder(root)


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
