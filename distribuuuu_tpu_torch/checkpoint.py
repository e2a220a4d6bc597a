"""Training checkpoints of the port (``checkpoint.py``), as ``torch.save`` files.

The JAX package's layout and naming: ``OUT_DIR/checkpoints/ckpt_ep_{E:03d}``
(E = epochs finished, the first is ``001``) and ``best``, each a directory
holding ``checkpoint.pt`` and a ``dtpu_manifest.json`` of sha256 hashes of
its files. A checkpoint is written into a temporary directory and renamed
into place, so a directory under the exact name is complete. It holds the
model's state_dict, the optimizer's state (its step counter included), the
epoch and ``best_acc1``. Only rank 0 writes.

Mid-epoch emergency checkpoints, elastic restore onto another world size
and quarantine of a corrupt directory are not yet ported (ROADMAP Queue 1
item 2); a corrupt or unverifiable checkpoint is skipped on resume.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from pathlib import Path

import torch

from distribuuuu_tpu_torch.logging import logger

_NAME_PREFIX = "ckpt_ep_"
_DIR_NAME = "checkpoints"
_BEST_NAME = "best"
_FILE_NAME = "checkpoint.pt"
_MANIFEST_NAME = "dtpu_manifest.json"
_CKPT_RE = re.compile(rf"^{_NAME_PREFIX}(\d+)$")


def get_checkpoint_dir(out_dir: str) -> str:
    return os.path.join(out_dir, _DIR_NAME)


def get_checkpoint_path(out_dir: str, epoch: int) -> str:
    """Directory of the checkpoint taken after ``epoch`` epochs (1-based)."""
    return os.path.join(get_checkpoint_dir(out_dir), f"{_NAME_PREFIX}{epoch:03d}")


def get_best_path(out_dir: str) -> str:
    return os.path.join(get_checkpoint_dir(out_dir), _BEST_NAME)


def manifest_path(ckpt_path: str) -> str:
    return os.path.join(ckpt_path, _MANIFEST_NAME)


def _hash_file(path: str) -> tuple[int, str]:
    h, n = hashlib.sha256(), 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
            n += len(chunk)
    return n, h.hexdigest()


def write_manifest(ckpt_path: str) -> dict:
    """Hash every file of a checkpoint directory into ``dtpu_manifest.json``."""
    files = {}
    for root, _, names in os.walk(ckpt_path):
        for name in sorted(names):
            rel = os.path.relpath(os.path.join(root, name), ckpt_path)
            if rel != _MANIFEST_NAME:
                n, digest = _hash_file(os.path.join(ckpt_path, rel))
                files[rel] = {"bytes": n, "sha256": digest}
    manifest = {"version": 1, "algo": "sha256", "files": files}
    Path(manifest_path(ckpt_path)).write_text(json.dumps(manifest, sort_keys=True))
    return manifest


def verify_checkpoint(ckpt_path: str) -> tuple[str, list[str]]:
    """Re-hash a checkpoint directory against its manifest: ``("ok", [])``,
    ``("unverified", [])`` without a manifest, or ``("corrupt", errors)``
    when the manifest is unreadable or a file is missing, resized or
    changed. Files beyond the manifest are tolerated."""
    mpath = manifest_path(ckpt_path)
    if not os.path.exists(mpath):
        return "unverified", []
    try:
        entries = json.loads(Path(mpath).read_text())["files"]
    except (OSError, ValueError, KeyError) as exc:
        return "corrupt", [f"unreadable manifest: {exc!r}"]
    errors = []
    for rel, want in sorted(entries.items()):
        fpath = os.path.join(ckpt_path, rel)
        if not os.path.exists(fpath):
            errors.append(f"{rel}: missing")
            continue
        n, digest = _hash_file(fpath)
        if n != want.get("bytes"):
            errors.append(f"{rel}: size {n} != manifest {want.get('bytes')}")
        elif digest != want.get("sha256"):
            errors.append(f"{rel}: sha256 mismatch")
    return ("corrupt", errors) if errors else ("ok", [])


def _write(path: str, payload: dict) -> None:
    """``payload`` into ``path/checkpoint.pt`` with its manifest, through a
    temporary directory renamed into place."""
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE_NAME))
    write_manifest(tmp)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(out_dir: str, epoch: int, state, best_acc1: float, is_best: bool) -> str:
    """Write the checkpoint after 0-based ``epoch`` (named ``epoch + 1``)
    and refresh ``best`` on an improvement. Returns its path."""
    payload = {
        "epoch": int(epoch),
        "model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
        "optimizer": {k: v.detach().cpu().clone()
                      for k, v in state.optimizer.state_dict().items()},
        "best_acc1": float(best_acc1),
    }
    os.makedirs(get_checkpoint_dir(out_dir), exist_ok=True)
    path = get_checkpoint_path(out_dir, epoch + 1)
    _write(path, payload)
    if is_best:
        _write(get_best_path(out_dir), payload)
    return path


def _checkpoint_file(path: str) -> str:
    return os.path.join(path, _FILE_NAME) if os.path.isdir(path) else path


def load_checkpoint(path: str, state, load_opt: bool = True) -> tuple[int, float]:
    """Restore ``state`` from a checkpoint directory (or its ``.pt``) in
    place; returns ``(start_epoch, best_acc1)``. ``load_opt`` False keeps
    the optimizer as it is (a warm start)."""
    payload = torch.load(_checkpoint_file(path), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    if load_opt and "optimizer" in payload:
        state.optimizer.load_state_dict(payload["optimizer"])
    return int(payload.get("epoch", -1)) + 1, float(payload.get("best_acc1", 0.0))


def checkpoints(out_dir: str) -> list[tuple[int, str]]:
    """Complete epoch checkpoints of ``out_dir``, newest first."""
    d = get_checkpoint_dir(out_dir)
    if not os.path.isdir(d):
        return []
    found = [(int(m.group(1)), os.path.join(d, name))
             for name in os.listdir(d) if (m := _CKPT_RE.match(name))]
    return sorted(found, reverse=True)


def restore_latest(out_dir: str, state, *, verify_integrity: bool = True,
                   skip_corrupt: bool = True):
    """Resume from the newest complete checkpoint: ``(start_epoch,
    best_acc1, path)``, or None when there is none. A candidate whose
    manifest does not verify is skipped (or raises without
    ``skip_corrupt``)."""
    for _, path in checkpoints(out_dir):
        if verify_integrity:
            status, errors = verify_checkpoint(path)
            if status == "corrupt":
                msg = f"checkpoint {path} failed integrity verification: {errors[:3]}"
                if not skip_corrupt:
                    raise RuntimeError(msg)
                logger.warning(msg + "; skipping it")
                continue
        start_epoch, best_acc1 = load_checkpoint(path, state)
        return start_epoch, best_acc1, path
    return None
