"""Training checkpoints of the port (``checkpoint.py``), as ``torch.save`` files.

The JAX package's layout and naming under ``OUT_DIR/checkpoints/``:

- ``ckpt_ep_{E:03d}`` after E finished epochs (the first is ``001``) and
  ``best``: the model's state_dict, the optimizer's state (its step counter
  included), the 0-based epoch and ``best_acc1``;
- ``ckpt_mid_ep_{E:03d}_it_{S:06d}``: an emergency checkpoint written when a
  run is preempted before step S of 0-based epoch E (:func:`save_mid_checkpoint`),
  which also records the world size, the samples a step consumes and the
  samples the epoch had consumed, so a relaunch on another world size
  resumes at the same sample (:func:`load_mid_checkpoint`);
- ``corrupt_<name>[.n]``: a checkpoint that failed its integrity check on
  resume, moved aside (:func:`quarantine_checkpoint`).

Each is a directory holding ``checkpoint.pt`` and a ``dtpu_manifest.json``
of sha256 hashes of its files, written into a temporary directory and
renamed into place, so a directory under the exact name is complete. Only
rank 0 writes. A checkpoint holds the replicated layout at every
``MESH.FSDP``: the model's whole tensors and the optimizer's state as one
process without fsdp keeps it (``TrainState.full_optimizer_state``, which
every rank enters before rank 0 writes), so a run restores at any fsdp
size; each rank takes its own shards on load. :func:`restore_latest` resumes from the most advanced
candidate (:func:`resume_candidates`), quarantining a corrupt one, skipping
``rollback`` known-good ones and falling back past one whose offset the new
world size cannot land on. ``python -m distribuuuu_tpu_torch.checkpoint
verify <OUT_DIR|checkpoint>`` re-hashes checkpoints offline. Each save,
manifest, restore, quarantine, skipped candidate and elastic remap is a
typed record of the run's journal (``obs.current()``), as in JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from pathlib import Path

import torch

from distribuuuu_tpu_torch import obs, resilience
from distribuuuu_tpu_torch.logging import logger

_NAME_PREFIX = "ckpt_ep_"
_DIR_NAME = "checkpoints"
_BEST_NAME = "best"
_FILE_NAME = "checkpoint.pt"
_MANIFEST_NAME = "dtpu_manifest.json"
_MID_FMT = "ckpt_mid_ep_{epoch:03d}_it_{step:06d}"
_CORRUPT_PREFIX = "corrupt_"
# exact names: a temporary directory a killed write left behind never matches
_CKPT_RE = re.compile(rf"^{_NAME_PREFIX}(\d+)$")
_MID_RE = re.compile(r"^ckpt_mid_ep_(\d+)_it_(\d+)$")


class ElasticResumeError(RuntimeError):
    """A mid-epoch checkpoint's sample offset is not a whole number of the
    new world's steps; :func:`restore_latest` falls back past it (an epoch
    checkpoint, at offset 0, always lands)."""


def get_checkpoint_dir(out_dir: str) -> str:
    return os.path.join(out_dir, _DIR_NAME)


def get_checkpoint_path(out_dir: str, epoch: int) -> str:
    """Directory of the checkpoint taken after ``epoch`` epochs (1-based)."""
    return os.path.join(get_checkpoint_dir(out_dir), f"{_NAME_PREFIX}{epoch:03d}")


def get_best_path(out_dir: str) -> str:
    return os.path.join(get_checkpoint_dir(out_dir), _BEST_NAME)


def get_mid_checkpoint_path(out_dir: str, epoch: int, step: int) -> str:
    """Directory of the emergency checkpoint before step ``step`` of 0-based ``epoch``."""
    return os.path.join(get_checkpoint_dir(out_dir), _MID_FMT.format(epoch=epoch, step=step))


def _scan_epoch_dirs(d: str) -> list[tuple[int, str]]:
    if not os.path.isdir(d):
        return []
    return sorted((int(m.group(1)), os.path.join(d, name))
                  for name in os.listdir(d) if (m := _CKPT_RE.match(name)))


def _scan_mid_dirs(d: str) -> list[tuple[int, int, str]]:
    """Emergency checkpoints of ``d`` as ``(epoch, step, path)``, ascending."""
    if not os.path.isdir(d):
        return []
    return sorted((int(m.group(1)), int(m.group(2)), os.path.join(d, name))
                  for name in os.listdir(d) if (m := _MID_RE.match(name)))


def _ranked_candidates(epochs: list[tuple[int, str]], mids: list[tuple[int, int, str]]
                       ) -> list[tuple[tuple[int, int, int], str, str]]:
    """The one ranking of checkpoints, most advanced first: ``(position,
    kind, path)`` with position ``(epoch, step, tiebreak)``; an epoch
    checkpoint (N, 0, 1) outranks an emergency one at the same position."""
    cands = [((n, 0, 1), "epoch", p) for n, p in epochs]
    cands += [((e, s, 0), "mid", p) for e, s, p in mids]
    cands.sort(key=lambda c: c[0], reverse=True)
    return cands


def _mid_checkpoints(out_dir: str) -> list[tuple[int, int, str]]:
    """Emergency checkpoints of ``out_dir`` as ``(epoch, step, path)``, ascending."""
    return _scan_mid_dirs(get_checkpoint_dir(out_dir))


def resume_candidates(out_dir: str, *, step_granular: bool = True
                      ) -> list[tuple[tuple[int, int, int], str, str]]:
    """Every resume candidate of ``out_dir`` as ``(position, kind, path)``,
    most advanced first: the order :func:`restore_latest` walks."""
    d = get_checkpoint_dir(out_dir)
    return _ranked_candidates(_scan_epoch_dirs(d), _scan_mid_dirs(d) if step_granular else [])


def manifest_path(ckpt_path: str) -> str:
    return os.path.join(ckpt_path, _MANIFEST_NAME)


def manifest_hash(ckpt_path: str) -> str:
    """The first 16 hex digits of the sha256 of a checkpoint's manifest ("":
    none, or unreadable). The manifest hashes every file, so this names the
    checkpoint's bytes: the version the serving replica reports in
    ``/healthz`` and its ``deploy_*`` records."""
    try:
        with open(manifest_path(ckpt_path), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return ""


def watch_candidates(watch_dir: str) -> list[tuple[tuple[int, int, int], str, str]]:
    """Deployable checkpoints under ``watch_dir`` as ``(position, kind,
    path)``, most advanced first, ranked as :func:`resume_candidates` ranks
    them (the deploy watcher's scan, ``serve/deploy.py``). ``watch_dir`` is a
    training run's OUT_DIR (its ``checkpoints/`` is scanned) or the
    checkpoints directory itself. The exact-name patterns leave out
    temporary directories of a write in progress and ``corrupt_*`` ones; a
    missing directory gives []."""
    d = str(watch_dir)
    if os.path.isdir(os.path.join(d, _DIR_NAME)):
        d = os.path.join(d, _DIR_NAME)
    return _ranked_candidates(_scan_epoch_dirs(d), _scan_mid_dirs(d))


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
        try:
            n, digest = _hash_file(fpath)
        except OSError as exc:
            errors.append(f"{rel}: unreadable ({exc!r})")
            continue
        if n != want.get("bytes"):
            errors.append(f"{rel}: size {n} != manifest {want.get('bytes')}")
        elif digest != want.get("sha256"):
            errors.append(f"{rel}: sha256 mismatch")
    return ("corrupt", errors) if errors else ("ok", [])


def quarantine_checkpoint(ckpt_path: str, errors: list[str]) -> str | None:
    """Rename a corrupt checkpoint ``corrupt_<name>`` (``.1``, ``.2``, ...
    when that exists), which no scan matches. Returns the new path, or None
    when the rename failed. Several ranks verify the same candidates, so a
    source another process already renamed is a lost race, not an error."""
    parent, name = os.path.split(str(ckpt_path).rstrip("/"))
    target = os.path.join(parent, f"{_CORRUPT_PREFIX}{name}")
    n = 0
    while os.path.exists(target):
        n += 1
        target = os.path.join(parent, f"{_CORRUPT_PREFIX}{name}.{n}")
    try:
        os.rename(ckpt_path, target)
    except OSError as exc:
        if not os.path.exists(ckpt_path):
            logger.warning(f"checkpoint {ckpt_path} was already quarantined by a concurrent "
                           f"process; skipping it")
            return None
        logger.error(f"could not quarantine corrupt checkpoint {ckpt_path}: {exc!r}")
        target = None
    logger.error(f"Checkpoint {ckpt_path} FAILED integrity verification ({len(errors)} "
                 f"error(s), first: {errors[0] if errors else '?'}); "
                 + (f"quarantined to {target}" if target else "quarantine rename failed"))
    obs.current().event("ckpt_quarantined", path=str(ckpt_path),
                        quarantine_path=str(target) if target else "", errors=errors[:8])
    return target


def _write(path: str, payload: dict) -> None:
    """``payload`` into ``path/checkpoint.pt`` with its manifest, through a
    temporary directory renamed into place."""
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE_NAME))
    tic = time.time()
    files = write_manifest(tmp)["files"]
    wall = time.time() - tic
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    obs.current().event("manifest", path=path, files=len(files),
                        bytes=sum(f["bytes"] for f in files.values()), wall_s=round(wall, 4))


def _state_payload(state, epoch: int, best_acc1: float, optimizer: dict | None = None) -> dict:
    """``optimizer``: ``state.full_optimizer_state()``, which a sharded
    state gathers on every rank before rank 0 writes (then it must be
    given); None takes it here."""
    if optimizer is None:
        if state.fsdp > 1:
            raise ValueError("a sharded state's optimizer is gathered on every rank: pass "
                             "optimizer=state.full_optimizer_state() from each")
        optimizer = state.full_optimizer_state()
    return {
        "epoch": int(epoch),
        "model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
        "optimizer": {k: v.detach().cpu().clone() for k, v in optimizer.items()},
        "best_acc1": float(best_acc1),
    }


def save_checkpoint(out_dir: str, epoch: int, state, best_acc1: float, is_best: bool,
                    optimizer: dict | None = None) -> str:
    """Write the checkpoint after 0-based ``epoch`` (named ``epoch + 1``)
    and refresh ``best`` on an improvement. Returns its path. Emergency
    checkpoints of the epochs before ``epoch`` are pruned first (the
    previous epoch checkpoint, written as synchronously as this one,
    dominates them). ``optimizer``: as :func:`_state_payload`'s."""
    prune_mid_checkpoints(out_dir, before_epoch=epoch)
    payload = _state_payload(state, epoch, best_acc1, optimizer)
    os.makedirs(get_checkpoint_dir(out_dir), exist_ok=True)
    path = get_checkpoint_path(out_dir, epoch + 1)
    targets = [("epoch", path)] + ([("best", get_best_path(out_dir))] if is_best else [])
    for kind, p in targets:
        tic = time.time()
        _write(p, payload)
        obs.current().event("checkpoint", ckpt_kind=kind, path=p, epoch=epoch,
                            wall_s=round(time.time() - tic, 4), synchronous=True)
    return path


def save_mid_checkpoint(out_dir: str, epoch: int, step: int, state, best_acc1: float,
                        samples_per_step: int | None = None,
                        optimizer: dict | None = None) -> str:
    """The emergency checkpoint of a preempted run, before step ``step``
    (the batches of 0-based ``epoch`` already consumed) with the world size
    (``devices``), ``samples_per_step`` (``BATCH_SIZE * ACCUM_STEPS * world``) and
    ``global_samples = step * samples_per_step``, what an elastic relaunch
    remaps its step from. Synchronous, its whole write under
    ``resilience.retry`` (the process exits next), its manifest inline; it
    then removes the older emergency checkpoints of the same epoch, which it
    dominates. Returns the path.

    The dropout stream is counter-based (``trainer.dropout_seed``:
    each micro-step's generator is seeded from the run's base seed, the
    epoch, the step, the micro-step and the rank), so the checkpoint holds
    what the JAX package's ``rng_key`` holds, the base seed
    (``dropout_seed``), and no generator state: a resume draws the same
    masks. ``optimizer``: as :func:`_state_payload`'s."""
    payload = dict(_state_payload(state, epoch, best_acc1, optimizer), step=int(step),
                   devices=int(state.world))
    if getattr(state, "dropout_seed", None) is not None:
        payload["dropout_seed"] = int(state.dropout_seed)
    if samples_per_step:
        payload["samples_per_step"] = int(samples_per_step)
        payload["global_samples"] = int(step) * int(samples_per_step)
    path = get_mid_checkpoint_path(out_dir, epoch, step)
    os.makedirs(get_checkpoint_dir(out_dir), exist_ok=True)
    tic = time.time()
    resilience.retry(_write, path, payload, retry_on=(Exception,),
                     desc=f"emergency checkpoint save {path}")
    obs.current().event("checkpoint", ckpt_kind="emergency", path=path, epoch=epoch, step=step,
                        wall_s=round(time.time() - tic, 4), synchronous=True)
    for e, _, old in _mid_checkpoints(out_dir):
        if e == epoch and old != path:
            try:
                shutil.rmtree(old)
            except OSError as exc:
                logger.warning(f"could not prune superseded emergency checkpoint {old}: "
                               f"{exc!r}")
    return path


def prune_mid_checkpoints(out_dir: str, before_epoch: int) -> None:
    """Remove the emergency checkpoints of epochs before ``before_epoch``
    (an epoch checkpoint dominates them). Best effort: a failure warns."""
    for e, _, path in _mid_checkpoints(out_dir):
        if e < before_epoch:
            try:
                shutil.rmtree(path)
            except OSError as exc:
                logger.warning(f"could not prune stale emergency checkpoint {path}: {exc!r}")


def _checkpoint_file(path: str) -> str:
    return os.path.join(path, _FILE_NAME) if os.path.isdir(path) else path


def _load_payload(path: str) -> dict:
    return torch.load(_checkpoint_file(path), map_location="cpu", weights_only=True)


def _restore_state(payload: dict, state, load_opt: bool) -> None:
    """The replicated layout into ``state``; under fsdp this rank's shards."""
    state.model.load_state_dict(payload["model"], strict=True)
    state.reshard()
    if load_opt and "optimizer" in payload:
        state.load_full_optimizer_state(payload["optimizer"])


def load_checkpoint(path: str, state, load_opt: bool = True) -> tuple[int, float]:
    """Restore ``state`` from a checkpoint directory (or its ``.pt``) in
    place; returns ``(start_epoch, best_acc1)``. ``load_opt`` False keeps
    the optimizer as it is (a warm start)."""
    tic = time.time()
    payload = _load_payload(path)
    _restore_state(payload, state, load_opt)
    obs.current().event("restore", path=str(path), wall_s=round(time.time() - tic, 4))
    return int(payload.get("epoch", -1)) + 1, float(payload.get("best_acc1", 0.0))


def load_mid_checkpoint(path: str, state, samples_per_step: int | None = None,
                        load_opt: bool = True) -> tuple[int, int, float]:
    """Restore ``state`` from an emergency checkpoint in place; returns
    ``(epoch, step, best_acc1)``: the 0-based epoch to re-enter and the
    batches of it already consumed, at this run's world size. With
    ``samples_per_step`` other than the saved one, the step is
    ``global_samples // samples_per_step`` (the elastic remap), and
    :class:`ElasticResumeError` is raised, before ``state`` is touched,
    when that division leaves a remainder."""
    tic = time.time()
    payload = _load_payload(path)
    saved_step = step = int(payload["step"])
    saved_sps = int(payload.get("samples_per_step", 0))
    if samples_per_step and saved_sps and samples_per_step != saved_sps:
        global_samples = int(payload["global_samples"])
        if global_samples % samples_per_step:
            raise ElasticResumeError(
                f"checkpoint {path} was saved at sample offset {global_samples} ({saved_step} "
                f"steps x {saved_sps} samples/step); the new world consumes {samples_per_step} "
                f"samples/step, which cannot land on that offset exactly")
        step = global_samples // samples_per_step
        saved_devices = int(payload.get("devices", 0))
        logger.info(f"Elastic resume: remapped step {saved_step} (@{saved_sps} samples/step"
                    + (f", {saved_devices} devices" if saved_devices else "")
                    + f") -> step {step} (@{samples_per_step} samples/step) at sample offset "
                    f"{global_samples}")
        obs.current().event("elastic_resume", path=str(path), global_samples=global_samples,
                            saved_step=saved_step, saved_samples_per_step=saved_sps, step=step,
                            samples_per_step=int(samples_per_step),
                            **({"saved_devices": saved_devices} if saved_devices else {}))
    _restore_state(payload, state, load_opt)
    if "dropout_seed" in payload:  # continue the interrupted run's dropout stream
        state.dropout_seed = int(payload["dropout_seed"])
    obs.current().event("restore", path=str(path), wall_s=round(time.time() - tic, 4))
    return int(payload["epoch"]), step, float(payload.get("best_acc1", 0.0))


def restore_latest(out_dir: str, state, *, step_granular: bool = True,
                   skip_corrupt: bool = True, load_opt: bool = True,
                   verify_integrity: bool = True, samples_per_step: int | None = None,
                   rollback: int = 0):
    """Resume ``state`` in place from the most advanced restorable
    checkpoint of ``out_dir``: ``(start_epoch, start_step, best_acc1,
    path)``, or None when there is none. Candidates are the epoch
    checkpoints and, with ``step_granular``, the emergency ones, in
    :func:`resume_candidates`' order. Each candidate in turn:

    - ``verify_integrity``: a manifest that does not verify gets the
      directory quarantined, and the next is tried;
    - ``rollback`` > 0 skips that many known-good candidates (ones that
      passed the integrity gate; a quarantined one spends none of it);
    - an emergency checkpoint whose sample offset the world of
      ``samples_per_step`` cannot land on is skipped (always);
    - ``skip_corrupt``: a candidate that fails to load anyway is skipped
      (else the error is raised)."""
    to_roll_back = max(0, int(rollback))
    for _, kind, path in resume_candidates(out_dir, step_granular=step_granular):
        if verify_integrity:
            status, errors = verify_checkpoint(path)
            if status == "corrupt":
                quarantine_checkpoint(path, errors)
                continue
        if to_roll_back > 0:
            to_roll_back -= 1
            logger.warning(f"Rollback: skipping known-good checkpoint {path} ({to_roll_back} "
                           f"more to skip; RESUME.ROLLBACK={rollback})")
            obs.current().event("ckpt_skipped", path=path, reason="rollback",
                                error=f"rollback depth {rollback}")
            continue
        try:
            if kind == "epoch":
                start_epoch, best = load_checkpoint(path, state, load_opt=load_opt)
                return start_epoch, 0, best, path
            epoch, step, best = load_mid_checkpoint(path, state, samples_per_step, load_opt)
            return epoch, step, best, path
        except ElasticResumeError as exc:
            logger.warning(f"Checkpoint {path} skipped for elastic resume ({exc}); falling back "
                           f"to the next-highest checkpoint")
            obs.current().event("ckpt_skipped", path=path, reason="elastic", error=str(exc))
        except Exception as exc:
            if not skip_corrupt:
                raise
            logger.warning(f"Checkpoint {path} failed to restore ({exc!r}); falling back to "
                           f"the next-highest checkpoint")
            obs.current().event("ckpt_skipped", path=path, reason="restore_failed",
                                error=repr(exc))
    return None


def _cli_targets(path: str) -> list[str]:
    """The checkpoint directories a CLI path names: one checkpoint, a
    ``checkpoints/`` directory, or an OUT_DIR holding one."""
    if os.path.exists(manifest_path(path)) or os.path.exists(os.path.join(path, _FILE_NAME)):
        return [path]
    scan = get_checkpoint_dir(path) if os.path.isdir(get_checkpoint_dir(path)) else path
    if not os.path.isdir(scan):
        return []
    return [os.path.join(scan, name) for name in sorted(os.listdir(scan))
            if (_CKPT_RE.match(name) or _MID_RE.match(name) or name == _BEST_NAME)
            and os.path.isdir(os.path.join(scan, name))]


def main(argv: list[str] | None = None) -> int:
    """``python -m distribuuuu_tpu_torch.checkpoint verify <path> [--quarantine]``:
    re-hash one checkpoint, or every one under an OUT_DIR, against its
    manifest. Exit 0 when none is corrupt, else 1; ``--quarantine`` moves
    the corrupt ones aside as a resume would."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m distribuuuu_tpu_torch.checkpoint",
                                     description="Checkpoint integrity tools")
    sub = parser.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify", help="verify checksum manifests")
    v.add_argument("path", help="a checkpoint directory, a checkpoints/ directory or an OUT_DIR")
    v.add_argument("--quarantine", action="store_true",
                   help="rename corrupt checkpoints to corrupt_* (what auto-resume does)")
    args = parser.parse_args(argv)
    targets = _cli_targets(args.path)
    if not targets:
        print(f"no checkpoints found under {args.path}")
        return 1
    n_corrupt = 0
    for t in targets:
        status, errors = verify_checkpoint(t)
        print(f"{status.upper():10s} {t}")
        for e in errors:
            print(f"           - {e}")
        if status == "corrupt":
            n_corrupt += 1
            if args.quarantine and (q := quarantine_checkpoint(t, errors)):
                print(f"           quarantined -> {q}")
    print(f"{len(targets)} checkpoint(s), {n_corrupt} corrupt")
    return 1 if n_corrupt else 0


if __name__ == "__main__":
    raise SystemExit(main())
