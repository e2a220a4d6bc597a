"""Continuous train -> serve deployment (counterpart of ``serve/deploy.py``).

Per serving replica, a watcher thread polls ``SERVE.DEPLOY.WATCH_DIR`` (a
training run's OUT_DIR or its ``checkpoints/``) and walks each new
checkpoint through a gated rollout, as the JAX package's does:

1. **watch**: candidates ranked by their resume position
   (``checkpoint.watch_candidates``), so an older checkpoint never deploys
   over a newer one; ``corrupt_*`` and in-progress directories are
   invisible; a directory without its manifest yet is *held* (retried next
   poll), one that fails its manifest is skipped with a typed record (the
   watcher never quarantines a training run's files).
2. **stage**: the engine builds the incoming version beside the serving one
   with the incumbent's spec (``InferenceEngine.stage``: for ``:int8`` its
   own calibration, gate and prune, a failed gate a failed stage) and runs
   every ladder size once. The incumbent serves throughout.
3. **canary**: first a quality gate on golden-fixture inputs against the
   incumbent (``quant.gate.compare_logits``; non-finite logits fail), then
   a fraction of live traffic on the staged version, routed in the batcher
   by a hash of the trace id, until ``MIN_CANARY_REQUESTS`` or ``CANARY_S``;
   its p99 must stay within ``SLO_P99_FACTOR`` of the incumbent's live p99
   (the replica's ``LiveAggregator``, read before any canary traffic).
4. **promote or roll back**: the engine drops the old or the staged version;
   a rollback bumps the checkpoint's strike count in
   ``OUT_DIR/deploy/strikes.json`` (keyed by name and manifest hash), and at
   ``MAX_STRIKES`` the watcher never tries it again.

Replicas serialize rollouts through a lease file (``OUT_DIR/deploy/
rollout.lock``, a stale holder taken over), and a promotion is recorded in
``OUT_DIR/deploy/promoted.json`` so a peer or a restarted replica
fast-follows that checkpoint without a canary. ``GET /healthz`` reports each
model's version and a readiness flag that is False while a swap is in
flight. Every step is a typed ``deploy_*`` record, the JAX package's, which
``obs summarize`` renders as its "deployments:" section. The files go
through ``runtime/pathio`` (local paths; ``gs://`` is item 13).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from distribuuuu_tpu_torch.checkpoint import (
    manifest_hash,
    manifest_path,
    verify_checkpoint,
    watch_candidates,
)
from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.quant.gate import compare_logits
from distribuuuu_tpu_torch.runtime import pathio


@dataclass
class DeploySettings:
    """The `cfg.SERVE.DEPLOY` knobs, engine-shaped (tests construct this
    directly; `from_cfg` maps the config tree)."""

    watch_dir: str
    model: str = ""  # "" = the sole hosted model
    poll_s: float = 5.0
    canary_fraction: float = 0.1
    canary_s: float = 30.0
    min_canary_requests: int = 20
    slo_p99_factor: float = 2.0
    gate_n: int = 16
    gate_seed: int = 0
    min_top1_agree: float = 0.5
    max_logit_rmse: float = 0.0  # 0 = RMSE unbounded (top-1 + finiteness gate)
    max_strikes: int = 2
    lock_lease_s: float = 600.0

    @classmethod
    def from_cfg(cls, deploy_cfg) -> "DeploySettings":
        return cls(
            watch_dir=str(deploy_cfg.WATCH_DIR),
            model=str(deploy_cfg.MODEL),
            poll_s=float(deploy_cfg.POLL_S),
            canary_fraction=float(deploy_cfg.CANARY_FRACTION),
            canary_s=float(deploy_cfg.CANARY_S),
            min_canary_requests=int(deploy_cfg.MIN_CANARY_REQUESTS),
            slo_p99_factor=float(deploy_cfg.SLO_P99_FACTOR),
            gate_n=int(deploy_cfg.GATE_N),
            gate_seed=int(deploy_cfg.GATE_SEED),
            min_top1_agree=float(deploy_cfg.MIN_TOP1_AGREE),
            max_logit_rmse=float(deploy_cfg.MAX_LOGIT_RMSE),
            max_strikes=int(deploy_cfg.MAX_STRIKES),
            lock_lease_s=float(deploy_cfg.LOCK_LEASE_S),
        )


def deploy_dir(out_dir: str) -> str:
    return pathio.join(str(out_dir), "deploy")


# ---------------------------------------------------------------------------
# Persisted rollback strikes
# ---------------------------------------------------------------------------

class StrikeStore:
    """Per-checkpoint rollback strike counts, persisted as one small JSON
    file under ``OUT_DIR/deploy/`` (via `pathio`, atomic local writes).

    Strikes survive replica restarts: a
    poison checkpoint that rolled back twice before the replica was
    SIGKILLed is still struck out after the relaunch. Writes happen only
    under the rollout lease (one writer at a time fleet-wide); reads are
    re-read from disk per decision so peers see each other's strikes.
    """

    def __init__(self, out_dir: str):
        self.path = pathio.join(deploy_dir(out_dir), "strikes.json")

    def _read(self) -> dict[str, int]:
        try:
            data = json.loads(pathio.read_bytes(self.path).decode("utf-8"))
            return {str(k): int(v) for k, v in data.items()}
        except Exception:
            return {}

    @staticmethod
    def _key(ckpt_path: str) -> str:
        """``<name>@<manifest hash>``: the name alone (stable across mounts
        and relaunch working dirs) would let a struck-out checkpoint from an
        OLD training run block a NEW run's same-named — different-bytes —
        checkpoint forever; the manifest hash pins the strike to the exact
        bytes that earned it. Manifest-less dirs fall back to the bare name.
        """
        name = _ckpt_name(ckpt_path)
        digest = manifest_hash(ckpt_path)
        return f"{name}@{digest}" if digest else name

    def get(self, ckpt_path: str) -> int:
        strikes = self._read()
        name = _ckpt_name(ckpt_path)
        if not any(k == name or k.startswith(f"{name}@") for k in strikes):
            return 0  # no same-named record: spare the per-poll manifest read
        return strikes.get(self._key(ckpt_path), 0)

    def bump(self, ckpt_path: str) -> int:
        strikes = self._read()
        key = self._key(ckpt_path)
        strikes[key] = strikes.get(key, 0) + 1
        try:
            pathio.makedirs(os.path.dirname(self.path))
            pathio.write_text(self.path, json.dumps(strikes, sort_keys=True))
        except Exception as exc:  # strike persistence is best-effort
            logger.warning(f"deploy: could not persist strikes: {exc!r}")
        return strikes[key]


def _ckpt_name(path: str) -> str:
    return str(path).rstrip("/").rsplit("/", 1)[-1]


# ---------------------------------------------------------------------------
# Rolling-update lease (one replica rolls at a time)
# ---------------------------------------------------------------------------

class RolloutLease:
    """Fleet-wide rollout serialization through a lease file: claim by an
    atomic write, settle, re-read to confirm. Best-effort mutual exclusion
    (a tie can admit two rollouts, which costs one redundant canary, never
    correctness), and a holder silent for ``lease_s`` is taken over, so a
    replica killed mid-rollout cannot block deploys.
    """

    def __init__(self, out_dir: str, holder: str, lease_s: float):
        self.path = pathio.join(deploy_dir(out_dir), "rollout.lock")
        self.holder = str(holder)
        self.lease_s = float(lease_s)
        self._last_refresh = 0.0

    def _read(self) -> dict | None:
        try:
            return json.loads(pathio.read_bytes(self.path).decode("utf-8"))
        except Exception:
            return None

    def try_acquire(self) -> bool:
        current = self._read()
        if current is not None and current.get("holder") != self.holder:
            age = time.time() - float(current.get("ts", 0.0))
            if age < self.lease_s:
                return False  # a live peer is mid-rollout
            logger.warning(
                f"deploy: taking over stale rollout lease from "
                f"{current.get('holder')!r} ({age:.0f}s old)"
            )
        try:
            pathio.makedirs(os.path.dirname(self.path))
            pathio.write_text(
                self.path, json.dumps({"holder": self.holder, "ts": time.time()})
            )
            time.sleep(0.05)  # let a racing claim's rename win or lose visibly
            settled = self._read()
            return settled is not None and settled.get("holder") == self.holder
        except Exception as exc:
            logger.warning(f"deploy: lease acquire failed: {exc!r}")
            return False

    def refresh(self) -> None:
        """Re-stamp the lease so a long rollout phase is not taken for a
        dead holder's. Throttled to a tenth of the lease (at least 1 s), as
        callers refresh from tight wait loops."""
        now = time.monotonic()
        if now - self._last_refresh < max(1.0, self.lease_s / 10.0):
            return
        self._last_refresh = now
        try:
            pathio.write_text(
                self.path, json.dumps({"holder": self.holder, "ts": time.time()})
            )
        except Exception:
            pass

    def release(self) -> None:
        current = self._read()
        if current is not None and current.get("holder") == self.holder:
            pathio.remove(self.path)


# ---------------------------------------------------------------------------
# Promoted-version record (the fleet-convergence / fast-follow channel)
# ---------------------------------------------------------------------------

def read_promoted(out_dir: str) -> dict[str, str]:
    try:
        path = pathio.join(deploy_dir(out_dir), "promoted.json")
        data = json.loads(pathio.read_bytes(path).decode("utf-8"))
        return {str(k): str(v) for k, v in data.items()}
    except Exception:
        return {}


def record_promoted(out_dir: str, model: str, ckpt_path: str) -> None:
    promoted = read_promoted(out_dir)
    promoted[str(model)] = str(ckpt_path)
    try:
        pathio.makedirs(deploy_dir(out_dir))
        pathio.write_text(
            pathio.join(deploy_dir(out_dir), "promoted.json"),
            json.dumps(promoted, sort_keys=True),
        )
    except Exception as exc:
        logger.warning(f"deploy: could not record promotion: {exc!r}")


# ---------------------------------------------------------------------------
# The per-replica deploy manager
# ---------------------------------------------------------------------------

def _p99(samples: list[float]) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[max(0, min(len(s) - 1, math.ceil(0.99 * len(s)) - 1))]


class DeployManager:
    """One replica's watch→stage→canary→promote/rollback loop.

    Wired by `serve.frontend.ServeReplica` from its own engine, batcher and
    live aggregator; every decision lands as a typed journal record through
    the replica's ``journal_event``. `poll_once` performs at most one full
    rollout and is the synchronous entry the tests drive; `start` runs it
    on a daemon thread at ``poll_s`` cadence.
    """

    def __init__(
        self,
        settings: DeploySettings,
        *,
        engine,
        batcher,
        aggregator=None,
        journal_event=None,
        out_dir: str = ".",
        replica: int = 0,
    ):
        if not settings.watch_dir:
            raise ValueError("DeployManager needs SERVE.DEPLOY.WATCH_DIR")
        self.settings = settings
        self.engine = engine
        self.batcher = batcher
        self.aggregator = aggregator
        self.out_dir = str(out_dir)
        self.replica = int(replica)
        self._event = journal_event or (lambda kind, **fields: None)
        self.model = settings.model or self._sole_model()
        if self.model not in engine.models:
            raise ValueError(
                f"SERVE.DEPLOY.MODEL {self.model!r} is not hosted "
                f"(hosting: {sorted(engine.models)})"
            )
        self.strikes = StrikeStore(self.out_dir)
        self.lease = RolloutLease(
            self.out_dir, f"replica-{self.replica}-{os.getpid()}",
            settings.lock_lease_s,
        )
        # readiness: False exactly while a version swap is in flight (the
        # /healthz rolling-restart gate; serving itself never stops)
        self._rolling = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # (path, action) pairs already journaled, so a held/corrupt/stale
        # dir is one typed event, not one per poll
        self._noted: set[tuple[str, str]] = set()
        # verify verdicts cached per (path -> (manifest digest, status)):
        # verify_checkpoint re-hashes EVERY file of the directory (multi-GB
        # on real runs, a full re-download on gs://), and a corrupt dir at
        # the newest position would otherwise be re-hashed every poll
        # forever. A changed manifest (repair, rewrite) invalidates the
        # entry; the authoritative check still runs at stage time
        # (load_weights verifies before loading).
        self._verified: dict[str, tuple[str, str]] = {}
        self.rollouts = 0  # completed rollouts (promotes + rollbacks)

    def _sole_model(self) -> str:
        models = sorted(self.engine.models)
        if len(models) != 1:
            raise ValueError(
                f"SERVE.DEPLOY.MODEL must name which hosted model to deploy "
                f"into (hosting: {models})"
            )
        return models[0]

    # -- lifecycle -----------------------------------------------------------

    @property
    def ready(self) -> bool:
        return not self._rolling.is_set()

    def start(self) -> "DeployManager":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dtpu-deploy-watch"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:  # the watcher must never kill serving
                logger.error(f"deploy: watch poll failed: {exc!r}")
            self._stop.wait(self.settings.poll_s)

    # -- the watch scan ------------------------------------------------------

    def _note(self, path: str, action: str, **fields) -> None:
        """Journal one deploy_watch event per (path, action) transition."""
        if (path, action) in self._noted:
            return
        self._noted.add((path, action))
        self._event(
            "deploy_watch", model=self.model, path=str(path), action=action,
            replica=self.replica, **fields,
        )

    def _serving_position(self) -> tuple[int, int]:
        v = self.engine.models[self.model].version
        return int(v.get("epoch", -1)), int(v.get("step", -1))

    def select_candidate(self) -> tuple[str, dict] | None:
        """The newest deployable checkpoint in the watch dir, or None.

        Walks candidates most-advanced-first and returns the first that is
        (a) strictly newer than the serving version, (b) not struck out,
        (c) manifest-complete (a dir mid-write is HELD — skipped this poll,
        retried the next; the training run's async manifest writer lands it
        shortly after the checkpoint), and (d) integrity-verified.
        """
        serving = self._serving_position()
        for (epoch, step, _), _kind, path in watch_candidates(self.settings.watch_dir):
            pos_fields = {"epoch": int(epoch), "step": int(step)}
            if (epoch, step) <= serving:
                # everything below is older still — and an already-serving
                # or older checkpoint is not an event worth noting: steady
                # state is "the newest checkpoint is the serving one"
                return None
            strikes = self.strikes.get(path)
            if strikes >= self.settings.max_strikes:
                self._note(path, "struck_out", strikes=strikes, **pos_fields)
                continue
            if not pathio.exists(manifest_path(path)):
                # mid-write: the checkpoint commit landed but the manifest
                # hasn't — held, not refused (re-noted never, retried every
                # poll until the manifest appears)
                self._note(path, "held", reason="no manifest yet", **pos_fields)
                continue
            digest = manifest_hash(path)
            cached = self._verified.get(path)
            if cached is not None and cached[0] == digest:
                status, errors = cached[1], []
            else:
                status, errors = verify_checkpoint(path)
                self._verified[path] = (digest, status)
            if status == "corrupt":
                self._note(
                    path, "corrupt",
                    reason="; ".join(errors[:3]) or "manifest verify failed",
                    **pos_fields,
                )
                continue
            return path, pos_fields
        return None

    # -- gates ---------------------------------------------------------------

    def _gated_forward(self, x: np.ndarray, version: str) -> np.ndarray:
        """The engine's forward of the gate inputs at the largest ladder size
        (padded, sliced back): no batcher and no SLO samples, and the staged
        version ran every ladder size when it was staged."""
        b = self.engine.batch_sizes[-1]
        chunks = []
        for i in range(0, int(x.shape[0]), b):
            part = x[i : i + b]
            padded = np.zeros((b, *x.shape[1:]), dtype=x.dtype)
            padded[: part.shape[0]] = part
            out = self.engine.forward(self.model, padded, version=version)
            chunks.append(out[: part.shape[0]])
        return np.concatenate(chunks, axis=0)

    def _quality_gate(self, path: str):
        """Candidate-vs-incumbent logits on deterministic fixture inputs —
        the serving twin of the int8 ``quant_quality`` gate. Returns a
        GateResult; non-finite candidate logits fail outright (the poisoned-
        checkpoint signature: a diverged run's weights produce NaN/inf)."""
        s = self.settings
        x = self.engine._gate_inputs(s.gate_n, s.gate_seed)
        incumbent = self._gated_forward(x, "live")
        candidate = self._gated_forward(x, "canary")
        max_rmse = s.max_logit_rmse if s.max_logit_rmse > 0 else float("inf")
        result = compare_logits(
            incumbent, candidate,
            min_top1_agree=s.min_top1_agree, max_logit_rmse=max_rmse,
        )
        if not np.all(np.isfinite(candidate)):
            result.passed = False
            result.logit_rmse = float("inf")
        return result

    def _incumbent_p99(self) -> float:
        """The incumbent's live p99 from the replica's aggregator (its
        ``serve_slo`` fold). Rollups are replica-stamped (``model#rN``), so
        prefer our own replica's series, fall back to any series of this
        model. 0.0 = no data yet (an idle replica) — the SLO gate passes
        vacuously."""
        if self.aggregator is None:
            return 0.0
        snap = self.aggregator.snapshot()
        series = snap.get("per_model", {}).get("serve_p99_ms", {})
        own = series.get(f"{self.model}#r{self.replica}")
        if own is not None:
            return float(own)
        for key, value in series.items():
            if key == self.model or key.startswith(f"{self.model}#r"):
                return float(value)
        return 0.0

    # -- the rollout ---------------------------------------------------------

    def poll_once(self) -> str:
        """One watch poll; runs a full rollout when a candidate is due.

        Returns what happened: ``idle`` | ``lease_wait`` | ``promoted`` |
        ``rolled_back`` | ``stage_failed`` | ``aborted`` (shutdown cut the
        canary short) — the tests' synchronous handle.
        """
        selected = self.select_candidate()
        if selected is None:
            return "idle"
        path, pos_fields = selected
        if not self.lease.try_acquire():
            self._note(path, "lease_wait", reason="another replica mid-rollout")
            return "lease_wait"
        # this path may have waited out a peer's rollout under lease_wait;
        # re-scan under the lease — the peer may have promoted past it
        self._noted = {(p, a) for p, a in self._noted if a != "lease_wait"}
        try:
            selected = self.select_candidate()
            if selected is None:
                return "idle"
            path, pos_fields = selected
            fast_follow = read_promoted(self.out_dir).get(self.model) == path
            self._note(path, "candidate", **pos_fields)
            return self._rollout(path, pos_fields, fast_follow=fast_follow)
        finally:
            self.lease.release()
            self._rolling.clear()

    def _rollout(self, path: str, pos_fields: dict, *, fast_follow: bool) -> str:
        self._rolling.set()  # /healthz ready=False: a swap is in flight
        t0 = time.time()
        # a leftover staged slot (an earlier rollout died between stage and
        # settle) would make stage() refuse — and strike — every future
        # candidate; discard it, never let it poison the watch loop
        self.engine.discard_staged(self.model)
        try:
            staged = self.engine.stage(self.model, path)
            # staging (weights, quantization, the ladder's runs) can outlast a short
            # lease; re-stamp so a LIVE holder is never "stale" to a peer
            self.lease.refresh()
        except Exception as exc:
            # unloadable despite a passing manifest (or a failed int8 gate):
            # strike it like a failed canary so it cannot retry forever
            strikes = self.strikes.bump(path)
            self._event(
                "deploy_rollback", model=self.model, path=str(path),
                reason=f"stage_failed: {exc!r}"[:300], strikes=strikes,
                replica=self.replica, **pos_fields,
            )
            logger.error(f"deploy: staging {path} failed: {exc!r}")
            self.rollouts += 1
            return "stage_failed"
        self._event(
            "deploy_stage", model=self.model, path=str(path),
            wall_s=round(time.time() - t0, 3),
            aot_compiles=len(staged.warmed),
            manifest_hash=staged.version.get("manifest_hash", ""),
            replica=self.replica, **pos_fields,
        )

        try:
            return self._judge_and_settle(path, pos_fields, t0, fast_follow)
        except Exception:
            # an unexpected error mid-rollout (a device error in the gate
            # forward, a dying aggregator, ...) must not leak the staged
            # slot or the canary routing: a leftover staged version would
            # make every FUTURE stage() refuse — and strike — innocent
            # checkpoints until the replica restarts. No strike for the
            # candidate either: this was our failure, not the checkpoint's.
            self.batcher.clear_canary(self.model)
            self.engine.discard_staged(self.model)
            raise

    def _judge_and_settle(
        self, path: str, pos_fields: dict, t0: float, fast_follow: bool
    ) -> str:
        s = self.settings
        if fast_follow:
            # a peer already gated, canaried and promoted this EXACT
            # checkpoint — converge to the fleet's version without
            # re-judging it. Crucially, no quality gate here either: a
            # restarted replica's incumbent may be N epochs stale, and
            # comparing the fleet's current version against stale weights
            # would strike out — fleet-wide, via the shared strike store —
            # the very checkpoint everyone else is serving.
            return self._promote(path, pos_fields, t0, fast_follow=True)

        # gate (b): quality delta on the golden-fixture inputs, before any
        # live traffic touches the staged version
        gate = self._quality_gate(path)
        self.lease.refresh()
        if not gate.passed:
            return self._rollback(
                path, pos_fields,
                reason=(
                    f"quality gate failed (top-1 agree {gate.top1_agree:.4f} "
                    f"< {s.min_top1_agree} or logit rmse {gate.logit_rmse:.4g}"
                    f" over bound)"
                ),
                canary_fields=dict(
                    requests=0, top1_agree=gate.top1_agree,
                    logit_rmse=_json_num(gate.logit_rmse),
                ),
            )

        # gate (a): canary a fraction of live traffic on the staged version
        samples: list[float] = []
        lock = threading.Lock()

        def on_canary(model: str, latency_ms: float) -> None:
            with lock:
                samples.append(float(latency_ms))

        # the incumbent baseline is snapshotted BEFORE any canary traffic
        # flows: the frontend's SLO rollups carry no version split, so a
        # window captured mid-canary blends the candidate's own latencies
        # into the baseline — a 50x-slower candidate could then pass a gate
        # measured against itself
        incumbent_p99 = self._incumbent_p99()
        self.batcher.set_canary(self.model, s.canary_fraction, hook=on_canary)
        t_canary = time.monotonic()
        try:
            while not self._stop.is_set():
                elapsed = time.monotonic() - t_canary
                with lock:
                    n = len(samples)
                if n >= s.min_canary_requests or elapsed >= s.canary_s:
                    break
                self.lease.refresh()
                self._stop.wait(min(0.1, s.poll_s))
        finally:
            self.batcher.clear_canary(self.model)
        with lock:
            samples = list(samples)
        if self._stop.is_set() and len(samples) < s.min_canary_requests:
            # replica shutting down mid-canary: the window was cut short,
            # so there is no basis for a verdict — promoting vacuously
            # would also record the UN-canaried version in promoted.json
            # for the whole fleet to fast-follow. Abort without a strike
            # (not the checkpoint's fault); the next poll re-judges it.
            self.engine.discard_staged(self.model)
            logger.info(
                f"deploy: rollout of {path} aborted mid-canary "
                f"({len(samples)} sample(s)) — replica stopping"
            )
            return "aborted"
        canary_p99 = _p99(samples)
        slo_ok = (
            not samples
            or incumbent_p99 <= 0.0
            or canary_p99 <= incumbent_p99 * s.slo_p99_factor
        )
        canary_fields = dict(
            requests=len(samples), p99_ms=round(canary_p99, 3),
            incumbent_p99_ms=round(incumbent_p99, 3),
            top1_agree=gate.top1_agree, logit_rmse=_json_num(gate.logit_rmse),
            wall_s=round(time.monotonic() - t_canary, 3),
        )
        if not slo_ok:
            return self._rollback(
                path, pos_fields,
                reason=(
                    f"canary p99 {canary_p99:.1f}ms > "
                    f"{s.slo_p99_factor:g}x incumbent {incumbent_p99:.1f}ms"
                ),
                canary_fields=canary_fields,
            )
        self._event(
            "deploy_canary", model=self.model, path=str(path),
            fraction=s.canary_fraction, passed=True, replica=self.replica,
            **canary_fields,
        )
        return self._promote(path, pos_fields, t0, fast_follow=False)

    def _promote(
        self, path: str, pos_fields: dict, t0: float, *, fast_follow: bool
    ) -> str:
        old = self.engine.promote(self.model)
        record_promoted(self.out_dir, self.model, path)
        self._event(
            "deploy_promote", model=self.model, path=str(path),
            wall_s=round(time.time() - t0, 3),
            manifest_hash=self.engine.models[self.model].version.get(
                "manifest_hash", ""
            ),
            fast_follow=fast_follow, replica=self.replica, **pos_fields,
        )
        logger.info(
            f"deploy: promoted {self.model} -> {path}"
            + (" (fast-follow)" if fast_follow else "")
            + f" (was {old.get('path', '?')})"
        )
        self.rollouts += 1
        return "promoted"

    def _rollback(
        self, path: str, pos_fields: dict, *, reason: str, canary_fields: dict
    ) -> str:
        self.engine.discard_staged(self.model)
        strikes = self.strikes.bump(path)
        self._event(
            "deploy_canary", model=self.model, path=str(path),
            fraction=self.settings.canary_fraction, passed=False,
            reason=reason, replica=self.replica, **canary_fields,
        )
        self._event(
            "deploy_rollback", model=self.model, path=str(path), reason=reason,
            strikes=strikes, replica=self.replica, **pos_fields,
        )
        logger.error(
            f"deploy: rolled back {self.model} candidate {path} "
            f"(strike {strikes}/{self.settings.max_strikes}): {reason} — "
            f"incumbent keeps serving"
        )
        self.rollouts += 1
        return "rolled_back"


def _json_num(x: float) -> float:
    """inf/nan are not JSON — the journal gets a large sentinel instead."""
    return float(x) if math.isfinite(x) else 1e30
