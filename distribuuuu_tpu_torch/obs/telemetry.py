"""Telemetry core: the one handle the training run reports through (counterpart of ``obs/telemetry.py``).

`Telemetry` owns the run's journal (``obs/journal.py``), the launch and
build counters (``obs/monitors.py``), the step cost and MFU
(``obs/flops.py``) and the goodput ledger. The trainer drives the
window and epoch cadence; the checkpoints, the loaders and the watchdog
report through :func:`current`, a module-level handle that is the inert
`NullTelemetry` outside a run, on every rank but 0 and with
``OBS.ENABLED`` off, so an instrumented call site never asks.

Telemetry adds no device synchronisation and no collective: a window
record is made from the floats the trainer's PRINT_FREQ fetch
(``trainer._fetch``) already brought to the host, the counters are host
integers, the step cost is counted on the meta device, and the memory
record reads the allocator's counters at epoch boundaries.

Goodput: productive step seconds over elapsed run seconds. Productive time
is the wall time of steady-state windows scaled by their non-skipped step
share; the first (cuDNN autotuning) window, eval, checkpoints and
preemption gaps count in the denominator only.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import uuid

import torch

from distribuuuu_tpu_torch.logging import logger
from distribuuuu_tpu_torch.obs import flops as _flops
from distribuuuu_tpu_torch.obs import memory as _memory
from distribuuuu_tpu_torch.obs import trace as _trace
from distribuuuu_tpu_torch.obs.journal import Journal, validate_record
from distribuuuu_tpu_torch.obs.monitors import MonitoringBridge


def _obs_cfg():
    from distribuuuu_tpu_torch.config import cfg

    return cfg.OBS


def journal_path(out_dir: str) -> str:
    """Where the run's journal lives (``OUT_DIR/OBS.JOURNAL``)."""
    return os.path.join(out_dir, _obs_cfg().JOURNAL)


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class NullTelemetry:
    """Inert telemetry: every reporting site works unconditionally (ranks
    other than 0, ``OBS.ENABLED`` off, library use outside a run)."""

    enabled = False

    def event(self, kind: str, **fields) -> None:
        pass

    def span(self, trace_id: str, phase: str, ms: float, **fields) -> None:
        pass

    def trace_tag(self, tag: str) -> str:
        return ""

    def add_wait(self, name: str, seconds: float) -> None:
        pass

    def epoch_start(self, epoch: int) -> None:
        pass

    def window(self, **kw) -> None:
        pass

    def epoch_end(self, **kw) -> None:
        pass

    def capture_step_cost(self) -> None:
        pass

    def commit(self) -> None:
        pass

    def close(self) -> None:
        pass


_NULL = NullTelemetry()
_CURRENT: "Telemetry | NullTelemetry" = _NULL


def current() -> "Telemetry | NullTelemetry":
    """The active run's telemetry (`NullTelemetry` when none)."""
    return _CURRENT


def set_current(tel: "Telemetry | NullTelemetry | None") -> None:
    global _CURRENT
    _CURRENT = tel if tel is not None else _NULL


class Telemetry:
    """Rank-0 journaling telemetry for one training run on ``device``, of
    ``devices`` processes of which ``batch_ranks`` read distinct batches."""

    enabled = True

    def __init__(self, out_dir: str, *, device, devices: int = 1, batch_ranks: int = 1,
                 run_tic: float | None = None):
        oc = _obs_cfg()
        self.journal = Journal(journal_path(out_dir), fsync=bool(oc.FSYNC))
        self.bridge = MonitoringBridge()
        self.device = torch.device(device)
        self._run_tic = run_tic if run_tic is not None else time.time()
        self._productive_s = 0.0
        self._peak = _flops.peak_flops_per_device(self.device, oc.PEAK_TFLOPS_PER_DEVICE)
        self._memory_snapshots = bool(oc.MEMORY_SNAPSHOTS)
        self._device_count = int(devices)
        self._batch_ranks = int(batch_ranks)
        self.step_flops: float | None = None
        self._step_cost_tried = not oc.MFU
        self._epoch_step_times: list[float] = []
        self._run_mark = self._epoch_mark = self.bridge.snapshot()
        self._waits: dict[str, float] = {}
        self._waits_mark: dict[str, float] = {}
        # per-WINDOW marks (data_wait_frac), apart from the per-epoch ones
        self._win_waits_mark: dict[str, float] = {}
        self._wait_lock = threading.Lock()
        self._trace = uuid.uuid4().hex[:8]  # the run's tag in train-side trace ids
        self._train_spans = bool(oc.TRAIN_SPANS)

    # -- journal ------------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        """Append one typed record (``ts`` added, schema-validated). An
        invalid record is a bug of the telemetry: logged loudly, dropped,
        and the run goes on."""
        record = {"ts": time.time(), "kind": kind, **fields}
        errors = validate_record(record)
        if errors:
            logger.error(f"telemetry: invalid {kind!r} record dropped: {errors}")
            return
        self.journal.append(record)

    # -- tracing -------------------------------------------------------------

    def trace_tag(self, tag: str) -> str:
        """A run-scoped trace id for train-side spans (``train-<run>-<tag>``)."""
        return f"train-{self._trace}-{tag}"

    def span(self, trace_id: str, phase: str, ms: float, **fields) -> None:
        """One typed ``span`` record (``obs/trace.py``; host wall only)."""
        self.event("span", **_trace.span_fields(trace_id, phase, ms, **fields))

    # -- cross-thread counters ----------------------------------------------

    def add_wait(self, name: str, seconds: float) -> None:
        """Accumulate a named host-wait counter (the loader's decode wait,
        the H2D dispatch, the step loop's data wait). Thread-safe: producer
        threads call it."""
        with self._wait_lock:
            self._waits[name] = self._waits.get(name, 0.0) + float(seconds)

    def _waits_delta(self) -> dict[str, float]:
        with self._wait_lock:
            delta = {
                k: round(v - self._waits_mark.get(k, 0.0), 6)
                for k, v in self._waits.items()
                if v - self._waits_mark.get(k, 0.0) > 0
            }
            self._waits_mark = dict(self._waits)
        return delta

    def _window_wait_delta(self, name: str) -> float:
        with self._wait_lock:
            total = self._waits.get(name, 0.0)
            delta = total - self._win_waits_mark.get(name, 0.0)
            self._win_waits_mark[name] = total
        return max(0.0, delta)

    # -- step cost / MFU -----------------------------------------------------

    def capture_step_cost(self) -> None:
        """Count the global step's FLOPs once (``obs/flops.step_flops``: the
        meta device, no launch); later calls do nothing."""
        if self._step_cost_tried:
            return
        self._step_cost_tried = True
        with torch.random.fork_rng(devices=[]):  # the meta model's init draws nothing the run sees
            self.step_flops = _flops.step_flops(self._batch_ranks)
        if self.step_flops is not None:
            logger.info(
                f"step cost: {self.step_flops:.4e} FLOPs a global step"
                + (f", peak {self._peak * self._device_count / 1e12:.1f} TFLOP/s over the run's "
                   f"{self._device_count} device(s)" if self._peak
                   else " (hardware peak unknown: MFU omitted)"))

    # -- training cadence ----------------------------------------------------

    def epoch_start(self, epoch: int) -> None:
        self._epoch_step_times = []
        self._epoch_mark = self.bridge.snapshot()
        # the eval pass waits on its loader too: rebase the window marks so
        # that wait is not billed to the next epoch's first window
        with self._wait_lock:
            self._win_waits_mark = dict(self._waits)

    def window(self, *, epoch: int, step: int, gstep: int, steps: int, skipped: int, lr: float,
               wall_s: float, data_time: float, imgs: float, warmup: bool,
               loss: float | None = None, acc1: float | None = None,
               acck: float | None = None) -> None:
        """One PRINT_FREQ window from the trainer's boundary fetch: step
        time and its percentiles over this epoch's steady-state windows,
        throughput, goodput, MFU, the data-wait share and, with
        ``OBS.TRAIN_SPANS``, its data-wait and compute spans."""
        steps = max(1, steps)
        wall_s = max(wall_s, 1e-9)
        step_time = wall_s / steps
        if not warmup:
            self._epoch_step_times.append(step_time)
            self._productive_s += wall_s * (steps - skipped) / steps
        times = sorted(self._epoch_step_times) or [step_time]
        mfu_val = (_flops.mfu(self.step_flops, step_time, self._device_count, self._peak)
                   if not warmup else None)
        # the time the step loop sat waiting for a batch (the prefetcher's
        # ``data_wait_s``) over the window's wall
        data_wait_s = self._window_wait_delta("data_wait_s")
        self.event(
            "window",
            epoch=epoch,
            step=step,
            gstep=gstep,
            steps=steps,
            skipped=skipped,
            lr=float(lr),
            step_time=round(step_time, 6),
            step_time_p50=round(_percentile(times, 0.50), 6),
            step_time_p90=round(_percentile(times, 0.90), 6),
            step_time_max=round(times[-1], 6),
            data_time=round(float(data_time), 6),
            data_wait_frac=round(min(1.0, data_wait_s / wall_s), 6),
            imgs_per_sec=round(imgs / wall_s, 3),
            goodput=round(self.goodput(), 6),
            mfu=round(mfu_val, 6) if mfu_val is not None else None,
            flops_per_step=self.step_flops,
            warmup=bool(warmup),
            loss=float(loss) if loss is not None else None,
            acc1=float(acc1) if acc1 is not None else None,
            acck=float(acck) if acck is not None else None,
        )
        if self._train_spans:
            tid = self.trace_tag(f"g{gstep}")
            self.span(tid, "data_wait", 1000.0 * data_wait_s, gstep=gstep, epoch=epoch)
            self.span(tid, "compute", 1000.0 * max(0.0, wall_s - data_wait_s),
                      gstep=gstep, epoch=epoch)

    def epoch_end(self, *, epoch: int, steps: int, skipped: int, wall_s: float, imgs: float,
                  state=None) -> None:
        """The epoch's summary, its skipped steps, the counters' deltas and,
        with ``OBS.MEMORY_SNAPSHOTS``, a memory record (``state``: what the
        CPU's record counts)."""
        self.event("epoch_train", epoch=epoch, steps=steps, skipped=skipped,
                   wall_s=round(wall_s, 3), imgs_per_sec=round(imgs / max(wall_s, 1e-9), 3),
                   goodput=round(self.goodput(), 6))
        if skipped:
            self.event("fault_skipped_steps", epoch=epoch, count=skipped)
        snap = self.bridge.snapshot()
        delta = MonitoringBridge.delta(snap, self._epoch_mark)
        self._epoch_mark = snap
        self.event("counters", scope="epoch", epoch=epoch, counters=delta["counters"],
                   durations=delta["durations"], waits=self._waits_delta())
        if self._memory_snapshots:
            self.event("memory", epoch=epoch, **_memory.snapshot(self.device, state))

    def goodput(self) -> float:
        elapsed = max(time.time() - self._run_tic, 1e-9)
        return min(1.0, self._productive_s / elapsed)

    # -- durability ----------------------------------------------------------

    def commit(self) -> None:
        """The preemption path's durability point (``Journal.commit``)."""
        try:
            self.journal.commit()
        except Exception as exc:
            logger.warning(f"telemetry journal commit failed: {exc!r}")

    def close(self) -> None:
        self.journal.close()


# ---------------------------------------------------------------------------
# Run lifecycle
# ---------------------------------------------------------------------------

def _config_fingerprint() -> str:
    from distribuuuu_tpu_torch.config import cfg

    try:
        text = cfg.dump()
    except Exception:
        text = repr(cfg)
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def start_run(out_dir: str, *, is_primary: bool = True, device="cpu", devices: int = 1,
              batch_ranks: int = 1, run_tic: float | None = None
              ) -> "Telemetry | NullTelemetry":
    """Open the run's telemetry and make it :func:`current`.

    Only rank 0 journals (``OBS.ENABLED`` gates it); every other process
    gets the `NullTelemetry`. Writes the ``run_start`` record (config
    fingerprint, topology, the card) and registers the journal's commit on
    the preemption path, so a preempted run keeps its telemetry as it keeps
    its emergency checkpoint."""
    from distribuuuu_tpu_torch import resilience
    from distribuuuu_tpu_torch.config import cfg

    end_run()  # a handle an aborted run in this process left open
    if not is_primary or not cfg.OBS.ENABLED:
        set_current(_NULL)
        return _NULL
    tel = Telemetry(out_dir, device=device, devices=devices, batch_ranks=batch_ranks,
                    run_tic=run_tic)
    set_current(tel)
    cuda = tel.device.type == "cuda"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", devices))
    tel.event(
        "run_start",
        run_id=f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}",
        arch=cfg.MODEL.ARCH,
        hosts=max(1, int(devices) // max(1, local)),
        devices=int(devices),
        local_devices=local,
        platform="gpu" if cuda else "cpu",
        device_kind=torch.cuda.get_device_name(tel.device) if cuda else "cpu",
        global_batch=int(cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.ACCUM_STEPS * batch_ranks),
        config_fingerprint=_config_fingerprint(),
        torch_version=torch.__version__,
        peak_tflops_per_device=(tel._peak / 1e12) if tel._peak else None,
        out_dir=str(out_dir),
        pid=os.getpid(),
    )
    resilience.register_preemption_hook(tel.commit)
    return tel


def end_run(*, best_acc1: float = 0.0, epochs: int = 0, clean: bool = True) -> None:
    """Write ``run_end`` (with the run's resilience totals) and close the
    journal. Idempotent; the trainer calls it on every way out."""
    tel = _CURRENT
    if not tel.enabled:
        set_current(_NULL)
        return
    from distribuuuu_tpu_torch import resilience

    run = MonitoringBridge.delta(tel.bridge.snapshot(), tel._run_mark)
    tel.event("counters", scope="run", counters=run["counters"], durations=run["durations"],
              waits=dict(tel._waits))
    tel.event(
        "run_end",
        best_acc1=float(best_acc1),
        epochs=int(epochs),
        wall_s=round(time.time() - tel._run_tic, 3),
        goodput=round(tel.goodput(), 6),
        total_skipped=int(sum(resilience.RUN_STATS.skipped_steps.values())),
        clean=bool(clean),
    )
    tel.close()
    # a later run registers its own hook; dead ones must not pile up
    resilience.unregister_preemption_hook(tel.commit)
    set_current(_NULL)
