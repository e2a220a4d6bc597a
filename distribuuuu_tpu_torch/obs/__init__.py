"""The training run's telemetry (counterpart of the JAX package's ``obs/``).

- **Journal** (``obs.journal``): crash-safe rank-0 JSONL, one typed record
  a PRINT_FREQ window, epoch, eval, checkpoint, fault event or profile
  window, validated against the JAX package's schema.
- **Telemetry core** (``obs.telemetry``): the `Telemetry` handle the
  trainer, the checkpoints, the loaders and the watchdog report through;
  ``current()`` is inert outside a run, so instrumentation is
  unconditional.
- **Counters** (``obs.monitors``): the kernels' launch counters and the
  nvcc builds, journaled a epoch.
- **MFU and goodput** (``obs.flops`` + telemetry): FlopCounterMode's count
  of the step on the meta device against the card's peak; productive time
  over elapsed time.
- **Memory** (``obs.memory``): the train-state byte census and the
  allocator's counters a epoch.
- **Profiler windows** (``obs.profiler``, ``obs.traceparse``,
  ``obs.attribution``): config- and SIGUSR1-driven ``torch.profiler``
  captures, the per-kernel table and the step attribution journaled.
- **Live plane** (``obs.stream``, ``obs.alarms``, ``obs.exporter``): the
  incremental journal tailer, the record -> gauge fold, the ``OBS.ALARMS``
  engine and the Prometheus ``/metrics`` text, which the serving replica,
  the dataplane service and the export sidecar serve. ``ValidatedJournal``
  (``obs.journal``) is their writer.
- **CLI** (``obs.__main__``): ``python -m distribuuuu_tpu_torch.obs
  summarize|validate|export``.
"""

from distribuuuu_tpu_torch.obs.journal import (  # noqa: F401
    Journal,
    ValidatedJournal,
    read_journal,
    validate_journal,
    validate_record,
)
from distribuuuu_tpu_torch.obs.memory import activation_bytes, state_bytes  # noqa: F401
from distribuuuu_tpu_torch.obs.monitors import MonitoringBridge  # noqa: F401
from distribuuuu_tpu_torch.obs.profiler import (  # noqa: F401
    ProfilerWindows,
    install_sigusr1_handler,
    request_profile,
)
from distribuuuu_tpu_torch.obs.telemetry import (  # noqa: F401
    NullTelemetry,
    Telemetry,
    current,
    end_run,
    journal_path,
    set_current,
    start_run,
)
