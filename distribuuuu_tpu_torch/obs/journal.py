"""Crash-safe JSONL metrics journal and its record schema (counterpart of ``obs/journal.py``).

The journal is the machine-readable counterpart of the rank-0 progress log:
one JSON object a line, one line a telemetry event (PRINT_FREQ window,
epoch summary, eval, checkpoint, fault, profile window, ...). A run's whole
observable history greps and parses with nothing but the standard
library's ``json``.

Durability: the file is opened in append mode and flushed after every
record, so a SIGKILL loses at most the line being written (the reader skips
a torn final line instead of failing, and a relaunch drops it before its
first append). ``OBS.FSYNC`` adds an ``os.fsync`` a record; :meth:`Journal.commit`
(flush + fsync) is the preemption path's durability point. Local paths
only: a ``gs://`` OUT_DIR is ``runtime/pathio``'s remote half, not ported
(ROADMAP item 13). ``read_journal`` still reassembles ``.part<N>`` continuations, which
the JAX package's supervisors write beside a run's journal.

:class:`ValidatedJournal` is the writer of processes that observe other
work (a serving replica, the dataplane service, the export sidecar): a
record that fails validation is dropped with a log line, and a journal that
cannot be opened makes every append a no-op, so observability never stops
serving.

``SCHEMA`` is the JAX package's, kind for kind and field for field (later
slices write its serve, dataplane and fleet kinds), with one change:
``run_start`` requires ``torch_version`` where JAX requires
``jax_version``. ``validate_record`` checks a record's kind, required
fields and types; ``validate_journal`` applies it line by line.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Iterator

from distribuuuu_tpu_torch.logging import logger

# ---------------------------------------------------------------------------
# Schema: kind -> (required fields, optional fields); values are type tuples.
# Extra fields are allowed (forward compatibility); unknown kinds are not.
# ---------------------------------------------------------------------------

_NUM = (int, float)
_NUM_OR_NONE = (int, float, type(None))
_INT = (int,)
_STR = (str,)
_BOOL = (bool,)
_DICT = (dict,)
_LIST = (list,)

SCHEMA: dict[str, tuple[dict[str, tuple], dict[str, tuple]]] = {
    # run lifecycle -------------------------------------------------------
    "run_start": (
        {
            "run_id": _STR,
            "arch": _STR,
            "hosts": _INT,
            "devices": _INT,
            "local_devices": _INT,
            "platform": _STR,
            "device_kind": _STR,
            "global_batch": _INT,
            "config_fingerprint": _STR,
            "torch_version": _STR,
        },
        {"peak_tflops_per_device": _NUM_OR_NONE, "out_dir": _STR},
    ),
    "run_end": (
        {"best_acc1": _NUM, "wall_s": _NUM, "goodput": _NUM, "total_skipped": _INT,
         "clean": _BOOL},
        {"epochs": _INT},
    ),
    # training ------------------------------------------------------------
    "window": (
        {
            "epoch": _INT,
            "step": _INT,
            "gstep": _INT,
            "steps": _INT,
            "skipped": _INT,
            "lr": _NUM,
            "step_time": _NUM,
            "data_time": _NUM,
            "imgs_per_sec": _NUM,
            "goodput": _NUM,
            "warmup": _BOOL,
        },
        {
            "loss": _NUM_OR_NONE,
            "acc1": _NUM_OR_NONE,
            "acck": _NUM_OR_NONE,
            "mfu": _NUM_OR_NONE,
            "flops_per_step": _NUM_OR_NONE,
            "step_time_p50": _NUM,
            "step_time_p90": _NUM,
            "step_time_max": _NUM,
            # producer-starvation time / window wall: how much of this
            # window the step loop spent blocked on the input pipeline
            # (the data-wait alarm's signal)
            "data_wait_frac": _NUM,
        },
    ),
    "epoch_train": (
        {"epoch": _INT, "steps": _INT, "skipped": _INT, "wall_s": _NUM,
         "imgs_per_sec": _NUM, "goodput": _NUM},
        {},
    ),
    "eval": (
        {"acc1": _NUM, "acck": _NUM, "wall_s": _NUM, "samples": _NUM},
        {"epoch": (int, type(None)), "loss": _NUM_OR_NONE},
    ),
    # checkpoints / resume ------------------------------------------------
    "checkpoint": (
        {"ckpt_kind": _STR, "path": _STR, "wall_s": _NUM, "synchronous": _BOOL},
        {"epoch": _INT, "step": _INT},
    ),
    "restore": ({"path": _STR, "wall_s": _NUM}, {}),
    "resume": (
        {"path": _STR, "epoch": _INT, "step": _INT, "best_acc1": _NUM},
        {},
    ),
    # integrity manifest written for a committed checkpoint
    "manifest": (
        {"path": _STR, "files": _INT, "bytes": _INT, "wall_s": _NUM},
        {},
    ),
    # a resume candidate was skipped (failed restore / elastic mismatch)
    "ckpt_skipped": ({"path": _STR, "reason": _STR}, {"error": _STR}),
    # a resume candidate failed integrity verification and was moved aside
    "ckpt_quarantined": (
        {"path": _STR, "quarantine_path": _STR},
        {"errors": _LIST},
    ),
    # a mid-epoch resume position was remapped onto a new topology
    "elastic_resume": (
        {
            "path": _STR,
            "global_samples": _INT,
            "saved_step": _INT,
            "saved_samples_per_step": _INT,
            "step": _INT,
            "samples_per_step": _INT,
        },
        {"saved_devices": _INT},
    ),
    # resilience ----------------------------------------------------------
    "preempt": ({"epoch": _INT, "step": _INT, "path": _STR}, {}),
    "fault_skipped_steps": ({"epoch": _INT, "count": _INT}, {}),
    "fault_abort": ({"epoch": _INT, "step": _INT, "consecutive": _INT}, {}),
    # the watchdog detected a stalled step loop (dead peer / wedged rank):
    # written (and committed) just before the process hard-exits
    "hang": (
        {"timeout_s": _NUM, "stalled_s": _NUM, "phase": _STR},
        {"gstep": _NUM_OR_NONE},
    ),
    # supervision (dtpu-agent) --------------------------------------------
    # the agent took over this OUT_DIR: one per `python -m distribuuuu_tpu.agent`
    # (fleet-managed host agents add their ``host`` slot to every record and
    # journal into their own .part<2000+host> continuation)
    "supervisor_start": (
        {"nprocs": _INT, "max_restarts": _INT},
        {"cmd": _STR, "out_dir": _STR, "restart_window_s": _NUM, "host": _INT},
    ),
    # one preflight gate evaluation (before every launch/relaunch); a failed
    # gate lists which checks failed and counts against the restart budget
    "supervisor_preflight": (
        {"attempt": _INT, "ok": _BOOL},
        {
            "failures": _LIST,
            "checks": _DICT,
            "wall_s": _NUM,
            "replica": _INT,
            "host": _INT,
        },
    ),
    # a worker fleet was launched (attempt is 1-based across the whole
    # supervision, rollback is the resume depth the fleet was launched at)
    "supervisor_launch": (
        {"attempt": _INT, "nprocs": _INT},
        {"rollback": _INT, "port": _INT, "cmd": _STR, "replica": _INT, "host": _INT},
    ),
    # a fleet finished one way or another: per-rank exit codes + the merged
    # classification (resilience.classify_exit_code, worst rank wins)
    "supervisor_exit": (
        {"attempt": _INT, "outcome": _STR, "codes": _LIST},
        {"wall_s": _NUM, "heartbeat_kill": _BOOL, "replica": _INT, "host": _INT},
    ),
    # the recovery policy's decision for a non-clean exit: action is
    # restart | rollback | give_up | preempt_exit, with the parameters the
    # next attempt will use
    "supervisor_recovery": (
        {"attempt": _INT, "outcome": _STR, "action": _STR},
        {
            "backoff_s": _NUM,
            "rollback": _INT,
            "restarts_in_window": _INT,
            "reason": _STR,
            "replica": _INT,
            "host": _INT,
        },
    ),
    # the agent's final word: verdict is clean | gave_up | preempted (a
    # fleet-managed host agent reports its single attempt's merged outcome),
    # with the whole supervision's totals — the record tests and operators
    # gate on
    "supervisor_verdict": (
        {"verdict": _STR, "attempts": _INT, "restarts": _INT},
        {"rollbacks": _INT, "reason": _STR, "wall_s": _NUM, "host": _INT},
    ),
    # fleet orchestration (dtpu-fleet, docs/FAULT_TOLERANCE.md "Fleet runs");
    # all written by the controller into its .part<3000> continuation -------
    # the controller took over this pool: one per `dtpu-fleet` invocation
    "fleet_start": (
        {"hosts": _INT, "nprocs_per_host": _INT, "jobs": _INT},
        {"job_id": _STR, "out_dir": _STR, "rdzv": _STR, "max_gang_restarts": _INT},
    ),
    # a gang was formed and launched: which host slots, at what world size,
    # under which fleet epoch and derived rendezvous port
    "fleet_launch": (
        {"job": _STR, "fleet_epoch": _INT, "attempt": _INT, "hosts": _LIST,
         "world_size": _INT},
        {"port": _INT, "rollback": _INT},
    ),
    # one host's fleet-managed agent exited (outcome per the exit taxonomy)
    "fleet_host_exit": (
        {"job": _STR, "fleet_epoch": _INT, "host": _INT, "outcome": _STR},
        {"code": _INT, "wall_s": _NUM},
    ),
    # the controller declared a fleet-level failure for the running gang
    # (whole-host death, gang-wide hang, ...) and will re-form it
    "fleet_failure": (
        {"job": _STR, "fleet_epoch": _INT, "outcome": _STR},
        {"dead_hosts": _LIST, "codes": _LIST},
    ),
    # a cooperative gang resize: reason is host_failure (shrink) or rejoin
    # (a healed host returns; survivors checkpoint-and-exit at the agreed
    # step and the gang relaunches at the new size)
    "fleet_resize": (
        {"job": _STR, "from_epoch": _INT, "to_epoch": _INT, "from_hosts": _INT,
         "to_hosts": _INT, "reason": _STR},
        {},
    ),
    # the multi-job queue preempted a running job for a higher-priority one
    # (bounded drain: announce -> checkpoint-and-exit -> SIGTERM -> SIGKILL)
    "fleet_preempt": (
        {"job": _STR, "by": _STR},
        {"priority": _NUM, "by_priority": _NUM, "drain_s": _NUM},
    ),
    # the gang recovery policy's decision for a non-clean gang outcome
    "fleet_recovery": (
        {"job": _STR, "fleet_epoch": _INT, "outcome": _STR, "action": _STR},
        {"backoff_s": _NUM, "rollback": _INT, "restarts_in_window": _INT,
         "reason": _STR},
    ),
    # one job's final word: verdict is clean | gave_up | preempted
    "fleet_verdict": (
        {"job": _STR, "verdict": _STR, "attempts": _INT},
        {"gang_restarts": _INT, "resizes": _INT, "rollbacks": _INT,
         "reason": _STR, "wall_s": _NUM},
    ),
    # dataplane (dtpu-dataplane, docs/DATA.md); service records land in the
    # .part<3500> continuation, dataplane_fallback in the CLIENT's journal --
    # the service came up: dispatcher address + worker pool shape
    "dataplane_start": (
        {"address": _STR, "workers": _INT},
        {"worker_threads": _INT, "cache_bytes": _INT, "in_process": _BOOL},
    ),
    # a sample stream was registered (one per (spec, epoch) — NOT per client:
    # equal specs share one stream, which is the decode-once story)
    "dataplane_stream": (
        {"stream": _INT, "root": _STR, "train": _BOOL, "epoch": _INT,
         "num_batches": _INT},
        {"start_batch": _INT},
    ),
    # a lease recovery event: a worker died/stalled and its batch re-issued
    # (the typed record the chaos tier's zero-lost-samples proof greps for)
    "dataplane_lease": (
        {"stream": _INT, "batch": _INT, "event": _STR},
        {"worker": _STR},
    ),
    # cache/lease rollup (periodic + at stream close): hits/misses count
    # decodes saved/paid, evictions the LRU pressure
    "dataplane_cache": (
        {"hits": _INT, "misses": _INT, "evictions": _INT, "bytes": _INT},
        {"entries": _INT, "stream": _INT, "streams": _INT, "reissues": _INT},
    ),
    # a decode worker process exited (the service restarts it internally)
    "dataplane_worker_exit": (
        {"worker": _STR, "code": _INT},
        {"restarts": _INT},
    ),
    # a CLIENT degraded to local decode (dispatcher unreachable): the stream
    # continues bitwise-identically from `batch`; written by the trainer's
    # telemetry, so it lands in the main journal next to the run it slowed
    "dataplane_fallback": (
        {"reason": _STR, "epoch": _INT, "batch": _INT},
        {"error": _STR},
    ),
    # serving (dtpu-serve, docs/SERVING.md) -------------------------------
    # a serve replica came up: hosted models, compiled batch ladder, bind
    "serve_start": (
        {"models": _LIST, "batch_sizes": _LIST, "port": _INT, "replica": _INT},
        {"host": _STR, "aot_compiles": _INT, "warmup_s": _NUM, "input_dtype": _STR},
    ),
    # one served request (SERVE.JOURNAL_REQUESTS; the slo rollup is always on)
    "serve_request": (
        {"model": _STR, "n": _INT, "latency_ms": _NUM, "ok": _BOOL},
        {"queue_ms": _NUM, "trace_id": _STR},
    ),
    # one dispatched micro-batch: examples packed, compiled size chosen,
    # fill = examples/batch_size (the padding waste the ladder sizing tunes)
    "serve_batch": (
        {
            "model": _STR,
            "batch_size": _INT,
            "examples": _INT,
            "requests": _INT,
            "fill": _NUM,
            "queue_ms": _NUM,
            "compute_ms": _NUM,
        },
        # version "canary" marks batches the deploy rollout routed to the
        # staged model (serve/deploy.py); absent = the serving version
        {"version": _STR},
    ),
    # periodic per-model SLO rollup: latency percentiles, throughput, sheds,
    # and the batch-fill histogram (compiled size -> dispatch count)
    "serve_slo": (
        {
            "model": _STR,
            "window_s": _NUM,
            "requests": _INT,
            "shed": _INT,
            "qps": _NUM,
            "p50_ms": _NUM,
            "p99_ms": _NUM,
        },
        {"examples": _INT, "mean_fill": _NUM, "fill_hist": _DICT,
         "batches": _INT, "queue_depth": _INT, "replica": _INT},
    ),
    # backpressure: a request was shed at the bounded queue (never silent)
    "serve_shed": (
        {"model": _STR, "depth": _INT, "max_depth": _INT},
        {"n": _INT},
    ),
    # one (model, batch-size) AOT ladder compile at engine load: wall_s is
    # the lower+compile time (a persistent-cache hit shows up as a near-zero
    # wall — the warm-vs-cold serving startup number)
    "serve_compile": (
        {"model": _STR, "batch_size": _INT, "wall_s": _NUM},
        {"quant": _STR},
    ),
    # global ingress router (dtpu-ingress, serve/ingress.py; docs/SERVING.md
    # "Global ingress"). The router is a supervisory writer — its records
    # land on the .part<5000+instance> continuation. ------------------------
    # router came up: bound port, the pool map it will probe, and which
    # side of the active/standby pair this process started as
    "ingress_start": (
        {"port": _INT, "pools": _DICT, "role": _STR},
        {"instance": _INT, "tenants": _INT, "host": _STR},
    ),
    # one routed request (SERVE.INGRESS.JOURNAL_REQUESTS): which pool and
    # replica served it, end-to-end latency as the router saw it, whether
    # it left the home pool (spilled), and how many upstream attempts it
    # took. The per-tenant p99 the isolation guarantee is audited from.
    "ingress_route": (
        {"model": _STR, "pool": _STR, "replica": _STR, "n": _INT,
         "latency_ms": _NUM, "ok": _BOOL},
        {"tenant": _STR, "attempts": _INT, "spilled": _BOOL,
         "trace_id": _STR, "status": _INT},
    ),
    # the router refused a request: reason is quota (tenant token bucket
    # empty) | fair_share (saturated router, tenant over its weighted
    # share) | saturated (every pool shed; retry_after_s carries the
    # LARGEST surviving pool's drain estimate) | no_replica (every pool
    # dark) | standby (this router does not hold the lease)
    "ingress_shed": (
        {"reason": _STR},
        {"model": _STR, "tenant": _STR, "retry_after_s": _NUM,
         "pools_tried": _INT, "n": _INT, "trace_id": _STR},
    ),
    # per-tenant admission rollup every SERVE.INGRESS.ROLLUP_S
    "ingress_tenant": (
        {"tenant": _STR, "window_s": _NUM, "requests": _INT, "shed": _INT},
        {"examples": _INT, "qps": _NUM, "p50_ms": _NUM, "p99_ms": _NUM,
         "quota_rps": _NUM},
    ),
    # role transitions of the active/standby pair (and the fleet sidecar's
    # restart bookkeeping): action is start | promote (took the lease) |
    # demote (lost the lease to a peer; the process exits DEMOTED) |
    # restart | gave_up (sidecar restart budget exhausted)
    "ingress_failover": (
        {"action": _STR},
        {"role": _STR, "holder": _STR, "instance": _INT,
         "lease_age_s": _NUM, "code": _INT, "restarts": _INT,
         "wall_s": _NUM},
    ),
    # discovery transitions: event is join (first healthy probe) |
    # quarantine (probe failed; cooldown + re-probe) | rejoin (came back
    # after quarantine) | eject (alive but unready — version swap in
    # flight) | ready (readiness restored)
    "ingress_replica": (
        {"pool": _STR, "replica": _STR, "event": _STR},
        {"healthy_n": _INT, "detail": _STR},
    ),
    # the int8 quality gate's measurement vs the fp32 engine on fixture
    # inputs (quant/gate.py): passed False means the model REFUSED to serve
    "quant_quality": (
        {
            "model": _STR,
            "mode": _STR,
            "top1_agree": _NUM,
            "logit_rmse": _NUM,
            "passed": _BOOL,
        },
        {
            "n": _INT,
            "min_top1_agree": _NUM,
            "max_logit_rmse": _NUM,
            "calib_batches": _INT,
            "layers": _INT,
            "folded_bn": _INT,
            "wall_s": _NUM,
        },
    ),
    # continuous deployment (dtpu-deploy, serve/deploy.py; docs/SERVING.md
    # "Continuous deployment") ----------------------------------------------
    # the watcher judged one checkpoint dir: action is candidate (accepted,
    # a rollout begins) | held (no integrity manifest yet — a dir appearing
    # mid-write; retried next poll) | corrupt (manifest verify failed; the
    # watcher never quarantines someone else's artifacts) | struck_out
    # (strike count exhausted by earlier rollbacks) | lease_wait (another
    # replica's rollout holds the rolling lease). Checkpoints at or below
    # the serving version are steady state — never an event.
    "deploy_watch": (
        {"model": _STR, "path": _STR, "action": _STR},
        {"reason": _STR, "epoch": _INT, "step": _INT, "strikes": _INT,
         "replica": _INT},
    ),
    # the incoming version was loaded and AOT-compiled alongside the
    # incumbent (which kept serving throughout): wall_s is the whole
    # load+compile, each ladder entry's compile also landed as its own
    # serve_compile record
    "deploy_stage": (
        {"model": _STR, "path": _STR, "wall_s": _NUM},
        {"epoch": _INT, "step": _INT, "aot_compiles": _INT,
         "manifest_hash": _STR, "replica": _INT},
    ),
    # the canary verdict: the staged version served `fraction` of live
    # traffic and its SLO + the golden-fixture quality delta were gated
    # against the incumbent (passed False -> a deploy_rollback follows)
    "deploy_canary": (
        {"model": _STR, "path": _STR, "fraction": _NUM, "passed": _BOOL},
        {"requests": _INT, "p99_ms": _NUM, "incumbent_p99_ms": _NUM,
         "top1_agree": _NUM, "logit_rmse": _NUM, "reason": _STR,
         "wall_s": _NUM, "replica": _INT},
    ),
    # the staged version became the serving version; the old version's
    # executables and weights were dropped (HBM freed). fast_follow means
    # the canary was skipped because a peer replica already promoted this
    # exact checkpoint (the fleet-convergence path)
    "deploy_promote": (
        {"model": _STR, "path": _STR},
        {"epoch": _INT, "step": _INT, "wall_s": _NUM, "manifest_hash": _STR,
         "fast_follow": _BOOL, "replica": _INT},
    ),
    # a failing canary was demoted: the incumbent never stopped serving,
    # the checkpoint's strike count was bumped (and persisted), and at
    # MAX_STRIKES the watcher never tries the checkpoint again
    "deploy_rollback": (
        {"model": _STR, "path": _STR, "reason": _STR},
        {"strikes": _INT, "epoch": _INT, "step": _INT, "replica": _INT},
    ),
    # quantization-aware fine-tune (quant/qat.py, QUANT.QAT): the trainer
    # calibrated the fake-quant sites and every subsequent train/eval
    # forward runs the straight-through-estimator interception
    "qat": (
        {"mode": _STR, "layers": _INT, "calib_batches": _INT},
        {"distill": _NUM, "wall_s": _NUM, "im_size": _INT},
    ),
    # tracing (dtpu-obs v2, obs/trace.py) ---------------------------------
    # one timed phase of a traced request or train window, keyed by the
    # trace id that ties the phases together: serve requests carry the
    # client-minted ``x-dtpu-trace-id`` through frontend -> batcher ->
    # engine (phases queue_wait / pad / execute / total); train windows
    # mint ``train-<run>-g<gstep>`` ids (phases data_wait / compute) and
    # checkpoint dispatches ``train-<run>-ck<epoch>`` (phase checkpoint)
    "span": (
        {"trace_id": _STR, "phase": _STR, "ms": _NUM},
        {
            "model": _STR,
            "n": _INT,
            "batch_size": _INT,
            "requests": _INT,
            "gstep": _INT,
            "epoch": _INT,
            "ok": _BOOL,
        },
    ),
    # alarms (dtpu-obs v2, obs/alarms.py): a declarative rule (OBS.ALARMS)
    # crossed its threshold for the configured hysteresis window...
    "alarm": (
        {"rule": _STR, "metric": _STR, "value": _NUM, "threshold": _NUM,
         "op": _STR},
        {"model": _STR, "windows": _INT},
    ),
    # ... and recovered (active_s = how long the alarm was firing)
    "alarm_clear": (
        {"rule": _STR, "metric": _STR, "value": _NUM, "threshold": _NUM},
        {"model": _STR, "active_s": _NUM},
    ),
    # the fleet controller's registered alarm hook: the same transition,
    # journaled from the controller's part (state is fire|clear) — the
    # trigger record the FLEET.AUTOSCALE policy acts on (fleet_autoscale.py)
    "fleet_alarm": (
        {"rule": _STR, "metric": _STR, "value": _NUM, "threshold": _NUM,
         "state": _STR},
        {"model": _STR, "job": _STR},
    ),
    # one autoscale decision (fleet_autoscale.py; docs/FAULT_TOLERANCE.md
    # "Autoscaled fleets"): resource is serve_replicas | train_jobs |
    # data_workers; action is up | down | preempt | resume for policy
    # decisions and "applied" when the actuator (the dtpu-agent serving
    # mode) reports the capacity change landed (readiness-gated for ups —
    # to_n replicas answering /healthz ready). warm_pool counts drained
    # slots still holding the persistent compile cache; seq ties an
    # "applied" record back to the decision that requested it; wall_s on
    # an "applied" record is the measured bring-up/drain time.
    "fleet_scale": (
        {"resource": _STR, "action": _STR, "from_n": _INT, "to_n": _INT,
         "reason": _STR},
        {"model": _STR, "job": _STR, "rule": _STR, "metric": _STR,
         "value": _NUM, "warm_pool": _INT, "cooldown_s": _NUM, "seq": _INT,
         "wall_s": _NUM},
    ),
    # counters / memory / profiler ---------------------------------------
    "counters": (
        {"scope": _STR, "counters": _DICT, "durations": _DICT, "waits": _DICT},
        {"epoch": _INT},
    ),
    "memory": (
        {"epoch": _INT, "live_arrays": _INT, "live_bytes": _INT},
        {"per_device": (dict, type(None))},
    ),
    # per-device train-state byte census (params/opt/BN, measured from
    # addressable shards — obs/memory.state_bytes): the journaled proof that
    # fsdp=N keeps ~1/N of params+optimizer state per chip
    "state_bytes": (
        {
            "fsdp": _INT,
            "devices": _INT,
            "params_bytes": _INT,
            "opt_bytes": _INT,
            "bn_bytes": _INT,
            "total_bytes": _INT,
        },
        {
            "params_global_bytes": _INT,
            "opt_global_bytes": _INT,
            "bn_global_bytes": _INT,
        },
    ),
    # per-device encoder activation-byte census (priced from token geometry
    # — obs/memory.activation_bytes): the journaled 1/seq claim for the
    # sequence-parallel axis, the activation twin of state_bytes
    "activation_bytes": (
        {
            "seq": _INT,
            "l_global": _INT,
            "l_local": _INT,
            "depth": _INT,
            "dim": _INT,
            "batch_per_device": _INT,
            "token_bytes": _INT,
            "token_global_bytes": _INT,
        },
        {},
    ),
    "profile": (
        {"gstep": _INT, "steps": _INT, "logdir": _STR},
        {"device_ms_per_step": _NUM_OR_NONE, "top_ops": _LIST, "trigger": _STR},
    ),
    # one measured kernel verdict entering the perfdb registry
    # (obs/perfdb.record_verdict): `transition` records whether this
    # measurement flipped/unflipped the routing default for its
    # (device_kind, kernel_family, shape_class) key
    "kernel_verdict": (
        {
            "kernel_family": _STR,
            "device_kind": _STR,
            "shape_class": _STR,
            "speedup": _NUM,
            "flip": _BOOL,
            "source": _STR,
        },
        {
            "fused_ms": _NUM,
            "baseline_ms": _NUM,
            "interpret": _BOOL,
            "transition": _STR,
            "block": _INT,
            "numerics": _STR,
        },
    ),
    # step time folded into matmul/vector/collective/infeed/host buckets
    # (obs/attribution) — the profiler's per-op table as standing roofline
    # telemetry, written beside each `profile` record
    "step_attribution": (
        {"steps": _INT, "device_ms_per_step": _NUM_OR_NONE, "buckets": _DICT},
        {
            "logdir": _STR,
            "gstep": _INT,
            "matmul_pct": _NUM_OR_NONE,
            "device_kind": _STR,
            "ceiling_tflops": _NUM_OR_NONE,
            "host_ms": _NUM,
            "trigger": _STR,
        },
    ),
}


def validate_record(record: Any) -> list[str]:
    """Schema errors for one decoded journal record ([] when valid)."""
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, not an object"]
    errors: list[str] = []
    kind = record.get("kind")
    if not isinstance(kind, str):
        return ["missing/invalid 'kind'"]
    if not isinstance(record.get("ts"), (int, float)):
        errors.append(f"{kind}: missing/invalid 'ts'")
    spec = SCHEMA.get(kind)
    if spec is None:
        return errors + [f"unknown record kind {kind!r}"]
    required, optional = spec
    for field, types in required.items():
        if field not in record:
            errors.append(f"{kind}: missing required field {field!r}")
        elif not isinstance(record[field], types) or (
            # bool is an int subclass; an int-typed field must not accept it
            isinstance(record[field], bool) and bool not in types
        ):
            errors.append(
                f"{kind}: field {field!r} is {type(record[field]).__name__}, "
                f"expected {'/'.join(t.__name__ for t in types)}"
            )
    for field, types in optional.items():
        if field in record and (
            not isinstance(record[field], types)
            or (isinstance(record[field], bool) and bool not in types)
        ):
            errors.append(
                f"{kind}: field {field!r} is {type(record[field]).__name__}, "
                f"expected {'/'.join(t.__name__ for t in types)}"
            )
    return errors


def _journal_parts(path: str) -> list[str]:
    """The journal file plus any ``.part<N>`` continuations, in write order.
    Suffixes may nest (``.part2001.part1``): each dot-separated number chain
    sorts as a tuple, so nested continuations read back right after their
    base part."""
    parent, name = os.path.split(str(path))
    try:
        siblings = os.listdir(parent or ".")
    except OSError:
        siblings = []
    parts = []
    for f in siblings:
        if f.startswith(name + ".part"):
            nums = f[len(name) + 5:].split(".part")
            if all(s.isdigit() for s in nums):
                parts.append((tuple(int(s) for s in nums), os.path.join(parent, f)))
    return [str(path)] + [p for _, p in sorted(parts)]


def read_journal(path: str, *, strict: bool = False) -> Iterator[dict]:
    """Yield decoded records from a journal (and its continuations).

    A torn final line of any part is skipped unless ``strict``: a crash can
    tear the last part's tail. Any other undecodable line raises: that is
    corruption, not tearing. A missing main file is tolerated when
    ``.part<N>`` continuations exist; with neither, FileNotFoundError."""
    parts = _journal_parts(path)
    if len(parts) > 1 and not os.path.exists(parts[0]):
        parts = parts[1:]
    for part_path in parts:
        with open(part_path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                if strict or i != len(lines) - 1:
                    raise
                continue  # torn part tail: tolerated
            yield record


def validate_journal(path: str) -> list[str]:
    """All schema errors across a journal, prefixed with the record index."""
    errors: list[str] = []
    n = 0
    try:
        for i, rec in enumerate(read_journal(path)):
            n += 1
            errors.extend(f"record {i}: {e}" for e in validate_record(rec))
    except (OSError, json.JSONDecodeError) as exc:
        return [f"unreadable journal {path}: {exc!r}"]
    if n == 0:
        errors.append(f"journal {path} contains no records")
    return errors


def _jsonable(value: Any) -> Any:
    """Plain JSON types from numpy/torch scalars and tuples (telemetry is fed
    host values only; a 0-d tensor's ``item()`` would be a device sync)."""
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, bool, int, float, type(None))):
        return value
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(value)


def _truncate_torn_tail(path: str) -> None:
    """Drop a partial trailing line (no final newline) from a journal.

    The torn record is lost already (a crash interrupted its write), and
    ``read_journal`` tolerates it only while it stays the last line; once a
    relaunch appended after it the journal would stop parsing. A backward
    chunked scan, so healing a large journal costs O(torn line)."""
    try:
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            pos = size
            while pos > 0:
                chunk = min(65536, pos)
                f.seek(pos - chunk)
                data = f.read(chunk)
                nl = data.rfind(b"\n")
                if nl >= 0:
                    f.truncate(pos - chunk + nl + 1)
                    return
                pos -= chunk
            f.truncate(0)  # the whole file is one torn line
    except OSError:
        pass  # nothing to heal: append still works


class Journal:
    """Append-only JSONL writer with the durability contract above."""

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = str(path)
        self._fsync = fsync
        # an RLock: commit() runs as a preemption hook, possibly inside a
        # signal handler that interrupted this thread mid-append(); a plain
        # Lock would deadlock (at worst the in-flight line tears, which
        # read_journal tolerates at a tail)
        self._lock = threading.RLock()
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # a previous launch may have died mid-append: drop its partial line
        # before appending, or this run's first record would glue onto it
        _truncate_torn_tail(self.path)
        self._f = open(self.path, "a")

    def append(self, record: dict) -> None:
        line = json.dumps(_jsonable(record), separators=(",", ":"))
        with self._lock:
            if self._f is None:
                return  # closed (end of run): late events are dropped
            self._f.write(line + "\n")
            self._f.flush()
            if self._fsync:
                try:
                    os.fsync(self._f.fileno())
                except (OSError, io.UnsupportedOperation):
                    pass

    def commit(self) -> None:
        """Make everything appended so far durable (flush + fsync): the
        preemption path's barrier, where the process may be killed before
        ``atexit``."""
        with self._lock:
            if self._f is None:
                return
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except (OSError, io.UnsupportedOperation):
                pass

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class ValidatedJournal:
    """Schema-validated appends that degrade to a no-op on any failure.

    ``path=None`` (given, or after the file could not be opened) means
    degraded: :meth:`event` does nothing. An invalid record is logged and
    dropped; an append that fails is logged. Thread-safe through
    :class:`Journal`'s lock.
    """

    def __init__(self, path: str | None, *, label: str = "journal"):
        self.path: str | None = None
        self._label = label
        self._journal: Journal | None = None
        if path is None:
            return
        try:
            self._journal = Journal(str(path))
            self.path = str(path)
        except OSError as exc:
            logger.warning(f"{label} unavailable: {exc!r}")

    def event(self, kind: str, **fields: Any) -> None:
        if self._journal is None:
            return
        record = {"ts": time.time(), "kind": kind, **fields}
        errors = validate_record(record)
        if errors:
            logger.error(f"{self._label}: invalid {kind!r} record dropped: {errors}")
            return
        try:
            self._journal.append(record)
        except (OSError, ValueError) as exc:
            logger.warning(f"{self._label} append failed: {exc!r}")

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None
