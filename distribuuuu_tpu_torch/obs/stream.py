"""Streaming journal aggregation: the live half of the telemetry (counterpart of ``obs/stream.py``).

``read_journal`` re-reads every byte on every call. The live plane needs
the same record stream incrementally: :class:`JournalTailer` keeps a byte
cursor per journal part (the main file and every ``.part<N>``
continuation, nested suffixes included), and each :meth:`JournalTailer.poll`
parses only the bytes appended since the last one. A torn tail (a record
whose newline has not landed: a writer mid-append, or a crash) is held, not
skipped: the cursor stays at the last complete line, so a slow append is
delivered once when it completes and a crash-torn line never is. A complete
line that does not decode is corruption: counted and skipped. Paths are
local only; a ``gs://`` journal is ``runtime/pathio``, ROADMAP Queue 1
item 13.

:class:`LiveAggregator` folds the record stream into current-state gauges
(goodput, MFU, step time, data-wait share, per-model p50/p99/QPS/queue
depth, per-host attempts) and monotonic counters (steps, skips, sheds,
restarts, alarms). The fold is a pure function of each record, kind for
kind the JAX package's, so it gives JAX's snapshot on any journal, fed by a
tailer (the export sidecar, the dataplane's plane) or inline at append time
(the serving frontend, which must not tail its own open file).
``snapshot()`` is what the Prometheus exporter renders and the alarm
engine evaluates.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Iterable

from distribuuuu_tpu_torch.obs.journal import _journal_parts


class JournalTailer:
    """Incremental reader over a journal and its part continuations."""

    #: per-part byte budget a poll: a plane started late in a long run
    #: catches up over several polls at flat memory instead of reading a
    #: multi-GB remainder at once
    READ_LIMIT = 8 * 1024 * 1024

    def __init__(self, path: str):
        self.path = str(path)
        if "://" in self.path:
            raise NotImplementedError(
                f"tailing the remote journal {self.path} is runtime/pathio's remote half, not ported "
                f"(ROADMAP Queue 1 item 13)")
        self._cursors: dict[str, int] = {}
        self.bytes_read = 0  # committed (consumed) bytes
        self.decode_errors = 0

    def _read_from(self, part: str, offset: int) -> bytes:
        with open(part, "rb") as f:
            f.seek(offset)
            return f.read(self.READ_LIMIT)

    def poll(self) -> list[dict]:
        """Every record fully appended since the last poll, in write order."""
        records: list[dict] = []
        for part in _journal_parts(self.path):
            cursor = self._cursors.get(part, 0)
            try:
                data = self._read_from(part, cursor)
            except OSError:
                continue  # part gone or not yet created: retry next poll
            if not data:
                continue
            # consume complete lines only; a trailing fragment stays
            # unconsumed (the cursor holds) until its newline arrives
            end = data.rfind(b"\n")
            if end < 0:
                if len(data) >= self.READ_LIMIT:
                    # a "line" longer than the whole read budget is
                    # corruption, not a slow append: drop it, or the
                    # cursor wedges here
                    self._cursors[part] = cursor + len(data)
                    self.decode_errors += 1
                continue
            committed = data[: end + 1]
            self._cursors[part] = cursor + len(committed)
            self.bytes_read += len(committed)
            for line in committed.splitlines():
                if not line.strip():
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    self.decode_errors += 1  # a complete undecodable line
        return records


class LiveAggregator:
    """Fold journal records into current-state gauges and counters.

    Thread-safe (`ingest` may run on a journal-append path while an HTTP
    handler snapshots). All state is plain host floats/ints — folding a
    record is O(fields), snapshotting is a dict copy.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.gauges: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        # per-metric update COUNT: incremented when a record actually sets
        # that metric (labelled metrics per label), so the alarm engine can
        # count hysteresis windows of the METRIC — a span record must not
        # make a 10s-old serve_p99_ms look fresh to a 2s-cadence evaluator,
        # and a catch-up poll folding 10 breaching windows must count as 10
        # windows, not 1 evaluation
        self.metric_gen: dict[str, int] = {}
        # per-model serve gauges/counters: metric -> {model: value}
        self.per_model: dict[str, dict[str, float]] = {}
        # per-host supervision gauges: metric -> {host: value}
        self.per_host: dict[str, dict[str, float]] = {}
        # per-phase span aggregates
        self.per_phase: dict[str, dict[str, float]] = {}
        self.info: dict[str, str] = {}
        self.last_record_ts: float | None = None
        self._skip_streak = 0.0
        self.active_alarms: set[str] = set()

    # -- folding -------------------------------------------------------------

    def _bump_gen(self, key: str) -> None:
        self.metric_gen[key] = self.metric_gen.get(key, 0) + 1

    def _gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)
        self._bump_gen(name)

    def _count(self, name: str, by: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(by)
        self._bump_gen(name)

    def _model(self, metric: str, model: str, value: float) -> None:
        self.per_model.setdefault(metric, {})[str(model)] = float(value)
        # generation is per (metric, LABEL): one model's rollup must not
        # make another model's frozen stale value look like a fresh window
        # to the alarm engine
        self._bump_gen(f"{metric}|{model}")

    def _model_count(self, metric: str, model: str, by: float) -> None:
        d = self.per_model.setdefault(metric, {})
        d[str(model)] = d.get(str(model), 0.0) + float(by)
        self._bump_gen(f"{metric}|{model}")

    def ingest_all(self, records: Iterable[dict]) -> None:
        for r in records:
            self.ingest(r)

    def ingest(self, record: dict) -> None:
        if not isinstance(record, dict):
            return
        kind = record.get("kind")
        with self._lock:
            ts = record.get("ts")
            # alarm transitions never count as liveness: the plane WRITES
            # them (sidecar .part4000, controller .part3000) and tails them
            # back in — letting them bump last_record_ts would reset
            # heartbeat_age_s every time heartbeat_stale fires, so the
            # staleness alarm on a dead run would clear itself and flap
            # instead of latching
            if isinstance(ts, (int, float)) and kind not in (
                "alarm", "alarm_clear", "fleet_alarm", "fleet_scale"
            ):
                self.last_record_ts = max(self.last_record_ts or 0.0, float(ts))
            try:
                self._fold(kind, record)
            except (TypeError, ValueError, KeyError):
                # a malformed record (schema drift, hand-edited journal) must
                # never take down the telemetry plane
                self._count("aggregator_fold_errors_total")

    def _fold(self, kind, r: dict) -> None:  # noqa: C901 - one fold per kind
        if kind == "window":
            for key in ("goodput", "step_time", "imgs_per_sec", "lr",
                        "data_wait_frac", "mfu", "epoch", "gstep"):
                if isinstance(r.get(key), (int, float)):
                    self._gauge(key, r[key])
            steps = float(r.get("steps", 0) or 0)
            skipped = float(r.get("skipped", 0) or 0)
            self._count("steps_total", steps)
            self._count("skipped_steps_total", skipped)
            # window-granular streak: only a FULLY-skipped window extends
            # it; a window containing any healthy step rebases to its own
            # skip count (the trailing run can't exceed that), so sporadic
            # one-per-window skips never accumulate into a false page —
            # the trainer's per-step counter is the exact abort authority
            if skipped and skipped >= steps:
                self._skip_streak += skipped
            else:
                self._skip_streak = skipped
            self._gauge("consecutive_skips", self._skip_streak)
        elif kind == "epoch_train":
            self._gauge("epoch", r.get("epoch", 0))
            self._count("epochs_total")
        elif kind == "eval":
            self._gauge("eval_acc1", r.get("acc1", 0.0))
            self._gauge("eval_acck", r.get("acck", 0.0))
        elif kind == "run_start":
            self._count("runs_total")
            for key in ("run_id", "arch", "device_kind", "platform"):
                if r.get(key):
                    self.info[key] = str(r[key])
            if isinstance(r.get("devices"), (int, float)):
                self._gauge("devices", r["devices"])
        elif kind == "run_end":
            self._gauge("run_clean", 1.0 if r.get("clean") else 0.0)
            if isinstance(r.get("goodput"), (int, float)):
                self._gauge("goodput", r["goodput"])
        elif kind == "checkpoint":
            self._count("checkpoints_total")
            if isinstance(r.get("ts"), (int, float)):
                self._gauge("last_checkpoint_ts", r["ts"])
        elif kind in ("resume", "elastic_resume"):
            self._count("resumes_total")
        elif kind == "preempt":
            self._count("preempts_total")
        elif kind == "hang":
            self._count("hangs_total")
        elif kind == "fault_abort":
            self._count("fault_aborts_total")
        elif kind == "serve_slo":
            # label per (model, replica) when the rollup says which replica
            # it came from: a tailing aggregator over N same-model replicas
            # must keep N gauge series, not let the last-ingested window
            # mask a breaching sibling ("model#rN" splits back into
            # model/replica labels at the exporter)
            m = r["model"]
            if isinstance(r.get("replica"), int):
                m = f"{m}#r{r['replica']}"
            for key, metric in (
                ("p50_ms", "serve_p50_ms"),
                ("p99_ms", "serve_p99_ms"),
                ("qps", "serve_qps"),
                ("shed", "serve_shed"),
                ("mean_fill", "serve_mean_fill"),
                ("queue_depth", "serve_queue_depth"),
            ):
                if isinstance(r.get(key), (int, float)):
                    self._model(metric, m, r[key])
            self._model_count("serve_requests_total", m, float(r.get("requests", 0)))
            self._model_count("serve_shed_total", m, float(r.get("shed", 0)))
        elif kind == "serve_batch":
            m = r["model"]
            self._model_count("serve_batches_total", m, 1.0)
            self._model_count("serve_examples_total", m, float(r.get("examples", 0)))
        elif kind == "serve_shed":
            self._model_count("serve_shed_events_total", r["model"], 1.0)
        elif kind == "serve_start":
            self._gauge("serve_replica", r.get("replica", 0))
            self._gauge("serve_models", len(r.get("models", []) or []))
        elif kind == "deploy_watch":
            self._count("deploy_watch_events_total")
        elif kind == "deploy_stage":
            # a rollout is in flight from stage until promote/rollback —
            # the dtpu_deploy_rollout_active gauge an operator's dashboard
            # (and the fleet controller's alarm rules) can key on
            self._count("deploy_stages_total")
            self._model("deploy_rollout_active", r["model"], 1.0)
        elif kind == "deploy_canary":
            self._count("deploy_canaries_total")
            if isinstance(r.get("p99_ms"), (int, float)):
                self._model("deploy_canary_p99_ms", r["model"], r["p99_ms"])
        elif kind == "deploy_promote":
            self._count("deploy_promotes_total")
            self._model("deploy_rollout_active", r["model"], 0.0)
            # the serving version as a scrapeable number: checkpoint epoch
            # (and step for mid-epoch checkpoints)
            for key in ("epoch", "step"):
                if isinstance(r.get(key), (int, float)):
                    self._model(f"deploy_version_{key}", r["model"], r[key])
        elif kind == "deploy_rollback":
            self._count("deploy_rollbacks_total")
            self._model("deploy_rollout_active", r["model"], 0.0)
            if isinstance(r.get("strikes"), (int, float)):
                self._model("deploy_strikes", r["model"], r["strikes"])
        elif kind == "span":
            phase = str(r.get("phase", "?"))
            d = self.per_phase.setdefault(phase, {"count": 0.0, "ms_total": 0.0,
                                                  "ms_max": 0.0})
            ms = float(r.get("ms", 0.0))
            d["count"] += 1.0
            d["ms_total"] += ms
            d["ms_max"] = max(d["ms_max"], ms)
        elif kind in ("supervisor_launch", "fleet_launch"):
            self._count("attempts_total")
            if isinstance(r.get("attempt"), (int, float)):
                self._gauge("attempt", r["attempt"])
            if kind == "fleet_launch":
                self._gauge("fleet_epoch", r.get("fleet_epoch", 0))
                self._gauge("fleet_world_size", r.get("world_size", 0))
            host = r.get("host")
            if isinstance(host, int):
                self.per_host.setdefault("attempt", {})[str(host)] = float(
                    r.get("attempt", 0)
                )
        elif kind in ("supervisor_exit", "fleet_host_exit"):
            self._count("worker_exits_total")
            host = r.get("host")
            if isinstance(host, int):
                self.per_host.setdefault("exits_total", {})
                d = self.per_host["exits_total"]
                d[str(host)] = d.get(str(host), 0.0) + 1.0
        elif kind in ("supervisor_recovery", "fleet_recovery"):
            self._count("restarts_total")
        elif kind == "fleet_failure":
            self._count("fleet_failures_total")
        elif kind == "state_bytes":
            self._gauge("state_bytes_per_device", r.get("total_bytes", 0))
        elif kind == "memory":
            self._gauge("live_bytes", r.get("live_bytes", 0))
            self._gauge("live_arrays", r.get("live_arrays", 0))
        elif kind == "dataplane_start":
            self._count("dataplane_starts_total")
            self._gauge("dataplane_workers", r.get("workers", 0))
        elif kind == "dataplane_stream":
            self._count("dataplane_streams_total")
        elif kind == "dataplane_lease":
            self._count("dataplane_lease_reissues_total")
        elif kind == "dataplane_cache":
            # the record carries CUMULATIVE totals from the service process;
            # folded as gauges so a tailing restart can't double-count
            for key in ("hits", "misses", "evictions", "bytes", "entries",
                        "streams", "reissues"):
                if isinstance(r.get(key), (int, float)):
                    self._gauge(f"dataplane_cache_{key}"
                                if key in ("hits", "misses", "evictions",
                                           "bytes", "entries")
                                else f"dataplane_{key}", r[key])
        elif kind == "dataplane_worker_exit":
            self._count("dataplane_worker_exits_total")
        elif kind == "dataplane_fallback":
            self._count("dataplane_fallbacks_total")
        elif kind == "fleet_scale":
            # autoscale decisions (the JAX package's fleet): desired capacity per
            # resource as gauges — "applied" records (the actuator's report)
            # drive fleet_replicas, policy decisions drive fleet_desired, so
            # the /metrics surface shows both the target and the landed
            # capacity (dtpu_fleet_desired vs dtpu_fleet_replicas diverging
            # = a bring-up in flight)
            self._count("fleet_scale_decisions_total")
            resource = str(r.get("resource", "?"))
            to_n = float(r.get("to_n", 0))
            if resource == "serve_replicas":
                model = str(r.get("model") or "all")
                metric = (
                    "fleet_replicas" if r.get("action") == "applied"
                    else "fleet_desired"
                )
                self._model(metric, model, to_n)
            elif resource == "data_workers":
                self._gauge("fleet_data_workers_desired", to_n)
            elif resource == "train_jobs":
                self._gauge(
                    "fleet_training_held",
                    1.0 if r.get("action") == "preempt" else 0.0,
                )
            wp = r.get("warm_pool")
            if isinstance(wp, (int, float)) and not isinstance(wp, bool):
                self._gauge("fleet_warm_pool", float(wp))
        elif kind == "alarm":
            self._count("alarms_fired_total")
            self.active_alarms.add(self._alarm_key(r))
        elif kind == "alarm_clear":
            self._count("alarms_cleared_total")
            self.active_alarms.discard(self._alarm_key(r))
        elif kind == "step_attribution":
            # roofline buckets as standing gauges (dtpu_attr_*): the
            # 45%-outside-the-matmuls number on the /metrics surface
            buckets = r.get("buckets")
            if isinstance(buckets, dict):
                for bucket, ms in buckets.items():
                    if isinstance(ms, (int, float)) and not isinstance(ms, bool):
                        self._gauge(f"attr_{bucket}_ms", float(ms))
            if isinstance(r.get("matmul_pct"), (int, float)):
                self._gauge("attr_matmul_pct", float(r["matmul_pct"]))
        elif kind == "kernel_verdict":
            self._count("kernel_verdicts_total")
            if r.get("transition") in ("flip", "unflip"):
                self._count("kernel_flips_total")
        elif kind == "ingress_start":
            # the router's own birth record (the JAX package's ingress): role as a
            # gauge so dtpu_ingress_role flips 1→0 on a demotion
            self._gauge("ingress_port", float(r.get("port", 0)))
            self._gauge("ingress_role", 1.0 if r.get("role") == "active" else 0.0)
        elif kind == "ingress_route":
            # per-POOL request accounting (the "model" label slot carries
            # the pool here; the exporter renders it as pool="...")
            self._model_count("ingress_requests_total", r.get("pool") or "?", 1.0)
            if r.get("spilled"):
                self._count("ingress_spillovers_total")
            if not r.get("ok", True):
                self._count("ingress_errors_total")
        elif kind == "ingress_shed":
            self._count("ingress_sheds_total")
            self._model_count(
                "ingress_sheds_by_reason_total", str(r.get("reason", "?")), 1.0
            )
        elif kind == "ingress_tenant":
            # per-tenant rollup window → standing gauges + running counters
            # (label slot carries the tenant name)
            t = str(r.get("tenant") or "anonymous")
            self._model("ingress_tenant_qps", t, float(r.get("qps", 0.0)))
            if isinstance(r.get("p50_ms"), (int, float)):
                self._model("ingress_tenant_p50_ms", t, float(r["p50_ms"]))
            if isinstance(r.get("p99_ms"), (int, float)):
                self._model("ingress_tenant_p99_ms", t, float(r["p99_ms"]))
            self._model_count("ingress_tenant_requests_total", t, float(r["requests"]))
            self._model_count("ingress_tenant_shed_total", t, float(r["shed"]))
        elif kind == "ingress_failover":
            action = str(r.get("action", "?"))
            if action in ("promote", "demote"):
                self._count("ingress_failovers_total")
                self._gauge("ingress_role", 1.0 if action == "promote" else 0.0)
            elif action == "start":
                self._gauge("ingress_role", 1.0 if r.get("role") == "active" else 0.0)
            elif action in ("restart", "gave_up"):
                self._count("ingress_router_restarts_total")
        elif kind == "ingress_replica":
            # standing per-pool healthy-replica gauge: dtpu_ingress_pool_healthy
            # hitting 0 is the "pool went dark" page
            if isinstance(r.get("healthy_n"), (int, float)):
                self._model(
                    "ingress_pool_healthy", str(r.get("pool", "?")),
                    float(r["healthy_n"]),
                )
            if r.get("event") == "quarantine":
                self._count("ingress_quarantines_total")

    @staticmethod
    def _alarm_key(r: dict) -> str:
        model = r.get("model")
        return f"{r.get('rule', '?')}{f'[{model}]' if model else ''}"

    # -- reading -------------------------------------------------------------

    def snapshot(self, now: float | None = None) -> dict:
        """Point-in-time copy of the aggregate state (+ derived metrics).

        ``heartbeat_age_s`` — seconds since the newest record's ``ts`` —
        is derived here so staleness alarms work on a journal that has
        stopped growing (no new record will ever carry the bad news).
        """
        now = time.time() if now is None else now
        with self._lock:
            gauges = dict(self.gauges)
            if self.last_record_ts is not None:
                gauges["heartbeat_age_s"] = max(0.0, now - self.last_record_ts)
            return {
                "gauges": gauges,
                "counters": dict(self.counters),
                "per_model": {k: dict(v) for k, v in self.per_model.items()},
                "per_host": {k: dict(v) for k, v in self.per_host.items()},
                "per_phase": {k: dict(v) for k, v in self.per_phase.items()},
                "info": dict(self.info),
                "active_alarms": sorted(self.active_alarms),
                "last_record_ts": self.last_record_ts,
                # per-metric update counts: what the alarm engine's for=N
                # window counting keys on
                "metric_gen": dict(self.metric_gen),
            }
