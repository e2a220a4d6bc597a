"""Render a run report from a metrics journal (counterpart of ``obs/summarize.py``).

``python -m distribuuuu_tpu_torch.obs summarize <journal>``: the human view
of the machine-readable record: throughput a epoch, MFU, goodput, the
kernels' nvcc builds and host waits, the fault and resume history, the
dataplane's cache and fallbacks, serving's startup and SLO per model, its
deployments, the slowest traces, the alarms, checkpoint cadence and the
hottest device kernels of the last profiler window with their step
attribution. A pure
function of the journal (it reads nothing else), so it works anywhere the
journal is copied to. The text is the JAX package's line for line, but for
one line: where JAX reports its backend compiles, the port reports its nvcc
builds. The sections of records only the JAX package's supervision writes
(the agent, the fleet and its goodput timeline, ingress, kernel verdicts)
come with ROADMAP items 9 and 13.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable

from distribuuuu_tpu_torch.obs.attribution import render_roofline
from distribuuuu_tpu_torch.obs.journal import read_journal
from distribuuuu_tpu_torch.obs.monitors import BUILD_PREFIX


def _fmt_s(seconds: float) -> str:
    seconds = float(seconds)
    if seconds >= 3600:
        return f"{seconds / 3600:.1f}h"
    if seconds >= 60:
        return f"{seconds / 60:.1f}m"
    return f"{seconds:.1f}s"


def _median(vals: list[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[len(s) // 2]


def render(records: Iterable[dict]) -> str:
    """The report text for a record stream (exercised by the golden test)."""
    records = list(records)
    by_kind: dict[str, list[dict]] = defaultdict(list)
    for r in records:
        by_kind[r.get("kind", "?")].append(r)

    lines: list[str] = []
    out = lines.append
    out("== distribuuuu-tpu run report ==")

    start = by_kind["run_start"][-1] if by_kind["run_start"] else {}
    if start:
        out(
            f"run {start.get('run_id', '?')}: {start.get('arch', '?')} on "
            f"{start.get('devices', '?')}x{start.get('device_kind', '?')} "
            f"({start.get('hosts', '?')} host(s)), global batch "
            f"{start.get('global_batch', '?')}, config {start.get('config_fingerprint', '?')}"
        )
    end = by_kind["run_end"][-1] if by_kind["run_end"] else {}
    if end:
        out(
            f"result: best Acc@1 {end.get('best_acc1', 0.0):.3f} over "
            f"{end.get('epochs', '?')} epoch(s) in {_fmt_s(end.get('wall_s', 0.0))}, "
            f"goodput {100.0 * end.get('goodput', 0.0):.1f}%, "
            f"{'clean exit' if end.get('clean') else 'DIRTY EXIT'}"
        )

    # -- per-epoch throughput table -----------------------------------------
    windows_by_epoch: dict[int, list[dict]] = defaultdict(list)
    for w in by_kind["window"]:
        windows_by_epoch[w["epoch"]].append(w)
    if windows_by_epoch:
        out("")
        out("epoch | steps | imgs/s (p50) | step_time p50/p90 | MFU p50 | skipped")
        out("------|-------|--------------|-------------------|---------|--------")
        for epoch in sorted(windows_by_epoch):
            ws = [w for w in windows_by_epoch[epoch] if not w.get("warmup")]
            ws = ws or windows_by_epoch[epoch]
            ips = _median([w["imgs_per_sec"] for w in ws])
            p50 = _median([w["step_time"] for w in ws])
            p90 = _median([w.get("step_time_p90", w["step_time"]) for w in ws])
            mfus = [w["mfu"] for w in ws if w.get("mfu") is not None]
            mfu_s = f"{100.0 * _median(mfus):6.2f}%" if mfus else "    n/a"
            skipped = sum(w["skipped"] for w in windows_by_epoch[epoch])
            out(
                f"{epoch:5d} | {sum(w['steps'] for w in windows_by_epoch[epoch]):5d} "
                f"| {ips:12.1f} | {p50:.4f}s / {p90:.4f}s | {mfu_s} | {skipped:7d}"
            )

    # -- eval ----------------------------------------------------------------
    if by_kind["eval"]:
        out("")
        for ev in by_kind["eval"]:
            ep = ev.get("epoch")
            out(
                f"eval{f'[{ep}]' if ep is not None else ''}: "
                f"Acc@1 {ev['acc1']:.3f}  Acc@k {ev['acck']:.3f}  "
                f"({_fmt_s(ev['wall_s'])}, {ev['samples']:.0f} samples)"
            )

    # -- counters ------------------------------------------------------------
    run_counters = [c for c in by_kind["counters"] if c.get("scope") == "run"]
    if run_counters:
        c = run_counters[-1]
        # the port compiles no step: its builds are the nvcc runs of the
        # kernels' libraries (obs/monitors.py)
        builds = [d for k, d in c["durations"].items() if k.startswith(BUILD_PREFIX)]
        out("")
        out(
            f"builds: {sum(d.get('count', 0) for d in builds)} nvcc build(s), "
            f"{sum(d.get('total_s', 0.0) for d in builds):.1f}s total"
        )
        waits = c.get("waits", {})
        if waits:
            out(
                "host waits: "
                + ", ".join(f"{k}={_fmt_s(v)}" for k, v in sorted(waits.items()))
            )

    # -- resilience ----------------------------------------------------------
    n_skip = sum(r["count"] for r in by_kind["fault_skipped_steps"])
    n_emergency = sum(
        1 for r in by_kind["checkpoint"] if r.get("ckpt_kind") == "emergency"
    )
    parts = [
        f"skipped_steps={n_skip}",
        f"emergency_ckpts={n_emergency}",
        f"preempts={len(by_kind['preempt'])}",
        f"resumes={len(by_kind['resume'])}",
        f"aborts={len(by_kind['fault_abort'])}",
    ]
    # distributed-failure kinds: only shown when something actually happened
    # (most runs have none, and the line stays stable for the golden test)
    for label, kind in (
        ("hangs", "hang"),
        ("quarantined_ckpts", "ckpt_quarantined"),
        ("skipped_ckpts", "ckpt_skipped"),
        ("elastic_resumes", "elastic_resume"),
    ):
        if by_kind[kind]:
            parts.append(f"{label}={len(by_kind[kind])}")
    out("")
    out("faults: " + "  ".join(parts))

    # -- dataplane (dtpu-dataplane) -----------------------------------------
    # only present when a run used the disaggregated input service; omitted
    # otherwise so ordinary reports (and the golden test) are unchanged
    if by_kind["dataplane_start"] or by_kind["dataplane_fallback"]:
        out("")
        if by_kind["dataplane_start"]:
            s = by_kind["dataplane_start"][-1]
            out(
                f"dataplane: {s.get('workers', '?')} decode worker(s) x "
                f"{s.get('worker_threads', '?')} thread(s) at "
                f"{s.get('address', '?')}"
            )
        else:
            out("dataplane:")
        caches = by_kind["dataplane_cache"]
        if caches:
            c = caches[-1]
            hits, misses = c.get("hits", 0), c.get("misses", 0)
            rate = hits / max(1, hits + misses)
            out(
                f"  cache: {hits} hit(s) / {misses} decode(s) "
                f"({100.0 * rate:.1f}% saved), {c.get('evictions', 0)} "
                f"eviction(s), {c.get('bytes', 0) / 2**20:.1f} MB held"
            )
        n_streams = len(by_kind["dataplane_stream"])
        n_reissues = len(by_kind["dataplane_lease"])
        n_worker_exits = len(by_kind["dataplane_worker_exit"])
        out(
            f"  streams={n_streams}  lease_reissues={n_reissues}  "
            f"worker_exits={n_worker_exits}  "
            f"fallbacks={len(by_kind['dataplane_fallback'])}"
        )
        for r in by_kind["dataplane_fallback"]:
            out(
                f"  FALLBACK to local decode at epoch {r.get('epoch', '?')} "
                f"batch {r.get('batch', '?')} ({r.get('reason', '?')})"
            )

    # -- serving (dtpu-serve) -----------------------------------------------
    # only present for serving runs; omitted otherwise so training reports
    # (and the golden test) are unchanged
    if (
        by_kind["serve_start"]
        or by_kind["serve_slo"]
        or by_kind["serve_shed"]
        or by_kind["serve_compile"]
        or by_kind["quant_quality"]
    ):
        out("")
        if by_kind["serve_start"]:
            s = by_kind["serve_start"][-1]
            out(
                f"serving: replica {s.get('replica', '?')} hosting "
                f"{', '.join(s.get('models', []))} on port {s.get('port', '?')} "
                f"(ladder {s.get('batch_sizes', [])}, "
                f"{s.get('aot_compiles', 0)} AOT compile(s), "
                f"warmup {s.get('warmup_s', 0.0):.2f}s)"
            )
        else:
            out("serving:")
        # per-(model, batch-size) startup wall: the JAX engine's AOT compile,
        # the port's first warmup forward at that size (serve/engine.py); the
        # line keeps JAX's words
        compile_by_model: dict[str, list[dict]] = defaultdict(list)
        for r in by_kind["serve_compile"]:
            compile_by_model[r["model"]].append(r)
        for model in sorted(compile_by_model):
            recs = sorted(compile_by_model[model], key=lambda r: r["batch_size"])
            total = sum(r["wall_s"] for r in recs)
            per = ", ".join(f"b{r['batch_size']} {r['wall_s']:.2f}s" for r in recs)
            quant = next((r["quant"] for r in recs if r.get("quant")), "")
            out(
                f"  compile[{model}]{f' ({quant})' if quant else ''}: "
                f"{per} = {total:.2f}s"
            )
        # int8 quality gate verdicts (quant_quality; passed False = the
        # model refused to serve)
        for r in by_kind["quant_quality"]:
            out(
                f"  quant[{r.get('model', '?')}]: {r.get('mode', '?')} "
                f"top-1 agree {100.0 * r.get('top1_agree', 0.0):.2f}%, "
                f"logit rmse {r.get('logit_rmse', 0.0):.4f} "
                f"({r.get('layers', '?')} layer(s), "
                f"{r.get('folded_bn', 0)} BN folded) -> "
                f"{'PASSED' if r.get('passed') else 'FAILED (refused to serve)'}"
            )
        # per-model SLO: aggregate every window so the report covers the
        # whole run, not just the last rollup
        slo_by_model: dict[str, list[dict]] = defaultdict(list)
        for r in by_kind["serve_slo"]:
            slo_by_model[r["model"]].append(r)
        sheds_by_model: dict[str, int] = defaultdict(int)
        for r in by_kind["serve_shed"]:
            sheds_by_model[r["model"]] += 1
        for model in sorted(set(slo_by_model) | set(sheds_by_model)):
            rolls = slo_by_model.get(model, [])
            n_req = sum(r["requests"] for r in rolls)
            # service-wide elapsed = the wall-clock SPAN the windows cover
            # (each record's ts is its window end). Summing window_s instead
            # would double-count time when N replicas journal into one
            # reassembled journal and understate QPS by a factor of N.
            window = (
                max(r["ts"] for r in rolls)
                - min(r["ts"] - r["window_s"] for r in rolls)
                if rolls
                else 0.0
            )
            shed = sum(r["shed"] for r in rolls) or sheds_by_model.get(model, 0)
            # p50: requests-WEIGHTED median of the per-window medians, so an
            # idle tail window of 1 slow request cannot outvote a window of
            # 10k fast ones; p99: the worst window's p99 (conservative — the
            # per-window records keep the precise numbers)
            weighted = sorted(
                (r["p50_ms"], r["requests"]) for r in rolls if r["requests"]
            )
            p50, half, seen = 0.0, n_req / 2.0, 0
            for value, weight in weighted:
                seen += weight
                if seen >= half:
                    p50 = value
                    break
            p99 = max([r["p99_ms"] for r in rolls if r["requests"]], default=0.0)
            fill_hist: dict[str, int] = defaultdict(int)
            fills = []
            for r in rolls:
                for size, count in (r.get("fill_hist") or {}).items():
                    fill_hist[size] += count
                if r.get("batches"):
                    fills.append((r.get("mean_fill", 0.0), r["batches"]))
            mean_fill = (
                sum(f * b for f, b in fills) / sum(b for _, b in fills) if fills else 0.0
            )
            hist_s = ", ".join(
                f"{size}x{count}" for size, count in sorted(fill_hist.items(), key=lambda kv: int(kv[0]))
            )
            out(
                f"  {model}: {n_req} request(s), "
                f"qps {n_req / max(window, 1e-9):.1f}, "
                f"p50 {p50:.1f}ms / p99 {p99:.1f}ms, shed {shed}, "
                f"batch fill {100.0 * mean_fill:.0f}% [{hist_s or 'no batches'}]"
            )

    # -- deployments (serve/deploy.py) ---------------------------------------
    # the continuous train->serve lifecycle: watch verdicts, then each
    # rollout's stage -> canary -> promote/rollback story in order. Omitted
    # when no deploy records exist, so plain serving reports are unchanged.
    deploy_kinds = (
        "deploy_watch", "deploy_stage", "deploy_canary", "deploy_promote",
        "deploy_rollback",
    )
    if any(by_kind[k] for k in deploy_kinds):
        out("")
        n_promote = len(by_kind["deploy_promote"])
        n_rollback = len(by_kind["deploy_rollback"])
        out(
            f"deployments: {len(by_kind['deploy_stage'])} staged, "
            f"{n_promote} promoted, {n_rollback} rolled back"
        )
        # non-candidate watch verdicts (held / corrupt / struck_out / ...)
        # are the "why is my checkpoint not deploying" answers
        watch_skips: dict[str, int] = defaultdict(int)
        for r in by_kind["deploy_watch"]:
            if r.get("action") != "candidate":
                watch_skips[r.get("action", "?")] += 1
        if watch_skips:
            out(
                "  watch skips: "
                + ", ".join(f"{k}={v}" for k, v in sorted(watch_skips.items()))
            )
        lifecycle = sorted(
            (
                r for k in ("deploy_stage", "deploy_canary", "deploy_promote",
                            "deploy_rollback")
                for r in by_kind[k]
            ),
            key=lambda r: r.get("ts", 0.0),
        )
        for r in lifecycle:
            kind = r.get("kind")
            name = str(r.get("path", "?")).rstrip("/").rsplit("/", 1)[-1]
            tag = f"[{r.get('model', '?')}] {name}"
            if kind == "deploy_stage":
                out(
                    f"  stage   {tag}: {r.get('aot_compiles', '?')} ladder "
                    f"compile(s) in {r.get('wall_s', 0.0):.2f}s "
                    f"(incumbent kept serving)"
                )
            elif kind == "deploy_canary":
                verdict = "PASSED" if r.get("passed") else "FAILED"
                detail = (
                    f"p99 {r.get('p99_ms', 0.0):.1f}ms vs incumbent "
                    f"{r.get('incumbent_p99_ms', 0.0):.1f}ms, top-1 agree "
                    f"{100.0 * r.get('top1_agree', 0.0):.1f}%"
                )
                out(
                    f"  canary  {tag}: {100.0 * r.get('fraction', 0.0):.0f}% "
                    f"traffic, {r.get('requests', 0)} request(s), {detail} "
                    f"-> {verdict}"
                    + (f" ({r['reason']})" if not r.get("passed") and r.get("reason") else "")
                )
            elif kind == "deploy_promote":
                out(
                    f"  promote {tag}"
                    + (" (fast-follow)" if r.get("fast_follow") else "")
                    + (
                        f": now serving @ manifest {r['manifest_hash']}"
                        if r.get("manifest_hash")
                        else ""
                    )
                )
            elif kind == "deploy_rollback":
                out(
                    f"  ROLLBACK {tag}: {r.get('reason', '?')} "
                    f"(strike {r.get('strikes', '?')})"
                )

    # -- tracing (dtpu-obs v2: span records) --------------------------------
    # per-phase totals plus the critical path of the slowest traces — the
    # "where did the milliseconds go" view, reconstructed from the journal
    # alone. Omitted when no spans were journaled, so older reports (and
    # the golden test) are unchanged.
    if by_kind["span"]:
        out("")
        out("tracing:")
        by_phase: dict[str, list[float]] = defaultdict(list)
        by_trace: dict[str, list[dict]] = defaultdict(list)
        for s in by_kind["span"]:
            by_phase[s.get("phase", "?")].append(float(s.get("ms", 0.0)))
            by_trace[s.get("trace_id", "?")].append(s)
        out("  phase      | spans |   p50 ms |   max ms | total")
        for phase in sorted(by_phase):
            vals = sorted(by_phase[phase])
            out(
                f"  {phase:<10} | {len(vals):5d} | {_median(vals):8.1f} | "
                f"{vals[-1]:8.1f} | {_fmt_s(sum(vals) / 1000.0)}"
            )

        def trace_wall(spans: list[dict]) -> float:
            # a request's "total" span IS its wall; phase sums otherwise
            totals = [s["ms"] for s in spans if s.get("phase") == "total"]
            return float(max(totals) if totals else sum(s.get("ms", 0.0) for s in spans))

        slowest = sorted(by_trace.items(), key=lambda kv: -trace_wall(kv[1]))[:3]
        for trace_id, spans in slowest:
            phases = ", ".join(
                f"{s.get('phase', '?')} {s.get('ms', 0.0):.1f}ms"
                for s in sorted(spans, key=lambda s: s.get("ts", 0.0))
            )
            model = next((s["model"] for s in spans if s.get("model")), None)
            out(
                f"  slowest trace {trace_id}"
                + (f" [{model}]" if model else "")
                + f": {trace_wall(spans):.1f}ms ({phases})"
            )

    # -- alarms (dtpu-obs v2: declarative rules over the live aggregate) -----
    if by_kind["alarm"] or by_kind["alarm_clear"] or by_kind["fleet_alarm"]:
        out("")
        # pair chronologically per (rule, model): a clear belongs to the
        # fire it directly follows. One ENGINE alternates fire -> clear
        # strictly, but an engine that dies while an alarm is active leaves
        # an unpaired fire behind (its restart fires afresh) — index-based
        # pairing would hand the eventual clear to the wrong firing.
        clears_by_key: dict[tuple, list[dict]] = defaultdict(list)
        for r in by_kind["alarm_clear"]:
            clears_by_key[(r.get("rule"), r.get("model"))].append(r)
        for clears in clears_by_key.values():
            clears.sort(key=lambda r: r.get("ts", 0.0))
        fires_by_key: dict[tuple, list[dict]] = defaultdict(list)
        for r in by_kind["alarm"]:
            fires_by_key[(r.get("rule"), r.get("model"))].append(r)
        for fires in fires_by_key.values():
            fires.sort(key=lambda r: r.get("ts", 0.0))

        def fire_status(key: tuple, r: dict) -> str:
            fires = fires_by_key[key]
            i = fires.index(r)
            t0 = r.get("ts", 0.0)
            t1 = (
                fires[i + 1].get("ts", float("inf"))
                if i + 1 < len(fires)
                else float("inf")
            )
            clear = next(
                (c for c in clears_by_key[key] if t0 <= c.get("ts", 0.0) < t1),
                None,
            )
            if clear is not None:
                return f"cleared after {clear.get('active_s', 0.0):.0f}s"
            if t1 != float("inf"):
                # re-fired without a recorded clear: the firing engine died
                # while active — the state was lost, not resolved
                return "no clear recorded (engine restarted?)"
            return "STILL ACTIVE at journal end"

        out(
            f"alarms: {len(by_kind['alarm'])} fired, "
            f"{len(by_kind['alarm_clear'])} cleared"
            + (
                f", {len(by_kind['fleet_alarm'])} relayed to the fleet "
                f"controller"
                if by_kind["fleet_alarm"]
                else ""
            )
        )
        for r in by_kind["alarm"]:
            key = (r.get("rule"), r.get("model"))
            model_s = f"[{r['model']}]" if r.get("model") else ""
            out(
                f"  {r.get('rule', '?')}{model_s}: {r.get('metric', '?')} "
                f"{r.get('value', 0.0):.4g} {r.get('op', '?')} "
                f"{r.get('threshold', 0.0):.4g} — {fire_status(key, r)}"
            )

    # -- checkpoints ---------------------------------------------------------
    saves = [r for r in by_kind["checkpoint"] if r.get("ckpt_kind") != "emergency"]
    if saves or by_kind["restore"]:
        avg = sum(r["wall_s"] for r in saves) / len(saves) if saves else 0.0
        out(
            f"checkpoints: {len(saves)} save(s) (avg dispatch {avg:.2f}s), "
            f"{len(by_kind['restore'])} restore(s)"
        )

    # -- state bytes (fsdp 1/N measurement) ----------------------------------
    if by_kind["state_bytes"]:
        s = by_kind["state_bytes"][-1]
        glob = sum(
            s.get(f"{k}_global_bytes", 0) for k in ("params", "opt", "bn")
        )
        ratio = f" = {s['total_bytes'] / glob:.2f}x of global" if glob else ""
        out(
            f"state bytes/device (fsdp={s['fsdp']}): "
            f"params {s['params_bytes'] / 1e6:.1f} MB + "
            f"opt {s['opt_bytes'] / 1e6:.1f} MB + "
            f"bn {s['bn_bytes'] / 1e6:.1f} MB "
            f"= {s['total_bytes'] / 1e6:.1f} MB{ratio}"
        )

    # -- memory --------------------------------------------------------------
    if by_kind["memory"]:
        m = by_kind["memory"][-1]
        out(
            f"memory (last epoch): {m['live_arrays']} live arrays, "
            f"{m['live_bytes'] / 1e6:.1f} MB"
        )

    # -- profiler ------------------------------------------------------------
    if by_kind["profile"]:
        p = by_kind["profile"][-1]
        out("")
        out(
            f"profile @ gstep {p['gstep']} ({p['steps']} step(s), "
            f"trigger={p.get('trigger', '?')}): {p['logdir']}"
        )
        if p.get("device_ms_per_step"):
            out(f"device op time: {p['device_ms_per_step']:.2f} ms/step")
        for op in p.get("top_ops", [])[:10]:
            out(f"  {op['pct']:5.1f}%  {op['ms_per_step']:8.3f} ms  {op['op']}")

    # -- step attribution (roofline) -----------------------------------------
    if by_kind["step_attribution"]:
        a = by_kind["step_attribution"][-1]
        out("")
        head = "step attribution (roofline)"
        if a.get("gstep") is not None:
            head += f" @ gstep {a['gstep']}"
        out(head + ":")
        for line in render_roofline(a):
            out(line)

    return "\n".join(lines) + "\n"


def summarize_file(path: str) -> str:
    return render(read_journal(path))
