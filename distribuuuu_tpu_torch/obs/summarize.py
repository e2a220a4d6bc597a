"""Render a run report from a metrics journal (counterpart of ``obs/summarize.py``).

``python -m distribuuuu_tpu_torch.obs summarize <journal>``: the human view
of the machine-readable record: throughput a epoch, MFU, goodput, the
kernels' nvcc builds and host waits, the fault and resume history,
checkpoint cadence and the hottest device kernels of the last profiler
window with their step attribution. A pure function of the journal (it
reads nothing else), so it works anywhere the journal is copied to. The
text is the JAX package's line for line, but for one line: where JAX
reports its backend compiles, the port reports its nvcc builds. The
sections of the records a training run does not write (supervision, the
fleet, the dataplane, serving, deployments, ingress, alarms, kernel
verdicts) come with the slices that write them (ROADMAP item 7b).
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
