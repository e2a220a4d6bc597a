"""CLI: ``python -m distribuuuu_tpu_torch.obs``, journal tooling.

    python -m distribuuuu_tpu_torch.obs summarize exp/telemetry.jsonl
    python -m distribuuuu_tpu_torch.obs validate  exp/telemetry.jsonl
    python -m distribuuuu_tpu_torch.obs export --out-dir exp --port 9100

``export`` is the live sidecar of a plain training run: it tails the
journal, folds it into gauges, serves Prometheus text on ``/metrics`` and
evaluates the ``OBS.ALARMS`` rules, journaling their records into the
``.part4000`` continuation (never the run's own file). ``--once`` reads
the whole journal, prints the text and exits.

Exit codes: 0 ok, 1 validation findings or an unreadable journal, 2 usage.
(The JAX CLI's ``perfdb`` is not ported.)
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from distribuuuu_tpu_torch.obs.journal import validate_journal
from distribuuuu_tpu_torch.obs.summarize import summarize_file


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m distribuuuu_tpu_torch.obs",
                                 description="telemetry journal tooling of the port")
    sub = ap.add_subparsers(dest="command", required=True)
    p_sum = sub.add_parser("summarize", help="render a run report from a journal")
    p_sum.add_argument("journal", help="path to a telemetry .jsonl journal")
    p_val = sub.add_parser("validate", help="schema-validate every journal record")
    p_val.add_argument("journal", help="path to a telemetry .jsonl journal")
    p_exp = sub.add_parser("export", help="live /metrics exporter sidecar over a journal")
    p_exp.add_argument("journal", nargs="?", default=None,
                       help="journal path (or use --out-dir)")
    p_exp.add_argument("--out-dir", default=None,
                       help="run OUT_DIR (the journal is OUT_DIR/OBS.JOURNAL)")
    p_exp.add_argument("--port", type=int, default=9100, help="/metrics port (default 9100)")
    p_exp.add_argument("--host", default="127.0.0.1")
    p_exp.add_argument("--interval", type=float, default=2.0,
                       help="journal tail cadence, seconds")
    p_exp.add_argument("--once", action="store_true",
                       help="read the whole journal, print the metrics text, exit")
    args = ap.parse_args(argv)

    if args.command == "export":
        from distribuuuu_tpu_torch.obs.exporter import run_export
        from distribuuuu_tpu_torch.obs.telemetry import journal_path

        journal = args.journal
        if journal is None:
            if args.out_dir is None:
                ap.error("export needs a journal path or --out-dir")
            journal = journal_path(args.out_dir)
        stop = threading.Event()
        if not args.once:  # --once never blocks: process signals are left alone
            try:
                signal.signal(signal.SIGTERM, lambda s, f: stop.set())
                signal.signal(signal.SIGINT, lambda s, f: stop.set())
            except ValueError:  # not the main thread (embedded use)
                pass
        return run_export(journal, port=int(args.port), host=str(args.host),
                          interval_s=float(args.interval), once=bool(args.once),
                          stop_event=stop)

    if args.command == "validate":
        errors = validate_journal(args.journal)
        for e in errors:
            print(e, file=sys.stderr)
        if errors:
            print(f"INVALID: {len(errors)} schema error(s)", file=sys.stderr)
            return 1
        print(f"OK: {args.journal} is schema-valid")
        return 0

    try:
        report = summarize_file(args.journal)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"cannot read journal: {exc}", file=sys.stderr)
        return 1
    sys.stdout.write(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
