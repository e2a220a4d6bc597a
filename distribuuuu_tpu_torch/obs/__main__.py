"""CLI: ``python -m distribuuuu_tpu_torch.obs``, journal tooling.

    python -m distribuuuu_tpu_torch.obs summarize exp/telemetry.jsonl
    python -m distribuuuu_tpu_torch.obs validate  exp/telemetry.jsonl

Exit codes: 0 ok, 1 validation findings or an unreadable journal, 2 usage.
(The JAX CLI's ``export`` is the live plane, ROADMAP item 7b; ``perfdb`` is
not ported.)
"""

from __future__ import annotations

import argparse
import json
import sys

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
    args = ap.parse_args(argv)

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
