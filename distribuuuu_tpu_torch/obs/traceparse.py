"""The profiler window's device events, summarised (counterpart of ``obs/traceparse.py``).

A window (``obs/profiler.py``) writes ``<logdir>/train_steps.json``: the
window's ``steps``, its wall ``wall_ms`` (the card synchronised at both
ends), the step's ``batch``, the CUDA-side ``events`` as ``[name, start_us,
end_us]`` (kernels, memcpys and memsets as ``torch.profiler`` reports them)
and the ``host_events`` the host spent in CUDA copy calls, the same way.
This module aggregates the device events by kernel name and by category
(the name without its template arguments and parameter list), as JAX's
sums its device tracks by op and fusion category.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

TRACE_FILE = "train_steps.json"


def load_trace(logdir: str) -> dict:
    """The compact trace a window wrote into ``logdir``."""
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        return json.load(f)


def category(name: str) -> str:
    """A kernel's name without ``void``, template arguments and parameters
    (``void at::native::reduce_kernel<512, 1, ...>(...)`` ->
    ``at::native::reduce_kernel``)."""
    base = name[5:] if name.startswith("void ") else name
    return base.split("<", 1)[0].split("(", 1)[0].strip() or name


def summarize_device_ops(events: list, top: int):
    """Aggregate device event time. Returns ``(rows, cats, total)``: the
    hottest kernels by name, the per-category totals and the total device
    time (µs), each row ``(name, µs)``."""
    by_op: dict[str, float] = defaultdict(float)
    by_cat: dict[str, float] = defaultdict(float)
    total = 0.0
    for name, start, end in events:
        dur = float(end) - float(start)
        by_op[name] += dur
        by_cat[category(name)] += dur
        total += dur
    rows = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    cats = sorted(by_cat.items(), key=lambda kv: -kv[1])[:top]
    return rows, cats, total


def op_table(logdir: str, steps: int, top: int = 20) -> dict:
    """Journal-ready per-kernel summary of a traced window:
    ``{device_ms_per_step, top_ops: [{op, ms_per_step, pct}, ...]}``. A CPU
    window has no device events: ``device_ms_per_step`` None and no
    ``top_ops``; the profile record still marks that the window ran."""
    try:
        events = load_trace(logdir)["events"]
    except (OSError, KeyError, json.JSONDecodeError):
        return {"device_ms_per_step": None, "top_ops": []}
    rows, _cats, total = summarize_device_ops(events, top)
    steps = max(1, steps)
    if total <= 0:
        return {"device_ms_per_step": None, "top_ops": []}
    return {
        "device_ms_per_step": total / 1e3 / steps,
        "top_ops": [
            {
                "op": name if len(name) <= 80 else name[:77] + "...",
                "ms_per_step": round(dur / 1e3 / steps, 4),
                "pct": round(100.0 * dur / total, 2),
            }
            for name, dur in rows
        ],
    }
