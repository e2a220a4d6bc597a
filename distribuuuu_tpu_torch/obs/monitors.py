"""The port's run counters for the journal (counterpart of ``obs/monitors.py``).

JAX bridges ``jax.monitoring``'s compile and cache events. The port has no
compiler in the step; what it counts instead, each read where it is kept:

- ``counters``: the kernels' launch counters, one entry a counter
  (``ops/epilogue.py``: K1 and K1-bwd, each route and its scalar one;
  ``ops/attention.py``: the forward and backward entry points and the
  backward's calls by route; ``ops/moe_kernel.py``: K6, K7 and their
  backwards). A wrapper adds one where it launches its kernel and nowhere
  else, so a CPU or meta tensor counts nothing;
- ``durations``: the nvcc builds of this process, ``nvcc/<source>`` ->
  ``{count, total_s}`` (timed in ``ops/_build.build``; a library already
  built counts nothing).

``Telemetry`` snapshots both at epoch boundaries and journals the deltas
(:meth:`MonitoringBridge.delta`). The trainer's ``K1 launches`` log line
reads :func:`launch_counts` too, so the two cannot disagree.
"""

from __future__ import annotations

from typing import Any

from distribuuuu_tpu_torch.ops import _build
from distribuuuu_tpu_torch.ops import attention as att
from distribuuuu_tpu_torch.ops import epilogue as ep
from distribuuuu_tpu_torch.ops import moe_kernel as moe

BUILD_PREFIX = "nvcc/"


def launch_counts() -> dict[str, int]:
    """Every kernel launch counter of the process, by name."""
    out = {
        "epilogue.launches": ep.LAUNCHES,
        "epilogue.bwd_launches": ep.BWD_LAUNCHES,
        "epilogue.scalar_launches": ep.SCALAR_LAUNCHES,
        "epilogue.bwd_scalar_launches": ep.BWD_SCALAR_LAUNCHES,
        "attention.launches": att.LAUNCHES,
        "attention.table_launches": att.TABLE_LAUNCHES,
        "attention.bwd_launches": att.BWD_LAUNCHES,
        "attention.table_bwd_launches": att.TABLE_BWD_LAUNCHES,
        "moe.dispatch_launches": moe.DISPATCH_LAUNCHES,
        "moe.combine_launches": moe.COMBINE_LAUNCHES,
        "moe.dispatch_bwd_launches": moe.DISPATCH_BWD_LAUNCHES,
        "moe.combine_bwd_launches": moe.COMBINE_BWD_LAUNCHES,
    }
    out.update({f"attention.bwd_route_calls.{r}": n for r, n in att.BWD_ROUTE_CALLS.items()})
    return out


class MonitoringBridge:
    """Snapshots of the launch counters and the nvcc builds. Nothing to
    subscribe to (JAX's bridge installs listeners): the counters are module
    globals, read on demand."""

    def snapshot(self) -> dict[str, Any]:
        """``{"counters": ..., "durations": ...}`` totals, copied."""
        with _build._lock:
            durations = {k: dict(v) for k, v in _build.BUILDS.items()}
        return {"counters": launch_counts(), "durations": durations}

    @staticmethod
    def delta(now: dict[str, Any], since: dict[str, Any]) -> dict[str, Any]:
        """Per-name difference of two snapshots (names with no change are
        dropped, so epoch records stay small)."""
        counters = {
            k: v - since["counters"].get(k, 0)
            for k, v in now["counters"].items()
            if v - since["counters"].get(k, 0)
        }
        durations = {}
        for k, v in now["durations"].items():
            prev = since["durations"].get(k, {"count": 0, "total_s": 0.0})
            dc = v["count"] - prev["count"]
            if dc:
                durations[k] = {
                    "count": dc,
                    "total_s": round(v["total_s"] - prev["total_s"], 6),
                }
        return {"counters": counters, "durations": durations}
