"""Step-time attribution: the window's device time folded into buckets (counterpart of ``obs/attribution.py``).

The profiler window's per-kernel table (``obs/traceparse.py``) folded into
five buckets:

    matmul      the tensor-core work: cuBLAS and cuDNN GEMMs and
                convolutions (``gemm``, ``xmma``, ``cutlass``, ``wgmma``,
                ``fprop``/``dgrad``/``wgrad`` in the name) and the port's
                ``attention_*`` kernels (``attention_kernel``,
                ``attention_mma_kernel``, ``attention_bwd_*_kernel``: K2-K5
                and their backwards)
    vector      every other kernel: K1 (``epilogue_vec_kernel``,
                ``epilogue_scalar_kernel``), K1-bwd (``epilogue_bwd_kernel``,
                ``epilogue_bwd_bf16_kernel``), K6/K7 (``moe_dispatch_kernel``,
                ``moe_combine_kernel`` and their ``_bwd`` kernels), PyTorch's
                elementwise, reduction and copy kernels, memsets and device
                to device copies
    collective  NCCL's kernels (``ncclDevKernel_*``)
    infeed      host-device transfers on the copy engines (``Memcpy HtoD``,
                ``Memcpy DtoH``)
    host        the host's time in CUDA copy calls (a lower bound: only the
                calls the profiler names as copies, never arbitrary Python)

journaled as a ``step_attribution`` record beside every ``profile``
record and rendered by ``obs summarize``. The first marker found in a
kernel's lower-cased name decides; anything unrecognised is vector work by
definition of the residual bucket.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

from distribuuuu_tpu_torch.obs import traceparse

BUCKETS = ("matmul", "vector", "collective", "infeed", "host")

# substring -> bucket, checked in order (first match wins); lowercase
_MARKERS: tuple[tuple[str, str], ...] = (
    ("memcpy htod", "infeed"),
    ("memcpy dtoh", "infeed"),
    ("nccl", "collective"),
    ("gemm", "matmul"),
    ("xmma", "matmul"),
    ("cutlass", "matmul"),
    ("wgmma", "matmul"),
    ("fprop", "matmul"),
    ("dgrad", "matmul"),
    ("wgrad", "matmul"),
    ("attention_", "matmul"),
)


def classify_op(name: str) -> str:
    """Bucket for one device kernel (or its category)."""
    low = name.lower()
    for marker, bucket in _MARKERS:
        if marker in low:
            return bucket
    return "vector"


def attribute_trace(trace: dict, steps: int) -> dict:
    """Fold a window's compact trace into per-step bucket milliseconds:
    ``{steps, device_ms_per_step, buckets, matmul_pct, host_ms}``, the host
    bucket outside ``device_ms_per_step`` (it overlaps device time). A
    window without device events (the CPU) gives ``device_ms_per_step``
    None and zero buckets, as ``traceparse.op_table`` does."""
    steps = max(1, int(steps))
    _rows, cats, total = traceparse.summarize_device_ops(trace.get("events", []), top=10**6)
    buckets = {b: 0.0 for b in BUCKETS}
    for name, dur in cats:
        buckets[classify_op(name)] += dur
    host_us = sum(float(e) - float(s) for _, s, e in trace.get("host_events", []))
    buckets["host"] = round(host_us / 1e3 / steps, 4)
    for b in ("matmul", "vector", "collective", "infeed"):
        buckets[b] = round(buckets[b] / 1e3 / steps, 4)
    device_ms = total / 1e3 / steps if total > 0 else None
    matmul_pct = round(100.0 * buckets["matmul"] / device_ms, 2) if device_ms else None
    return {"steps": steps, "device_ms_per_step": device_ms, "buckets": buckets,
            "matmul_pct": matmul_pct, "host_ms": buckets["host"]}


def attribute_logdir(logdir: str, steps: int) -> dict:
    """:func:`attribute_trace` of the window in ``logdir``; the
    no-device-events shape when its trace is absent or unreadable."""
    try:
        trace = traceparse.load_trace(logdir)
    except (OSError, json.JSONDecodeError):
        trace = {}
    return attribute_trace(trace, steps)


def attribution_record(logdir: str, steps: int, *, gstep: int | None = None,
                       trigger: str | None = None, device_kind: str | None = None) -> dict:
    """Journal-ready ``step_attribution`` fields for one profiled window."""
    rec = attribute_logdir(logdir, steps)
    rec["logdir"] = str(logdir)
    if gstep is not None:
        rec["gstep"] = int(gstep)
    if trigger is not None:
        rec["trigger"] = str(trigger)
    if device_kind:
        rec["device_kind"] = str(device_kind)
    return rec


def render_roofline(rec: Mapping[str, Any]) -> list[str]:
    """The ``step_attribution`` record as summarize-style lines."""
    lines: list[str] = []
    dev = rec.get("device_ms_per_step")
    steps = rec.get("steps")
    head = f"  {steps} step(s)"
    if dev is not None:
        head += f", {dev:.2f} ms/step on device"
    if rec.get("device_kind"):
        head += f" [{rec['device_kind']}]"
    lines.append(head)
    buckets = rec.get("buckets") or {}
    if dev:
        for b in BUCKETS:
            ms = float(buckets.get(b, 0.0))
            if b == "host":
                if ms:
                    lines.append(f"    {b:<10} {ms:8.2f} ms/step (host tracks; lower bound)")
                continue
            lines.append(f"    {b:<10} {ms:8.2f} ms/step ({100.0 * ms / dev:5.1f}%)")
        pct = rec.get("matmul_pct")
        if pct is not None:
            lines.append(f"    outside-the-matmuls: {100.0 - float(pct):.1f}% of device time")
    ceiling = rec.get("ceiling_tflops")
    if ceiling:
        lines.append(f"    measured matmul ceiling: {float(ceiling):g} TFLOP/s")
    return lines
