"""Request and step tracing: trace ids and typed ``span`` records (counterpart of ``obs/trace.py``).

A trace is one unit of work whose phases add up to an explainable wall
time: one served request (queue wait, pad, execute, total), one train
PRINT_FREQ window (data wait, then compute) or one epoch boundary's
checkpoint. Every phase lands as a ``span`` record keyed by its trace id,
so ``obs summarize`` rebuilds the slowest traces from the journal alone.

- Serving: a caller may send its id in the ``x-dtpu-trace-id`` header; the
  frontend keeps a well-formed one (``ensure_trace_id`` mints one
  otherwise), threads it through the batcher to the dispatch and echoes it
  in the response.
- Training: ids are minted a window by ``Telemetry.window``
  (``train-<run>-g<gstep>``) and a checkpoint by the trainer
  (``train-<run>-ck<epoch>``).

Spans carry host wall times only and add no device sync: the execute span
is timed around the forward whose logits copy to the host is the response,
and train spans reuse the PRINT_FREQ boundary's fetch.
"""

from __future__ import annotations

import re
import uuid

#: HTTP header carrying the trace id end to end (client -> frontend -> response)
TRACE_HEADER = "x-dtpu-trace-id"

# ids are log- and label-safe by construction; anything else is replaced
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,128}$")

#: span phases of one served request, in causal order
SERVE_PHASES = ("queue_wait", "pad", "execute", "total")
#: span phases of one train window / epoch boundary
TRAIN_PHASES = ("data_wait", "compute", "checkpoint")


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id."""
    return uuid.uuid4().hex[:16]


def valid_trace_id(trace_id) -> bool:
    return isinstance(trace_id, str) and bool(_TRACE_ID_RE.match(trace_id))


def ensure_trace_id(trace_id) -> str:
    """The given id when well-formed, else a freshly minted one: a malformed
    id is replaced, never written to the journal."""
    return trace_id if valid_trace_id(trace_id) else mint_trace_id()


def span_fields(trace_id: str, phase: str, ms: float, **extra) -> dict:
    """The fields of one ``span`` record (None-valued extras dropped, so
    call sites can pass optional context unconditionally)."""
    fields = {"trace_id": str(trace_id), "phase": str(phase), "ms": round(float(ms), 3)}
    fields.update({k: v for k, v in extra.items() if v is not None})
    return fields
