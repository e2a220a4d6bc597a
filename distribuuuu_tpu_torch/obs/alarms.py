"""Declarative alarm engine over the live aggregator's snapshot (counterpart of ``obs/alarms.py``).

Rules come from ``cfg.OBS.ALARMS`` as strings::

    "goodput_floor=goodput<0.1:for=3"
    "p99_breach=serve_p99_ms>250"
    "heartbeat_stale=heartbeat_age_s>300"

``name=metric<threshold`` or ``name=metric>threshold``, with an optional
``:for=N`` hysteresis: a rule fires only after N consecutive breaching
windows of its metric and, once active, clears only after N consecutive
healthy ones, so a single noisy window can neither page nor silence.
Scalar metrics (any gauge or counter the aggregator tracks) evaluate once;
per-model serve metrics (``serve_p99_ms``, ``serve_qps``,
``serve_queue_depth``, ...) evaluate, fire and clear per model. A metric
absent from the snapshot is unknown, not breaching.

Transitions are journaled as typed ``alarm`` / ``alarm_clear`` records
through the given event sink and handed to every registered hook; a hook
that raises is logged and never stops the engine. The engine only observes
and reports: acting on an alarm is the hook owner's business.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from distribuuuu_tpu_torch.logging import logger

_RULE_RE = re.compile(
    r"^(?P<name>[A-Za-z0-9_.\-]+)=(?P<metric>[A-Za-z0-9_.\-]+)"
    r"(?P<op>[<>])(?P<threshold>-?[0-9.]+(?:[eE][-+]?[0-9]+)?)"
    r"(?::for=(?P<for>[0-9]+))?$"
)


@dataclass(frozen=True)
class AlarmRule:
    """One parsed rule: fire when ``metric <op> threshold`` holds for
    ``for_windows`` consecutive evaluations."""

    name: str
    metric: str
    op: str  # "<" or ">"
    threshold: float
    for_windows: int = 1

    def breached(self, value: float) -> bool:
        return value < self.threshold if self.op == "<" else value > self.threshold


def parse_alarm_rules(entries) -> list[AlarmRule]:
    """Parse ``OBS.ALARMS`` entries; malformed entries raise with the full
    string (a typo'd threshold must not silently disable the alarm)."""
    rules: list[AlarmRule] = []
    seen: set[str] = set()
    for entry in entries or []:
        m = _RULE_RE.match(str(entry).strip())
        if m is None:
            raise ValueError(
                f"OBS.ALARMS entry {entry!r} is not "
                f"'name=metric<threshold[:for=N]' (op is < or >)"
            )
        name = m.group("name")
        if name in seen:
            raise ValueError(f"OBS.ALARMS: duplicate rule name {name!r}")
        seen.add(name)
        rules.append(
            AlarmRule(
                name=name,
                metric=m.group("metric"),
                op=m.group("op"),
                threshold=float(m.group("threshold")),
                for_windows=max(1, int(m.group("for") or 1)),
            )
        )
    return rules


@dataclass
class _AlarmState:
    breaches: int = 0  # consecutive breaching WINDOWS of the metric
    oks: int = 0  # consecutive healthy windows (while active)
    active: bool = False
    fired_at: float = 0.0
    last_value: float = field(default=0.0)
    gen: int | None = None  # metric generation last counted


class AlarmEngine:
    """Evaluate rules against snapshots; journal + notify on transitions."""

    def __init__(
        self,
        rules: list[AlarmRule],
        journal_event: Callable[..., None] | None = None,
    ):
        self.rules = list(rules)
        self._event = journal_event or (lambda kind, **fields: None)
        self._hooks: list[Callable[[dict], None]] = []
        self._state: dict[tuple[str, str | None], _AlarmState] = {}
        # evaluate() mutates hysteresis state and runs concurrently in the
        # serving frontend (the HTTP threads' scrapes and the dispatch
        # thread's SLO flush): serialised, or two racing passes double-fire
        # one transition and corrupt the for=N counts. An RLock: transitions
        # run hooks while it is held, and a hook may read active().
        self._lock = threading.RLock()

    def register_hook(self, hook: Callable[[dict], None]) -> None:
        """``hook(transition)`` is called on every fire/clear with the same
        fields the journal record carries plus ``kind`` (alarm/alarm_clear)."""
        if hook not in self._hooks:
            self._hooks.append(hook)

    # -- evaluation ----------------------------------------------------------

    @staticmethod
    def _values(rule: AlarmRule, snapshot: dict) -> list[tuple[str | None, float]]:
        """(label, value) pairs this rule evaluates against — one unlabelled
        pair for scalar metrics, one per model for per-model metrics."""
        per_model = snapshot.get("per_model", {}).get(rule.metric)
        if per_model:
            return [(m, float(v)) for m, v in sorted(per_model.items())]
        for table in ("gauges", "counters"):
            value = snapshot.get(table, {}).get(rule.metric)
            if isinstance(value, (int, float)):
                return [(None, float(value))]
        return []  # unknown metric: not a breach

    #: metrics derived from the CLOCK rather than from records: these keep
    #: breaching/recovering between records, so freshness gating must not
    #: apply (staleness grows precisely while nothing new arrives)
    _CLOCK_METRICS = frozenset({"heartbeat_age_s"})

    def evaluate(self, snapshot: dict, now: float | None = None) -> list[dict]:
        """One evaluation pass; returns the transitions it produced.

        ``for=N`` counts windows of the rule's METRIC, not evaluation
        passes: the aggregator stamps a per-(metric, label) update count
        (``snapshot["metric_gen"]``), and a rule's breach/ok counters
        advance only when that count moved since the rule last looked —
        the plane polls every couple of seconds and the frontend evaluates
        per scrape, and re-counting one stale bad SLO window N times
        within seconds (or letting unrelated span/request traffic stand in
        for freshness) would fire a debounced alarm off a single window.
        Deliberately at most ONE window per evaluation, however many
        records a catch-up poll folded: a folded batch only exposes its
        FINAL value, and billing N historical windows at that value would
        page a freshly-attached plane off a healthy run whose last window
        blipped. Alarms are live signals — retrospective analysis is
        ``obs summarize``'s job, and a dead run is ``heartbeat_stale``'s.
        Snapshots without ``metric_gen`` (hand-built, unit tests) count
        every evaluation. Clock-derived metrics (`_CLOCK_METRICS`) are
        exempt from freshness — they change between records by definition.
        """
        now = time.time() if now is None else now
        transitions: list[dict] = []
        gens = snapshot.get("metric_gen")
        if not isinstance(gens, dict):
            gens = {}
        with self._lock:
            for rule in self.rules:
                clocked = rule.metric in self._CLOCK_METRICS
                for label, value in self._values(rule, snapshot):
                    st = self._state.setdefault((rule.name, label), _AlarmState())
                    st.last_value = value
                    gen = gens.get(
                        rule.metric if label is None else f"{rule.metric}|{label}"
                    )
                    if not clocked and gen is not None:
                        if gen == st.gen:
                            continue  # no new window of this metric yet
                        st.gen = gen
                    if rule.breached(value):
                        st.breaches += 1
                        st.oks = 0
                        if not st.active and st.breaches >= rule.for_windows:
                            st.active = True
                            st.fired_at = now
                            transitions.append(self._fire(rule, label, value))
                    else:
                        st.oks += 1
                        st.breaches = 0
                        if st.active and st.oks >= rule.for_windows:
                            st.active = False
                            transitions.append(
                                self._clear(rule, label, value, now - st.fired_at)
                            )
        return transitions

    def active(self) -> list[str]:
        with self._lock:
            return sorted(
                f"{name}{f'[{label}]' if label else ''}"
                for (name, label), st in self._state.items()
                if st.active
            )

    # -- transitions ---------------------------------------------------------

    def _notify(self, kind: str, fields: dict) -> dict:
        record = {"kind": kind, **fields}
        self._event(kind, **fields)
        for hook in self._hooks:
            try:
                hook(dict(record))
            except Exception as exc:  # a hook must never kill the plane
                logger.warning(f"alarm hook failed: {exc!r}")
        return record

    def _fire(self, rule: AlarmRule, label: str | None, value: float) -> dict:
        fields = {
            "rule": rule.name,
            "metric": rule.metric,
            "value": round(float(value), 6),
            "threshold": rule.threshold,
            "op": rule.op,
            "windows": rule.for_windows,
        }
        if label is not None:
            fields["model"] = label
        logger.warning(
            f"ALARM {rule.name}{f'[{label}]' if label else ''}: "
            f"{rule.metric} {value:.4g} {rule.op} {rule.threshold:.4g} "
            f"for {rule.for_windows} window(s)"
        )
        return self._notify("alarm", fields)

    def _clear(
        self, rule: AlarmRule, label: str | None, value: float, active_s: float
    ) -> dict:
        fields = {
            "rule": rule.name,
            "metric": rule.metric,
            "value": round(float(value), 6),
            "threshold": rule.threshold,
            "active_s": round(max(0.0, active_s), 3),
        }
        if label is not None:
            fields["model"] = label
        logger.info(
            f"alarm cleared {rule.name}{f'[{label}]' if label else ''}: "
            f"{rule.metric} back to {value:.4g} after {active_s:.1f}s"
        )
        return self._notify("alarm_clear", fields)


def engine_from_cfg(
    journal_event=None, *, exclude_metrics: tuple[str, ...] = ()
) -> AlarmEngine | None:
    """An engine from ``cfg.OBS.ALARMS``; config errors are logged and
    disable alarming (the plane they ride must never die of a typo).

    ``exclude_metrics`` drops rules whose metric a given context cannot
    honestly evaluate — the serve frontend drops ``heartbeat_age_s``: a
    replica with no traffic journals nothing, but idle is not dead
    (/healthz still answers), and the staleness default would page on
    every quiet 5 minutes.
    """
    try:
        from distribuuuu_tpu_torch.config import cfg

        entries = list(cfg.OBS.ALARMS) if "OBS" in cfg else []
        rules = [
            r for r in parse_alarm_rules(entries)
            if r.metric not in exclude_metrics
        ]
        return AlarmEngine(rules, journal_event)
    except Exception as exc:
        logger.error(f"OBS.ALARMS invalid — alarms disabled: {exc!r}")
        return None
