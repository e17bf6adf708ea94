"""Alert rules engine: the signals finally watch themselves.

Fourteen PRs of recorded telemetry (spans, federated metrics,
``/status``, flight dumps, SLO accounting) were all *passive* — an
operator had to read them.  This module evaluates **declarative rules**
over a :func:`~mdanalysis_mpi_tpu_torch.obs.metrics.unified_snapshot`
document on the scheduler's supervisor tick, and over the *federated*
snapshot at the fleet controller, and turns sustained breaches into
first-class events (docs/OBSERVABILITY.md "Alerting & profiling"):

- a ``firing`` transition records an ``alert_fired`` instant on the
  span timeline, sets ``mdtpu_alerts_firing{rule=}`` to 1, counts
  ``mdtpu_alert_transitions_total{rule=,to=}``, appends an ``alert``
  record to the owning journal (when one is attached), and — on the
  FIRST firing of a rule — writes one flight-recorder black box
  (``trigger="alert"``; a flapping rule never storms dumps);
- a ``resolved`` transition mirrors all of the above (gauge back to 0
  once no series of the rule fires, ``alert_resolved`` instant,
  journaled, counted) — no dump;
- ``/status`` gains an ``alerts`` block (firing table + recent
  transitions), rendered by ``mdtpu status --alerts``.

Rule kinds (the :data:`SEED_RULES` catalog is a pure literal so
``mdtpu lint`` MDT206 can statically harvest it, exactly like the
metric tables):

``threshold``
    Instantaneous value (gauge level, or counter total summed over
    ``metrics``) compared against ``threshold`` with ``op``; must hold
    for ``for_ticks`` consecutive evaluations (the hysteresis that
    keeps a one-tick spike from firing).
``rate``
    Counter increase per second over the trailing ``window_s``
    exceeds ``threshold`` (needs two samples spanning >0 s — a rule
    never fires off a single observation).
``burn_rate``
    The SRE multi-window burn-rate pattern over an attainment-style
    gauge (0..1, e.g. ``mdtpu_slo_attainment{class=}``): burn =
    (1 - value) / (1 - objective) — how many times faster than
    budgeted the error budget is being spent — and the rule breaches
    only when the average burn over BOTH the fast window (recent,
    catches a cliff) and the slow window (sustained, rejects a blip)
    exceeds ``burn_threshold``.

Labeled series evaluate independently (one state per ``(rule,
series)`` — the ``class="interactive"`` attainment firing does not
mask ``class="batch"``), while the exported gauge stays per rule:
1 while ANY series of the rule fires.

Stdlib only, like the rest of ``obs/``.  Evaluation never raises into
the supervisor tick that called it: a rule over a missing/renamed
metric simply reads 0 samples and stays quiet.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

#: Seed rule catalog — PURE LITERAL (lint MDT206 harvests it with
#: ``ast.literal_eval``, and ``tests/test_bench_contract.py`` pins the
#: names in PINNED_ALERT_RULES so rule drift is caught like metric
#: drift).  Names are unique snake_case by contract.
SEED_RULES = [
    {"name": "slo_burn_rate", "kind": "burn_rate",
     "metric": "mdtpu_slo_attainment",
     "objective": 0.9, "fast_window_s": 60.0, "slow_window_s": 300.0,
     "burn_threshold": 2.0, "for_ticks": 2,
     "description": "a QoS class is burning its latency-SLO error "
                    "budget >2x faster than sustainable over both "
                    "the fast and slow windows"},
    {"name": "queue_saturated", "kind": "threshold",
     "metric": "mdtpu_queue_depth", "op": ">=", "threshold": 64,
     "for_ticks": 3,
     "description": "queue depth has sat at/above the saturation "
                    "bound for consecutive ticks while capacity "
                    "cannot drain it"},
    {"name": "shed_rate_high", "kind": "rate",
     "metric": "mdtpu_jobs_shed_total", "window_s": 60.0,
     "threshold": 0.5, "for_ticks": 2,
     "description": "the overload ladder is shedding jobs faster "
                    "than 0.5/s over the trailing minute"},
    {"name": "data_corruption", "kind": "threshold",
     "metrics": ["mdtpu_scrub_corrupt_total",
                 "mdtpu_integrity_corrupt_total",
                 "mdtpu_store_chunk_crc_rejects_total"],
     "op": ">", "threshold": 0, "for_ticks": 1,
     "description": "any scrub/digest/store-CRC corruption count is "
                    "nonzero — silent data corruption is never a "
                    "wait-and-see signal"},
    {"name": "store_remote_error_rate", "kind": "rate",
     "metric": "mdtpu_store_remote_errors_total", "window_s": 60.0,
     "threshold": 1.0, "for_ticks": 2,
     "description": "the remote store tier is failing requests "
                    "faster than 1/s over the trailing minute — "
                    "reads are riding the degradation ladder "
                    "(cache/mirror) instead of the remote"},
    {"name": "breaker_flapping", "kind": "rate",
     "metric": "mdtpu_breaker_transitions_total", "window_s": 60.0,
     "threshold": 0.2, "for_ticks": 1,
     "description": "circuit breakers are transitioning faster than "
                    "1 per 5 s over the trailing minute — a backend "
                    "is flapping, not failing cleanly"},
    {"name": "stream_staleness", "kind": "threshold",
     "metric": "mdtpu_stream_snapshot_age_seconds", "op": ">",
     "threshold": 30.0, "for_ticks": 2,
     "description": "a live tenant's newest partial snapshot is over "
                    "30 s old for consecutive ticks — its feed "
                    "stalled (producer dead, store unreachable) or "
                    "the streaming pass cannot keep up "
                    "(docs/STREAMING.md)"},
    {"name": "canary_failing", "kind": "threshold",
     "metric": "mdtpu_canary_consecutive_failures", "op": ">=",
     "threshold": 2.0, "for_ticks": 2,
     "description": "the synthetic canary probe (service/canary.py) "
                    "has failed its last 2+ end-to-end runs for "
                    "consecutive ticks — the serving path is broken "
                    "even if no tenant traffic is arriving; the "
                    "failure stage is on "
                    "mdtpu_canary_failures_total{stage=}"},
]

_SNAKE_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: Bounded transition history the /status block exposes.
MAX_RECENT = 64

#: Bounded per-series sample history for rate/burn windows.
MAX_HISTORY = 512


class AlertRule:
    """One validated rule (see the module docstring for kinds)."""

    __slots__ = ("name", "kind", "metrics", "op", "threshold",
                 "for_ticks", "window_s", "fast_window_s",
                 "slow_window_s", "objective", "burn_threshold",
                 "description")

    def __init__(self, spec: dict):
        spec = dict(spec)
        self.name = spec.pop("name")
        if not _SNAKE_RE.match(self.name):
            raise ValueError(
                f"alert rule name {self.name!r} is not snake_case")
        self.kind = spec.pop("kind")
        if self.kind not in ("threshold", "rate", "burn_rate"):
            raise ValueError(f"unknown alert rule kind {self.kind!r}")
        metric = spec.pop("metric", None)
        metrics = spec.pop("metrics", None)
        self.metrics = tuple(metrics) if metrics else (metric,)
        if not self.metrics or self.metrics[0] is None:
            raise ValueError(f"rule {self.name!r} names no metric")
        self.op = spec.pop("op", ">")
        if self.op not in (">", ">=", "<", "<="):
            raise ValueError(f"rule {self.name!r}: bad op {self.op!r}")
        self.threshold = float(spec.pop("threshold", 0.0))
        self.for_ticks = max(1, int(spec.pop("for_ticks", 1)))
        self.window_s = float(spec.pop("window_s", 60.0))
        self.fast_window_s = float(spec.pop("fast_window_s", 60.0))
        self.slow_window_s = float(spec.pop("slow_window_s", 300.0))
        self.objective = float(spec.pop("objective", 0.9))
        self.burn_threshold = float(spec.pop("burn_threshold", 1.0))
        self.description = spec.pop("description", "")
        if spec:
            raise ValueError(
                f"rule {self.name!r}: unknown fields {sorted(spec)}")

    def _compare(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == ">=":
            return value >= self.threshold
        if self.op == "<":
            return value < self.threshold
        return value <= self.threshold


def seed_rules() -> list[AlertRule]:
    """The validated seed catalog (fresh objects each call)."""
    return [AlertRule(s) for s in SEED_RULES]


def _series_total(series: dict) -> float:
    """Sum every label-key value of one snapshot series (counters and
    gauges; histograms contribute their count)."""
    total = 0.0
    for v in series.get("values", {}).values():
        if isinstance(v, dict):
            total += v.get("count", 0)
        else:
            total += v
    return total


def _labeled_values(snapshot: dict, name: str) -> dict:
    """``{label_key: scalar}`` for one metric (missing → empty)."""
    series = snapshot.get(name)
    if not isinstance(series, dict):
        return {}
    out = {}
    for k, v in series.get("values", {}).items():
        out[k] = v.get("count", 0) if isinstance(v, dict) else v
    return out


class _SeriesState:
    __slots__ = ("breach_ticks", "clear_ticks", "firing", "since",
                 "value", "history")

    def __init__(self):
        self.breach_ticks = 0
        self.clear_ticks = 0
        self.firing = False
        self.since: float | None = None
        self.value: float | None = None
        self.history: deque = deque(maxlen=MAX_HISTORY)


class AlertEngine:
    """Evaluate rules over metric snapshots; emit transitions.

    ``clock``
        Injectable monotonic clock (tests drive windows
        deterministically; the scheduler/fleet pass their own).
    ``flight_dir``
        Where the first-firing black box lands (None: no dumps).
    ``journal``
        An object with ``record(ev, fingerprint, **fields)`` (the
        scheduler/fleet :class:`~mdanalysis_mpi_tpu_torch.service.journal.
        JobJournal`); every transition appends an ``alert`` record.
    """

    def __init__(self, rules=None, clock=time.monotonic,
                 flight_dir: str | None = None, journal=None):
        if rules is None:
            rules = seed_rules()
        self.rules = [r if isinstance(r, AlertRule) else AlertRule(r)
                      for r in rules]
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.clock = clock
        self.flight_dir = flight_dir
        self.journal = journal
        self._lock = threading.Lock()
        # (rule_name, series_key) -> _SeriesState
        self._state: dict[tuple, _SeriesState] = {}
        self._dumped: set[str] = set()     # rules that already dumped
        self._recent: deque = deque(maxlen=MAX_RECENT)

    # ---- evaluation ----

    def _rule_values(self, rule: AlertRule, snapshot: dict) -> dict:
        """``{series_key: value}`` this evaluation should judge."""
        if rule.kind == "burn_rate":
            # per-label attainment series; the zero-injected "" series
            # (value 0, no jobs yet) would read as a 100%-miss class —
            # skip unlabeled zero placeholders
            vals = _labeled_values(snapshot, rule.metrics[0])
            return {k: v for k, v in vals.items() if k or v}
        if len(rule.metrics) > 1:
            total = sum(_series_total(snapshot.get(m, {}))
                        for m in rule.metrics)
            return {"": total}
        if rule.kind == "rate":
            # rates run over the summed counter: per-label rates would
            # fire per reason/class, which the seed rules don't need
            return {"": _series_total(snapshot.get(rule.metrics[0],
                                                   {}))}
        return _labeled_values(snapshot, rule.metrics[0])

    def _breach(self, rule: AlertRule, st: _SeriesState,
                value: float, now: float) -> bool:
        if rule.kind == "threshold":
            st.value = value
            return rule._compare(value)
        st.history.append((now, value))
        if rule.kind == "rate":
            window = [(t, v) for t, v in st.history
                      if now - t <= rule.window_s]
            if len(window) < 2:
                st.value = 0.0
                return False
            dt = window[-1][0] - window[0][0]
            dv = window[-1][1] - window[0][1]
            rate = dv / dt if dt > 0 else 0.0
            st.value = round(rate, 6)
            return rate > rule.threshold
        # burn_rate: value is an attainment gauge in [0, 1]
        budget = max(1e-9, 1.0 - rule.objective)

        def _avg_burn(window_s: float):
            pts = [v for t, v in st.history if now - t <= window_s]
            if not pts:
                return None
            return sum((1.0 - v) / budget for v in pts) / len(pts)

        fast = _avg_burn(rule.fast_window_s)
        slow = _avg_burn(rule.slow_window_s)
        st.value = round(fast, 4) if fast is not None else None
        # cold-start guard: until the IN-WINDOW history actually
        # spans a meaningful fraction of the slow window, "slow"
        # would average the same few points as "fast" and the
        # multi-window pattern degenerates to single-window — a
        # first-job startup blip would fire.  Half the slow window of
        # coverage is the price of the "sustained" claim.  Measured
        # over points INSIDE the window, not the whole retained
        # history: a series that vanished and reappeared (a pruned
        # lost-host gauge whose host rejoined) restarts the guard
        # instead of riding stale pre-gap points past it.
        in_win = [t for t, _ in st.history
                  if now - t <= rule.slow_window_s]
        span = now - in_win[0] if in_win else 0.0
        if span < rule.slow_window_s * 0.5:
            return False
        return (fast is not None and slow is not None
                and fast > rule.burn_threshold
                and slow > rule.burn_threshold)

    def evaluate(self, snapshot: dict, now: float | None = None) -> list:
        """One tick: judge every rule against ``snapshot``; fire and
        resolve per the hysteresis; return this tick's transitions
        (``[{rule, series, state, value, at}]``)."""
        if now is None:
            now = self.clock()
        transitions = []
        with self._lock:
            for rule in self.rules:
                values = self._rule_values(rule, snapshot)
                # a FIRING series that vanished from the snapshot (a
                # class with no more jobs, a pruned lost-host gauge)
                # must still be able to resolve: no data walks the
                # same clear hysteresis as a clean reading — without
                # this, a vanished series would fire forever.  A
                # vanished series' state is then EVICTED (immediately
                # when it was not firing): a host-churning fleet
                # mints host=-labeled series forever, and retained
                # states would grow memory and per-tick cost without
                # bound.  If the series reappears it starts fresh —
                # the burn cold-start guard re-arms, which errs quiet.
                stale = []
                for key, st in self._state.items():
                    rn, series = key
                    if rn != rule.name or series in values:
                        continue
                    st.breach_ticks = 0
                    if not st.firing:
                        stale.append(key)
                        continue
                    st.clear_ticks += 1
                    if st.clear_ticks >= rule.for_ticks:
                        st.firing = False
                        st.since = None
                        transitions.append(
                            {"rule": rule.name, "series": series,
                             "state": "resolved",
                             "value": None, "at": now})
                        stale.append(key)
                for key in stale:
                    del self._state[key]
                for series, value in values.items():
                    key = (rule.name, series)
                    st = self._state.get(key)
                    if st is None:
                        st = self._state[key] = _SeriesState()
                    breach = self._breach(rule, st, float(value), now)
                    if breach:
                        st.breach_ticks += 1
                        st.clear_ticks = 0
                        if (not st.firing
                                and st.breach_ticks >= rule.for_ticks):
                            st.firing = True
                            st.since = now
                            transitions.append(
                                {"rule": rule.name, "series": series,
                                 "state": "firing",
                                 "value": st.value, "at": now})
                    else:
                        st.breach_ticks = 0
                        if st.firing:
                            # resolve hysteresis mirrors for_ticks: a
                            # flapping signal stays firing until it
                            # has been clean as long as it had to be
                            # dirty to fire
                            st.clear_ticks += 1
                            if st.clear_ticks >= rule.for_ticks:
                                st.firing = False
                                st.since = None
                                transitions.append(
                                    {"rule": rule.name,
                                     "series": series,
                                     "state": "resolved",
                                     "value": st.value, "at": now})
                        else:
                            st.clear_ticks = 0
            for tr in transitions:
                self._recent.append(dict(tr))
        for tr in transitions:
            self._emit(tr)
        return transitions

    # ---- side effects (outside the state lock) ----

    def _rule_firing_locked(self, rule_name: str) -> bool:
        return any(st.firing for (rn, _), st in self._state.items()
                   if rn == rule_name)

    def _emit(self, tr: dict) -> None:
        from mdanalysis_mpi_tpu_torch.obs import flight as _flight
        from mdanalysis_mpi_tpu_torch.obs import spans as _spans
        from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

        rule, state = tr["rule"], tr["state"]
        with self._lock:
            any_firing = self._rule_firing_locked(rule)
            first_dump = (state == "firing"
                          and rule not in self._dumped)
            if first_dump:
                self._dumped.add(rule)
        METRICS.set_gauge("mdtpu_alerts_firing",
                          1 if any_firing else 0, rule=rule)
        METRICS.inc("mdtpu_alert_transitions_total", rule=rule,
                    to=state)
        if state == "firing":
            _spans.span_event("alert_fired", rule=rule,
                              series=tr["series"], value=tr["value"])
        else:
            _spans.span_event("alert_resolved", rule=rule,
                              series=tr["series"], value=tr["value"])
        if self.journal is not None:
            try:
                self.journal.record("alert", None, rule=rule,
                                    state=state, series=tr["series"],
                                    value=tr["value"])
            except Exception:
                pass     # a full disk must not kill the alert path
        if first_dump and self.flight_dir:
            # the black box of the moment the rule FIRST fired —
            # exactly once per rule, however often it flaps
            # (tests/test_alerts.py pins the no-storm contract)
            _flight.dump("alert", self.flight_dir,
                         extra={"rule": rule, "series": tr["series"],
                                "value": tr["value"]})

    # ---- reading ----

    def firing(self) -> list:
        """Currently firing series: ``[{rule, series, since, value}]``
        sorted by rule name."""
        with self._lock:
            return sorted(
                ({"rule": rn, "series": series,
                  "since": st.since, "value": st.value}
                 for (rn, series), st in self._state.items()
                 if st.firing),
                key=lambda d: (d["rule"], d["series"]))

    def status(self) -> dict:
        """The ``/status`` ``alerts`` block: rule census, the firing
        table, and the recent transition history."""
        with self._lock:
            recent = [dict(tr) for tr in self._recent]
        return {
            "rules": [r.name for r in self.rules],
            "firing": self.firing(),
            "recent": recent,
        }
